"""The benchmark of raft_tpu_torch on one or four H100 cards.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line; ``perfbench/README.md`` says how to add a configuration, a
traffic mix or a metric.
"""
