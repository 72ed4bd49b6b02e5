"""Parity of raft_tpu_torch.obs (the metrics registry, its collectors and
the online recall probe) with raft_tpu.obs.

* The registry reproduces ``tests/golden/obs_scrape.prom`` byte for byte
  from the reference suite's ``_golden_registry`` recipe, and its
  refusals, snapshots and scrape-under-traffic behaviour are the
  reference's.
* Each collector's exposition equals the reference's, byte for byte, for
  the same scripted stream on the same injected clock (the reference
  suite's TestCollectors, TestDurabilityCollectors and
  TestRobustnessCollectors scripts, run on each package's own islands).
  The write-ahead log's collector is also scraped on rank 0 of a gloo
  world of 4 (the log's writer) against the reference's single process.
* The recall probe's scripts (TestRecallProbe) give the same samples,
  estimates and drift edges as the reference's, on single-host IVF-Flat
  searchers over the same index, and on a 4-rank front-rank scheduler
  whose truth searches go through the command channel.

Rows and queries are integer valued (tests/test_torch_common.py), so the
served ids of both packages are identical, and so are the estimates.
"""

import importlib
import os
import threading
import types

import numpy as np
import pytest

import raft_tpu.comms.health as jhealth
import raft_tpu.lifecycle as jlc
import raft_tpu.lifecycle.elastic as jelastic
import raft_tpu.lifecycle.wal as jwal
import raft_tpu.obs as jobs
import raft_tpu.parallel as jpar
import raft_tpu.parallel.routing as jrouting
import raft_tpu.serve as jserve
import raft_tpu_torch.comms.health as health_mod
import raft_tpu_torch.lifecycle as lc
import raft_tpu_torch.lifecycle.elastic as elastic_mod
import raft_tpu_torch.lifecycle.wal as wal_mod
import raft_tpu_torch.obs as obs
import raft_tpu_torch.parallel.routing as routing_mod
import raft_tpu_torch.serve as serve
from test_topk_merge import _mesh
from test_torch_common import int_data
from test_torch_routed import _ref_index, _ref_params
from test_torch_serve import _DB, _flat_pair
from test_torch_world import World
from torch_durable_cases import N_LISTS, case_recall_probe, case_wal_scrape

# The packages export functions named like these modules.
topk_mod = importlib.import_module("raft_tpu_torch.comms.topk_merge")
jtopk = importlib.import_module("raft_tpu.comms.topk_merge")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "obs_scrape.prom")
DIM = 16

PORT = types.SimpleNamespace(obs=obs, serve=serve, health=health_mod,
                             lc=lc, routing=routing_mod, topk=topk_mod,
                             wal=wal_mod, elastic=elastic_mod)
REF = types.SimpleNamespace(obs=jobs, serve=jserve, health=jhealth, lc=jlc,
                            routing=jrouting, topk=jtopk, wal=jwal,
                            elastic=jelastic)


def _both(script, *args):
    return script(PORT, *args), script(REF, *args)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:          # noqa: BLE001 - the outcome is the data
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# The registry


def golden_registry(ns):
    """The reference suite's ``_golden_registry`` recipe."""
    reg = ns.obs.MetricsRegistry()
    c = reg.counter("raft_demo_requests_total", "served requests",
                    labels=("bucket", "kind"))
    c.inc(3, bucket="8x10", kind="flat")
    c.inc(bucket="4x5", kind="pq")
    live = reg.gauge("raft_demo_live", "per-rank liveness",
                     labels=("rank",))
    for rank in range(3):
        live.set(float(rank != 1), rank=rank)
    frac = reg.gauge("raft_demo_frac", "a non-integer value")
    frac.set(0.8125)
    h = reg.histogram("raft_demo_latency_seconds", "request latency",
                      labels=("bucket",), buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.002, 0.05, 0.2):
        h.observe(v, bucket="8x10")
    esc = reg.gauge("raft_demo_info", "label-value escaping",
                    labels=("note",))
    esc.set(1, note='quote "q" back\\slash\nnewline')
    return reg


def test_golden_scrape_byte_for_byte():
    text = golden_registry(PORT).prometheus_text()
    with open(GOLDEN) as f:
        assert text == f.read()
    assert text == golden_registry(PORT).prometheus_text()


def test_snapshot_equals_the_reference():
    port, ref = _both(lambda ns: golden_registry(ns).snapshot())
    assert port == ref


def s_registry_rules(ns):
    reg = ns.obs.MetricsRegistry()
    a = reg.counter("x_total", "h", labels=("l",))
    out = [reg.counter("x_total", "other help", labels=("l",)) is a,
           len(reg)]
    out += [_outcome(lambda: reg.gauge("x_total", labels=("l",))),
            _outcome(lambda: reg.counter("x_total", labels=("other",))),
            _outcome(lambda: reg.counter("9bad")),
            _outcome(lambda: reg.counter("ok_total", labels=("bad-label",))),
            _outcome(lambda: reg.counter("c_total").inc(-1))]
    c = reg.counter("c2_total", labels=("a",))
    out += [_outcome(lambda: c.inc(b="x")), _outcome(lambda: c.inc())]
    out += [_outcome(lambda: reg.histogram("h", buckets=(0.1, 0.1))),
            _outcome(lambda: reg.histogram("h2", buckets=()))]
    h = reg.histogram("h_seconds", buckets=(0.1, 1.0))
    out += [reg.histogram("h_seconds", buckets=(1.0, 0.1)) is h,
            _outcome(lambda: reg.histogram("h_seconds",
                                           buckets=(0.001, 0.01)))]
    calls = []
    unsub = reg.register_collector(lambda: calls.append(1))
    reg.collect()
    unsub()
    unsub()
    reg.collect()
    g = reg.gauge("g", labels=("r",))
    g.set(2.5, r=1)
    g.inc(r=1)
    return out + [calls, g.value(r=1), reg.prometheus_text()]


def test_registry_rules_equal_the_reference():
    port, ref = _both(s_registry_rules)
    assert port == ref


def test_scrape_under_traffic_race():
    """Writers hammer a counter, a histogram and ServeStats while two
    scrapers loop the exposition: no error, no torn line, exact totals."""
    reg = obs.MetricsRegistry()
    c = reg.counter("race_total", labels=("w",))
    h = reg.histogram("race_latency_seconds", buckets=(0.01, 0.1))
    stats = serve.ServeStats()
    obs.ServeStatsCollector(reg, stats)
    n_writers, n_iters = 4, 300
    barrier = threading.Barrier(n_writers + 2)
    errors = []

    def write(w):
        barrier.wait()
        for i in range(n_iters):
            c.inc(w=str(w))
            h.observe(0.001 * (i % 7))
            stats.count((8, 5), "requests")
            stats.observe_latency((8, 5), 0.001)

    def scrape():
        barrier.wait()
        try:
            for _ in range(30):
                for line in reg.prometheus_text().splitlines():
                    assert line.startswith(("#", "r"))
                reg.snapshot()
        except Exception as e:          # noqa: BLE001 - surfaced after join
            errors.append(e)

    threads = [threading.Thread(target=write, args=(w,))
               for w in range(n_writers)]
    threads += [threading.Thread(target=scrape) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    assert all(c.value(w=str(w)) == n_iters for w in range(n_writers))
    text = reg.prometheus_text()
    assert "race_latency_seconds_count %d" % (n_writers * n_iters) in text
    assert ('raft_serve_requests_total{bucket="8x5"} %d'
            % (n_writers * n_iters)) in text


# ---------------------------------------------------------------------------
# Collectors: each scripted stream scraped through both packages


def c_serve_stats(ns):
    stats = ns.serve.ServeStats()
    for ms in range(1, 101):
        stats.observe_latency((8, 5), ms / 1000.0)
        stats.count((8, 5), "requests")
    stats.count((4, 10), "batches", 3)
    reg = ns.obs.MetricsRegistry()
    ns.obs.ServeStatsCollector(reg, stats)
    return [reg.prometheus_text(), stats.snapshot()["buckets"]["8x5"]]


def c_shard_health(ns):
    health = ns.health.ShardHealth(4, latency=ns.health.LatencyPolicy())
    reg = ns.obs.MetricsRegistry()
    col = ns.obs.ShardHealthCollector(reg, health)
    health.mark_dead(2)
    health.mark_live(2)                 # a flap between scrapes
    health.mark_dead(1)
    health.mark_suspect(3)
    texts = [reg.prometheus_text()]
    health.mark_live(3)
    texts.append(reg.prometheus_text())
    col.close()
    health.mark_dead(0)                 # after close: not counted
    health.mark_suspect(2)
    return texts + [reg.prometheus_text()]


def c_cache(ns):
    cache = ns.serve.ResultCache(capacity=2)
    reg = ns.obs.MetricsRegistry()
    ns.obs.CacheCollector(reg, cache)
    q = [np.full((1, 2), float(i), np.float32) for i in range(4)]
    cache.get(0, q[0], 5)
    for i in range(3):
        cache.put(0, q[i], 5, "r%d" % i)
    cache.get(0, q[2], 5)
    cache.invalidate()
    return [reg.prometheus_text()]


def c_compactor(ns):
    """The reference suite's compactor script on one IVF-Flat index."""
    p, j = _flat_pair(n_probes=4)
    s = p if ns is PORT else j
    s.delete(np.arange(64))
    comp = ns.lc.Compactor(s, ns.lc.CompactionPolicy(trigger_frac=0.05))
    reg = ns.obs.MetricsRegistry()
    ns.obs.CompactorCollector(reg, comp)
    ns.obs.SearcherCollector(reg, s)
    texts = [comp.should_run(), comp.run_once() is not None,
             reg.prometheus_text()]

    def boom():
        raise RuntimeError("injected-compaction-fault")

    s.delete(np.arange(64, 128))
    comp._pre_publish = boom
    texts.append(_outcome(lambda: comp.run_once(force=True)))
    texts.append(reg.prometheus_text())
    comp._pre_publish = None
    texts += [comp.run_once(force=True) is not None, reg.prometheus_text()]
    return texts


def c_drift_signal(ns):
    p, j = _flat_pair(n_probes=4)
    s = p if ns is PORT else j
    drifted = [False]
    comp = ns.lc.Compactor(s, ns.lc.CompactionPolicy(trigger_frac=0.25),
                           drift_signal=lambda: drifted[0])
    out = [comp.should_run()]
    for flag in (True, True, False, True):
        drifted[0] = flag
        out.append(comp.should_run())
    return out


def c_merge_dispatch(ns):
    stats = ns.topk.MergeDispatchStats()
    stats.record("ring", 8, 5, 5, 4)
    stats.record("allgather", 16, 10, 10, 4)
    stats.record("ring", 8, 5, 5, 4)
    reg = ns.obs.MetricsRegistry()
    ns.obs.MergeDispatchCollector(reg, stats=stats)
    return [reg.prometheus_text(), ns.topk.merge_comm_bytes("ring", 8, 5,
                                                            5, 4)]


def c_routing(ns):
    rng = np.random.default_rng(3)
    weights = rng.integers(1, 40, 16).astype(np.float64)
    owner = ns.routing.assign_lists(weights, 4)
    pm = ns.routing.build_placement(owner, 4)
    stats = ns.routing.RoutingStats()
    for _ in range(3):
        probes = rng.integers(0, 16, (8, 3)).astype(np.int32)
        plan = ns.routing.plan_route(probes, pm)
        stats.record(plan, pm, probe_ids=probes)
    reg = ns.obs.MetricsRegistry()
    ns.obs.RoutingCollector(reg, stats=stats)
    return [reg.prometheus_text()]


def c_wal(ns, d):
    """A fsynced log on an injected clock, a stub follower and promotion:
    records, bytes, the fsync histogram (each latency once), snapshots,
    head, lag and promotions."""
    clock = iter(np.arange(0.0, 10.0, 0.25))
    log = ns.wal.MutationLog(os.path.join(d, "port" if ns is PORT else "ref"),
                             n_parts=2, fsync=True,
                             monotonic=lambda: float(next(clock)))
    rng = np.random.default_rng(5)
    for e in range(1, 4):
        log.append("extend", e, dict(
            vectors=rng.integers(0, 8, (6, 4)).astype(np.float32),
            ids=np.arange(6 * e, 6 * e + 6, dtype=np.int32)))
    log.stats.record_snapshot(2)
    fol = types.SimpleNamespace(lag=2)
    promo = types.SimpleNamespace(promotions=0)
    reg = ns.obs.MetricsRegistry()
    col = ns.obs.WalCollector(reg, log.stats, followers=[fol],
                              promotion=promo)
    texts = [reg.prometheus_text(), reg.prometheus_text()]
    fol.lag, promo.promotions = 0, 1
    texts.append(reg.prometheus_text())
    col.close()
    log.close()
    return texts


def c_elastic(ns):
    stats = ns.elastic.ElasticStats()
    reg = ns.obs.MetricsRegistry()
    ns.obs.ElasticCollector(reg, stats=stats)
    texts = [reg.prometheus_text()]
    for action, moved, epoch in (("leave", 3, 1), ("join", 2, 2)):
        stats.record(ns.elastic.ElasticReport(
            action=action, rank=3, active_before=(0, 1, 2, 3),
            active_after=(0, 1, 2), lists_moved=moved, warmed_shapes=0,
            epoch=epoch))
    reg2 = ns.obs.MetricsRegistry()
    col = ns.obs.ElasticCollector(reg2)
    return texts + [reg.prometheus_text(), col.stats is
                    ns.elastic.elastic_stats]


def c_hedge(ns):
    stub = types.SimpleNamespace(hedge_stats=ns.serve.HedgeStats())
    stub.hedge_stats.record(fired=True, won=True)
    stub.hedge_stats.record(suppressed=True)
    stub.hedge_stats.record(fired=True)
    reg = ns.obs.MetricsRegistry()
    ns.obs.HedgeCollector(reg, stub)
    empty = ns.obs.MetricsRegistry()
    ns.obs.HedgeCollector(empty, types.SimpleNamespace())
    return [reg.prometheus_text(), empty.prometheus_text()]


def c_breaker(ns):
    class _Stub:
        def shadow_probe(self, rank, queries, k):
            return 0.001

    health = ns.health.ShardHealth(2)
    health.mark_dead(1)
    prober = ns.serve.RecoveryProber(_Stub(), health,
                                     np.zeros((1, 4), np.float32), 4,
                                     clean_threshold=3)
    reg = ns.obs.MetricsRegistry()
    ns.obs.BreakerCollector(reg, prober)
    texts = [reg.prometheus_text()]
    for _ in range(3):
        prober.step()
        texts.append(reg.prometheus_text())
    prober.close()
    return texts


def c_degrade(ns):
    s = (serve.Searcher.brute_force(_DB, device="cpu") if ns is PORT
         else jserve.Searcher.brute_force(_DB))
    sched = ns.serve.BatchScheduler(
        s, ns.serve.BucketGrid.pow2(8, k_grid=(5, 10)),
        ns.serve.BatchPolicy(max_batch=8, max_wait=10.0, max_queue=10),
        clock=lambda: 0.0)
    reg = ns.obs.MetricsRegistry()
    ns.obs.DegradeCollector(reg, sched)
    texts = [reg.prometheus_text()]
    sched.submit(np.zeros((1, DIM), np.float32), 5)
    sched.brownout_level = 2
    texts.append(reg.prometheus_text())
    sched.run_until_idle()
    texts.append(reg.prometheus_text())
    sched.close()
    return texts


def c_one_scrape(ns):
    """Every single-host island on one registry, one served request."""
    p, j = _flat_pair(n_probes=4)
    s = p if ns is PORT else j
    grid = ns.serve.BucketGrid.pow2(8, k_grid=(5,))
    cache = ns.serve.ResultCache(capacity=8)
    sched = ns.serve.BatchScheduler(
        s, grid, ns.serve.BatchPolicy(max_batch=8, max_wait=0.0),
        cache=cache, clock=lambda: 0.0)
    mstats = ns.topk.MergeDispatchStats()
    mstats.record("allgather", 8, 5, 5, 4)
    health = ns.health.ShardHealth(4)
    reg = ns.obs.MetricsRegistry()
    ns.obs.ServeStatsCollector(reg, sched.stats)
    ns.obs.ShardHealthCollector(reg, health)
    ns.obs.CacheCollector(reg, cache)
    ns.obs.SearcherCollector(reg, s)
    ns.obs.MergeDispatchCollector(reg, stats=mstats)
    ns.obs.CompactorCollector(reg, ns.lc.Compactor(s))
    ns.obs.DegradeCollector(reg, sched)
    t = sched.submit(int_data(np.random.default_rng(5), (4, DIM)), 5)
    sched.run_until_idle()
    assert t.done
    text = reg.prometheus_text()
    sched.close()
    return [text]


COLLECTOR_SCRIPTS = [c_serve_stats, c_shard_health, c_cache, c_compactor,
                     c_drift_signal, c_merge_dispatch, c_routing,
                     c_elastic, c_hedge, c_breaker, c_degrade, c_one_scrape]


@pytest.mark.parametrize("script", COLLECTOR_SCRIPTS,
                         ids=lambda f: f.__name__[2:])
def test_collector_exposition_equals_the_reference(script):
    port, ref = _both(script)
    assert port == ref


def test_wal_collector_exposition_equals_the_reference(tmp_path):
    port, ref = _both(c_wal, str(tmp_path))
    assert port == ref
    assert "raft_wal_records_total 3" in port[0]
    assert "raft_wal_fsync_seconds_count 3" in port[1]   # observed once
    assert "raft_wal_promotions_total 1" in port[2]


# ---------------------------------------------------------------------------
# The recall probe, single host


def r_estimate(ns, n_probes=2, rate=1.0, seed=3, drift_below=None):
    """The reference suite's estimate / drift script: a scheduler with a
    probe over IVF-Flat at ``n_probes``; the served answers, the probe's
    snapshot, recall and drift, and the scrape."""
    p, j = _flat_pair(n_probes=n_probes)
    s = p if ns is PORT else j
    reg = ns.obs.MetricsRegistry()
    probe = ns.obs.RecallProbe(s, rate=rate, seed=seed, max_pending=64,
                               window=64, min_samples=8,
                               drift_below=drift_below, registry=reg)
    sched = ns.serve.BatchScheduler(
        s, ns.serve.BucketGrid.pow2(8, k_grid=(5,)),
        ns.serve.BatchPolicy(max_batch=8, max_wait=0.0), probe=probe,
        clock=lambda: 0.0)
    rng = np.random.default_rng(17)
    served = []
    for _ in range(8):
        q = int_data(rng, (4, DIM))
        t = sched.submit(q, 5)
        sched.run_until_idle()
        served.append((q, t.result().indices))
    scored = probe.run_pending()
    out = (scored, probe.snapshot(), probe.recall(), probe.drift,
           probe.sample_count(), reg.prometheus_text())
    probe.close()
    sched.close()
    return out, served


def test_estimate_equals_the_reference_and_the_truth():
    (port, served), (ref, jserved) = _both(r_estimate)
    for (q, a), (_, b) in zip(served, jserved):
        np.testing.assert_array_equal(a, b)
    assert port == ref
    scored, snap, est = port[:3]
    assert scored == 8 and snap["buckets"]["4x5"]["samples"] == 32
    # The same rows against the reference's full-probe search.
    full = _flat_pair(n_probes=16)[1]             # every list probed
    truth = [full.search(q, 5).indices for q, _ in served]
    true = float(np.mean([len(np.intersect1d(idx[r], t[r])) / 5.0
                          for (q, idx), t in zip(served, truth)
                          for r in range(q.shape[0])]))
    assert est == pytest.approx(true, abs=1e-12) and 0.0 < est < 1.0


def test_drift_flag_and_registry_publish_equal_the_reference():
    port, ref = _both(lambda ns: r_estimate(ns, n_probes=1,
                                            drift_below=0.999)[0])
    assert port == ref
    assert port[3] is True and "raft_recall_drift 1" in port[5]
    assert "raft_recall_scanned_total 8" in port[5]


def r_sampling(ns):
    p, j = _flat_pair(n_probes=8)
    s = p if ns is PORT else j
    q = np.zeros((1, DIM), np.float32)
    out = []
    for seed in (9, 9, 10):
        probe = ns.obs.RecallProbe(s, rate=0.3, seed=seed)
        out.append([probe.offer(q, 5, np.zeros((1, 5), np.int64), (1, 5),
                                s.epoch) for _ in range(64)])
    probe = ns.obs.RecallProbe(s, rate=1.0, seed=0, max_pending=2)
    for _ in range(5):
        probe.offer(q, 5, np.zeros((1, 5), np.int64), (1, 5), s.epoch)
    out.append(probe.snapshot())
    probe = ns.obs.RecallProbe(s, rate=1.0, seed=0)
    probe.offer(int_data(np.random.default_rng(0), (1, DIM)), 5,
                np.zeros((1, 5), np.int64), (1, 5), s.epoch)
    s.delete(np.array([0]))              # the epoch moves before the scan
    out += [probe.run_pending(), probe.snapshot()]
    return out


def test_sampling_rate_limit_and_staleness_equal_the_reference():
    port, ref = _both(r_sampling)
    assert port == ref
    assert port[0] == port[1] != port[2] and any(port[0])
    assert port[3]["pending"] == 2 and port[3]["dropped"] == 3
    assert port[4] == 0 and port[5]["stale"] == 1


def r_truth_fn(ns):
    p, j = _flat_pair(n_probes=8)
    s = p if ns is PORT else j
    calls = []
    probe = ns.obs.RecallProbe(s, rate=1.0, seed=0, truth_fn=lambda q, k: (
        calls.append(q.shape) or np.asarray([[7, 9, 11, -1, -1]])))
    served = np.full((1, 5), -1, np.int64)
    served[0, 0] = 7
    probe.offer(np.zeros((1, DIM), np.float32), 5, served, (1, 5), s.epoch)
    out = [probe.run_pending(), probe.recall(), calls]
    for kw in ({"rate": 1.5}, {"max_pending": 0}, {"window": 0},
               {"min_samples": 0}, {"drift_below": 0.0}):
        out.append(_outcome(lambda kw=kw: ns.obs.RecallProbe(s, **kw))[0])
    return out


def test_truth_fn_pads_and_validation_equal_the_reference():
    port, ref = _both(r_truth_fn)
    assert port == ref
    assert port[:3] == [1, pytest.approx(0.2), [(1, DIM)]]
    assert port[3:] == ["LogicError"] * 5


def test_degraded_answers_are_not_offered():
    """A completion flagged degraded is never sampled (partial coverage is
    not recall loss), in both packages."""
    def script(ns):
        p, j = _flat_pair(n_probes=8)
        s = p if ns is PORT else j

        class _Degraded:
            def __getattr__(self, name):
                return getattr(s, name)

            def search(self, queries, k, **kw):
                import dataclasses
                return dataclasses.replace(s.search(queries, k),
                                           degraded=True)

        d = _Degraded()
        probe = ns.obs.RecallProbe(d, rate=1.0, seed=0)
        sched = ns.serve.BatchScheduler(
            d, ns.serve.BucketGrid.pow2(8, k_grid=(5,)),
            ns.serve.BatchPolicy(max_batch=8, max_wait=0.0), probe=probe,
            clock=lambda: 0.0)
        t = sched.submit(int_data(np.random.default_rng(2), (2, DIM)), 5)
        sched.run_until_idle()
        out = (t.result().degraded, probe.snapshot()["sampled"],
               probe.snapshot()["offered"])
        sched.close()
        return out

    port, ref = _both(script)
    assert port == ref == (True, 0, 0)


# ---------------------------------------------------------------------------
# On a world of 4: the probe behind a front rank, the log's collector


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("obs_world"))
    yield w
    w.close()


_rng = np.random.default_rng(41)
WX = int_data(_rng, (256, 8))
WCENTERS = WX[::32][:N_LISTS]


def test_front_rank_probe_equals_the_reference(world):
    """A 4-rank front-rank scheduler at n_probes 2 with a sampling probe:
    the truth searches go through the command channel; the samples,
    estimate and scrape are the reference's single controller's, and the
    followers leave when the scheduler closes."""
    reqs = [int_data(np.random.default_rng(100 + i), (1 + i % 3, 8))
            for i in range(24)]
    outs = world.run(case_recall_probe, 4, WX, WCENTERS, reqs, 5, 0.5, 5, 2)
    snap, est, scored, sampled, text = outs[0]
    assert all(isinstance(o, int) and o > 0 for o in outs[1:])
    mesh = _mesh(4)
    jpar.routing_stats.reset()
    index = _ref_index(mesh, "flat", WX, WCENTERS, "list")
    s = jserve.Searcher.ivf_flat(index, _ref_params("flat", "scan", 2),
                                 mesh=mesh)
    reg = jobs.MetricsRegistry()
    probe = jobs.RecallProbe(s, rate=0.5, seed=5, registry=reg)
    jsampled = []
    real = probe.offer

    def offer(queries, k, indices, bucket, epoch):
        hit = real(queries, k, indices, bucket, epoch)
        if hit:
            jsampled.append((queries, np.asarray(indices)))
        return hit

    probe.offer = offer
    sched = jserve.BatchScheduler(s, jserve.BucketGrid.pow2(8, k_grid=(5,)),
                                  jserve.BatchPolicy(max_batch=8,
                                                     max_wait=0.0),
                                  probe=probe)
    for q in reqs:
        sched.submit(q, 5)
        sched.run_until_idle()
    assert probe.run_pending() == scored > 0
    assert len(sampled) == len(jsampled)
    for (q, a), (jq, b) in zip(sampled, jsampled):
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(a, b)
    assert snap == probe.snapshot() and est == probe.recall()
    assert text == reg.prometheus_text()
    sched.close()


def test_wal_collector_on_rank_0_equals_the_reference(world, tmp_path):
    """The reference suite's WalCollector and promotion-counter scripts:
    rank 0's scrapes (the log's writer) equal the reference's; the
    promotion is the port's (the primary's death on every rank, then a
    poll)."""
    rows = int_data(np.random.default_rng(57), (32, 8))
    texts = world.run(case_wal_scrape, 4, WX, WCENTERS, rows,
                      str(tmp_path / "port"))[0]
    mesh = _mesh(4)
    index = _ref_index(mesh, "flat", WX, WCENTERS, "list")
    sp = _ref_params("flat", "scan", N_LISTS)
    root = str(tmp_path / "ref" / "a")
    clock = iter(np.arange(0.0, 100.0, 0.25))
    log = jwal.MutationLog(root, n_parts=2, fsync=True,
                           monotonic=lambda: float(next(clock)))
    log.snapshot(index, mesh)
    primary = jserve.Searcher("ivf_flat", mesh=mesh, index=index,
                              search_params=sp, wal=log)
    primary.delete(np.arange(16))
    primary.extend(rows)
    fidx, flog = jwal.recover(mesh, root, n_parts=2, fsync=False)
    follower = jwal.Follower(jserve.Searcher(
        "ivf_flat", mesh=mesh, index=fidx, search_params=sp, wal=flog),
        flog)
    primary.delete(np.arange(16, 24))
    follower.poll()
    reg = jobs.MetricsRegistry()
    jobs.WalCollector(reg, log.stats, followers=[follower])
    want = [reg.prometheus_text(), reg.prometheus_text()]
    follower.catch_up()
    want.append(reg.prometheus_text())
    log.close()
    flog.close()
    assert texts[:3] == want
    assert "raft_wal_records_total 3" in texts[0]
    assert 'raft_wal_replay_lag_epochs{follower="0"} 1' in texts[0]
    assert "raft_wal_fsync_seconds_count 3" in texts[1]
    assert "raft_wal_promotions_total 0" in texts[3]
    assert "raft_wal_promotions_total 1" in texts[4]
