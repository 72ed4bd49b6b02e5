"""Random state. The distributions and dataset generators of the
reference's ``random`` package come in a later slice."""

from raft_tpu_torch.random.rng_state import GeneratorType, RngState

__all__ = ["GeneratorType", "RngState"]
