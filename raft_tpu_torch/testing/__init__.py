"""Testing utilities: the deterministic chaos / fault-injection harness
(port of ``raft_tpu/testing``)."""

from raft_tpu_torch.testing.chaos import (
    ChaosMonkey,
    FaultSpec,
    InjectedFault,
)

__all__ = ["ChaosMonkey", "FaultSpec", "InjectedFault"]
