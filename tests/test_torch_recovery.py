"""The circuit-breaker ``RecoveryProber`` of raft_tpu_torch against
raft_tpu's, on the CPU and with no world: the reference suite's
``TestRecoveryBreaker`` scripts (``tests/test_fault_tolerance.py``) drive
the stub-searcher state machine through both packages' probers, each over
its own package's ``ShardHealth``, and every step's re-admissions, the
breaker states and the final snapshots must be equal. The prober on a
sharded searcher (collective steps) is held to the reference in
``tests/test_torch_sharded_ops.py``.
"""

import numpy as np
import pytest

from raft_tpu import serve as jserve
from raft_tpu.comms import LatencyPolicy as JLatencyPolicy
from raft_tpu.comms import ShardHealth as JShardHealth
from raft_tpu.core.error import LogicError as JLogicError
from raft_tpu.testing.chaos import InjectedFault
from raft_tpu_torch import serve
from raft_tpu_torch.comms import LatencyPolicy, ShardHealth
from raft_tpu_torch.core.error import LogicError
from test_fault_tolerance import _StubProbeSearcher

_LAT = dict(alpha=0.25, window=8, quantile=0.9, multiplier=3.0,
            min_samples=4)


def _packages():
    return ((serve, ShardHealth, LatencyPolicy),
            (jserve, JShardHealth, JLatencyPolicy))


def _slow_probe(mod, Health, Lat):
    h = Health(2)
    h.mark_dead(1)
    stub = _StubProbeSearcher([0.001, 0.9, 0.001, 0.001, 0.001])
    p = mod.RecoveryProber(stub, h, np.zeros((1, 4), np.float32), 4,
                           clean_threshold=3, budget=0.1)
    out = [p.state(1)]
    for _ in range(5):
        out += [p.step(), p.state(1), h.is_live(1)]
    out += [h.state(1), p.snapshot(), stub.calls]
    p.close()
    p.close()
    return out


def _exception(mod, Health, Lat):
    h = Health(2)
    h.mark_dead(1)
    stub = _StubProbeSearcher([0.001, InjectedFault("probe lost"), 0.001,
                               0.001, 0.001])
    p = mod.RecoveryProber(stub, h, np.zeros((1, 4), np.float32), 4,
                           clean_threshold=3)
    out = []
    for _ in range(5):
        out += [p.step(), p.state(1)]
    out.append(p.snapshot())
    p.close()
    return out


def _flap(mod, Health, Lat):
    h = Health(2)
    h.mark_dead(1)
    p = mod.RecoveryProber(_StubProbeSearcher(), h,
                           np.zeros((1, 4), np.float32), 4,
                           clean_threshold=3)
    out = [p.step(), p.step(), p.state(1)]
    h.mark_live(1)
    h.mark_dead(1)
    out.append(p.state(1))
    for _ in range(3):
        out += [p.step(), h.is_live(1)]
    out.append(p.snapshot())
    p.close()
    return out


def _suspect(mod, Health, Lat):
    h = Health(2, latency=Lat(**_LAT))
    h.mark_suspect(1)
    stub = _StubProbeSearcher()
    p = mod.RecoveryProber(stub, h, np.zeros((1, 4), np.float32), 4,
                           clean_threshold=3)
    out = [p.state(1)]
    for _ in range(3):
        out += [p.step(), p.state(1)]
    out += [h.state(1), h.is_suspect(1), stub.calls, p.snapshot(), repr(p)]
    p.close()
    return out


@pytest.mark.parametrize("script", [_slow_probe, _exception, _flap,
                                    _suspect])
def test_breaker_equals_the_reference(script):
    port, ref = (script(*pkg) for pkg in _packages())
    assert port == ref


@pytest.mark.parametrize("kw,queries", [
    (dict(clean_threshold=0), np.zeros((1, 4), np.float32)),
    (dict(budget=-1.0), np.zeros((1, 4), np.float32)),
    ({}, np.zeros(4, np.float32))])
def test_validation_equals_the_reference(kw, queries):
    with pytest.raises(LogicError):
        serve.RecoveryProber(_StubProbeSearcher(), ShardHealth(2), queries,
                             4, **kw)
    with pytest.raises(JLogicError):
        jserve.RecoveryProber(_StubProbeSearcher(), JShardHealth(2),
                              queries, 4, **kw)
