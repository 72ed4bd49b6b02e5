"""Parity of raft_tpu_torch.testing.chaos (the port's own fault-injection
harness) with raft_tpu.testing.chaos.

Each script of ``tests/test_fault_tolerance.py::TestChaosMonkey`` (and one
for each typed I/O seam, the rank hook, ``delay``, ``clear`` and
``reset``) runs through both harnesses on the same seed; the call counts,
the raised exception types and messages, the corrupted bytes and the
health registries' states must be equal. The port's ``wrap_write`` tears
a write through the port's own ``util/atomic_io.FileIO`` seam.
"""

import os

import numpy as np
import pytest

from raft_tpu.comms.health import ShardHealth as JShardHealth
from raft_tpu.core.error import RaftError as JRaftError
from raft_tpu.testing import chaos as jchaos
from raft_tpu.util import atomic_io as jatomic
from raft_tpu_torch.comms.health import ShardHealth
from raft_tpu_torch.core.error import LogicError, RaftError
from raft_tpu_torch.testing import chaos
from raft_tpu_torch.util import atomic_io

SIDES = {"port": (chaos, ShardHealth, atomic_io),
         "ref": (jchaos, JShardHealth, jatomic)}


def _outcome(fn):
    """('ok', value) or (exception type name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:          # noqa: BLE001 - the outcome is the data
        return (type(e).__name__, str(e))


def _both(script, tmp_path=None):
    """Run ``script(mod, health_cls, atomic_io, dir)`` through each side;
    returns the two traces."""
    out = {}
    for side, (mod, health_cls, aio) in SIDES.items():
        d = None
        if tmp_path is not None:
            d = str(tmp_path / side)
            os.makedirs(d)
        out[side] = script(mod, health_cls, aio, d)
    return out["port"], out["ref"]


def _same(a, b):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _same(a[k], b[k])
    else:
        assert a == b, (a, b)


# ---------------------------------------------------------------------------
# The reference suite's TestChaosMonkey scripts


def s_corruption_seeds(mod, health_cls, aio, d):
    payload = np.arange(32, dtype=np.float32).reshape(4, 8)
    a = mod.ChaosMonkey(seed=7).corrupt(payload)
    b = mod.ChaosMonkey(seed=7).corrupt(payload)
    c = mod.ChaosMonkey(seed=8).corrupt(payload)
    return [a, b, c, payload]


def s_corrupt_fault_kind(mod, health_cls, aio, d):
    m = mod.ChaosMonkey(seed=3)
    op = m.wrap("load", lambda: np.ones(16, np.float32),
                faults=[mod.FaultSpec(kind="corrupt", at=(1,))])
    return [op(), op(), op(), m.calls("load")]


def s_int_corruption(mod, health_cls, aio, d):
    ids = np.arange(64, dtype=np.int32)
    top = np.array([0] * 63 + [np.iinfo(np.int32).max], np.int32)
    m = mod.ChaosMonkey(seed=1)
    return [m.corrupt(ids), m.corrupt(top), m.corrupt(np.zeros(0)),
            m.corrupt(np.array(["a", "b"]))]


def s_pytree_corruption(mod, health_cls, aio, d):
    rng = np.random.default_rng(4)
    tree = (rng.normal(size=(3, 5)).astype(np.float32),
            [np.arange(9, dtype=np.int64)],
            {"x": rng.normal(size=7)})
    out = mod.ChaosMonkey(seed=11).corrupt(tree)
    return [out[0], out[1][0], out[2]["x"]]


def s_drop_rank(mod, health_cls, aio, d):
    health = health_cls(4)
    m = mod.ChaosMonkey(seed=0, health=health)
    op = m.wrap("step", lambda: "ok",
                faults=[mod.FaultSpec(kind="drop_rank", at=(2,), rank=1)])
    trace = [op(), op(), bool(health.all_live()), op()]
    return trace + [health.live_mask, health.n_live(),
                    _outcome(lambda: mod.ChaosMonkey().wrap(
                        "x", lambda: 1, faults=[mod.FaultSpec(
                            kind="drop_rank", rank=0)])())]


def s_replay_after_reset(mod, health_cls, aio, d):
    m = mod.ChaosMonkey(seed=0)
    op = m.wrap("op", lambda: "ok",
                faults=[mod.FaultSpec(kind="raise", at=(0,))])
    trace = [_outcome(op), _outcome(op)]
    m.reset("op")
    trace += [_outcome(op), m.calls("op")]
    m.reset()
    return trace + [m.calls("op"), _outcome(op)]


def s_fire_site(mod, health_cls, aio, d):
    m = mod.ChaosMonkey(seed=0)
    m.script("io", [mod.FaultSpec(kind="raise", at=(1,))])
    trace = [_outcome(lambda: m.fire("io")) for _ in range(3)]
    hook = m.hook("io")
    return trace + [_outcome(hook), m.calls("io"), m.calls("never")]


def s_error_factory(mod, health_cls, aio, d):
    m = mod.ChaosMonkey(seed=0)
    op = m.wrap("net", lambda: 5, faults=[mod.FaultSpec(
        kind="raise", at=(0, 2), error=lambda: TimeoutError("slow"))])
    return [_outcome(op) for _ in range(4)]


def s_fault_spec_validation(mod, health_cls, aio, d):
    bad = [dict(kind="melt"), dict(kind="drop_rank"),
           dict(kind="torn_write"), dict(kind="delay"),
           dict(kind="delay", seconds=-1.0)]
    out = [_outcome(lambda kw=kw: mod.FaultSpec(**kw)) for kw in bad]
    m = mod.ChaosMonkey()
    op = m.wrap("gen", lambda: 1, faults=[mod.FaultSpec(
        kind="torn_write", offset=3)])
    return out + [_outcome(op)]


def s_delay_and_clear(mod, health_cls, aio, d):
    slept = []
    m = mod.ChaosMonkey(seed=0, sleep=slept.append)
    op = m.wrap("slow", lambda: "done", faults=[mod.FaultSpec(
        kind="delay", at=None, seconds=0.25)])
    trace = [op(), op()]
    m.clear("slow")
    trace += [op(), m.calls("slow"), list(slept)]
    nosleep = mod.ChaosMonkey()
    op2 = nosleep.wrap("s", lambda: 1, faults=[mod.FaultSpec(
        kind="delay", seconds=1.0)])
    return trace + [_outcome(op2)]


def s_rank_hook(mod, health_cls, aio, d):
    slept = []
    health = health_cls(4)
    m = mod.ChaosMonkey(seed=0, health=health, sleep=slept.append)
    m.script("dispatch", [
        mod.FaultSpec(kind="delay", at=(0, 1, 2), rank=2, seconds=0.5),
        mod.FaultSpec(kind="drop_rank", at=(3,), rank=3),
        mod.FaultSpec(kind="raise", at=(4,))])
    hook = m.rank_hook("dispatch")
    trace = [hook([0, 1]), hook(np.array([2, 3])), hook([[2]]),
             hook([0]), _outcome(lambda: hook([1])), hook([2])]
    return trace + [list(slept), health.live_mask]


def s_wrap_write_torn(mod, health_cls, aio, d):
    m = mod.ChaosMonkey(seed=0)
    write = m.wrap_write("disk", faults=[
        mod.FaultSpec(kind="torn_write", at=(1,), offset=5),
        mod.FaultSpec(kind="raise", at=(2,)),
        mod.FaultSpec(kind="torn_write", at=(3,), offset=99)])
    io = aio.FileIO(write_bytes=write)
    out = []
    for i in range(4):
        path = os.path.join(d, f"f{i}")
        out.append(_outcome(lambda p=path, i=i: aio.atomic_write_bytes(
            p, bytes(range(10 + i)), io, fsync=False)))
    files = {n: open(os.path.join(d, n), "rb").read()
             for n in sorted(os.listdir(d))}
    return out + [files, m.calls("disk")]


def s_wrap_rename(mod, health_cls, aio, d):
    m = mod.ChaosMonkey(seed=0)
    rename = m.wrap_rename("publish", faults=[
        mod.FaultSpec(kind="partial_rename", at=(1,)),
        mod.FaultSpec(kind="raise", at=(2,), error=lambda: OSError(
            "rename refused"))])
    io = aio.FileIO(replace=rename)
    out = []
    for i in range(3):
        out.append(_outcome(lambda i=i: aio.atomic_savez(
            os.path.join(d, f"s{i}.npz"), io, fsync=False,
            a=np.arange(i + 1))))
    left = sorted(os.listdir(d))
    # The messages name the paths, which differ between the two sides.
    return [(o[0], o[1] if o[0] == "ok" else o[1].replace(d, "<d>"))
            for o in out] + [left, m.calls("publish")]


SCRIPTS = [s_corruption_seeds, s_corrupt_fault_kind, s_int_corruption,
           s_pytree_corruption, s_drop_rank, s_replay_after_reset,
           s_fire_site, s_error_factory, s_fault_spec_validation,
           s_delay_and_clear, s_rank_hook]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__[2:])
def test_script_equals_reference(script):
    port, ref = _both(script)
    _same(port, ref)


@pytest.mark.parametrize("script", [s_wrap_write_torn, s_wrap_rename],
                         ids=lambda f: f.__name__[2:])
def test_io_seam_script_equals_reference(script, tmp_path):
    port, ref = _both(script, tmp_path)
    _same(port, ref)


def test_corruption_facts():
    """The reference suite's assertions, on the port alone."""
    payload = np.arange(32, dtype=np.float32).reshape(4, 8)
    a, b, c, p = s_corruption_seeds(chaos, ShardHealth, atomic_io, None)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, payload)
    np.testing.assert_array_equal(p, payload)      # corrupt copies
    ids, top, empty, strs = s_int_corruption(chaos, ShardHealth, atomic_io,
                                             None)
    assert ids.dtype == np.int32 and top.dtype == np.int32
    assert not np.array_equal(top, np.array([0] * 63 + [2 ** 31 - 1]))


def test_injected_fault_is_an_oserror_and_raft_error():
    assert issubclass(chaos.InjectedFault, OSError)
    assert issubclass(chaos.InjectedFault, RaftError)
    assert not issubclass(chaos.InjectedFault, JRaftError)
    with pytest.raises(LogicError, match="unknown fault kind"):
        chaos.FaultSpec(kind="melt")


def test_torn_write_leaves_a_prefix_on_the_port_seam(tmp_path):
    """A torn write through the port's FileIO leaves ``.tmp`` holding a
    true prefix and the final name absent (the rename never ran)."""
    m = chaos.ChaosMonkey()
    io = atomic_io.FileIO(write_bytes=m.wrap_write("w", faults=[
        chaos.FaultSpec(kind="torn_write", offset=3)]))
    path = str(tmp_path / "x.bin")
    with pytest.raises(chaos.InjectedFault, match="3/8 bytes"):
        atomic_io.atomic_write_bytes(path, b"abcdefgh", io)
    assert not os.path.exists(path)
    assert open(path + ".tmp", "rb").read() == b"abc"
