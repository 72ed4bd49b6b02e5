"""Parity of raft_tpu_torch.comms (the collectives facade, its self-tests
and the shard health registry) with raft_tpu.comms.

The port's collectives run in a gloo world of 4 CPU ranks (one world for
the file, ``test_torch_world.World``); the reference's self-tests run on
``tests/conftest.py``'s 8-device CPU mesh at the same sizes. ``ShardHealth``
and ``checked_sync`` are host state machines: both packages' registries
take the same scripted statuses and latencies and must agree at every
step, listener events included.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

import raft_tpu.comms as jcomms
import raft_tpu.comms.comms_test as jct
import raft_tpu_torch.comms as tcomms
from raft_tpu_torch.core.error import LogicError
from test_torch_world import (World, case_comm_split, case_comm_split_part,
                              case_comms_bf16_shift, case_comms_test,
                              case_host_sendrecv_retry)

_FAMILY = ["test_collective_allreduce", "test_collective_allreduce_prod",
           "test_collective_gatherv", "test_collective_allgatherv",
           "test_collective_gather", "test_collective_broadcast",
           "test_collective_reduce", "test_collective_allgather",
           "test_collective_reducescatter",
           "test_pointToPoint_simple_send_recv",
           "test_pointToPoint_device_multicast_sendrecv",
           "test_pointToPoint_host_sendrecv"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("comms_world"))
    yield w
    w.close()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", _FAMILY)
def test_comms_self_test_passes_in_both_packages(world, n, name):
    mesh = JMesh(np.array(jax.devices()[:n]), ("data",))
    assert getattr(jct, name)(mesh)
    assert world.run(case_comms_test, n, name)[:n] == [True] * n


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("root", [0, 1])
@pytest.mark.parametrize("name", ["test_collective_gatherv",
                                  "test_collective_gather",
                                  "test_collective_broadcast",
                                  "test_collective_reduce"])
def test_rooted_self_tests_at_another_root(world, n, root, name):
    mesh = JMesh(np.array(jax.devices()[:n]), ("data",))
    assert getattr(jct, name)(mesh, root=root)
    assert world.run(case_comms_test, n, name, root)[:n] == [True] * n


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """A world of 2: ``comm_split`` splits a communicator over the whole
    job, so its 2-rank case needs a job of 2."""
    w = World(2, tmp_path_factory.mktemp("comms_world2"))
    yield w
    w.close()


@pytest.mark.parametrize("n", [2, 4])
def test_commsplit(world, world2, n):
    """The reference splits a (n / 2) x 2 mesh on its column axis; the
    port splits its ranks by row, two columns each."""
    devs = np.array(jax.devices()[:n]).reshape(n // 2, 2)
    assert jct.test_commsplit(JMesh(devs, ("rows", "cols")))
    w = world if n == 4 else world2
    assert w.run(case_comms_test, n, "test_commsplit", 2) == [True] * n


def test_comm_split_by_parity(world):
    out = world.run(case_comm_split, 4)
    assert [o[0] for o in out] == [0, 0, 1, 1]
    np.testing.assert_array_equal(out[0][1], [0, 2])
    np.testing.assert_array_equal(out[1][1], [1, 3])
    assert {o[2] for o in out} == {"SUCCESS"}


def test_comm_split_of_a_part_of_the_job_raises(world):
    out = world.run(case_comm_split_part, 2)
    assert all("every process of the job" in m for m in out[:2])
    assert out[2:] == [None, None]


def test_two_byte_floats_and_bools_travel_bit_for_bit(world):
    out = world.run(case_comms_bf16_shift, 4)
    for r in range(4):
        src = (r - 1) % 4
        x = (np.arange(6, dtype=np.float32) / 7 + src)
        want = np.asarray(jax.numpy.asarray(x).astype(jax.numpy.bfloat16))
        np.testing.assert_array_equal(out[r][0], want.view(np.int16))
        np.testing.assert_array_equal(out[r][1], [src % 2 == 0, True])
        assert int(out[r][2][0]) == 2 ** 40 + src


@pytest.mark.parametrize("failures", [0, 2])
def test_host_sendrecv_retries_a_transient_failure(world, failures):
    out = world.run(case_host_sendrecv_retry, 4, failures)
    payload = np.arange(8, dtype=np.float32).reshape(4, 2)
    for rows, attempts in out:
        np.testing.assert_array_equal(rows, payload[(np.arange(4) - 1) % 4])
        assert attempts == failures + 1


def test_make_mesh_needs_a_process_group():
    with pytest.raises(LogicError, match="init_process_group"):
        tcomms.make_mesh(device="cpu")
    with pytest.raises(LogicError, match="Mesh from make_mesh"):
        tcomms.Comms(object())


def test_enums_match_the_reference():
    for ours, theirs in ((tcomms.DatatypeT, jcomms.DatatypeT),
                         (tcomms.OpT, jcomms.OpT),
                         (tcomms.StatusT, jcomms.StatusT)):
        assert [(m.name, m.value) for m in ours] == \
            [(m.name, m.value) for m in theirs]


def test_inject_comms_on_handle():
    from raft_tpu_torch.core.resources import Resources

    h = Resources("cpu")
    assert not h.comms_initialized()
    with pytest.raises(LogicError):
        h.get_comms()
    sentinel = object()
    tcomms.inject_comms_on_handle(h, sentinel)
    assert h.get_comms() is sentinel


# ---------------------------------------------------------------------------
# ShardHealth / checked_sync against the reference's state machine.


def _script(pkg, health):
    """Drive one registry through a fixed script; every return value,
    view and listener event, in order."""
    S = pkg.StatusT
    log = []
    health.add_listener(lambda r, live: log.append(("bin", r, live)))
    health.add_state_listener(lambda r, st: log.append(("state", r, st)))
    unwatch = health.watch(3, on_dead=lambda: log.append("w-dead"),
                           on_live=lambda: log.append("w-live"),
                           on_suspect=lambda: log.append("w-suspect"))
    steps = ([("rec", 0, S.ERROR), ("rec", 0, S.SUCCESS),
              ("rec", 0, S.ERROR), ("rec", 0, S.ABORT),
              ("rec", 1, S.ABORT), ("rec", 1, S.ABORT),
              ("rec", 1, S.SUCCESS), ("live", 1), ("rec", 1, S.ERROR)]
             + [("lat", r, 0.01 * (1 + r % 2)) for r in (0, 2, 3) * 8]
             + [("lat", 3, 0.5)] * 9
             + [("lat", 2, 0.011)] * 3
             + [("suspect", 2), ("suspect", 2), ("dead", 2),
                ("suspect", 2), ("live", 3), ("lat", 3, 0.01),
                ("dead", 3), ("live", 3), ("live", 2)])
    for step in steps:
        if step[0] == "rec":
            log.append(health.record(step[1], step[2]))
        elif step[0] == "lat":
            log.append(health.observe_latency(step[1], step[2]))
        elif step[0] == "live":
            health.mark_live(step[1])
        elif step[0] == "dead":
            health.mark_dead(step[1])
        else:
            health.mark_suspect(step[1])
        log.append((health.live_mask.tolist(), health.suspect_mask.tolist(),
                    [health.state(r) for r in range(health.n_ranks)],
                    health.n_live(), health.n_suspect(), health.coverage(),
                    health.all_live(),
                    [round(health.latency_ewma(r), 12)
                     if not np.isnan(health.latency_ewma(r)) else None
                     for r in range(health.n_ranks)]))
    unwatch()
    unwatch()
    health.mark_dead(3)
    log.append(repr(health))
    return log


@pytest.mark.parametrize("threshold", [1, 2])
@pytest.mark.parametrize("latency", [None, dict(min_samples=4),
                                     dict(multiplier=2.0, quantile=0.5,
                                          window=4, floor=0.02)])
def test_shard_health_follows_the_reference(threshold, latency):
    ours = tcomms.ShardHealth(
        4, failure_threshold=threshold,
        latency=None if latency is None else tcomms.LatencyPolicy(**latency))
    theirs = jcomms.ShardHealth(
        4, failure_threshold=threshold,
        latency=None if latency is None else jcomms.LatencyPolicy(**latency))
    assert _script(tcomms, ours) == _script(jcomms, theirs)


@pytest.mark.parametrize("kw", [dict(alpha=0.0), dict(window=0),
                                dict(quantile=1.5), dict(multiplier=1.0),
                                dict(min_samples=0), dict(floor=-1.0)])
def test_latency_policy_rejects_what_the_reference_rejects(kw):
    with pytest.raises(LogicError):
        tcomms.LatencyPolicy(**kw)
    with pytest.raises(Exception):
        jcomms.LatencyPolicy(**kw)


def test_shard_health_rejects_bad_ranks():
    h = tcomms.ShardHealth(2)
    for bad in (lambda: h.record(2, tcomms.StatusT.ERROR),
                lambda: h.observe_latency(0, -1.0),
                lambda: h.watch(0), lambda: tcomms.ShardHealth(0),
                lambda: tcomms.ShardHealth(2, failure_threshold=0)):
        with pytest.raises(LogicError):
            bad()


class _ScriptedComms:
    """A comms stand-in whose sync_stream replays scripted statuses."""

    def __init__(self, statuses):
        self.statuses = list(statuses)

    def sync_stream(self, *arrays):
        return self.statuses.pop(0)


def test_checked_sync_feeds_health_as_the_reference():
    for pkg in (tcomms, jcomms):
        S = pkg.StatusT
        script = [S.SUCCESS, S.ERROR, S.ABORT, S.SUCCESS, S.ERROR]
        h = pkg.ShardHealth(2, failure_threshold=2)
        c = _ScriptedComms(script)
        got = [pkg.checked_sync(c, h, 1, None).name for _ in script]
        assert got == [s.name for s in script]
        assert h.live_mask.tolist() == [True, False]
        assert pkg.checked_sync(_ScriptedComms([S.ERROR]), None, 0) \
            == S.ERROR
