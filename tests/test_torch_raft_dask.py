"""Parity of raft_dask_torch (the session layer over the port) with
raft_dask.

Mirrors tests/test_raft_dask.py case by case. The reference's session
runs over ``tests/conftest.py``'s 8-device CPU mesh; the port's runs SPMD
in a gloo world of 4 CPU ranks (``test_torch_world.World``), where every
rank calls ``Comms(device="cpu").init()``. The self-tests return booleans,
so both packages must answer ``True``. A two-process job that ``Comms``
starts itself from ``coordinator_address`` covers the bootstrap.
"""

import multiprocessing as mp
import queue
import socket

import pytest
import torch
import torch.distributed as dist

import raft_dask
import raft_dask.common as rd
import raft_dask_torch
import raft_dask_torch.common as rdt
from raft_tpu_torch.core.error import CudaError, LogicError
from test_torch_world import (_DASK_SELF_TESTS, World, bootstrap_rank,
                              case_dask_session)

N_RANKS = 4
BOOTSTRAP_TIMEOUT = 90.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(N_RANKS, tmp_path_factory.mktemp("dask_world"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def sessions(world):
    """Each rank's view of one session over the whole world."""
    return world.run(case_dask_session)


@pytest.fixture
def ref_session():
    c = rd.Comms()
    c.init()
    yield c
    c.destroy()


def test_surface_matches_the_reference():
    assert raft_dask_torch.__all__ == raft_dask.__all__
    assert rdt.__all__ == rd.__all__


def test_init_and_lookup(ref_session, sessions):
    ref_info = ref_session.worker_info()
    assert len(ref_info) == 8
    assert local_handle_has_comms(ref_session)
    for has_comms, info, _, _, _, device in sessions:
        assert has_comms and device == "cpu"
        assert len(info) == N_RANKS
        assert sorted(v["rank"] for v in info.values()) == list(
            range(N_RANKS))
        assert {v["size"] for v in info.values()} == {N_RANKS}
    # Every rank sees the same map.
    assert all(s[1] == sessions[0][1] for s in sessions)


def local_handle_has_comms(session) -> bool:
    handle = rd.local_handle(session.sessionId)
    return handle is not None and handle.get_comms() is not None


@pytest.mark.parametrize("name", _DASK_SELF_TESTS)
def test_collectives(ref_session, sessions, name):
    assert getattr(rd, name)(rd.local_handle(ref_session.sessionId))
    assert [s[2][name] for s in sessions] == [True] * N_RANKS


def test_destroy_clears_session(sessions):
    c = rd.Comms().init()
    sid = c.sessionId
    assert rd.local_handle(sid) is not None
    c.destroy()
    assert rd.local_handle(sid) is None
    assert not c.nccl_initialized
    for s in sessions:
        assert s[3] and not s[4]


def test_session_over_part_of_the_world(world):
    """``workers`` lists ranks: every rank makes the group, the members
    get handles and pass the self-tests, the others get none."""
    got = world.run(case_dask_session, [1, 3])
    for rank, (has_comms, info, outcomes, cleared, _, _) in enumerate(got):
        assert info == {1: {"rank": 0, "size": 2}, 3: {"rank": 1, "size": 2}}
        assert cleared
        member = rank in (1, 3)
        assert has_comms == member
        assert all(v is (True if member else None)
                   for v in outcomes.values()), outcomes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_bootstrap_from_the_coordinator():
    """Two processes start their job through ``coordinator_address`` on
    gloo; the seven self-tests pass and ``destroy`` ends the job."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = f"localhost:{_free_port()}"
    procs = [ctx.Process(target=bootstrap_rank, args=(r, 2, address, results),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(2):
            rank, ok, val = results.get(timeout=BOOTSTRAP_TIMEOUT)
            assert ok, val
            got[rank] = val
    except queue.Empty:
        pytest.fail(f"the bootstrap did not answer in {BOOTSTRAP_TIMEOUT} s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
    for rank in range(2):
        out = got[rank]
        assert all(out[name] is True for name in _DASK_SELF_TESTS), out
        assert out["size"] == 2 and out["backend"] == "gloo"
        assert out["ended"]


def test_no_job_and_no_coordinator_raises():
    assert not dist.is_initialized()
    with pytest.raises(LogicError, match="coordinator_address"):
        rdt.Comms(device="cpu").init()


def test_init_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: nothing to refuse")
    with pytest.raises(CudaError):
        rdt.Comms().init()
    with pytest.raises(CudaError):
        rdt.Comms(coordinator_address=f"localhost:{_free_port()}",
                  num_processes=1, process_id=0).init()
    assert not dist.is_initialized()
