"""Handle-injection shims and collective self-test drivers.

Ref: python/raft-dask/raft_dask/common/comms_utils.pyx:
``inject_comms_on_handle``:288 / ``inject_comms_on_handle_coll_only``:258
attach a bootstrapped communicator to a worker handle, and the
``perform_test_comms_*`` wrappers drive the C++ self-tests in
``raft::comms`` (comms/comms_test.hpp; exercised from
raft_dask/test/test_comms.py:26-160). Here the self-tests run the
:mod:`raft_tpu_torch.comms.comms_test` suite over the handle's mesh. Each
is collective: every rank of the session calls it, and it returns
whether this rank saw the expected result.
"""

from __future__ import annotations

from raft_tpu_torch.comms import comms_test as _ct


def inject_comms_on_handle(handle, comms, *args) -> None:
    """Ref: comms_utils.pyx:288 (the NCCL + UCX variant; point-to-point
    runs over the same process group)."""
    handle.set_comms(comms)


def inject_comms_on_handle_coll_only(handle, comms, *args) -> None:
    """Ref: comms_utils.pyx:258 (collectives-only variant)."""
    handle.set_comms(comms)


def _mesh(handle):
    return handle.get_comms().mesh


def perform_test_comms_allreduce(handle) -> bool:
    """Ref: comms_utils.pyx perform_test_comms_allreduce ->
    test_collective_allreduce."""
    return _ct.test_collective_allreduce(_mesh(handle))


def perform_test_comms_allgather(handle) -> bool:
    return _ct.test_collective_allgather(_mesh(handle))


def perform_test_comms_bcast(handle, root: int = 0) -> bool:
    return _ct.test_collective_broadcast(_mesh(handle), root=root)


def perform_test_comms_reduce(handle, root: int = 0) -> bool:
    return _ct.test_collective_reduce(_mesh(handle), root=root)


def perform_test_comms_reducescatter(handle) -> bool:
    return _ct.test_collective_reducescatter(_mesh(handle))


def perform_test_comms_send_recv(handle) -> bool:
    return _ct.test_pointToPoint_simple_send_recv(_mesh(handle))


def perform_test_comm_split(handle) -> bool:
    """Ref: comms_utils.pyx perform_test_comm_split. The ranks form a
    (rows, cols) grid, two rows when their count is even, and each row
    splits off as a sub-communicator, as ``raft_dask.common`` splits the
    columns of its 2-D mesh. The split spans every process of the job."""
    mesh = _mesh(handle)
    rows = 2 if mesh.size % 2 == 0 else 1
    return _ct.test_commsplit(mesh, n_cols=mesh.size // rows)
