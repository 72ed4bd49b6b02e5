"""Built-in collective self-tests.

Port of ``raft_tpu/comms/comms_test.py`` (the reference's
``comms_test.hpp`` family). Each function is collective: every rank of the
mesh calls it, and it returns whether THIS rank saw the expected result.
Over a gloo world on the CPU, an NCCL world on the card, or a gloo world
of CUDA ranks (staged through host memory), the same functions check the
semantics of :class:`~raft_tpu_torch.comms.comms.Comms`.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.comms.comms import Comms, Mesh, OpT


def _check(out: torch.Tensor, expect, atol: float = 1e-6) -> bool:
    return bool(np.allclose(out.detach().cpu().numpy(), np.asarray(expect),
                            atol=atol))


def _f32(mesh: Mesh, values) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32),
                           device=mesh.device)


def test_collective_allreduce(mesh: Mesh) -> bool:
    """Each rank contributes 1; the result is the world size."""
    comms = Comms(mesh)
    out = comms.allreduce(_f32(mesh, [1.0]))
    return _check(out, [comms.get_size()])


def test_collective_allreduce_prod(mesh: Mesh) -> bool:
    """PROD with negatives and a zero lane: rank r contributes
    [-(r + 2), r == 0 ? 0 : 1], so lane 0 is (-1)^n (n + 1)! and lane 1
    is 0."""
    comms = Comms(mesh)
    n, r = comms.get_size(), comms.get_rank()
    out = comms.allreduce(_f32(mesh, [-(r + 2.0), 0.0 if r == 0 else 1.0]),
                          op=OpT.PROD)
    expect0 = ((-1.0) ** n) * np.prod(np.arange(2, n + 2, dtype=np.float64))
    return _check(out, [expect0, 0.0], atol=1e-3)


def test_collective_gatherv(mesh: Mesh, root: int = 0) -> bool:
    """Rooted variable-count gather: rank r sends r + 1 valid values
    (padded to the group size); root sees every shard with its count,
    the other ranks zeros."""
    comms = Comms(mesh)
    n, r = comms.get_size(), comms.get_rank()
    mine = _f32(mesh, np.where(np.arange(n) < r + 1, r + 10.0, 0.0))
    shards, counts = comms.gatherv(
        mine, torch.tensor([r + 1], device=mesh.device), root=root)
    shards_exp = np.zeros((n, n), np.float32)
    counts_exp = np.zeros((n, 1), np.int64)
    if r == root:
        for src in range(n):
            shards_exp[src, :src + 1] = src + 10.0
            counts_exp[src] = src + 1
    return _check(shards, shards_exp) and _check(counts, counts_exp)


def test_collective_allgatherv(mesh: Mesh) -> bool:
    """Padded variable-count allgather: every rank sees every shard and
    its valid count."""
    comms = Comms(mesh)
    n, r = comms.get_size(), comms.get_rank()
    mine = _f32(mesh, np.where(np.arange(n) < r + 1, r + 10.0, 0.0))
    shards, counts = comms.allgatherv(
        mine, torch.tensor([r + 1], device=mesh.device))
    shards_exp = np.zeros((n, n), np.float32)
    for src in range(n):
        shards_exp[src, :src + 1] = src + 10.0
    return (_check(shards, shards_exp.reshape(-1))
            and _check(counts, np.arange(1, n + 1)[:, None]))


def test_collective_gather(mesh: Mesh, root: int = 0) -> bool:
    """Rooted gather: root sees every rank's value in rank order, the
    other ranks zeros."""
    comms = Comms(mesh)
    n, r = comms.get_size(), comms.get_rank()
    out = comms.gather(_f32(mesh, [r + 5.0]), root=root)
    expect = (np.arange(n, dtype=np.float32) + 5.0 if r == root
              else np.zeros(n, np.float32))
    return _check(out, expect)


def test_collective_broadcast(mesh: Mesh, root: int = 0) -> bool:
    """Root's value lands on every rank."""
    comms = Comms(mesh)
    mine = _f32(mesh, [7.0 if comms.get_rank() == root else 0.0])
    return _check(comms.bcast(mine, root=root), [7.0])


def test_collective_reduce(mesh: Mesh, root: int = 0) -> bool:
    """Only root holds the sum."""
    comms = Comms(mesh)
    out = comms.reduce(_f32(mesh, [1.0]), root=root)
    return _check(out, [comms.get_size() if comms.get_rank() == root
                        else 0.0])


def test_collective_allgather(mesh: Mesh) -> bool:
    """Every rank sees [0, n)."""
    comms = Comms(mesh)
    out = comms.allgather(_f32(mesh, [comms.get_rank()]))
    return _check(out, np.arange(comms.get_size()))


def test_collective_reducescatter(mesh: Mesh) -> bool:
    """Each rank gets its slice of the elementwise sum."""
    comms = Comms(mesh)
    n = comms.get_size()
    out = comms.reducescatter(_f32(mesh, np.ones(n)))
    return out.shape == (1,) and _check(out, [n])


def test_pointToPoint_simple_send_recv(mesh: Mesh) -> bool:
    """Ring exchange: rank r sends its id to r + 1."""
    comms = Comms(mesh)
    n, r = comms.get_size(), comms.get_rank()
    return _check(comms.shift(_f32(mesh, [r]), 1), [(r - 1) % n])


def test_pointToPoint_device_multicast_sendrecv(mesh: Mesh) -> bool:
    """All-pairs multicast: rank r sends payload r n + j to rank j, so
    rank r ends with column r of the payload matrix."""
    comms = Comms(mesh)
    n, r = comms.get_size(), comms.get_rank()
    mine = _f32(mesh, r * n + np.arange(n))[:, None]
    out = comms.device_multicast_sendrecv(mine, axis=0)
    return _check(out, (np.arange(n) * n + r)[:, None])


def test_pointToPoint_host_sendrecv(mesh: Mesh) -> bool:
    """Host-buffer paired send / receive: each rank's host row goes one
    step round the ring, and every rank sees the permuted rows."""
    comms = Comms(mesh)
    n = comms.get_size()
    payload = np.arange(n, dtype=np.float32)[:, None] * 10.0
    out = comms.host_sendrecv(payload, dest=1, source=0)
    return bool(np.allclose(out, payload[(np.arange(n) - 1) % n]))


def test_commsplit(mesh: Mesh, n_cols: int = 2) -> bool:
    """Sub-communicator over one row of an (n / n_cols) x n_cols grid of
    ranks: an allreduce there counts only that row's n_cols ranks. The
    mesh spans the job (``Comms.comm_split``)."""
    comms = Comms(mesh)
    sub = comms.comm_split(comms.get_rank() // n_cols)
    out = sub.allreduce(_f32(mesh, [[1.0]]))
    return sub.get_size() == n_cols and _check(out, [[n_cols]])
