"""``comms_t``-style collective facade over ``torch.distributed``.

Port of ``raft_tpu/comms/comms.py``. The reference binds a communicator
to a mesh axis and calls it inside one ``shard_map`` (single controller).
The port runs SPMD instead, as ``torch.distributed`` does: one process
per rank, each calling the same collective with its own operand, over a
process group.

* :class:`Mesh` (built by :func:`make_mesh`) is the port's mesh: a process
  group (the world by default), this rank's ``torch.device`` and the axis
  name, kept for messages. The device is ``cuda`` unless the caller asks
  for the CPU.
* :class:`Comms` is the communicator over a mesh. Every method is
  collective: each rank of the group calls it, in the same order.
* Where the tensors travel is set by the group's backend, never by a
  fallback: NCCL moves tensors on the mesh's card; gloo moves host tensors,
  so a CUDA operand is staged through host memory and its result moved
  back (gloo has no CUDA ``send`` / ``recv`` or ``all_gather``). 2-byte
  floats and bools travel as same-width integers, which every backend
  moves bit for bit.

The reference's contracts are kept where the SPMD form allows: rooted
collectives (``reduce``, ``gather``, ``gatherv``) return zeros off the
root, ``allgatherv`` / ``gatherv`` work on padded shards plus counts, and
``comm_split`` is a sub-communicator (``dist.new_group``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import DeviceLike, resolve_device


class DatatypeT(enum.Enum):
    """The reference's ``datatype_t``; tensors carry their dtype, and the
    enum is kept for API parity."""

    CHAR = 0
    UINT8 = 1
    INT32 = 2
    UINT32 = 3
    INT64 = 4
    UINT64 = 5
    FLOAT32 = 6
    FLOAT64 = 7


class OpT(enum.Enum):
    """The reference's ``op_t``."""

    SUM = 0
    PROD = 1
    MIN = 2
    MAX = 3


class StatusT(enum.Enum):
    """The reference's ``status_t``: the outcome of ``sync_stream``."""

    SUCCESS = 0
    ERROR = 1
    ABORT = 2


_REDUCE_OPS = {OpT.SUM: dist.ReduceOp.SUM, OpT.MIN: dist.ReduceOp.MIN,
               OpT.MAX: dist.ReduceOp.MAX}

# Dtypes that travel as a same-width integer (moved, never reduced).
_WIRE_VIEW = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
              torch.bool: torch.uint8}


@dataclass(frozen=True, eq=False)
class Mesh:
    """A process group, this rank's device and the axis name."""

    group: Optional[dist.ProcessGroup]
    device: torch.device
    axis: str = "data"

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group)).lower()

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Mesh(axis={self.axis!r}, size={self.size}, "
                f"rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


def make_mesh(group: Optional[dist.ProcessGroup] = None,
              device: DeviceLike = None, axis: str = "data") -> Mesh:
    """This rank's mesh over ``group`` (the world when None) of an
    initialised ``torch.distributed`` job. ``device`` is ``cuda`` unless
    the caller asks for the CPU; a missing card raises. A NCCL group needs
    a CUDA device."""
    expects(dist.is_available() and dist.is_initialized(),
            "make_mesh needs torch.distributed.init_process_group first")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # The card's index, as the tensors placed there report it.
        dev = torch.device("cuda", torch.cuda.current_device())
    expects(dist.get_rank(group) >= 0,
            "this process is not a member of the group")
    mesh = Mesh(group, dev, axis)
    expects(mesh.backend != "nccl" or dev.type == "cuda",
            "a NCCL group needs a CUDA device, got %s", dev)
    return mesh


class Comms:
    """A communicator over one :class:`Mesh`. Every method is collective
    over the mesh's group."""

    def __init__(self, mesh: Mesh):
        expects(isinstance(mesh, Mesh),
                "Comms needs a Mesh from make_mesh, got %s",
                type(mesh).__name__)
        self.mesh = mesh

    @property
    def group(self):
        return self.mesh.group

    # -- topology ----------------------------------------------------------
    def get_size(self) -> int:
        return self.mesh.size

    def get_rank(self) -> int:
        return self.mesh.rank

    def _global(self, rank: int) -> int:
        """The world rank of group rank ``rank`` (what p2p ops take)."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

    def comm_split(self, color: int) -> "Comms":
        """Sub-communicator over the ranks that pass the same ``color``, in
        rank order (the reference's ``comm_split``; its mesh form splits
        on a sub-axis). ``torch.distributed`` creates a process group with
        every process of the job, so the communicator split is one over
        the whole job: every process calls it, and each gets the
        communicator of its own color."""
        expects(self.get_size() == dist.get_world_size(),
                "comm_split splits a communicator over every process of "
                "the job (this one has %s of %s)", self.get_size(),
                dist.get_world_size())
        colors = self.allgather(torch.tensor([int(color)])).tolist()
        ours = None
        for c in sorted(set(colors)):
            # Every process creates every group, in the same order.
            grp = dist.new_group(ranks=[g for g, cg in enumerate(colors)
                                        if cg == c])
            if c == int(color):
                ours = grp
        return Comms(Mesh(ours, self.mesh.device, self.mesh.axis))

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def sync_stream(self, *tensors) -> StatusT:
        """Wait for this rank's device work; ERROR when that surfaces a
        failure (a raw KeyboardInterrupt propagates, as in the
        reference)."""
        try:
            if self.mesh.device.type == "cuda" or any(
                    isinstance(t, torch.Tensor) and t.is_cuda
                    for t in tensors):
                torch.cuda.synchronize(self.mesh.device)
            return StatusT.SUCCESS
        except Exception:
            return StatusT.ERROR

    def group_start(self) -> None:
        """Kept for API parity: the exchanges that must run together are
        issued as one ``batch_isend_irecv`` here."""

    def group_end(self) -> None:
        """See :meth:`group_start`."""

    # -- the wire ----------------------------------------------------------
    def _wire_device(self) -> torch.device:
        return (self.mesh.device if self.mesh.backend == "nccl"
                else torch.device("cpu"))

    def _to_wire(self, x: torch.Tensor, move_only: bool = True):
        """``x`` where the backend reads it; for a move-only collective,
        2-byte floats and bools as same-width integers."""
        x = x.contiguous()
        if move_only and x.dtype in _WIRE_VIEW:
            x = x.view(_WIRE_VIEW[x.dtype])
        return x.to(self._wire_device())

    @staticmethod
    def _from_wire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if y.dtype != like.dtype:
            y = y.view(like.dtype)
        return y.to(like.device)

    # -- collectives -------------------------------------------------------
    def allreduce(self, x: torch.Tensor, op: OpT = OpT.SUM) -> torch.Tensor:
        """The reduction of every rank's ``x``, on every rank. PROD
        multiplies the gathered values in rank order, exact in sign and
        zero, as the reference does."""
        if op == OpT.PROD:
            return torch.prod(self.allgather(x, tiled=False), dim=0)
        expects(op in _REDUCE_OPS, "unknown op %s", op)
        w = self._to_wire(x, move_only=False).clone()
        dist.all_reduce(w, op=_REDUCE_OPS[op], group=self.group)
        return self._from_wire(w, x)

    def allgather(self, x: torch.Tensor, axis: int = 0,
                  tiled: bool = True) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``axis`` in rank order
        (``tiled=False`` stacks a new axis)."""
        w = self._to_wire(x)
        bufs = [torch.empty_like(w) for _ in range(self.get_size())]
        dist.all_gather(bufs, w, group=self.group)
        parts = [self._from_wire(b, x) for b in bufs]
        return torch.cat(parts, dim=axis) if tiled else torch.stack(parts,
                                                                    dim=axis)

    def allgatherv(self, x: torch.Tensor, counts: torch.Tensor,
                   axis: int = 0):
        """Padded shards concatenated, and every rank's valid counts
        stacked: the caller masks."""
        return (self.allgather(x, axis=axis, tiled=True),
                self.allgather(counts, tiled=False))

    def _rooted(self, x: torch.Tensor, root: int) -> torch.Tensor:
        return x if self.get_rank() == root else torch.zeros_like(x)

    def reduce(self, x: torch.Tensor, root: int = 0,
               op: OpT = OpT.SUM) -> torch.Tensor:
        """The reduction on ``root``, zeros elsewhere."""
        return self._rooted(self.allreduce(x, op), root)

    def bcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """``root``'s ``x`` on every rank."""
        w = self._to_wire(x).clone()
        dist.broadcast(w, src=self._global(root), group=self.group)
        return self._from_wire(w, x)

    def reducescatter(self, x: torch.Tensor, op: OpT = OpT.SUM,
                      scatter_axis: int = 0) -> torch.Tensor:
        """This rank's slice along ``scatter_axis`` of the elementwise
        sum (the axis divides by the group size)."""
        expects(op == OpT.SUM, "reducescatter supports SUM")
        n = self.get_size()
        expects(x.shape[scatter_axis] % n == 0,
                "reducescatter axis %s does not divide by %s",
                x.shape[scatter_axis], n)
        c = x.shape[scatter_axis] // n
        return self.allreduce(x, op).narrow(scatter_axis,
                                            self.get_rank() * c, c)

    def gather(self, x: torch.Tensor, root: int = 0,
               axis: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated on ``root``, zeros elsewhere."""
        return self._rooted(self.allgather(x, axis=axis, tiled=True), root)

    def gatherv(self, x: torch.Tensor, count: torch.Tensor, root: int = 0,
                axis: int = 0):
        """Rooted variable-count gather: ``(stacked padded shards, counts)``
        on ``root``, zeros elsewhere."""
        stacked = self.allgather(x, axis=axis, tiled=False)
        counts = self.allgather(count, tiled=False)
        return self._rooted(stacked, root), self._rooted(counts, root)

    def exchange_start(self, xs, send_to: int, recv_from: int):
        """Post one batched exchange: send the tensors ``xs`` to group rank
        ``send_to`` and receive tensors of their shapes and dtypes from
        ``recv_from``. Returns ``finish()``, which waits and returns the
        received tensors on their senders' devices: what runs between the
        two overlaps the transfer."""
        r = self.get_rank()
        if send_to == r and recv_from == r:
            same = tuple(x.clone() for x in xs)
            return lambda: same
        wires = [self._to_wire(x) for x in xs]
        bufs = [torch.empty_like(w) for w in wires]
        ops = ([dist.P2POp(dist.isend, w, self._global(send_to), self.group)
                for w in wires]
               + [dist.P2POp(dist.irecv, b, self._global(recv_from),
                             self.group) for b in bufs])
        reqs = dist.batch_isend_irecv(ops)

        def finish():
            for req in reqs:
                req.wait()
            return tuple(self._from_wire(b, x) for b, x in zip(bufs, xs))

        return finish

    def exchange(self, xs, send_to: int, recv_from: int):
        """:meth:`exchange_start`, waited at once."""
        return self.exchange_start(xs, send_to, recv_from)()

    def device_sendrecv(self, x: torch.Tensor, dest: int,
                        source: int) -> torch.Tensor:
        """Paired send / receive over the edges ``i -> i + dest - source``
        (mod size): what ``x`` rank ``r - (dest - source)`` sent."""
        return self.shift(x, dest - source)

    def shift(self, x: torch.Tensor, offset: int = 1) -> torch.Tensor:
        """Ring shift by ``offset``: rank r receives rank r - offset's
        ``x``."""
        n = self.get_size()
        r = self.get_rank()
        return self.exchange((x,), (r + offset) % n, (r - offset) % n)[0]

    def device_multicast_sendrecv(self, x: torch.Tensor,
                                  axis: int = 0) -> torch.Tensor:
        """All-pairs exchange: slab j of ``x`` along ``axis`` goes to rank
        j, and slab j of the result is what rank j sent here (slabs are
        padded to one size, as in the reference)."""
        n = self.get_size()
        r = self.get_rank()
        expects(x.shape[axis] % n == 0,
                "multicast axis %s does not divide by %s", x.shape[axis], n)
        slabs = [s.contiguous() for s in torch.chunk(x, n, dim=axis)]
        wires = [self._to_wire(s) for s in slabs]
        bufs = [torch.empty_like(w) for w in wires]
        ops = []
        for j in range(n):
            if j == r:
                bufs[j] = wires[j].clone()
                continue
            ops.append(dist.P2POp(dist.isend, wires[j], self._global(j),
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, bufs[j], self._global(j),
                                  self.group))
        for req in (dist.batch_isend_irecv(ops) if ops else []):
            req.wait()
        return torch.cat([self._from_wire(b, x) for b in bufs], dim=axis)

    def host_sendrecv(self, x, dest: int, source: int, retry=None,
                      transfer_hook=None) -> np.ndarray:
        """Paired HOST-buffer send / receive. ``x`` is the same host array
        on every rank, row r = rank r's payload; returns the same layout
        with row r = what rank r received (every rank's row, gathered to
        all). ``retry`` wraps the round trip in ``core/retry.with_retry``;
        ``transfer_hook`` wraps one attempt (a test seam)."""
        from raft_tpu_torch.core.retry import with_retry

        x = np.asarray(x)
        expects(x.ndim >= 1 and x.shape[0] == self.get_size(),
                "leading axis must equal the comm size (one row per rank)")

        def transfer():
            mine = torch.as_tensor(x[self.get_rank()][None].copy())
            got = self.device_sendrecv(mine, dest, source)
            return self.allgather(got).numpy()

        op = transfer if transfer_hook is None else transfer_hook(transfer)
        if retry is None:
            return op()
        return with_retry(op, retry)


def build_comms(mesh: Mesh) -> Comms:
    """The communicator over ``mesh`` (the process group is the clique;
    ``init_process_group`` bootstrapped it)."""
    return Comms(mesh)


def inject_comms_on_handle(handle, comms: Comms) -> None:
    """Attach a communicator to a :class:`~raft_tpu_torch.core.resources.
    Resources` handle."""
    handle.set_comms(comms)
