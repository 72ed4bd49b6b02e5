"""Cluster-wide communicator session over ``torch.distributed``.

Ref: python/raft-dask/raft_dask/common/comms.py:37: ``Comms`` bootstraps a
NCCL clique (+ optional UCX endpoints) across Dask workers, stamps a
``sessionId``, and each worker later retrieves its injected handle via
``local_handle(sessionId)`` (:245).

The port runs SPMD, one process per rank, as ``raft_tpu_torch.comms``
does: every rank calls ``Comms(...).init()`` in the same order. ``init``
joins the ``torch.distributed`` job that exists, or starts one from
``coordinator_address`` / ``num_processes`` / ``process_id`` (NCCL on
``cuda``, gloo on the CPU), builds the port's mesh and communicator over
it and injects them into a ``raft_tpu_torch`` ``DeviceResources``, which
a session table keyed by ``sessionId`` holds for ``local_handle``. The
reference's ``axis=`` argument names a JAX mesh axis and has no
counterpart here.
"""

from __future__ import annotations

import uuid
from typing import Optional, Sequence

import torch.distributed as dist

from raft_tpu_torch.comms.comms import build_comms, inject_comms_on_handle, make_mesh
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import DeviceLike, DeviceResources, resolve_device
from raft_tpu_torch.core.retry import DEFAULT_COMM_RETRY, with_retry

_SESSIONS: dict = {}


def local_handle(sessionId: str):
    """The session's injected handle on this rank (ref: raft_dask
    local_handle, comms.py:245), or None when there is no such session."""
    state = _SESSIONS.get(sessionId)
    return None if state is None else state["handle"]


class Comms:
    """Communicator session over a ``torch.distributed`` job.

    Ref: raft_dask.common.Comms (comms.py:37): ``init()`` forms the clique
    and injects this rank's handle, ``destroy()`` tears it down. With
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``, ``init`` starts the job when none exists, the
    analog of the NCCL unique-id broadcast of comms.py:135-204, retried
    under ``retry_policy`` (``DEFAULT_COMM_RETRY`` when None).
    ``device`` is this rank's device, ``cuda`` unless the caller asks for
    the CPU. ``comms_p2p`` (UCX) is accepted for source compatibility:
    point-to-point runs over the same process group.
    """

    def __init__(self, comms_p2p: bool = False, verbose: bool = False,
                 coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 retry_policy=None, device: DeviceLike = None):
        self.comms_p2p = comms_p2p
        self.verbose = verbose
        self._coord = coordinator_address
        self._nprocs = num_processes
        self._pid = process_id
        self._device = device
        self.retry_policy = (DEFAULT_COMM_RETRY if retry_policy is None
                             else retry_policy)
        self.sessionId = uuid.uuid4().hex
        self.nccl_initialized = False  # name kept for API parity
        self.ucx_initialized = False
        self._started_job = False

    # -- lifecycle (ref: comms.py Comms.init/destroy) ----------------------
    def _start_job(self, device) -> None:
        """Start the ``torch.distributed`` job from the coordinator; a
        rendezvous that races the coordinator coming up raises
        RuntimeError and is retried."""
        expects(self._coord is not None and self._nprocs is not None
                and self._pid is not None,
                "no torch.distributed job to join: start one, or give "
                "coordinator_address, num_processes and process_id")
        backend = "nccl" if device.type == "cuda" else "gloo"

        def bootstrap():
            dist.init_process_group(
                backend, init_method=f"tcp://{self._coord}",
                world_size=int(self._nprocs), rank=int(self._pid))

        with_retry(bootstrap, self.retry_policy)
        self._started_job = True

    def init(self, workers: Optional[Sequence[int]] = None):
        """Form this rank's mesh and inject its handle (ref: Comms.init,
        comms.py:170). ``workers`` lists the ranks of the session (every
        rank of the job when None); every rank of the job calls ``init``
        with the same list, and a rank outside it gets no handle."""
        device = resolve_device(self._device)
        if not dist.is_initialized():
            self._start_job(device)
        group, ranks = None, list(range(dist.get_world_size()))
        if workers is not None:
            ranks = sorted(int(r) for r in workers)
            expects(len(set(ranks)) == len(ranks) and ranks[0] >= 0
                    and ranks[-1] < dist.get_world_size(),
                    "workers must be distinct ranks of the job, got %s",
                    workers)
            # Every process makes the group, members or not (gloo groups).
            group = dist.new_group(ranks=ranks)
        handle = None
        if dist.get_rank() in ranks:
            mesh = make_mesh(group, device=device)
            handle = DeviceResources(device=mesh.device)
            inject_comms_on_handle(handle, build_comms(mesh))
        _SESSIONS[self.sessionId] = {"handle": handle, "ranks": ranks}
        self.nccl_initialized = True
        if self.comms_p2p:
            self.ucx_initialized = True
        if self.verbose:
            print(f"Initialized comms session {self.sessionId} over "
                  f"{len(ranks)} ranks")
        return self

    def worker_info(self):
        """Rank/size map by the job's rank (ref: comms.py worker_info):
        one entry a rank of the session, ranks sharing a card included."""
        ranks = _SESSIONS[self.sessionId]["ranks"]
        return {r: {"rank": i, "size": len(ranks)}
                for i, r in enumerate(ranks)}

    def destroy(self):
        """Tear down the session (ref: Comms.destroy, comms.py:218); a job
        that ``init`` started ends with it."""
        _SESSIONS.pop(self.sessionId, None)
        if self._started_job and dist.is_initialized():
            dist.destroy_process_group()
        self._started_job = False
        self.nccl_initialized = False
        self.ucx_initialized = False

    def __enter__(self):
        return self.init()

    def __exit__(self, *exc):
        self.destroy()
