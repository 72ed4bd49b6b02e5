"""``raft_dask``-compatible communicator sessions over the PyTorch / CUDA
port ``raft_tpu_torch``.

Ref: python/raft-dask: the reference's second Python package, whose job is
to form a multi-process communicator clique (NCCL + optional UCX endpoints
over Dask workers, raft_dask/common/comms.py:37) and inject it into each
worker's handle. The port's clique is a ``torch.distributed`` process
group, one process a rank (NCCL on the card, gloo on the CPU). This
package mirrors ``raft_dask/`` module for module, so downstream code
switches with ``import raft_dask_torch as raft_dask``.
"""

from raft_dask_torch.common import Comms, local_handle

__all__ = ["Comms", "local_handle"]
