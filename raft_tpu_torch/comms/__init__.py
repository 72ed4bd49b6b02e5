"""Collective communication over ``torch.distributed`` and the top-k merge
engines of sharded search.

Port of ``raft_tpu/comms``: the :class:`Comms` facade and its self-tests
(``comms_test``), the shard liveness registry (``health``) and the merge
engines with the single-host merge core (``topk_merge``).
"""

from raft_tpu_torch.comms.comms import (
    Comms,
    DatatypeT,
    Mesh,
    OpT,
    StatusT,
    build_comms,
    inject_comms_on_handle,
    make_mesh,
)
from raft_tpu_torch.comms.comms_test import (
    test_collective_allgather,
    test_collective_allgatherv,
    test_collective_allreduce,
    test_collective_allreduce_prod,
    test_collective_broadcast,
    test_collective_gather,
    test_collective_gatherv,
    test_collective_reduce,
    test_collective_reducescatter,
    test_commsplit,
    test_pointToPoint_device_multicast_sendrecv,
    test_pointToPoint_host_sendrecv,
    test_pointToPoint_simple_send_recv,
)
from raft_tpu_torch.comms.health import (
    LatencyPolicy,
    ShardHealth,
    checked_sync,
)
from raft_tpu_torch.comms.topk_merge import (
    MERGE_ENGINES,
    PIPELINED_ENGINES,
    merge_comm_bytes,
    merge_parts,
    pipeline_chunk_bounds,
    resolve_merge_engine,
    resolve_pipeline_chunks,
    topk_merge,
    topk_merge_pipelined,
)

__all__ = [
    "Comms", "DatatypeT", "Mesh", "OpT", "StatusT", "build_comms",
    "inject_comms_on_handle", "make_mesh", "LatencyPolicy", "ShardHealth",
    "checked_sync",
    "MERGE_ENGINES", "PIPELINED_ENGINES", "merge_comm_bytes",
    "merge_parts", "pipeline_chunk_bounds", "resolve_merge_engine",
    "resolve_pipeline_chunks", "topk_merge", "topk_merge_pipelined",
    "test_collective_allreduce", "test_collective_allreduce_prod",
    "test_collective_gatherv", "test_collective_allgatherv",
    "test_collective_gather", "test_collective_broadcast",
    "test_collective_reduce", "test_collective_allgather",
    "test_collective_reducescatter", "test_pointToPoint_simple_send_recv",
    "test_pointToPoint_device_multicast_sendrecv",
    "test_pointToPoint_host_sendrecv", "test_commsplit",
]
