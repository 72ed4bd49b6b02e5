from raft_dask_torch.common.comms import Comms, local_handle
from raft_dask_torch.common.comms_utils import (
    inject_comms_on_handle,
    inject_comms_on_handle_coll_only,
    perform_test_comms_allreduce,
    perform_test_comms_allgather,
    perform_test_comms_bcast,
    perform_test_comms_reduce,
    perform_test_comms_reducescatter,
    perform_test_comms_send_recv,
    perform_test_comm_split,
)

__all__ = [
    "Comms",
    "local_handle",
    "inject_comms_on_handle",
    "inject_comms_on_handle_coll_only",
    "perform_test_comms_allreduce",
    "perform_test_comms_allgather",
    "perform_test_comms_bcast",
    "perform_test_comms_reduce",
    "perform_test_comms_reducescatter",
    "perform_test_comms_send_recv",
    "perform_test_comm_split",
]
