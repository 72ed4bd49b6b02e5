"""pylibraft-compatible API surface over the PyTorch / CUDA port
``raft_tpu_torch``.

Mirrors the module layout and entry points of the reference's
``python/pylibraft`` package (Cython over ``raft::runtime``), module for
module with ``pylibraft/``, so code written against pylibraft switches
with ``import pylibraft_torch as pylibraft``. Inputs are numpy arrays,
tensors or ``device_ndarray``s: tensors stay on their device, the rest
move to the handle's (``cuda`` unless the caller passes
``handle=DeviceResources(device="cpu")``). Outputs are ``device_ndarray``
wrappers over tensors (``set_output_as("array")`` returns the tensors).

Ref layout: python/pylibraft/pylibraft/{common,distance,neighbors,cluster,
random}.
"""

__version__ = "23.04.00+cuda"

from pylibraft_torch import cluster, common, distance, neighbors, random  # noqa: E402,F401
