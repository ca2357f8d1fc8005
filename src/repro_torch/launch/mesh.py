"""Production and test meshes, as ``torch.distributed`` ``DeviceMesh``es.

Defined as functions (never module-level constants) so importing this module
touches no process group.  Each builds a mesh over the default process
group, which the caller initialises first (``init_process_group`` with its
rank, world size and rendezvous): the mesh's size must equal the group's.
Meshes live on the card unless the caller passes ``device_type="cpu"``
(``gloo`` processes, or a one-process ``"fake"`` group for shapes only).
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16×16 single-pod (256 ranks) or 2×16×16 two-pod (512 ranks) mesh.

    Axes: ``data`` (DP / FSDP), ``model`` (TP / EP); multi-pod prepends
    ``pod`` (hierarchical DP by default, reassignable to pipeline stages).
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(n_data: int = 2, n_model: int = 2, pods: int = 0,
                   device_type: str = "cuda") -> DeviceMesh:
    """Small mesh for CI-scale distribution tests."""
    if pods:
        return init_device_mesh(device_type, (pods, n_data, n_model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))
