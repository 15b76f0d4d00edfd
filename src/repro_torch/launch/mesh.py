"""Production mesh factory: the reference's ``launch/mesh.py`` as a
``torch.distributed`` ``DeviceMesh``.

Functions, not module constants, so that importing this module touches no
process group.  Single pod: ``(16, 16)`` over ``("data", "model")`` = 256
ranks; multi-pod adds a leading ``"pod"`` axis, ``(2, 16, 16)`` = 512
ranks.  A mesh needs the default process group first (one rank a card:
``torch.distributed.init_process_group`` with its address, world size and
rank; the dry run uses a fake group, ``launch/dryrun.py``).  The device type
is the card's unless the caller asks for the CPU (``device="cpu"``: gloo
ranks in the tests, the dry run's fake ranks).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type(device) -> str:
    return "cuda" if device is None else torch.device(device).type


def _mesh(shape: tuple, axes: tuple, device) -> DeviceMesh:
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, found {world}: initialise the default process "
            "group with that many ranks first (the dry run uses a fake one, see launch/dryrun.py)"
        )
    ranks = torch.arange(need, dtype=torch.int64).view(shape)
    return DeviceMesh(_device_type(device), ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(device=None) -> DeviceMesh:
    """The degenerate 1 x 1 mesh over the local device (rank 0's)."""
    return _mesh((1, 1), ("data", "model"), device)


def data_parallel_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
