"""Production meshes, the port of ``repro.launch.mesh``: ``DeviceMesh``es
over the ranks of the initialised default process group.

Functions, not module constants, so importing touches no process group.
The card is the default device type; the dry run passes "cpu", as the
reference forces host devices for its own."""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 ("data", "model"), 256 ranks, or 2x16x16 ("pod", "data",
    "model"), 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    have = _world()
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} — run "
            "via launch.dryrun (it opens a fake process group of that "
            "size) or on a pod")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_worker_mesh(n_model: int = 1,
                     device_type: str = "cuda") -> DeviceMesh:
    """A (1, n_model) ("data", "model") mesh: tensor parallelism inside
    one serving worker."""
    have = _world()
    if have < n_model:
        raise RuntimeError(f"need {n_model} devices for mesh (1, "
                           f"{n_model}), have {have}")
    return init_device_mesh(device_type, (1, n_model),
                            mesh_dim_names=("data", "model"))
