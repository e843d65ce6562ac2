"""Mesh construction of the port (``repro.launch.mesh``).

FUNCTIONS, not module-level constants: importing this module touches no
process group.  Each builds a named ``DeviceMesh`` over the process group
that the caller initialised (``torchrun`` gives every rank its rank and the
world size), on ``"cuda"`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Tuple

import torch.distributed as dist

# spec fitting lives with the sharding rules; re-exported for launch code
from repro_torch.distribution.partitioning import (  # noqa: F401
    fit_spec, sanitize_spec)


def make_host_mesh(shape: Tuple[int, ...] = (1, 1),
                   axes: Tuple[str, ...] = ("data", "model"), *,
                   device: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the initialised process
    group, whose world size must be the mesh's size.  On "cuda" each rank
    takes the card of its local rank (``LOCAL_RANK``, else its rank modulo
    the cards) first."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (run under torchrun)")
    size = 1
    for s in shape:
        size *= s
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"the mesh {tuple(shape)} {tuple(axes)} needs "
                         f"{size} ranks; the world has {world}")
    if device == "cuda":
        import os

        import torch

        n = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 dist.get_rank() % n)))
    return init_device_mesh(device, tuple(shape),
                            mesh_dim_names=tuple(axes))


def init_world(device: str = "cuda") -> int:
    """Join the process group ``torchrun`` describes (``RANK`` and
    ``WORLD_SIZE`` set; NCCL on "cuda", gloo on "cpu") unless one is
    initialised already; returns the world size (1 outside torchrun)."""
    import os

    if not dist.is_initialized():
        if "RANK" not in os.environ:
            return 1
        dist.init_process_group("nccl" if device == "cuda" else "gloo")
    return dist.get_world_size()


def make_serve_mesh(*, device: str = "cuda"):
    """The serving mesh: shape (1, world) named ("data", "model") over the
    initialised process group, every rank one CU column."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    return make_host_mesh((1, world), ("data", "model"), device=device)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The 16x16 single-pod (256 ranks) or 2x16x16 dual-pod (512 ranks)
    mesh."""
    if multi_pod:
        return make_host_mesh((2, 16, 16), ("pod", "data", "model"),
                              device=device)
    return make_host_mesh((16, 16), ("data", "model"), device=device)
