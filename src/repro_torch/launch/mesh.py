"""Device meshes: the 16×16 production pod (256 cards), the 2×16×16 pair of
pods, and small host meshes over whatever ranks exist.

The port of ``repro.launch.mesh``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the current
process group, with the reference's axis names (``data``, ``model``,
``pod``). Functions, not module constants: importing this module starts no
process group.

The production meshes can be built without their cards under a fake
process group of 256 or 512 ranks (``launch.dryrun.fake_world``): the
sharding rules (``repro_torch.distributed.sharding``) read only the axis
names and sizes.

Not ported: ``auto_axis_kwargs``, which passes ``axis_types=Auto`` to
``jax.make_mesh`` where the JAX version has it; a DeviceMesh has no axis
types.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type(device_type: str | None) -> str:
    """The card unless the caller names another device type."""
    return "cuda" if device_type is None else device_type


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(math.prod(shape)).view(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` one, over the current process
    group, which must hold exactly 256 or 512 ranks. On the cards unless
    ``device_type`` names another type (the dry run builds it on the CPU
    under a fake group)."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    want = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"the production mesh needs a process group of "
                           f"{want} ranks; none is initialized")
    world = dist.get_world_size()
    if world != want:
        raise RuntimeError(f"the {'x'.join(map(str, shape))} mesh needs "
                           f"{want} ranks, the process group has {world}")
    return _mesh(_device_type(device_type), shape, names)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str | None = None):
    """A small ``("data", "model")`` mesh over the ranks that exist (tests
    and local runs). ``data`` and ``model`` are clamped to the world size,
    as the reference clamps them to its device count; the mesh holds the
    first ``data · model`` ranks. With no process group initialized it
    starts a world of one through a ``HashStore`` (no TCP port): NCCL on
    the card, gloo when ``device_type`` is ``"cpu"``. It never falls back
    to gloo when NCCL fails."""
    dtype = _device_type(device_type)
    if not dist.is_initialized():
        if dtype == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; pass "
                                   "device_type='cpu' for a mesh on the CPU")
            backend = "nccl"
        else:
            backend = "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    data = min(data, n)
    model = max(min(model, n // data), 1)
    return _mesh(dtype, (data, model), ("data", "model"))
