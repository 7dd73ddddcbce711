"""Wrapper for the frontier_relax kernel (``csrc/frontier_relax.cu``).

One launch per call, which is one per BFS level; ``frontier_relax.launches``
counts them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_int32_cuda, kernel_wanted
from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref

_ARGTYPES = {"frontier_relax": [ctypes.c_void_p] * 4 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def frontier_relax(dist: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   level: int, *, use_kernel: bool | None = None
                   ) -> torch.Tensor:
    """bool[E] frontier-expansion mask of one BFS level:
    ``(dist[src] == level) & (dist[dst] == INF32)``.

    ``level`` is a host int. ``src``/``dst`` entries must lie in
    ``[0, dist.numel())``. ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``.
    """
    if not kernel_wanted(src, use_kernel):
        return frontier_relax_ref(dist, src, dst, level)
    check_int32_cuda("frontier_relax", src, dst, dist)
    e = src.numel()
    if dst.numel() != e:
        raise ValueError(
            f"frontier_relax: src has {e} entries, dst {dst.numel()}")
    mask = torch.empty(e, dtype=torch.bool, device=src.device)
    if e == 0:
        return mask
    fn = build.function("frontier_relax", "frontier_relax",
                        _ARGTYPES["frontier_relax"])
    rc = fn(src.data_ptr(), dst.data_ptr(), dist.data_ptr(), mask.data_ptr(),
            e, int(level), src.device.index,
            torch.cuda.current_stream(src.device).cuda_stream)
    build.check("frontier_relax", rc)
    frontier_relax.launches += 1
    return mask


frontier_relax.launches = 0
