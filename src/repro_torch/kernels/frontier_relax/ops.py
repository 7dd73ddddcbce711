"""Wrappers for the frontier_relax kernels (``csrc/frontier_relax.cu``).

``frontier_relax`` is the expansion mask of one BFS level, one launch a
call. ``bfs_level`` is the whole level, the parent scatter-min fused in,
which ``repro_torch.core.bfs.bfs_rst`` calls once a level. Each wrapper's
``.launches`` counts its calls that launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_int32_cuda, kernel_wanted
from repro_torch.kernels.frontier_relax.ref import (INF32, bfs_level_ref,
                                                    frontier_relax_ref)

_ARGTYPES = {
    "frontier_relax": [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "bfs_level": [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
}


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


def bfs_level_buffer(n: int, device) -> torch.Tensor:
    """The int32[n + 1] buffer one BFS's ``bfs_level`` calls share: every
    slot INF32 (no proposal yet; slot n is the kernel's level flag)."""
    return torch.full((n + 1,), INF32, dtype=torch.int32, device=device)


def bfs_level(dist: torch.Tensor, parent: torch.Tensor,
              cand: torch.Tensor | None, src: torch.Tensor, dst: torch.Tensor,
              level: int, *, consts=None,
              use_kernel: bool | None = None) -> bool:
    """One level of the edge-centric BFS, in place on int32[n] ``dist`` and
    ``parent``; returns whether it discovered a vertex.

    Every undiscovered vertex with a half-edge from level ``level`` gets
    ``dist = level + 1`` and the smallest such source as its parent.
    ``cand`` is ``bfs_level_buffer(n, device)``, made once per BFS and
    passed to each of its levels: the kernel's proposals and its flag.
    ``consts`` is the plain version's ``level_constants``, which a caller
    running many levels builds once (each call builds them where None).
    Each path ignores the other's. ``src``/``dst`` entries must lie in
    ``[0, n)``. One host read a level, of the flag. ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``.
    """
    if not kernel_wanted(src, use_kernel):
        return bfs_level_ref(dist, parent, src, dst, level, consts=consts)
    check_int32_cuda("bfs_level", src, dst, dist, parent, cand)
    n, e = dist.numel(), src.numel()
    if dst.numel() != e or parent.numel() != n or cand.numel() != n + 1:
        raise ValueError(
            f"bfs_level: src {e}, dst {dst.numel()}, dist {n}, parent "
            f"{parent.numel()} and cand {cand.numel()} entries (want "
            "dst == src, parent == dist, cand == dist + 1)")
    if n == 0:
        return False
    fn = build.function("frontier_relax", "bfs_level", _ARGTYPES["bfs_level"])
    rc = fn(src.data_ptr(), dst.data_ptr(), dist.data_ptr(),
            parent.data_ptr(), cand.data_ptr(), e, n, int(level),
            src.device.index,
            torch.cuda.current_stream(src.device).cuda_stream)
    build.check("frontier_relax", rc)
    bfs_level.launches += 1
    return int(cand[n]) == level + 1


bfs_level.launches = 0
