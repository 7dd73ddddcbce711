"""Wrapper for the hook_edges kernel (``csrc/hook_edges.cu``).

One launch per call; ``hook_edges.launches`` counts them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_int32_cuda, kernel_wanted
from repro_torch.kernels.hook_edges.ref import hook_edges_ref

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def hook_edges(src: torch.Tensor, dst: torch.Tensor, rep: torch.Tensor,
               use_min: bool, *, n_nodes: int,
               use_kernel: bool | None = None):
    """Per half-edge hook proposals ``(tgt, val)``, int32[E] each.

    ``tgt == n_nodes`` marks an edge whose endpoints share a representative
    (drop it). ``src``/``dst`` entries must lie in ``[0, rep.numel())``.
    ``use_kernel`` follows ``repro_torch.kernels.kernel_wanted``.
    """
    if not kernel_wanted(src, use_kernel):
        return hook_edges_ref(src, dst, rep, use_min, n_nodes)
    check_int32_cuda("hook_edges", src, dst, rep)
    e = src.numel()
    if dst.numel() != e:
        raise ValueError(f"hook_edges: src has {e} entries, dst {dst.numel()}")
    tgt, val = torch.empty_like(src), torch.empty_like(src)
    if e == 0:
        return tgt, val
    fn = build.function("hook_edges", "hook_edges", _ARGTYPES)
    rc = fn(src.data_ptr(), dst.data_ptr(), rep.data_ptr(), tgt.data_ptr(),
            val.data_ptr(), e, n_nodes, int(bool(use_min)), src.device.index,
            torch.cuda.current_stream(src.device).cuda_stream)
    build.check("hook_edges", rc)
    hook_edges.launches += 1
    return tgt, val


hook_edges.launches = 0
