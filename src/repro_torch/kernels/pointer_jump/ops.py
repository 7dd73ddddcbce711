"""Wrapper for the pointer_jump doubling kernel (``csrc/pointer_jump.cu``).

The convergence loop lives in ``repro_torch.core.compress``; this wrapper is
one group of ``n_jumps`` doubling steps, which the kernel runs as
``n_jumps`` launches. ``pointer_jump_double_k.launches`` counts them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_int32_cuda, kernel_wanted
from repro_torch.kernels.pointer_jump.ref import pointer_jump_double_ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def pointer_jump_double_k(p: torch.Tensor, *, n_jumps: int = 5,
                          use_kernel: bool | None = None) -> torch.Tensor:
    """``n_jumps`` doubling steps ``p = p[p]`` on an int32[n] table.

    Functional: ``p`` is not written. ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``.
    """
    if not kernel_wanted(p, use_kernel):
        return pointer_jump_double_ref(p, n_jumps)
    check_int32_cuda("pointer_jump_double_k", p)
    n = p.numel()
    if n == 0 or n_jumps == 0:
        return p.clone()
    out = torch.empty_like(p)
    scratch = torch.empty_like(p) if n_jumps > 1 else out
    fn = build.function("pointer_jump", "pointer_jump_double", _ARGTYPES)
    rc = fn(p.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, n_jumps,
            p.device.index, torch.cuda.current_stream(p.device).cuda_stream)
    build.check("pointer_jump", rc)
    pointer_jump_double_k.launches += n_jumps
    return out


pointer_jump_double_k.launches = 0
