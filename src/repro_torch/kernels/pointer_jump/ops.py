"""Wrappers for the pointer_jump kernels (``csrc/pointer_jump.cu``).

``pointer_jump_double_k`` is one group of ``n_jumps`` doubling steps, which
the kernel runs as ``n_jumps`` launches; the convergence loop around it
lives in ``repro_torch.core.compress``. ``pointer_jump_k`` is the chain
variant, ``n_jumps + 1`` hops against one fixed table in one launch. Each
wrapper's ``.launches`` counts its kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_int32_cuda, kernel_wanted
from repro_torch.kernels.pointer_jump.ref import (pointer_jump_double_ref,
                                                  pointer_jump_ref)

_ARGTYPES = {
    "pointer_jump_double": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p],
    "pointer_jump_chain": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


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
    fn = build.function("pointer_jump", "pointer_jump_double",
                        _ARGTYPES["pointer_jump_double"])
    rc = fn(p.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, n_jumps,
            p.device.index, torch.cuda.current_stream(p.device).cuda_stream)
    build.check("pointer_jump", rc)
    pointer_jump_double_k.launches += n_jumps
    return out


pointer_jump_double_k.launches = 0


def pointer_jump_k(p: torch.Tensor, *, n_jumps: int = 5,
                   use_kernel: bool | None = None) -> torch.Tensor:
    """One launch: follow the parent chain ``n_jumps + 1`` hops.

    ``out[i] = p^(n_jumps+1)(i)`` against the fixed table ``p`` (the
    paper's several jumps per thread); ``p`` is not written. Entries of
    ``p`` must lie in ``[0, n)``. ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``.
    """
    if not kernel_wanted(p, use_kernel):
        return pointer_jump_ref(p, n_jumps)
    check_int32_cuda("pointer_jump_k", p)
    n = p.numel()
    out = torch.empty_like(p)
    if n == 0:
        return out
    fn = build.function("pointer_jump", "pointer_jump_chain",
                        _ARGTYPES["pointer_jump_chain"])
    rc = fn(p.data_ptr(), out.data_ptr(), n, n_jumps, p.device.index,
            torch.cuda.current_stream(p.device).cuda_stream)
    build.check("pointer_jump", rc)
    pointer_jump_k.launches += 1
    return out


pointer_jump_k.launches = 0
