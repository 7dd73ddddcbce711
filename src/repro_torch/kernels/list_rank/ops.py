"""Wrapper for the list_rank doubling kernel (``csrc/list_rank.cu``).

The convergence loop lives in ``repro_torch.core.compress.wyllie_rank``;
this wrapper is one group of ``n_steps`` Wyllie steps, which the kernel runs
as ``n_steps`` launches. ``list_rank_double_k.launches`` counts them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_int32_cuda, kernel_wanted
from repro_torch.kernels.list_rank.ref import list_rank_double_ref

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def list_rank_double_k(succ: torch.Tensor, dist: torch.Tensor, *,
                       n_steps: int = 5, use_kernel: bool | None = None):
    """``n_steps`` Wyllie doubling steps on int32[n] ``(succ, dist)``.

    ``succ == -1`` ends a list. Functional: the inputs are not written.
    Returns the new ``(succ, dist)``. ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``.
    """
    if not kernel_wanted(succ, use_kernel):
        return list_rank_double_ref(succ, dist, n_steps)
    check_int32_cuda("list_rank_double_k", succ, dist)
    n = succ.numel()
    if dist.numel() != n:
        raise ValueError(f"list_rank_double_k: succ has {n} entries, "
                         f"dist {dist.numel()}")
    if n == 0 or n_steps == 0:
        return succ.clone(), dist.clone()
    succ_out, dist_out = torch.empty_like(succ), torch.empty_like(dist)
    if n_steps > 1:
        succ_tmp, dist_tmp = torch.empty_like(succ), torch.empty_like(dist)
    else:
        succ_tmp, dist_tmp = succ_out, dist_out
    fn = build.function("list_rank", "list_rank_double", _ARGTYPES)
    rc = fn(succ.data_ptr(), dist.data_ptr(), succ_out.data_ptr(),
            dist_out.data_ptr(), succ_tmp.data_ptr(), dist_tmp.data_ptr(),
            n, n_steps, succ.device.index,
            torch.cuda.current_stream(succ.device).cuda_stream)
    build.check("list_rank", rc)
    list_rank_double_k.launches += n_steps
    return succ_out, dist_out


list_rank_double_k.launches = 0
