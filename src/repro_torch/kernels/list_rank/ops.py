"""Wrappers for the list_rank kernels (``csrc/list_rank.cu``).

``list_rank_double_k`` is one group of ``n_steps`` Wyllie doubling steps,
which the kernel runs as ``n_steps`` launches; the convergence loop around
it lives in ``repro_torch.core.compress.wyllie_rank``. ``list_rank_k`` is
the chain variant, ``n_steps`` updates against one snapshot in one launch.
Each wrapper's ``.launches`` counts its kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_int32_cuda, kernel_wanted
from repro_torch.kernels.list_rank.ref import (list_rank_double_ref,
                                               list_rank_steps_ref)

_ARGTYPES = {
    "list_rank_double": [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int,
                                                 ctypes.c_int,
                                                 ctypes.c_void_p],
    "list_rank_chain": [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_void_p],
}


def _check_pair(name: str, succ: torch.Tensor, dist: torch.Tensor) -> int:
    check_int32_cuda(name, succ, dist)
    n = succ.numel()
    if dist.numel() != n:
        raise ValueError(f"{name}: succ has {n} entries, dist {dist.numel()}")
    return n


def list_rank_double_k(succ: torch.Tensor, dist: torch.Tensor, *,
                       n_steps: int = 5, use_kernel: bool | None = None):
    """``n_steps`` Wyllie doubling steps on int32[n] ``(succ, dist)``.

    ``succ == -1`` ends a list. Functional: the inputs are not written.
    Returns the new ``(succ, dist)``. ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``.
    """
    if not kernel_wanted(succ, use_kernel):
        return list_rank_double_ref(succ, dist, n_steps)
    n = _check_pair("list_rank_double_k", succ, dist)
    if n == 0 or n_steps == 0:
        return succ.clone(), dist.clone()
    succ_out, dist_out = torch.empty_like(succ), torch.empty_like(dist)
    if n_steps > 1:
        succ_tmp, dist_tmp = torch.empty_like(succ), torch.empty_like(dist)
    else:
        succ_tmp, dist_tmp = succ_out, dist_out
    fn = build.function("list_rank", "list_rank_double",
                        _ARGTYPES["list_rank_double"])
    rc = fn(succ.data_ptr(), dist.data_ptr(), succ_out.data_ptr(),
            dist_out.data_ptr(), succ_tmp.data_ptr(), dist_tmp.data_ptr(),
            n, n_steps, succ.device.index,
            torch.cuda.current_stream(succ.device).cuda_stream)
    build.check("list_rank", rc)
    list_rank_double_k.launches += n_steps
    return succ_out, dist_out


list_rank_double_k.launches = 0


def list_rank_k(succ: torch.Tensor, dist: torch.Tensor, *, n_steps: int = 5,
                use_kernel: bool | None = None):
    """One launch: ``n_steps`` Wyllie updates against one snapshot.

    Gives the (k+1)-hop chain prefix sums ``dist'[i] = Σ_{j≤k}
    dist[s^j(i)]`` and ``succ'[i] = s^(k+1)(i)``; ``succ == -1`` ends a
    list. Functional. Returns ``(succ', dist')``. ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``.
    """
    if not kernel_wanted(succ, use_kernel):
        return list_rank_steps_ref(succ, dist, n_steps)
    n = _check_pair("list_rank_k", succ, dist)
    succ_out, dist_out = torch.empty_like(succ), torch.empty_like(dist)
    if n == 0:
        return succ_out, dist_out
    fn = build.function("list_rank", "list_rank_chain",
                        _ARGTYPES["list_rank_chain"])
    rc = fn(succ.data_ptr(), dist.data_ptr(), succ_out.data_ptr(),
            dist_out.data_ptr(), n, n_steps, succ.device.index,
            torch.cuda.current_stream(succ.device).cuda_stream)
    build.check("list_rank", rc)
    list_rank_k.launches += 1
    return succ_out, dist_out


list_rank_k.launches = 0
