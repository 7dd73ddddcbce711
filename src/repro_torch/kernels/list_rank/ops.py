"""Wrappers for the list_rank kernels (``csrc/list_rank.cu``).

``list_rank_double_k`` is one group of ``n_steps`` Wyllie doubling steps
in one cooperative launch, which can also return whether any list is still
open; the convergence loop around it lives in
``repro_torch.core.compress.wyllie_rank`` (``list_rank`` calls it). ``list_rank_k`` is the chain
variant, ``n_steps`` updates against one snapshot, composed from squarings
in one cooperative launch. ``list_rank_double_stepwise`` and
``list_rank_chain_previous`` are the previous designs of the two kernels
(one launch per doubling step; one thread an element taking the steps),
kept only as yardsticks: ``chip_smoke.py`` and the card tests call them,
no function of the package does. Each wrapper's ``.launches`` counts its
kernel's launches; each launch of ``list_rank_double_k`` is also the span
``kernel.list_rank_double`` (``obs``), with its ``entries`` and
``passes``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import build, check_int32_cuda, kernel_wanted
from repro_torch.kernels.hops import c_schedule, hop_schedule
from repro_torch.kernels.list_rank.ref import (NO_SUCC, list_rank_double_ref,
                                               list_rank_steps_ref)

_ARGTYPES = {
    "list_rank_double": [ctypes.c_void_p] * 7 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
    "list_rank_double_stepwise": [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "list_rank_chain": [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
    "list_rank_chain_previous": [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
# The cooperative kernel's 32-bit indices (an int32 successor table cannot
# point further).
_MAX_ENTRIES = 1 << 31


def _check_pair(name: str, succ: torch.Tensor, dist: torch.Tensor) -> int:
    check_int32_cuda(name, succ, dist)
    n = succ.numel()
    if dist.numel() != n:
        raise ValueError(f"{name}: succ has {n} entries, dist {dist.numel()}")
    return n


def _with_open(succ: torch.Tensor, dist: torch.Tensor, return_open: bool,
               flag: torch.Tensor | None = None):
    """``(succ, dist)``, and with ``return_open`` the flag: ``flag`` where
    the kernel computed it, else ``any(succ != -1)``."""
    if not return_open:
        return succ, dist
    return succ, dist, torch.any(succ != NO_SUCC) if flag is None else flag


def list_rank_double_k(succ: torch.Tensor, dist: torch.Tensor, *,
                       n_steps: int = 5, use_kernel: bool | None = None,
                       return_open: bool = False):
    """``n_steps`` Wyllie doubling steps on int32[n] ``(succ, dist)``.

    ``succ == -1`` ends a list. Functional: the inputs are not written.
    Returns the new ``(succ, dist)``; with ``return_open``, ``(succ, dist,
    open)`` where ``open`` is a 0-dim bool tensor on the inputs' device,
    ``any(succ_out != -1)``, which the kernel computes in its last step.
    ``n_steps <= 0`` runs no step (copies of the inputs), as the reference's
    ``for _ in range(n_steps)`` does. ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``.
    """
    if not kernel_wanted(succ, use_kernel):
        return _with_open(*list_rank_double_ref(succ, dist, n_steps),
                          return_open)
    n = _check_pair("list_rank_double_k", succ, dist)
    if n == 0 or n_steps <= 0:
        return _with_open(succ.clone(), dist.clone(), return_open)
    if n > _MAX_ENTRIES:
        raise ValueError(f"list_rank_double_k: {n} entries, the kernel "
                         f"indexes at most {_MAX_ENTRIES}")
    with obs.span("kernel.list_rank_double", entries=n, passes=n_steps):
        s, d, open_ = _launch_double(succ, dist, n_steps)
    list_rank_double_k.launches += 1
    return _with_open(s, d, return_open, open_)


list_rank_double_k.launches = 0



def list_rank(succ: torch.Tensor, valid: torch.Tensor, *, n_steps: int = 5,
              use_kernel: bool | None = None) -> torch.Tensor:
    """Distance-to-end ranks: the engine's ``wyllie_rank``, one
    ``list_rank_double_k`` group per convergence check. The reference's
    convenience entry; ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``."""
    from repro_torch.core.compress import wyllie_rank
    return wyllie_rank(succ, valid, n_jumps=n_steps, use_kernel=use_kernel)

def _launch_double(succ: torch.Tensor, dist: torch.Tensor, n_steps: int,
                   blocks: int = 0):
    """One cooperative launch of the doubling kernel on a grid of
    ``blocks`` (0: the kernel's own, ``list_rank_double_blocks``); raises if
    the launch is refused. Returns ``(succ', dist', open)``."""
    n = succ.numel()
    succ_out, dist_out = torch.empty_like(succ), torch.empty_like(dist)
    # Packed (succ, dist) pairs, int2 in the kernel: step j < n_steps - 1
    # writes pair j % 2.
    pairs = [torch.empty(n, dtype=torch.int64, device=succ.device)
             for _ in range(min(n_steps - 1, 2))]
    pair_a = pairs[0] if pairs else succ_out
    pair_b = pairs[-1] if pairs else succ_out
    # The kernel zeroes these 4 bytes as one int32 and ORs 1 into it; on
    # the little-endian card byte 0 then reads as the bool.
    flag = torch.empty(4, dtype=torch.bool, device=succ.device)
    fn = build.function("list_rank", "list_rank_double",
                        _ARGTYPES["list_rank_double"])
    rc = fn(succ.data_ptr(), dist.data_ptr(), succ_out.data_ptr(),
            dist_out.data_ptr(), pair_a.data_ptr(), pair_b.data_ptr(),
            flag.data_ptr(), n, n_steps, blocks, succ.device.index,
            torch.cuda.current_stream(succ.device).cuda_stream)
    build.check("list_rank", rc)
    return succ_out, dist_out, flag[0]


def list_rank_double_stepwise(succ: torch.Tensor, dist: torch.Tensor, *,
                              n_steps: int = 5, return_open: bool = False):
    """The previous design of ``list_rank_double_k`` on the card: one
    launch per step over four int32 tables, and the flag as a separate
    ``torch.any`` pass. Same values; a yardstick only."""
    n = _check_pair("list_rank_double_stepwise", succ, dist)
    if n == 0 or n_steps <= 0:
        succ_out, dist_out = succ.clone(), dist.clone()
    else:
        succ_out, dist_out = torch.empty_like(succ), torch.empty_like(dist)
        if n_steps > 1:
            succ_tmp, dist_tmp = torch.empty_like(succ), torch.empty_like(dist)
        else:
            succ_tmp, dist_tmp = succ_out, dist_out
        fn = build.function("list_rank", "list_rank_double_stepwise",
                            _ARGTYPES["list_rank_double_stepwise"])
        rc = fn(succ.data_ptr(), dist.data_ptr(), succ_out.data_ptr(),
                dist_out.data_ptr(), succ_tmp.data_ptr(), dist_tmp.data_ptr(),
                n, n_steps, succ.device.index,
                torch.cuda.current_stream(succ.device).cuda_stream)
        build.check("list_rank", rc)
        list_rank_double_stepwise.launches += n_steps
    return _with_open(succ_out, dist_out, return_open)


list_rank_double_stepwise.launches = 0


def list_rank_k(succ: torch.Tensor, dist: torch.Tensor, *, n_steps: int = 5,
                use_kernel: bool | None = None):
    """One launch: ``n_steps`` Wyllie updates against one snapshot.

    Gives the (k+1)-hop chain prefix sums ``dist'[i] = Σ_{j≤k}
    dist[s^j(i)]`` and ``succ'[i] = s^(k+1)(i)``; ``succ == -1`` ends a
    list, and the int32 sums wrap. Functional. Returns ``(succ', dist')``.
    On the card the k + 1 hops are composed from squarings: one cooperative
    launch runs the passes of ``hops.hop_schedule(n_steps, pack_input=True)``,
    a grid-wide barrier between them, on (succ, dist) packed as one 8-byte
    pair by the first pass (3 random one-sector gathers an element at the
    default 5, where the steps take 5 of two tables each). ``n_steps <= 0``
    gives copies of the inputs.
    ``use_kernel`` follows ``repro_torch.kernels.kernel_wanted``.
    """
    if not kernel_wanted(succ, use_kernel):
        return list_rank_steps_ref(succ, dist, n_steps)
    n = _check_pair("list_rank_k", succ, dist)
    if n == 0:
        return succ.clone(), dist.clone()
    if n > _MAX_ENTRIES:
        raise ValueError(f"list_rank_k: {n} entries, the kernel indexes at "
                         f"most {_MAX_ENTRIES}")
    out = _launch_chain(succ, dist, hop_schedule(n_steps, pack_input=True))
    list_rank_k.launches += 1
    return out


list_rank_k.launches = 0


def _launch_chain(succ: torch.Tensor, dist: torch.Tensor, plan,
                  blocks: int = 0):
    """One cooperative launch of the chain kernel running ``plan`` (a
    ``hops.hop_schedule``) on a grid of ``blocks`` (0: the kernel's own,
    ``list_rank_chain_blocks``); raises if the launch is refused or the
    plan is malformed. Each pass but the last writes its own packed table.
    Returns ``(succ', dist')``."""
    n = succ.numel()
    succ_out, dist_out = torch.empty_like(succ), torch.empty_like(dist)
    # Packed (succ, dist) pairs, int2 in the kernel.
    scratch = (torch.empty((len(plan) - 1) * n, dtype=torch.int64,
                           device=succ.device) if len(plan) > 1 else succ_out)
    spec = c_schedule(plan)
    fn = build.function("list_rank", "list_rank_chain",
                        _ARGTYPES["list_rank_chain"])
    rc = fn(succ.data_ptr(), dist.data_ptr(), succ_out.data_ptr(),
            dist_out.data_ptr(), scratch.data_ptr(), ctypes.addressof(spec),
            len(spec), n, blocks, succ.device.index,
            torch.cuda.current_stream(succ.device).cuda_stream)
    build.check("list_rank", rc)
    return succ_out, dist_out


def list_rank_chain_previous(succ: torch.Tensor, dist: torch.Tensor, *,
                             n_steps: int = 5):
    """The previous design of ``list_rank_k`` on the card: one launch, one
    thread an element taking the ``n_steps`` steps, two int32 gathers a
    step. Same values; a yardstick only."""
    n = _check_pair("list_rank_chain_previous", succ, dist)
    succ_out, dist_out = torch.empty_like(succ), torch.empty_like(dist)
    if n == 0:
        return succ_out, dist_out
    fn = build.function("list_rank", "list_rank_chain_previous",
                        _ARGTYPES["list_rank_chain_previous"])
    rc = fn(succ.data_ptr(), dist.data_ptr(), succ_out.data_ptr(),
            dist_out.data_ptr(), n, n_steps, succ.device.index,
            torch.cuda.current_stream(succ.device).cuda_stream)
    build.check("list_rank", rc)
    list_rank_chain_previous.launches += 1
    return succ_out, dist_out


list_rank_chain_previous.launches = 0
