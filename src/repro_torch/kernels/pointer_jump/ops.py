"""Wrappers for the pointer_jump kernels (``csrc/pointer_jump.cu``).

``pointer_jump_double_k`` is one group of ``n_jumps`` doubling steps in
one cooperative launch, which can also return the group's convergence
flag; the convergence loop around it lives in
``repro_torch.core.compress``. ``pointer_jump_k`` is the chain variant,
``n_jumps + 1`` hops against one fixed table, composed from squarings in
one cooperative launch. ``pointer_jump_double_stepwise`` and
``pointer_jump_chain_previous`` are the previous designs of the two
kernels (one launch per doubling step; one thread an entry following the
table), kept only as yardsticks: ``chip_smoke.py`` and the card tests call
them, no function of the package does. Each wrapper's ``.launches`` counts
its kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_int32_cuda, kernel_wanted
from repro_torch.kernels.hops import c_schedule, hop_schedule
from repro_torch.kernels.pointer_jump.ref import (pointer_jump_double_ref,
                                                  pointer_jump_ref)

_ARGTYPES = {
    "pointer_jump_double": [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
    "pointer_jump_double_stepwise": [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "pointer_jump_chain": [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
    "pointer_jump_chain_previous": [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p],
}
# The cooperative kernel's 32-bit indices (an int32 table cannot point
# further).
_MAX_ENTRIES = 1 << 31


def pointer_jump_double_k(p: torch.Tensor, *, n_jumps: int = 5,
                          use_kernel: bool | None = None,
                          return_changed: bool = False):
    """``n_jumps`` doubling steps ``p = p[p]`` on an int32[n] table.

    Functional: ``p`` is not written. With ``return_changed``, returns
    ``(out, changed)``: ``changed`` is a 0-dim bool tensor on ``p``'s
    device, ``any(out != p)``, which the kernel computes in its last step.
    ``n_jumps <= 0`` runs no step (a copy of ``p``, unchanged), as the
    reference's ``for _ in range(n_jumps)`` does. ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``.
    """
    if not kernel_wanted(p, use_kernel):
        out = pointer_jump_double_ref(p, n_jumps)
        return (out, torch.any(out != p)) if return_changed else out
    check_int32_cuda("pointer_jump_double_k", p)
    n = p.numel()
    if n == 0 or n_jumps <= 0:
        out = p.clone()
        return ((out, torch.zeros((), dtype=torch.bool, device=p.device))
                if return_changed else out)
    if n > _MAX_ENTRIES:
        raise ValueError(f"pointer_jump_double_k: {n} entries, the kernel "
                         f"indexes at most {_MAX_ENTRIES}")
    out, changed = _launch_double(p, n_jumps)
    pointer_jump_double_k.launches += 1
    return (out, changed) if return_changed else out


pointer_jump_double_k.launches = 0


def _launch_double(p: torch.Tensor, n_jumps: int, blocks: int = 0):
    """One cooperative launch of the doubling kernel on a grid of
    ``blocks`` (0: the kernel's own, ``pointer_jump_double_blocks``); raises
    if the launch is refused. Returns ``(out, changed)``."""
    out = torch.empty_like(p)
    scratch = torch.empty_like(p) if n_jumps > 1 else out
    # The kernel zeroes these 4 bytes as one int32 and ORs 1 into it; on
    # the little-endian card byte 0 then reads as the bool.
    flag = torch.empty(4, dtype=torch.bool, device=p.device)
    fn = build.function("pointer_jump", "pointer_jump_double",
                        _ARGTYPES["pointer_jump_double"])
    rc = fn(p.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            flag.data_ptr(), p.numel(), n_jumps, blocks, p.device.index,
            torch.cuda.current_stream(p.device).cuda_stream)
    build.check("pointer_jump", rc)
    return out, flag[0]


def pointer_jump_double_stepwise(p: torch.Tensor, *, n_jumps: int = 5,
                                 return_changed: bool = False):
    """The previous design of ``pointer_jump_double_k`` on the card: one
    launch per step, and the flag as a separate ``torch.any`` pass. Same
    values; a yardstick only."""
    check_int32_cuda("pointer_jump_double_stepwise", p)
    n = p.numel()
    if n == 0 or n_jumps <= 0:
        out = p.clone()
    else:
        out = torch.empty_like(p)
        scratch = torch.empty_like(p) if n_jumps > 1 else out
        fn = build.function("pointer_jump", "pointer_jump_double_stepwise",
                            _ARGTYPES["pointer_jump_double_stepwise"])
        rc = fn(p.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
                n_jumps, p.device.index,
                torch.cuda.current_stream(p.device).cuda_stream)
        build.check("pointer_jump", rc)
        pointer_jump_double_stepwise.launches += n_jumps
    return (out, torch.any(out != p)) if return_changed else out


pointer_jump_double_stepwise.launches = 0


def pointer_jump_k(p: torch.Tensor, *, n_jumps: int = 5,
                   use_kernel: bool | None = None) -> torch.Tensor:
    """One launch: follow the parent chain ``n_jumps + 1`` hops.

    ``out[i] = p^(n_jumps+1)(i)`` against the fixed table ``p`` (the
    paper's several jumps per thread); ``p`` is not written. Entries of
    ``p`` must lie in ``[0, n)``. On the card the hops are composed from
    squarings: one cooperative launch runs the passes of
    ``hops.hop_schedule(n_jumps)``, a grid-wide barrier between them (3
    random gathers an entry at the default 5, where following the chain
    takes 5). ``n_jumps <= 0`` gives a copy of ``p`` (one pass, no
    gather). ``use_kernel`` follows ``repro_torch.kernels.kernel_wanted``.
    """
    if not kernel_wanted(p, use_kernel):
        return pointer_jump_ref(p, n_jumps)
    check_int32_cuda("pointer_jump_k", p)
    n = p.numel()
    if n == 0:
        return p.clone()
    if n > _MAX_ENTRIES:
        raise ValueError(f"pointer_jump_k: {n} entries, the kernel indexes "
                         f"at most {_MAX_ENTRIES}")
    out = _launch_chain(p, hop_schedule(n_jumps))
    pointer_jump_k.launches += 1
    return out


pointer_jump_k.launches = 0


def _launch_chain(p: torch.Tensor, plan, blocks: int = 0):
    """One cooperative launch of the chain kernel running ``plan`` (a
    ``hops.hop_schedule``) on a grid of ``blocks`` (0: the kernel's own,
    ``pointer_jump_chain_blocks``); raises if the launch is refused or the
    plan is malformed. Each pass but the last writes its own table."""
    n = p.numel()
    out = torch.empty_like(p)
    scratch = (torch.empty((len(plan) - 1) * n, dtype=p.dtype,
                           device=p.device) if len(plan) > 1 else out)
    spec = c_schedule(plan)
    fn = build.function("pointer_jump", "pointer_jump_chain",
                        _ARGTYPES["pointer_jump_chain"])
    rc = fn(p.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            ctypes.addressof(spec), len(spec), n, blocks, p.device.index,
            torch.cuda.current_stream(p.device).cuda_stream)
    build.check("pointer_jump", rc)
    return out


def pointer_jump_chain_previous(p: torch.Tensor, *,
                                n_jumps: int = 5) -> torch.Tensor:
    """The previous design of ``pointer_jump_k`` on the card: one launch,
    one thread an entry following the table ``n_jumps`` times. Same values;
    a yardstick only."""
    check_int32_cuda("pointer_jump_chain_previous", p)
    n = p.numel()
    out = torch.empty_like(p)
    if n == 0:
        return out
    fn = build.function("pointer_jump", "pointer_jump_chain_previous",
                        _ARGTYPES["pointer_jump_chain_previous"])
    rc = fn(p.data_ptr(), out.data_ptr(), n, n_jumps, p.device.index,
            torch.cuda.current_stream(p.device).cuda_stream)
    build.check("pointer_jump", rc)
    pointer_jump_chain_previous.launches += 1
    return out


pointer_jump_chain_previous.launches = 0
