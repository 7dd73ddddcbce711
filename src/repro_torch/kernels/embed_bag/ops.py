"""Wrappers for the embed_bag kernel (``csrc/embed_bag.cu``).

The forward is one launch per call, counted by ``embed_bag.launches``. The
backward is the reference's hand-written VJP (``repro/kernels/embed_bag/
ops.py``, ``_vjp_bwd``) in PyTorch ops, ``embed_bag_backward``: one
``torch.autograd.Function`` puts it behind the kernel and behind the plain
version alike. The kernel runs the plan of ``launch_plan`` (vector width,
16-byte index loads), chosen here from the shapes and the tensors'
addresses; the C entry refuses a plan they do not allow.
``embed_bag_previous`` is the previous design (one thread a bag's feature
chunk, looping over its indices), kept only as a yardstick:
``chip_smoke.py`` and the card tests call it, no function of the package
does.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, kernel_wanted, plain_as_kernel
from repro_torch.kernels.embed_bag.ref import embed_bag_ref

_ARGTYPES = {
    "embed_bag": [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "embed_bag_previous": [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
    + [ctypes.c_int] * 5 + [ctypes.c_void_p]}
_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}


class LaunchPlan(NamedTuple):
    """How the kernel reads: ``vector`` elements a load (one thread a
    ``vector``-wide chunk of a row), and ``vector_idx``: the indices (and
    weights) 16 bytes at a time."""
    vector: int
    vector_idx: bool


def launch_plan(hot: int, dim: int, elem_size: int, idx_addr: int,
                table_addr: int, out_addr: int,
                weights_addr: int | None) -> LaunchPlan:
    """The kernel's plan for ``hot`` indices a bag and rows of ``dim``
    elements of ``elem_size`` bytes, from the tensors' addresses.

    ``vector``: the widest power of two of at most 16 bytes that divides
    ``dim`` and to which the table and the output are aligned (a row starts
    at a multiple of ``dim * elem_size`` bytes). ``vector_idx``: ``hot % 4
    == 0`` and the indices (and weights, if any) 16-byte aligned, so every
    bag's indices start on 16 bytes. The kernel also unrolls hot 4 and 8
    (the repo's configs) at compile time.
    """
    vector = next(v for v in (8, 4, 2, 1)
                  if v * elem_size <= 16 and dim % v == 0
                  and table_addr % (v * elem_size) == 0
                  and out_addr % (v * elem_size) == 0)
    vector_idx = (hot % 4 == 0 and idx_addr % 16 == 0
                  and (weights_addr is None or weights_addr % 16 == 0))
    return LaunchPlan(vector, vector_idx)


def _check(name: str, idx: torch.Tensor, table: torch.Tensor,
           weights: torch.Tensor | None) -> None:
    tensors = (idx, table) if weights is None else (idx, table, weights)
    if not (idx.dtype == torch.int32 and idx.dim() == 2
            and table.dtype in _IS_BF16 and table.dim() == 2
            and (weights is None or (weights.dtype == torch.float32
                                     and weights.shape == idx.shape))
            and all(t.is_cuda and t.is_contiguous()
                    and t.device == idx.device for t in tensors)):
        raise ValueError(
            f"{name}: expected contiguous CUDA tensors on one device: "
            "int32[B, hot] idx, float32 or bf16 [V, D] table, float32[B, hot] "
            "weights or None; got " + ", ".join(
                f"dtype={t.dtype} shape={tuple(t.shape)} device={t.device} "
                f"contiguous={t.is_contiguous()}" for t in tensors))


def _launch(idx: torch.Tensor, table: torch.Tensor,
            weights: torch.Tensor | None, out: torch.Tensor, mean: bool,
            plan: LaunchPlan) -> None:
    """One launch of the kernel on ``plan``; raises if it is refused."""
    (b, hot), (v, d) = idx.shape, table.shape
    fn = build.function("embed_bag", "embed_bag", _ARGTYPES["embed_bag"])
    rc = fn(idx.data_ptr(), None if weights is None else weights.data_ptr(),
            table.data_ptr(), out.data_ptr(), b, v, hot, d,
            _IS_BF16[table.dtype], int(mean), plan.vector,
            int(plan.vector_idx), idx.device.index,
            torch.cuda.current_stream(idx.device).cuda_stream)
    build.check("embed_bag", rc)


def embed_bag(idx: torch.Tensor, table: torch.Tensor,
              weights: torch.Tensor | None = None, *, mean: bool = False,
              use_kernel: bool | None = None) -> torch.Tensor:
    """EmbeddingBag: out[b] = Σ_h w[b, h] · table[idx[b, h]] (or the mean,
    divided by max(Σ_h w[b, h], 1e-9)), in the table's dtype.

    ``idx`` is int32[B, hot]; ``table`` float32 or bf16 [V, D]; ``weights``
    float32[B, hot], or None for all ones. An index follows ``table[idx]``:
    one in ``[-V, 0)`` counts from the end, and one outside ``[-V, V)``
    raises, on the CPU at once and on the card at the next synchronising
    call (the kernel traps, as ``table[idx]`` asserts there, and the CUDA
    context is lost in both). ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``. Differentiable in ``table`` and
    ``weights`` through ``embed_bag_backward``, on either path.
    """
    return _EmbedBag.apply(idx, table, weights, mean, use_kernel)


def _forward(idx: torch.Tensor, table: torch.Tensor,
             weights: torch.Tensor | None, mean: bool,
             use_kernel: bool | None) -> torch.Tensor:
    """The kernel's launch, or the plain version, by ``kernel_wanted``."""
    if not kernel_wanted(idx, use_kernel):
        def run():
            return embed_bag_ref(idx, weights, table, mean=mean)
        if use_kernel is False:
            return run()
        return plain_as_kernel("embed_bag", run, idx, table, weights)
    _check("embed_bag", idx, table, weights)
    (b, hot), d = idx.shape, table.shape[1]
    out = table.new_empty((b, d))
    if out.numel() == 0:
        return out
    if hot == 0:
        return out.zero_()
    _launch(idx, table, weights, out, mean, launch_plan(
        hot, d, table.element_size(), idx.data_ptr(), table.data_ptr(),
        out.data_ptr(), None if weights is None else weights.data_ptr()))
    embed_bag.launches += 1
    return out


def embed_bag_backward(g: torch.Tensor, idx: torch.Tensor,
                       table: torch.Tensor, weights: torch.Tensor | None,
                       out: torch.Tensor, *, mean: bool,
                       need_weights: bool = True):
    """(d_table, d_weights) of ``embed_bag`` for the output gradient ``g``,
    the reference's VJP formulas, with s[b] = max(Σ_h w[b, h], 1e-9):

        d_table[idx[b, h]] += ŵ[b, h] · g[b]  in the table's dtype,
                              ŵ = w (sum) or w / s (mean);
        d_w[b, h] = g[b] · table[idx[b, h]]                     (sum),
                  = (g[b] · table[idx[b, h]] − g[b] · out[b]) / s  (mean).

    ``weights=None`` counts as all ones; ``d_weights`` is None unless
    ``need_weights``. Ids in ``[-V, 0)`` count from the end, as in the
    forward.
    """
    b, hot = idx.shape
    v, d = table.shape
    w = (weights if weights is not None
         else torch.ones((b, hot), dtype=torch.float32, device=idx.device))
    denom = torch.clamp(w.sum(-1, keepdim=True), min=1e-9) if mean else None
    w_eff = w / denom if mean else w
    d_rows = w_eff[..., None] * g[:, None, :]                 # [B, hot, D]
    rows_at = idx.reshape(-1).long()
    rows_at = torch.where(rows_at < 0, rows_at + v, rows_at)
    d_table = torch.zeros_like(table).index_add_(
        0, rows_at, d_rows.reshape(-1, d).to(table.dtype))
    if not need_weights:
        return d_table, None
    d_w = torch.einsum("bd,bhd->bh", g, table[idx])
    if mean:
        d_w = d_w / denom - torch.einsum("bd,bd->b", g, out)[:, None] / denom
    return d_table, d_w.to(w.dtype)


class _EmbedBag(torch.autograd.Function):
    """``embed_bag``'s forward dispatch with ``embed_bag_backward``."""

    @staticmethod
    def forward(ctx, idx, table, weights, mean, use_kernel):
        out = _forward(idx, table, weights, mean, use_kernel)
        ctx.mean = mean
        ctx.save_for_backward(idx, table, weights, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        idx, table, weights, out = ctx.saved_tensors
        d_table, d_w = embed_bag_backward(
            g, idx, table, weights, out, mean=ctx.mean,
            need_weights=ctx.needs_input_grad[2])
        return (None, d_table if ctx.needs_input_grad[1] else None, d_w,
                None, None)


embed_bag.launches = 0


def embed_bag_previous(idx: torch.Tensor, table: torch.Tensor,
                       weights: torch.Tensor | None = None, *,
                       mean: bool = False) -> torch.Tensor:
    """The previous design of ``embed_bag`` on the card (one launch; the
    same values bit for bit), a yardstick that no path calls."""
    _check("embed_bag_previous", idx, table, weights)
    (b, hot), (v, d) = idx.shape, table.shape
    out = table.new_empty((b, d))
    if out.numel() == 0:
        return out
    if hot == 0:
        return out.zero_()
    fn = build.function("embed_bag", "embed_bag_previous",
                        _ARGTYPES["embed_bag_previous"])
    rc = fn(idx.data_ptr(), None if weights is None else weights.data_ptr(),
            table.data_ptr(), out.data_ptr(), b, v, hot, d,
            _IS_BF16[table.dtype], int(mean), idx.device.index,
            torch.cuda.current_stream(idx.device).cuda_stream)
    build.check("embed_bag", rc)
    embed_bag_previous.launches += 1
    return out


embed_bag_previous.launches = 0
