"""Wrapper for the embed_bag kernel (``csrc/embed_bag.cu``).

Forward only: one launch per call, counted by ``embed_bag.launches``. The
reference's hand-written VJP (``repro/kernels/embed_bag/ops.py``) comes with
DIEN's training.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, kernel_wanted
from repro_torch.kernels.embed_bag.ref import embed_bag_ref

_ARGTYPES = {"embed_bag": [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
             + [ctypes.c_int] * 5 + [ctypes.c_void_p]}
_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}


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
    ``repro_torch.kernels.kernel_wanted``.
    """
    if not kernel_wanted(idx, use_kernel):
        return embed_bag_ref(idx, weights, table, mean=mean)
    tensors = (idx, table) if weights is None else (idx, table, weights)
    if not (idx.dtype == torch.int32 and idx.dim() == 2
            and table.dtype in _IS_BF16 and table.dim() == 2
            and (weights is None or (weights.dtype == torch.float32
                                     and weights.shape == idx.shape))
            and all(t.is_cuda and t.is_contiguous()
                    and t.device == idx.device for t in tensors)):
        raise ValueError(
            "embed_bag: expected contiguous CUDA tensors on one device: "
            "int32[B, hot] idx, float32 or bf16 [V, D] table, float32[B, hot] "
            "weights or None; got " + ", ".join(
                f"dtype={t.dtype} shape={tuple(t.shape)} device={t.device} "
                f"contiguous={t.is_contiguous()}" for t in tensors))
    (b, hot), (v, d) = idx.shape, table.shape
    out = table.new_empty((b, d))
    if out.numel() == 0:
        return out
    if hot == 0:
        return out.zero_()
    fn = build.function("embed_bag", "embed_bag", _ARGTYPES["embed_bag"])
    rc = fn(idx.data_ptr(), None if weights is None else weights.data_ptr(),
            table.data_ptr(), out.data_ptr(), b, v, hot, d,
            _IS_BF16[table.dtype], int(mean), idx.device.index,
            torch.cuda.current_stream(idx.device).cuda_stream)
    build.check("embed_bag", rc)
    embed_bag.launches += 1
    return out


embed_bag.launches = 0
