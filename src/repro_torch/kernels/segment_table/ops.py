"""Wrapper for the segment_table kernel (``csrc/segment_table.cu``).

One call builds the whole [levels + 1, n] table: a device copy of the
values and one launch per doubling level, so ``segment_table.launches``
grows by ``levels`` a call. The query fold stays in
``repro_torch.core.compress.segment_reduce``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, kernel_wanted
from repro_torch.kernels.segment_table.ref import segment_table_ref

_ARGTYPES = {"segment_table": [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64] + [ctypes.c_int] * 4
             + [ctypes.c_void_p]}
_IS_FLOAT = {torch.int32: 0, torch.float32: 1}


def segment_table(values: torch.Tensor, *, levels: int, op: str,
                  use_kernel: bool | None = None) -> torch.Tensor:
    """[levels + 1, n] doubling sparse table over int32 or float32 ``values``.

    Row k holds ``op`` over ``values[i : min(i + 2^k, n)]``; ``op`` is
    ``"min"`` or ``"max"``. ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``.
    """
    if op not in ("min", "max"):
        raise ValueError(f"segment_table needs op 'min' or 'max', got {op!r}")
    if levels < 0:
        raise ValueError(f"segment_table: levels={levels} < 0")
    if not kernel_wanted(values, use_kernel):
        return segment_table_ref(values, levels=levels, op=op)
    if not (values.dtype in _IS_FLOAT and values.dim() == 1
            and values.is_contiguous()):
        raise ValueError(
            "segment_table: expected a contiguous 1-D int32 or float32 CUDA "
            f"tensor, got dtype={values.dtype} shape={tuple(values.shape)} "
            f"contiguous={values.is_contiguous()}")
    n = values.numel()
    table = values.new_empty((levels + 1, n))
    if n == 0:
        return table
    fn = build.function("segment_table", "segment_table",
                        _ARGTYPES["segment_table"])
    rc = fn(values.data_ptr(), table.data_ptr(), n, levels,
            _IS_FLOAT[values.dtype], int(op == "max"), values.device.index,
            torch.cuda.current_stream(values.device).cuda_stream)
    build.check("segment_table", rc)
    segment_table.launches += levels
    return table


segment_table.launches = 0
