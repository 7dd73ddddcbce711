"""Wrappers for the segment_table kernel (``csrc/segment_table.cu``).

One call builds the whole [levels + 1, n] table in two launches (the
first K levels in shared-memory tiles, the levels above from row K; K is 13,
or 11 below 264 tiles of 2^13 values), or one where ``levels <= K``;
``launches_per_call`` gives the count and ``segment_table.launches`` grows
by it. ``segment_table_stepwise`` is the
previous design (a device copy and one launch per level), kept only as a
yardstick: ``chip_smoke.py`` and the card tests call it, no function of
the package does. The query fold stays in
``repro_torch.core.compress.segment_reduce``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, kernel_wanted
from repro_torch.kernels.segment_table.ref import segment_table_ref

_ARGTYPES = {
    "segment_table": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "segment_table_stepwise": [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64] + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "segment_table_launches": [ctypes.c_int64, ctypes.c_int,
                               ctypes.c_void_p],
}
_IS_FLOAT = {torch.int32: 0, torch.float32: 1}


def _check(op: str, levels: int) -> None:
    if op not in ("min", "max"):
        raise ValueError(f"segment_table needs op 'min' or 'max', got {op!r}")
    if levels < 0:
        raise ValueError(f"segment_table: levels={levels} < 0")


def _launch(symbol: str, values: torch.Tensor, levels: int,
            op: str) -> torch.Tensor:
    if not (values.is_cuda and values.dtype in _IS_FLOAT
            and values.dim() == 1 and values.is_contiguous()):
        raise ValueError(
            "segment_table: expected a contiguous 1-D int32 or float32 CUDA "
            f"tensor, got dtype={values.dtype} shape={tuple(values.shape)} "
            f"device={values.device} contiguous={values.is_contiguous()}")
    table = values.new_empty((levels + 1, values.numel()))
    if values.numel():
        fn = build.function("segment_table", symbol, _ARGTYPES[symbol])
        rc = fn(values.data_ptr(), table.data_ptr(), values.numel(), levels,
                _IS_FLOAT[values.dtype], int(op == "max"),
                values.device.index,
                torch.cuda.current_stream(values.device).cuda_stream)
        build.check("segment_table", rc)
    return table


def launches_per_call(n: int, levels: int) -> int:
    """The launches one ``segment_table`` kernel call of ``n`` values and
    ``levels`` levels makes (0 for ``n == 0``); asks the built library."""
    if n == 0:
        return 0
    count = ctypes.c_int(0)
    fn = build.function("segment_table", "segment_table_launches",
                        _ARGTYPES["segment_table_launches"])
    build.check("segment_table", fn(n, levels, ctypes.addressof(count)))
    return count.value


def segment_table(values: torch.Tensor, *, levels: int, op: str,
                  use_kernel: bool | None = None) -> torch.Tensor:
    """[levels + 1, n] doubling sparse table over int32 or float32 ``values``.

    Row k holds ``op`` over ``values[i : min(i + 2^k, n)]``; ``op`` is
    ``"min"`` or ``"max"``. ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``.
    """
    _check(op, levels)
    if not kernel_wanted(values, use_kernel):
        return segment_table_ref(values, levels=levels, op=op)
    table = _launch("segment_table", values, levels, op)
    segment_table.launches += launches_per_call(values.numel(), levels)
    return table


segment_table.launches = 0


def segment_table_stepwise(values: torch.Tensor, *, levels: int,
                           op: str) -> torch.Tensor:
    """The previous design of ``segment_table`` on the card: a device copy
    of the values and one launch per level. Same table; a yardstick only."""
    _check(op, levels)
    table = _launch("segment_table_stepwise", values, levels, op)
    segment_table_stepwise.launches += levels if values.numel() else 0
    return table


segment_table_stepwise.launches = 0
