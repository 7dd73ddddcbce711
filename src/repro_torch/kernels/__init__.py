"""Hand-written Hopper kernels for the RST pipeline's hot spots.

Each kernel lives in its own subpackage, the same layout as
``repro.kernels``:
  csrc/<name>.cu — the CUDA C++ source for ``sm_90a`` (plain C interface);
  ops.py         — the wrapper: checks, allocation, launch, launch counter;
  ref.py         — the plain PyTorch version (CPU path and on-card oracle).

Kernels:
  pointer_jump    k doubling steps ``t = t[t]`` (one launch per step), and
                  the chain variant, k + 1 hops against a fixed table.
  list_rank       k Wyllie steps on (succ, dist) (one launch per step), and
                  the chain variant, (k + 1)-hop prefix sums in one launch.
  hook_edges      per half-edge hook proposal (tgt, val) under min/max hooking.
  frontier_relax  the BFS frontier-expansion mask of one level.
  segment_table   the [levels + 1, n] min/max doubling sparse table (one
                  launch per level).

``build.py`` compiles the sources with ``nvcc`` on first use and loads them
through ``ctypes``.

Dispatch (``kernel_wanted``) replaces ``repro.kernels.auto_interpret``: every
wrapper takes ``use_kernel: bool | None``. ``None`` launches the kernel for a
CUDA tensor and runs the plain version for a CPU tensor; ``True`` on a CPU
tensor raises; ``False`` runs the plain version on either device. A kernel
that fails to build or launch raises; nothing swaps in the plain version.
"""
from __future__ import annotations

import torch


def kernel_wanted(t: torch.Tensor, use_kernel: bool | None) -> bool:
    """Resolve a wrapper's ``use_kernel`` argument for tensor ``t``."""
    if use_kernel is None:
        return t.is_cuda
    if use_kernel and not t.is_cuda:
        raise ValueError(
            f"use_kernel=True needs a CUDA tensor, got one on {t.device}; "
            "pass use_kernel=None or False to run the plain version")
    return bool(use_kernel)


def check_int32_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous 1-D int32 CUDA tensor on
    one device (what the kernels' C interfaces take)."""
    dev = tensors[0].device
    for t in tensors:
        if not (t.is_cuda and t.dtype == torch.int32 and t.dim() == 1
                and t.is_contiguous() and t.device == dev):
            raise ValueError(
                f"{name}: expected contiguous 1-D int32 tensors on one CUDA "
                f"device, got dtype={t.dtype} shape={tuple(t.shape)} "
                f"device={t.device} contiguous={t.is_contiguous()}")
