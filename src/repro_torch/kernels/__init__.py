"""Hand-written Hopper kernels: the RST pipeline's hot spots and DIEN's
embedding bag.

Each kernel lives in its own subpackage, the same layout as
``repro.kernels``:
  csrc/<name>.cu — the CUDA C++ source for ``sm_90a`` (plain C interface);
  ops.py         — the wrapper: checks, allocation, launch, launch counter;
  ref.py         — the plain PyTorch version (CPU path and on-card oracle).

Kernels:
  pointer_jump    k doubling steps ``t = t[t]`` (one cooperative launch
                  with the convergence flag fused), and the chain variant,
                  k + 1 hops against a fixed table (one cooperative launch
                  that composes them from squarings, on the plan of
                  ``hops.py``).
  list_rank       k Wyllie steps on (succ, dist) (one cooperative launch
                  with the "any list open" flag fused), and the chain
                  variant, (k + 1)-hop prefix sums (one cooperative launch,
                  squarings on packed (succ, dist) pairs).
  hook_edges      per half-edge hook proposal (tgt, val) under min/max hooking.
  frontier_relax  the BFS frontier-expansion mask of one level, and the
                  whole level (``bfs_level``: the mask, the parent
                  scatter-min and the updates in two launches, with the
                  "anything discovered" flag), which BFS runs.
  segment_table   the [levels + 1, n] min/max doubling sparse table (two
                  launches: the first 13 levels, or 11 for n below
                  2,162,688, in shared-memory tiles, the rest from that
                  row; one where no level is left).
  embed_bag       fixed-hotness gather with a weighted sum or mean (DIEN's
                  multi-hot user profile; one launch on the plan of
                  ``embed_bag.ops.launch_plan``, one thread a chunk of a
                  row, a bag's row loads all in flight before its range
                  check, hot 4 and 8 unrolled at compile time).

``build.py`` compiles the sources with ``nvcc`` on first use and loads them
through ``ctypes``. ``hops.py`` plans the chain kernels' passes.

Dispatch (``kernel_wanted``) replaces ``repro.kernels.auto_interpret``: every
wrapper takes ``use_kernel: bool | None``. ``None`` launches the kernel for a
CUDA tensor and runs the plain version for a CPU tensor; ``True`` on a CPU
tensor raises; ``False`` runs the plain version on either device. A kernel
that fails to build or launch raises; nothing swaps in the plain version.

``plain_as_kernel`` runs a wrapper's plain version where the card would
launch its kernel; while ``launch.cost_analysis`` counts a step (its
hook set by ``set_cost_hook``), the call counts as the one launch.

Not ported, as TPU plumbing with no counterpart here: the reference's
``pad_to_tile`` (the (8, 128) TPU tile), ``auto_interpret`` and
``core.compress.default_interpret`` (Pallas interpret mode off the TPU);
``kernel_wanted`` takes their place.
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


_COST_HOOK = None


def set_cost_hook(hook):
    """Install ``hook(name, run, inputs)`` (None: none); returns the one it
    replaces. ``launch.cost_analysis`` sets it while it counts a step."""
    global _COST_HOOK
    prev, _COST_HOOK = _COST_HOOK, hook
    return prev


def plain_as_kernel(name: str, run, *inputs):
    """``run()``, the plain version of kernel ``name`` on ``inputs``, where
    the card would launch the kernel: under the cost hook it is counted as
    that launch (its boundary's bytes, not its intermediate ops)."""
    if _COST_HOOK is None:
        return run()
    return _COST_HOOK(name, run, inputs)
