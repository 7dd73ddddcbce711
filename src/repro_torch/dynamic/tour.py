"""Incremental Euler-tour refresh for the batch-dynamic forest.

The port of ``repro.dynamic.tour``. ``euler.tour_numbering`` is the
substrate for biconnectivity and subtree queries, and its main cost is the
Wyllie list ranking, ⌈log2(longest tour)/k⌉ + 1 doubling syncs over 2n
slots. A batch usually touches a few components, so ``_merge_dirty``
renumbers only the dirty ones (``DynamicForest.dirty``), JaJa-style
(DESIGN.md §9):

  1. every clean vertex becomes a singleton in the parent array, so the
     ranking converges in ⌈log2(longest dirty tour)/k⌉ + 1 syncs;
  2. per-vertex preorder keys come from the fresh numbering for dirty
     vertices and from the cached one for clean vertices (the order within
     a clean component is unchanged);
  3. one stable sort of (component, key), packed into one int64 as
     ``tour_numbering`` packs its own, re-densifies the preorder; sizes
     carry over the same split.

The result is bit-equal to a full ``tour_numbering(parent)``.
``incremental=False`` forces the full recompute (the ablation switch).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.euler import TourNumbering, tour_numbering
from repro_torch.dynamic.forest import DynamicForest


def _clear_dirty(state: DynamicForest) -> DynamicForest:
    return dataclasses.replace(state, dirty=torch.zeros_like(state.dirty))


def _merge_dirty(parent: torch.Tensor, rep: torch.Tensor,
                 dirty: torch.Tensor, cached: TourNumbering, *,
                 use_kernel: bool | None = None,
                 return_syncs: bool = False):
    n = parent.numel()
    verts = torch.arange(n, dtype=torch.int32, device=parent.device)

    # Rank only the dirty sub-forest: clean vertices become singletons,
    # whose Euler lists are empty.
    masked = torch.where(dirty, parent, verts)
    fresh, syncs = tour_numbering(masked, use_kernel=use_kernel,
                                  return_syncs=True)

    # Preorder keys, fresh where dirty and cached where clean; both are in
    # [0, n) and injective within a component, and only ever compared
    # within one (the sort is component-major).
    key = torch.where(dirty, fresh.pre, cached.pre)
    order = torch.sort((rep.long() << 32) + key.long(), stable=True).indices
    pre = torch.empty(n, dtype=torch.int32, device=parent.device)
    pre[order] = verts
    size = torch.where(dirty, fresh.size, cached.size)
    tn = TourNumbering(pre=pre, size=size, last=pre + size - 1, comp=rep,
                       parent=parent)
    return (tn, syncs) if return_syncs else tn


def refresh_tour(state: DynamicForest,
                 cached: TourNumbering | None = None, *,
                 incremental: bool = True, use_kernel: bool | None = None):
    """Refresh the tour numbering after one or more ``apply_batch`` calls.

    A thin wrapper kept for the reference's callers: the canonical entry
    is ``dynamic.view.refresh_tour_once`` (or ``ForestView.refresh``).

    Args:
      state: the dynamic forest (its ``dirty`` mask names the components
        whose tree changed since ``cached`` was computed).
      cached: the numbering from the previous refresh; ``None`` forces a
        full recompute.
      incremental: ``False`` always recomputes from scratch.
      use_kernel: see ``repro_torch.kernels.kernel_wanted``.

    Returns:
      (numbering, state'), state' with its dirty mask cleared.
    """
    from repro_torch.dynamic.view import refresh_tour_once

    return refresh_tour_once(state, cached, incremental=incremental,
                             use_kernel=use_kernel)
