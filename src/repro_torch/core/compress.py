"""Pointer-compression engine: every O(log n) jump phase of the pipeline.

The port of ``repro.core.compress`` (DESIGN.md §3), for the functions the
GConn + Euler path needs:

  * ``jump_k(p, k)``      — k chained doubling steps, no convergence check;
  * ``compress_full(p)``  — full path compression, ``n_jumps`` doubling steps
                            per convergence check, so a table of depth d
                            costs ⌈log2(d)/n_jumps⌉ + 1 checks;
  * ``roots_of(p)``       — alias of ``compress_full``;
  * ``compress_scoped``   — compress the active rows, freeze the rest;
  * ``reduce_to_root`` / ``rank_to_root`` — doubling with a payload combine;
  * ``wyllie_rank(s, v)`` — list ranking with the same amortization.

A "sync" is one host read of a convergence flag (``.item()`` through
``bool``); on CUDA it is the device round-trip the paper counts. ``syncs``
counts loop bodies exactly as the reference does.

``use_kernel`` (``None`` | ``True`` | ``False``) follows
``repro_torch.kernels.kernel_wanted``: ``jump_k`` runs the pointer_jump
kernel and ``wyllie_rank`` the list_rank kernel on CUDA tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.list_rank.ops import list_rank_double_k
from repro_torch.kernels.pointer_jump.ops import pointer_jump_double_k

NO_SUCC = -1

#: Doubling steps chained between convergence checks (paper's 5-jump trick).
DEFAULT_JUMPS = 5


def jump_k(p: torch.Tensor, n_jumps: int = DEFAULT_JUMPS, *,
           use_kernel: bool | None = None) -> torch.Tensor:
    """Apply ``p = p[p]`` ``n_jumps`` times: no convergence check, no sync.

    Each step doubles the compressed distance, so ``jump_k`` covers chains
    of depth up to ``2**n_jumps``. Functional: ``p`` is unchanged.
    """
    return pointer_jump_double_k(p, n_jumps=n_jumps, use_kernel=use_kernel)


def compress_full(p: torch.Tensor, *, n_jumps: int = DEFAULT_JUMPS,
                  use_kernel: bool | None = None, return_syncs: bool = False,
                  max_syncs: int | None = None):
    """Fully compress ``p`` (every entry ends on its chain's fixed point).

    Args:
      p: int32[n] parent table; roots self-point. Odd cycles never converge
         (bound the loop with ``max_syncs``) and even cycles collapse to
         spurious fixed points; see ``validate.reaches_root``.
      n_jumps: doubling steps chained between convergence checks.
      use_kernel: see the module docstring.
      return_syncs: also return the number of convergence checks (int).
      max_syncs: optional bound on convergence checks.

    Returns:
      compressed table, or ``(compressed, syncs)`` if ``return_syncs``.
    """
    q, changed, syncs = p, True, 0
    while changed and (max_syncs is None or syncs < max_syncs):
        q2 = jump_k(q, n_jumps, use_kernel=use_kernel)
        changed = bool(torch.any(q2 != q))
        q, syncs = q2, syncs + 1
    return (q, syncs) if return_syncs else q


def roots_of(p: torch.Tensor, **kwargs):
    """int32[n] root of every vertex's chain; alias of ``compress_full``."""
    return compress_full(p, **kwargs)


def compress_scoped(p: torch.Tensor, active: torch.Tensor, **kwargs):
    """Compress the ``active`` rows and freeze the rest.

    Inactive rows become self-loops before the loop, so the sync count
    depends only on the active chains. ``active`` must be closed under
    ``p``. Returns chain roots where ``active``, identity elsewhere. Same
    kwargs as ``compress_full``.
    """
    verts = torch.arange(p.numel(), dtype=p.dtype, device=p.device)
    return compress_full(torch.where(active, p, verts), **kwargs)


_COMBINE = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}


def reduce_to_root(parent: torch.Tensor, payload: torch.Tensor,
                   op: str = "add", *, n_jumps: int = DEFAULT_JUMPS,
                   return_syncs: bool = False):
    """Pointer doubling with a payload combine along every v→root path.

    Returns ``(red, root)``: red[v] = ``op`` over the payload of every vertex
    from v to its root (both inclusive), root[v] = the chain's fixed point;
    plus ``syncs`` if requested. For ``op="add"`` the payload at roots must
    be 0. ``parent`` must be an acyclic self-rooted forest.
    """
    combine = _COMBINE[op]
    red, hop, changed, syncs = payload, parent, True, 0
    while changed:
        for _ in range(n_jumps):
            red = combine(red, red[hop])
            hop = hop[hop]
        changed = bool(torch.any(hop != hop[hop]))
        syncs += 1
    # The loop may stop with red[v] covering [v, root) only; one more fold
    # of red[hop] (= payload[root] at the fixed point) closes the interval.
    red = combine(red, red[hop])
    return (red, hop, syncs) if return_syncs else (red, hop)


def rank_to_root(parent: torch.Tensor, *, n_jumps: int = DEFAULT_JUMPS,
                 return_syncs: bool = False):
    """``(depth, root)`` per vertex of a self-rooted acyclic parent table."""
    verts = torch.arange(parent.numel(), dtype=parent.dtype,
                         device=parent.device)
    depth0 = (parent != verts).to(torch.int32)
    return reduce_to_root(parent, depth0, "add", n_jumps=n_jumps,
                          return_syncs=return_syncs)


def wyllie_rank(succ: torch.Tensor, valid: torch.Tensor, *,
                n_jumps: int = DEFAULT_JUMPS, use_kernel: bool | None = None,
                return_syncs: bool = False):
    """Wyllie list ranking: d[e] = number of list elements after e.

    Args:
      succ: int32[n] successor table; −1 ends a list. Disjoint lists rank
        independently.
      valid: bool[n] slot validity (invalid slots rank 0).

    The convergence flag is read before the first group, as in both paths
    of the reference, so ``syncs`` counts groups of ``n_jumps`` steps.

    Returns:
      int32[n] distances to each element's own list end, or ``(d, syncs)``.
    """
    d = (valid & (succ != NO_SUCC)).to(torch.int32)
    s, syncs = succ, 0
    while bool(torch.any(s != NO_SUCC)):
        s, d = list_rank_double_k(s, d, n_steps=n_jumps,
                                  use_kernel=use_kernel)
        syncs += 1
    return (d, syncs) if return_syncs else d
