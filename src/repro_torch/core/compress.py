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
  * ``wyllie_rank(s, v)`` — list ranking with the same amortization;
  * ``segment_reduce``    — min/max over index ranges from a doubling
                            sparse table (⌈log2 n⌉ levels, no sync);
  * ``segment_reduce_scoped`` — the same for the active queries only,
                            building levels up to the longest of them.

A "sync" is one host read of a convergence flag (``.item()`` through
``bool``); on CUDA it is the device round-trip the paper counts. ``syncs``
counts loop bodies exactly as the reference does.

``use_kernel`` (``None`` | ``True`` | ``False``) follows
``repro_torch.kernels.kernel_wanted``: ``jump_k`` runs the pointer_jump
kernel, ``wyllie_rank`` the list_rank kernel and ``segment_reduce`` the
segment_table kernel on CUDA tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.list_rank.ops import list_rank_double_k
from repro_torch.kernels.pointer_jump.ops import pointer_jump_double_k
from repro_torch.kernels.segment_table.ops import segment_table
from repro_torch.kernels.segment_table.ref import segment_table_ref

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


def _table_levels(n: int) -> int:
    """Doubling levels of a sparse table over n values: ⌈log2 n⌉, at least 1."""
    return max(1, (n - 1).bit_length())


def _check_idempotent(op: str) -> None:
    if op not in ("min", "max"):
        raise ValueError(f"segment_reduce needs an idempotent op, got {op!r}")


def segment_reduce(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   op: str = "min", *,
                   use_kernel: bool | None = None) -> torch.Tensor:
    """Idempotent range reduction: out[q] = op over values[lo[q] .. hi[q]].

    Level k of the doubling (sparse) table holds op over
    ``values[i : i + 2^k]``; the ⌈log2 n⌉ levels are built with no
    convergence sync (the segment_table kernel on the card), and each query
    folds the two power-of-two windows covering [lo, hi], which overlap,
    hence the idempotency requirement. With ``values`` in preorder,
    subtree(v) is the query ``[pre[v], last[v]]`` (DESIGN.md §4).

    Args:
      values: int32 or float32 [n].
      lo, hi: int32[q] inclusive bounds, ``0 <= lo <= hi < n``.
      op: "min" or "max"; any other op raises.
      use_kernel: see the module docstring.

    Returns:
      [q] reductions, of the dtype of ``values``.
    """
    _check_idempotent(op)
    levels = _table_levels(values.numel())
    table = segment_table(values, levels=levels, op=op,
                          use_kernel=use_kernel)
    return _fold_queries(table, lo, hi, levels, _COMBINE[op])


def _fold_queries(table: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  levels: int, combine) -> torch.Tensor:
    """Fold the two power-of-two windows covering each [lo, hi] query.

    ``k = floor(log2(hi - lo + 1))``, integer-exact, capped at ``levels``
    and 0 for empty queries. Rows past the end of ``table`` read row 0 (the
    values), as the reference's unbuilt rows do. Indices are clamped into
    [0, n), as the reference's gathers clamp.
    """
    n = table.shape[1]
    length = hi - lo + 1
    pow2 = torch.bitwise_left_shift(
        torch.ones(levels + 1, dtype=length.dtype, device=length.device),
        torch.arange(levels + 1, dtype=length.dtype, device=length.device))
    k = torch.clamp(torch.searchsorted(pow2, length, right=True,
                                       out_int32=True) - 1, min=0)
    span = torch.bitwise_left_shift(torch.ones_like(k), k)
    row = torch.where(k < table.shape[0], k, 0).long() * n
    flat = table.reshape(-1)
    a = flat[row + torch.clamp(lo, 0, n - 1).long()]
    b = flat[row + torch.clamp(torch.maximum(hi - span + 1, lo), 0,
                               n - 1).long()]
    return combine(a, b)


def segment_reduce_scoped(values: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor, active: torch.Tensor,
                          op: str = "min", *, return_syncs: bool = False):
    """``segment_reduce`` for the ``active`` queries only.

    One host read of the longest active query, then only the levels that
    cover it: ``built = min(⌈log2 max_len⌉, levels)`` doubling steps
    instead of ⌈log2 n⌉, which is what makes a dirty small component cheap
    in a large graph (DESIGN.md §10). No kernel path, as in the reference:
    the level count depends on the data.

    Args:
      values, lo, hi, op: as ``segment_reduce``.
      active: bool[q]; inactive queries return a defined but arbitrary
        value (a fold over the levels built).
      return_syncs: also return ``built`` (int).

    Returns:
      [q] reductions (exact where ``active``), or ``(out, built)``.
    """
    _check_idempotent(op)
    levels = _table_levels(values.numel())
    max_len = 1
    if lo.numel():
        max_len = int(torch.max(torch.where(active, hi - lo + 1, 1)))
    built = min((max_len - 1).bit_length(), levels) if max_len > 1 else 0
    table = segment_table_ref(values, levels=built, op=op)
    out = _fold_queries(table, lo, hi, levels, _COMBINE[op])
    return (out, built) if return_syncs else out
