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

``lanes=T`` (the convergence loops and ``segment_reduce_scoped``) runs the
call over a disjoint union of T equal lanes, lane t holding entries
``[t·L, (t+1)·L)`` and never pointing outside them (the fleet's and
``bcc_batch``'s layout). A converged lane is a fixed point of every step,
so the loop runs until the slowest lane converges, with the same host
reads as one call, and each lane's values are those of a call of its own.
``syncs`` then comes back as int32[T]: each lane's own count, as the
reference's vmapped ``while_loop`` keeps it, accumulated on the device
from per-lane flags (row reductions over the [T, L] view).

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
from repro_torch.kernels.segment_table.ref import (maximum, minimum,
                                                   segment_table_ref)

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


def _lane_any(x: torch.Tensor, lanes: int) -> torch.Tensor:
    """bool[lanes]: any True in each lane of the union mask ``x``."""
    return x.view(lanes, -1).any(1)


def compress_full(p: torch.Tensor, *, n_jumps: int = DEFAULT_JUMPS,
                  use_kernel: bool | None = None, return_syncs: bool = False,
                  max_syncs: int | None = None, lanes: int | None = None):
    """Fully compress ``p`` (every entry ends on its chain's fixed point).

    Args:
      p: int32[n] parent table; roots self-point. Odd cycles never converge
         (bound the loop with ``max_syncs``) and even cycles collapse to
         spurious fixed points; see ``validate.reaches_root``.
      n_jumps: doubling steps chained between convergence checks.
      use_kernel: see the module docstring.
      return_syncs: also return the number of convergence checks (int).
      max_syncs: optional bound on convergence checks.
      lanes: see the module docstring (syncs int32[lanes]).

    Returns:
      compressed table, or ``(compressed, syncs)`` if ``return_syncs``.
    """
    q, changed, syncs = p, True, 0
    # A lane counts the first check, then one more for every group that
    # still changed it.
    lane_syncs = (torch.ones(lanes, dtype=torch.int32, device=p.device)
                  if lanes is not None and return_syncs else None)
    while changed and (max_syncs is None or syncs < max_syncs):
        # The group's flag, any(q2 != q), comes with the table (fused into
        # the kernel's last step on the card): one host read per group.
        q2, flag = pointer_jump_double_k(q, n_jumps=n_jumps,
                                         use_kernel=use_kernel,
                                         return_changed=True)
        if lane_syncs is not None:
            lane_syncs += _lane_any(q2 != q, lanes)
        q = q2
        changed, syncs = bool(flag), syncs + 1
    if lane_syncs is not None:
        syncs = lane_syncs
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


_COMBINE = {"add": torch.add, "min": minimum, "max": maximum}


def reduce_to_root(parent: torch.Tensor, payload: torch.Tensor,
                   op: str = "add", *, n_jumps: int = DEFAULT_JUMPS,
                   return_syncs: bool = False, lanes: int | None = None):
    """Pointer doubling with a payload combine along every v→root path.

    Returns ``(red, root)``: red[v] = ``op`` over the payload of every vertex
    from v to its root (both inclusive), root[v] = the chain's fixed point;
    plus ``syncs`` if requested. For ``op="add"`` the payload at roots must
    be 0. ``parent`` must be an acyclic self-rooted forest. ``lanes``: see
    the module docstring (a converged lane's steps fold its roots' 0).
    """
    combine = _COMBINE[op]
    red, hop, changed, syncs = payload, parent, True, 0
    if lanes is not None:
        lane_open = torch.ones(lanes, dtype=torch.bool, device=parent.device)
        lane_syncs = torch.zeros(lanes, dtype=torch.int32,
                                 device=parent.device)
    while changed:
        for _ in range(n_jumps):
            red = combine(red, red[hop])
            hop = hop[hop]
        if lanes is None:
            changed = bool(torch.any(hop != hop[hop]))
        else:
            lane_syncs += lane_open
            lane_open = _lane_any(hop != hop[hop], lanes)
            changed = bool(lane_open.any())
        syncs += 1
    if lanes is not None:
        syncs = lane_syncs
    # The loop may stop with red[v] covering [v, root) only; one more fold
    # of red[hop] (= payload[root] at the fixed point) closes the interval.
    red = combine(red, red[hop])
    return (red, hop, syncs) if return_syncs else (red, hop)


def rank_to_root(parent: torch.Tensor, *, n_jumps: int = DEFAULT_JUMPS,
                 return_syncs: bool = False, lanes: int | None = None):
    """``(depth, root)`` per vertex of a self-rooted acyclic parent table."""
    verts = torch.arange(parent.numel(), dtype=parent.dtype,
                         device=parent.device)
    depth0 = (parent != verts).to(torch.int32)
    return reduce_to_root(parent, depth0, "add", n_jumps=n_jumps,
                          return_syncs=return_syncs, lanes=lanes)


def wyllie_rank(succ: torch.Tensor, valid: torch.Tensor, *,
                n_jumps: int = DEFAULT_JUMPS, use_kernel: bool | None = None,
                return_syncs: bool = False, lanes: int | None = None):
    """Wyllie list ranking: d[e] = number of list elements after e.

    Args:
      succ: int32[n] successor table; −1 ends a list. Disjoint lists rank
        independently.
      valid: bool[n] slot validity (invalid slots rank 0).
      lanes: see the module docstring (syncs int32[lanes]).

    The convergence flag is read before the first group, as in both paths
    of the reference, so ``syncs`` counts groups of ``n_jumps`` steps.

    Returns:
      int32[n] distances to each element's own list end, or ``(d, syncs)``.
    """
    d = (valid & (succ != NO_SUCC)).to(torch.int32)
    s, syncs = succ, 0
    # The first check reads the input; each later one the group's flag,
    # any(s != -1), which comes with the tables (fused into the kernel's
    # last step on the card).
    if lanes is None:
        still_open = bool(torch.any(s != NO_SUCC))
    else:
        # A lane counts the groups that start with a list of it open.
        lane_open = _lane_any(s != NO_SUCC, lanes)
        lane_syncs = torch.zeros(lanes, dtype=torch.int32, device=s.device)
        still_open = bool(lane_open.any())
    while still_open:
        s, d, flag = list_rank_double_k(s, d, n_steps=n_jumps,
                                        use_kernel=use_kernel,
                                        return_open=True)
        if lanes is not None:
            lane_syncs += lane_open
            lane_open = _lane_any(s != NO_SUCC, lanes)
        still_open, syncs = bool(flag), syncs + 1
    if lanes is not None:
        syncs = lane_syncs
    return (d, syncs) if return_syncs else d


def _table_levels(n: int) -> int:
    """Doubling levels of a sparse table over n values: ⌈log2 n⌉, at least 1."""
    return max(1, (n - 1).bit_length())


def _check_idempotent(op: str) -> None:
    if op not in ("min", "max"):
        raise ValueError(f"segment_reduce needs an idempotent op, got {op!r}")


def segment_reduce(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   op: str = "min", *, use_kernel: bool | None = None,
                   levels: int | None = None) -> torch.Tensor:
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
      levels: table levels, ⌈log2 n⌉ by default; a disjoint union of
        lanes of L values passes ⌈log2 L⌉, since no query spans lanes.

    Returns:
      [q] reductions, of the dtype of ``values``.
    """
    _check_idempotent(op)
    if levels is None:
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
                          op: str = "min", *, return_syncs: bool = False,
                          lanes: int | None = None):
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
      lanes: T lanes of L values and L queries each (see the module
        docstring): one host read of the T longest active queries, levels
        capped at ⌈log2 L⌉, the table built to the largest lane's count,
        and ``built`` int32[T], each lane's own. Only inactive queries,
        which are arbitrary, see the other lanes' extra levels.

    Returns:
      [q] reductions (exact where ``active``), or ``(out, built)``.
    """
    _check_idempotent(op)

    def levels_for(max_len: int) -> int:
        return min((max_len - 1).bit_length(), levels) if max_len > 1 else 0

    lens = torch.where(active, hi - lo + 1, 1)
    if lanes is not None:
        levels = _table_levels(values.numel() // lanes)
        lane_built = [levels_for(m) for m in
                      torch.amax(lens.view(lanes, -1), 1).tolist()]
        built = max(lane_built)
    else:
        levels = _table_levels(values.numel())
        max_len = int(torch.max(lens)) if lo.numel() else 1
        built = levels_for(max_len)
    table = segment_table_ref(values, levels=built, op=op)
    out = _fold_queries(table, lo, hi, levels, _COMBINE[op])
    if lanes is not None:
        built = torch.tensor(lane_built, dtype=torch.int32,
                             device=values.device)
    return (out, built) if return_syncs else out
