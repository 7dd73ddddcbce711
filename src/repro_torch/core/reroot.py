"""Path-reversal re-rooting (the PR-RST primitive, paper §III-C).

The port of ``repro.core.reroot``. Re-rooting a tree at vertex u is one
O(log n)-depth data-parallel operation: mark every vertex on the u → root
parent path with doubling tables, then flip the marked parent pointers in
one masked scatter. PR-RST's rounds and, later, the batch-dynamic layer's
edge insertions (DESIGN.md §9) both call it.

  * ``ancestor_tables`` / ``mark_paths`` / ``reverse_and_graft``: the
    doubling-table path marking and the masked-scatter reversal, with the
    adaptive level count (one host read of ``any(valid)`` per level);
  * ``link_components``: one batched link round. Every moving component
    picks one winning candidate edge (deterministic scatter-min), re-roots
    itself at that edge's ``start`` and grafts onto ``target``; the
    representative array is kept by one compression of the component-level
    overlay.

Every ``mode="drop"`` scatter of the reference writes here into n extra
slots spread by slot id (``n + i % n``), cut off after. Each real slot
still has at most one writer (one winner per mover, one path per
component), so ``index_put_``'s unordered writes give the reference's
values; a single drop slot would funnel every inactive writer onto one
address on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.compress import DEFAULT_JUMPS, compress_full

INF32 = torch.iinfo(torch.int32).max


def _drop_slots(m: int, n: int, device) -> torch.Tensor:
    """int64[m] extra slots ``n + i % n`` for the inactive writers of a
    scatter into a table of n, extended to 2n and cut back after."""
    return n + torch.arange(m, dtype=torch.int64, device=device) % max(n, 1)


def _scatter_set(n: int, fill, idx: torch.Tensor, values, dtype
                 ) -> torch.Tensor:
    """A table of n filled with ``fill``, then ``table[idx] = values`` where
    ``idx`` holds real slots in [0, n) or drop slots in [n, 2n)."""
    out = torch.full((2 * n,), fill, dtype=dtype, device=idx.device)
    out[idx] = values
    return out[:n]


def ancestor_tables(p: torch.Tensor, levels: int):
    """Doubling tables (anc, pred, valid), each [levels, n], plus ``used``.

    anc[k][v]   = ancestor of v at distance exactly 2^k (if valid[k][v]).
    pred[k][v]  = the path vertex immediately below anc[k][v].
    valid[k][v] = depth(v) >= 2^k.

    Only the first ``used`` levels are filled: the build stops as soon as
    ``valid`` is all false, one host read per level. Levels ≥ ``used`` are
    zero and must not be consulted.
    """
    n = p.numel()
    verts = torch.arange(n, dtype=torch.int32, device=p.device)
    anc, pred, valid = p, verts, p != verts
    ancs = torch.zeros((levels, n), dtype=torch.int32, device=p.device)
    preds = torch.zeros((levels, n), dtype=torch.int32, device=p.device)
    valids = torch.zeros((levels, n), dtype=torch.bool, device=p.device)
    used = 0
    while used < levels and bool(torch.any(valid)):
        ancs[used], preds[used], valids[used] = anc, pred, valid
        hop = anc.long()
        anc, pred, valid = anc[hop], pred[hop], valid & valid[hop]
        used += 1
    return ancs, preds, valids, used


def mark_paths(p: torch.Tensor, starts: torch.Tensor, active: torch.Tensor,
               levels: int):
    """Mark every vertex on the root path of each active start vertex.

    Returns (mark: bool[n], prednode: int32[n]); prednode[w] is the path
    vertex immediately below w (valid where mark and w is not a start).
    """
    n = p.numel()
    dev = p.device
    ancs, preds, valids, used = ancestor_tables(p, levels)

    # Both tables are extended by n drop slots for the whole loop.
    mark = torch.zeros((2 * n,), dtype=torch.bool, device=dev)
    mark[torch.where(active, starts.long(),
                     _drop_slots(starts.numel(), n, dev))] = True
    prednode = torch.full((2 * n,), -1, dtype=torch.int32, device=dev)

    # Marked vertices lie on one path per tree, at distinct depths, so
    # their ancestors at distance 2^k are distinct: one writer per slot.
    vdrop = _drop_slots(n, n, dev)
    for k in range(used):
        tgt = torch.where(mark[:n] & valids[k], ancs[k].long(), vdrop)
        mark[tgt] = True
        prednode[tgt] = preds[k]
    return mark[:n], prednode[:n]


def reverse_and_graft(p: torch.Tensor, mark: torch.Tensor,
                      prednode: torch.Tensor, starts: torch.Tensor,
                      grafts: torch.Tensor, active: torch.Tensor
                      ) -> torch.Tensor:
    """Flip parent pointers along marked paths; set P[start] = graft."""
    n = p.numel()
    sidx = torch.where(active, starts.long(),
                       _drop_slots(starts.numel(), n, p.device))
    is_start = _scatter_set(n, False, sidx, True, torch.bool)
    flip = mark & ~is_start & (prednode >= 0)
    p = torch.cat([torch.where(flip, prednode, p), torch.zeros_like(p)])
    p[sidx] = torch.where(active, grafts, 0).to(p.dtype)
    return p[:n]


def link_components(p: torch.Tensor, rt: torch.Tensor, start: torch.Tensor,
                    target: torch.Tensor, cand: torch.Tensor, *, levels: int,
                    n_jumps: int = DEFAULT_JUMPS,
                    use_kernel: bool | None = None,
                    return_syncs: bool = False):
    """One batched link round: re-root + graft one winning edge per mover.

    For every candidate edge e, the component of ``start[e]`` is the mover:
    it re-roots itself at ``start[e]`` and grafts onto ``target[e]``. Each
    moving component gets exactly one winner (scatter-min on edge slot id).

    Preconditions (the caller's contract, as in the reference):
      * ``rt == roots_of(p)``;
      * ``rt[start[e]] != rt[target[e]]`` for every candidate e;
      * the move relation follows a strict total order on components,
        fixed for the round, so the component-level overlay is acyclic.

    Returns ``(p', rt', is_winner)`` with ``rt' == roots_of(p')`` kept by
    one ``compress_full`` of the component overlay (pointer_jump kernel on
    the card) and one gather; with ``return_syncs`` the overlay
    compression's convergence checks are appended.
    """
    n = p.numel()
    m = start.numel()
    dev = p.device
    eid = torch.arange(m, dtype=torch.int32, device=dev)
    verts = torch.arange(n, dtype=torch.int32, device=dev)
    drop = _drop_slots(m, n, dev)

    mover = rt[torch.clamp(start, 0, n - 1)]

    # One winning edge per moving component (deterministic scatter-min).
    win = torch.full((2 * n,), INF32, dtype=torch.int32, device=dev)
    win.scatter_reduce_(0, torch.where(cand, mover.long(), drop),
                        torch.where(cand, eid, INF32), "amin")
    is_winner = cand & (win[mover] == eid)

    # Per component (indexed by moving root): start and graft vertices.
    widx = torch.where(is_winner, mover.long(), drop)
    comp_start = _scatter_set(n, -1, widx, start, torch.int32)
    comp_graft = _scatter_set(n, -1, widx, target, torch.int32)
    comp_active = comp_start >= 0

    mark, prednode = mark_paths(p, comp_start, comp_active, levels)
    p_next = reverse_and_graft(p, mark, prednode, comp_start, comp_graft,
                               comp_active)

    # Moving root m joins the component of rt[t]; the move order is strict
    # within a round, so the overlay is an acyclic forest of components.
    graft_root = rt[torch.clamp(comp_graft, 0, n - 1)]
    overlay = torch.where(comp_active, graft_root, verts)
    comp_rt, syncs = compress_full(overlay, n_jumps=n_jumps,
                                   use_kernel=use_kernel, return_syncs=True)
    rt_next = comp_rt[rt]
    if return_syncs:
        return p_next, rt_next, is_winner, syncs
    return p_next, rt_next, is_winner
