"""Path-Reversal Rooted Spanning Tree (PR-RST, Cong & Bader), paper §III-C.

The port of ``repro.core.pr_rst``. PR-RST keeps a valid rooted forest
``P`` at all times. Each round every component picks one cross edge
(u, v), re-roots its own tree at u by reversing the parent path u → r, and
grafts via ``P[u] = v``. The winner selection, the doubling-table path
marking, the reversal, the graft and the incremental representatives all
live in ``core.reroot.link_components``; this module keeps the hooking
policy and the round loop, one host read of ``any(is_winner)`` per round.

The returned P is rooted wherever the last surviving component root
happened to be; a final path reversal re-roots it at the designated root.
"""
from __future__ import annotations

import torch

from repro_torch.core.compress import DEFAULT_JUMPS
from repro_torch.core.graph import Graph
from repro_torch.core.reroot import (link_components, mark_paths,
                                     reverse_and_graft)


def _pr_rst_round(p, rt, rnd: int, src, dst, *, levels: int,
                  alternate_hooking: bool = False,
                  n_jumps: int = DEFAULT_JUMPS,
                  use_kernel: bool | None = None):
    """One hook / mark / reverse / graft round.

    Precondition: ``rt == roots_of(p)``. The mover side of each cross edge
    is chosen by root-id order (min-hooking, or the paper's min/max
    alternation); root-id order is strict within a round, so the component
    overlay stays acyclic. Returns ``(p_next, rt_next, hooked, syncs)``:
    ``hooked`` a bool tensor, ``syncs`` the overlay compression's checks.
    """
    ru = rt[src]
    rv = rt[dst]
    cross = ru != rv
    use_min = (rnd % 2 == 0) if alternate_hooking else True
    mover = torch.maximum(ru, rv) if use_min else torch.minimum(ru, rv)
    is_u_mover = mover == ru
    start = torch.where(is_u_mover, src, dst)    # u_i, the grafted vertex
    target = torch.where(is_u_mover, dst, src)   # v_i, the graft destination

    p_next, rt_next, is_winner, syncs = link_components(
        p, rt, start, target, cross, levels=levels, n_jumps=n_jumps,
        use_kernel=use_kernel, return_syncs=True)
    return p_next, rt_next, torch.any(is_winner), syncs


def pr_rst(graph: Graph, root, *, max_rounds: int | None = None,
           alternate_hooking: bool = False, use_kernel: bool | None = None,
           n_jumps: int = DEFAULT_JUMPS, return_syncs: bool = False):
    """PR-RST: a rooted spanning tree in O(log² n) parallel depth.

    Returns:
      parent: int32[n], a valid rooted tree per component; the component of
              ``root`` is rooted at ``root``, the others at an arbitrary
              vertex; isolated vertices point at themselves.
      rounds: int, rounds run minus one, as in the reference.
      syncs:  with ``return_syncs``, the convergence checks of every
              round's overlay compression, summed (the pointer_jump kernel
              launches ``n_jumps`` times per check).
    """
    n = graph.n_nodes
    src, dst = graph.src, graph.dst
    dev = src.device
    levels = max(1, (n - 1).bit_length())
    root = int(root)

    p = torch.arange(n, dtype=torch.int32, device=dev)
    rt = p
    bound = n if max_rounds is None else max_rounds
    rnd, changed, syncs = 0, True, 0
    while changed and rnd < bound:
        p, rt, hooked, s = _pr_rst_round(
            p, rt, rnd, src, dst, levels=levels,
            alternate_hooking=alternate_hooking, n_jumps=n_jumps,
            use_kernel=use_kernel)
        syncs += s
        changed = bool(hooked)
        rnd += 1

    # Final re-root at the designated root: one more path reversal. The
    # reference passes n slots with only slot 0 active; one slot gives the
    # same tree.
    start = torch.full((1,), root, dtype=torch.int32, device=dev)
    active = torch.ones((1,), dtype=torch.bool, device=dev)
    mark, prednode = mark_paths(p, start, active, levels)
    p = reverse_and_graft(p, mark, prednode, start, start, active)
    return (p, rnd - 1, syncs) if return_syncs else (p, rnd - 1)
