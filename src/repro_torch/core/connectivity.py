"""GConn-style connectivity with spanning-forest extraction.

The port of ``repro.core.connectivity`` (the paper's §III-B): rounds of
*hooking* then full *shortcutting*. Each successful hook marks one spanning
edge, so connectivity yields an unrooted spanning forest that
``core.euler`` roots.

Per round:
  * hook proposals per half-edge from the ``hook_edges`` kernel (the
    reference inlines the same computation);
  * stage 1: scatter-min (or max) of the proposals per target root, one
    ``scatter_reduce_``; min and max are order-free, so the result is
    bit-equal to the reference's ``.at[].min``;
  * stage 2: the winning half-edge per hooked root, deduped on canonical
    undirected ids (e % M), so one undirected edge is marked at most once;
  * ``compress_full`` to convergence.

Pure-min hooking is the default; ``alternate_hooking=True`` keeps the
paper's min/max alternation for the ablation (DESIGN.md §2).
"""
from __future__ import annotations

import torch

from repro_torch.core.compress import compress_full
from repro_torch.core.graph import Graph
from repro_torch.kernels.hook_edges.ops import hook_edges

INF32 = torch.iinfo(torch.int32).max


def pointer_jump_full(p: torch.Tensor, *,
                      use_kernel: bool | None = None) -> torch.Tensor:
    """Jump ``p[i] = p[p[i]]`` until convergence (full path compression)."""
    return compress_full(p, use_kernel=use_kernel)


def connected_components(graph: Graph, *, max_rounds: int | None = None,
                         use_kernel: bool | None = None,
                         alternate_hooking: bool = False,
                         return_syncs: bool = False):
    """Connectivity + spanning forest via alternating hook / compress rounds.

    Inputs may carry parallel edges and self-loops; at most one half-edge
    per undirected edge is marked and self-loops never are. A ``padded``
    graph's ids outside [0, n) are clamped into it first (``Graph.clamped``).

    Returns:
      rep:         int32[n] component representative per vertex (a root id).
      forest_mask: bool[2M]; True for the canonical half (e < M) of each
                   spanning-forest edge; n - n_components are set.
      rounds:      int, hook/compress rounds executed minus one, as in the
                   reference.
      syncs:       with ``return_syncs``, the convergence checks of every
                   ``compress_full`` call, summed (the pointer_jump kernel
                   launches once per check).
    """
    # A sentinel row (n, n) of a padded graph reads vertex n - 1 twice in
    # the reference, so it never crosses, hooks or wins; clamped, it is
    # that self-loop, and no id that reaches hook_edges lies outside rep.
    graph = graph.clamped()
    n = graph.n_nodes
    src, dst = graph.src, graph.dst
    dev = src.device
    m2 = src.numel()
    m = m2 // 2
    edge_id = torch.arange(m2, dtype=torch.int32, device=dev)
    canonical = edge_id < m
    eid_canon = torch.where(canonical, edge_id, edge_id - m)
    # Non-crossing edges scatter the op's identity (a no-op) into n extra
    # slots, spread by edge id, that are cut off. Where the reference
    # sends them (their shared root), or any one slot, or their source
    # vertex (a power-law hub), the atomics behind scatter_reduce_ queue
    # on one address on the card.
    drop = n + edge_id.long() % max(n, 1)

    p = torch.arange(n, dtype=torch.int32, device=dev)
    forest = torch.zeros(m2, dtype=torch.bool, device=dev)
    bound = n if max_rounds is None else max_rounds
    rnd, changed, syncs = 0, True, 0
    while changed and rnd < bound:
        use_min = (rnd % 2 == 0) if alternate_hooking else True
        tgt, val = hook_edges(src, dst, p, use_min, n_nodes=n,
                              use_kernel=use_kernel)
        cross = tgt != n
        idx = torch.where(cross, tgt.long(), drop)

        # Stage 1: hook every target root to the extreme proposal.
        init = INF32 if use_min else -1
        hooked = torch.full((2 * n,), init, dtype=torch.int32, device=dev)
        hooked.scatter_reduce_(0, idx, torch.where(cross, val, init),
                               "amin" if use_min else "amax")
        got_hook = hooked[:n] != init
        p_next = torch.where(got_hook, hooked[:n], p)

        # Stage 2: the smallest canonical edge id among the edges that
        # achieved their target's hook wins; only its canonical half is set.
        achieved = cross & (hooked[idx] == val)
        win = torch.full((2 * n,), INF32, dtype=torch.int32, device=dev)
        win.scatter_reduce_(0, idx, torch.where(achieved, eid_canon, INF32),
                            "amin")
        forest |= achieved & (win[idx] == eid_canon) & canonical

        p, s = compress_full(p_next, use_kernel=use_kernel, return_syncs=True)
        syncs += s
        changed = bool(torch.any(got_hook))
        rnd += 1
    if return_syncs:
        return p, forest, rnd - 1, syncs
    return p, forest, rnd - 1


def count_components(rep: torch.Tensor) -> int:
    """Number of distinct representatives (components)."""
    verts = torch.arange(rep.numel(), dtype=rep.dtype, device=rep.device)
    return int(torch.sum(rep == verts))
