"""Batch-dynamic rooted spanning forest: state + update application.

The port of ``repro.dynamic.forest`` (DESIGN.md §9). The static pipelines
rebuild a tree from a frozen edge list; this module maintains one under an
edge-update stream. State is a ``DynamicForest``: the rooted parent array,
its component representatives (the invariant ``rep == roots_of(parent)``,
carried across batches), and a fixed-capacity undirected edge pool, the
live multigraph, of which the parent array is always a spanning forest.

``apply_batch`` processes one batch of insertions and deletions:

  * **Deletions** cut deleted tree edges in one masked scatter (the child
    endpoint becomes the root of its severed subtree) and re-establish the
    representatives with a compression scoped to the components that had a
    cut (``compress.compress_scoped``).
  * **Insertions** land in free pool slots: the first free slots come from
    a cumsum over the free mask and a binary search of it, with no host
    read (the reference's fixed-size ``nonzero`` has no sync-free twin in
    torch); overflow (pool full) is counted, never silent.
  * **The link loop** restores the spanning invariant: while a pool edge
    crosses two components, each smaller component (strict (size, root
    id) order, union by size) picks one winning edge, re-roots itself at
    that edge's endpoint and grafts (``core.reroot.link_components``). The
    loop is a host loop with one read a round, of "any edge crosses"
    (which holds exactly when the round links something), so a batch of r
    productive rounds pays r + 1 reads: the accounting ``replay`` records.
    Component sizes come from one sort of ``rep``, not a histogram: on a
    connected graph all n of a histogram's atomics land on one bin.

``apply_batch`` is functional: it never writes into the input state's
tensors, which ``dynamic.bcc.DynamicBCC`` and ``dynamic.queries`` keep as
snapshots and compare against.

Deletions address pool slots (``delete_mask``); ``edge_slots`` resolves a
batch of (u, v) pairs to slots, multiset-aware: k requests for one pair
claim k distinct parallel copies. Empty pool slots carry ``src = dst = n``,
as in the reference; ``live_graph`` marks its ``Graph`` as ``padded``.

Every ``mode="drop"`` scatter of the reference (inactive writers sent to
slot n) writes here into spread drop slots past the table's end, cut off
after (``core.reroot._drop_slots``): on the card, writers that share one
address queue on it.

``dirty`` marks vertices whose component's tree changed since the last
tour refresh (cuts, re-roots, grafts; not non-tree pool edits);
``dynamic.tour`` consumes and clears it. ``version`` is a host int, so a
query's staleness check reads nothing from the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.compress import DEFAULT_JUMPS, compress_scoped
from repro_torch.core.connectivity import connected_components
from repro_torch.core.euler import euler_tour_root
from repro_torch.core.graph import Graph, resolve_device
from repro_torch.core.reroot import _drop_slots, link_components


@dataclasses.dataclass(frozen=True)
class DynamicForest:
    """Rooted spanning forest of a dynamic edge multiset.

    Attributes:
      n_nodes:    vertex count n.
      parent:     int32[n] rooted forest; roots (and isolated vertices)
                  self-point. Always spans the pool graph's components.
      rep:        int32[n] component representative per vertex, the
                  invariant ``rep == roots_of(parent)``.
      pool_src, pool_dst: int32[capacity] live undirected edge pool; empty
                  slots carry the ``n_nodes`` sentinel.
      pool_valid: bool[capacity] slot occupancy.
      tree_mask:  bool[capacity], the slot is a spanning-forest edge
                  (exactly n − n_components slots; ≤ 1 per vertex pair).
      dirty:      bool[n], the vertex's component tree changed since the
                  last tour refresh (component-closed by construction).
      version:    host int, bumped by every ``apply_batch``. Derived
                  caches (``dynamic.queries.QuerySession``) stamp the
                  version they were built against (DESIGN.md §12).
    """

    n_nodes: int
    parent: torch.Tensor
    rep: torch.Tensor
    pool_src: torch.Tensor
    pool_dst: torch.Tensor
    pool_valid: torch.Tensor
    tree_mask: torch.Tensor
    dirty: torch.Tensor
    version: int

    @property
    def capacity(self) -> int:
        return self.pool_src.numel()

    @property
    def device(self) -> torch.device:
        return self.parent.device

    @property
    def n_components(self) -> torch.Tensor:
        """0-d int32: vertices that are their own representative."""
        verts = torch.arange(self.n_nodes, dtype=torch.int32,
                             device=self.device)
        return torch.sum(self.rep == verts, dtype=torch.int32)

    @property
    def n_live_edges(self) -> torch.Tensor:
        """0-d int32: occupied pool slots."""
        return torch.sum(self.pool_valid, dtype=torch.int32)


def _mark(size: int, idx: torch.Tensor, keep: torch.Tensor,
          base: torch.Tensor | None = None) -> torch.Tensor:
    """bool[size]: ``base`` (or all False) with True at ``idx`` where
    ``keep``; the other writers go to spread drop slots past the end.
    ``index_fill_`` takes the True as a kernel argument: assigned through a
    tensor index (``out[idx] = True``), a Python scalar is first copied to
    the card, one stream synchronization a call."""
    dev = idx.device
    out = torch.zeros(2 * size, dtype=torch.bool, device=dev)
    if base is not None:
        out[:size] = base
    out.index_fill_(0, torch.where(keep, idx.long(),
                                   _drop_slots(idx.numel(), size, dev)), True)
    return out[:size]


def _put(table: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """A copy of ``table`` [size] with ``table[idx] = values``, where
    ``idx`` holds real slots in [0, size) or drop slots in
    [size, size + idx.numel())."""
    size = table.numel()
    out = torch.cat([table, table.new_zeros(idx.numel())])
    out[idx] = values
    return out[:size]


def _first_true(mask: torch.Tensor, k: int) -> torch.Tensor:
    """int64[k]: the positions of the first k True entries of ``mask``,
    ``mask.numel()`` past the last (``jnp.nonzero(mask, size=k,
    fill_value=len)``). A cumsum and a binary search: no host read."""
    counts = torch.cumsum(mask, 0)
    want = torch.arange(1, k + 1, dtype=counts.dtype, device=mask.device)
    return torch.searchsorted(counts, want)


def _component_sizes(rt: torch.Tensor) -> torch.Tensor:
    """int32[n]: how many vertices have representative v, per v. Counted
    from the sorted representatives (as ``euler.tour_numbering`` counts
    its roots): a histogram's atomics would all land on one bin of a
    connected graph."""
    srt = torch.sort(rt).values
    verts = torch.arange(rt.numel(), dtype=rt.dtype, device=rt.device)
    return (torch.searchsorted(srt, verts, right=True, out_int32=True)
            - torch.searchsorted(srt, verts, out_int32=True))


def forest_empty(n_nodes: int, capacity: int, *,
                 device: str | torch.device | None = None) -> DynamicForest:
    """Edgeless forest over n vertices with an empty pool, on ``device``
    (the card unless the caller names another)."""
    dev = resolve_device(device)
    verts = torch.arange(n_nodes, dtype=torch.int32, device=dev)
    sent = torch.full((capacity,), n_nodes, dtype=torch.int32, device=dev)
    off = torch.zeros(capacity, dtype=torch.bool, device=dev)
    return DynamicForest(
        n_nodes=n_nodes, parent=verts, rep=verts.clone(), pool_src=sent,
        pool_dst=sent.clone(), pool_valid=off, tree_mask=off.clone(),
        dirty=torch.zeros(n_nodes, dtype=torch.bool, device=dev), version=0)


def forest_from_graph(graph: Graph, capacity: int | None = None,
                      root: int = 0, *, batch_hint: int = 16,
                      use_kernel: bool | None = None) -> DynamicForest:
    """Seed the dynamic state from a static graph (GConn + Euler build), on
    the graph's device.

    The pool holds the graph's M undirected edges in its first M slots.
    ``capacity`` must be ≥ M; the default leaves insertion headroom,
    ``max(M + 4 * batch_hint, ceil(1.25 * M))``. The forest is the GConn
    spanning forest rooted at ``root`` (its component) or at the
    component representatives (the others).
    """
    n = graph.n_nodes
    m = graph.n_edges
    dev = graph.device
    if capacity is None:
        capacity = max(m + 4 * batch_hint, -(-5 * m // 4))
    if capacity < m:
        raise ValueError(f"capacity {capacity} < graph edges {m}")

    rep, forest_mask, _ = connected_components(graph, use_kernel=use_kernel)
    t = max(n - 1, 1)
    m2 = graph.n_half_edges
    slots = _first_true(forest_mask, t)
    in_range = slots < m2
    # Slot m2 past the half-edges reads the sentinel n.
    sentinel = graph.src.new_full((1,), n)
    fu = torch.cat([graph.src, sentinel])[slots]
    fv = torch.cat([graph.dst, sentinel])[slots]
    comp_root = torch.where(rep == rep[root], root, rep).to(torch.int32)
    parent = euler_tour_root(n, fu, fv, in_range, comp_root,
                             use_kernel=use_kernel)

    pad = capacity - m
    sent = torch.full((pad,), n, dtype=torch.int32, device=dev)
    off = torch.zeros(pad, dtype=torch.bool, device=dev)
    # Winning half-edges are always canonical (e < M), so the undirected
    # tree mask is the first half of forest_mask.
    return DynamicForest(
        n_nodes=n, parent=parent, rep=comp_root,
        pool_src=torch.cat([graph.src[:m], sent]),
        pool_dst=torch.cat([graph.dst[:m], sent]),
        pool_valid=torch.cat([torch.ones(m, dtype=torch.bool, device=dev),
                              off]),
        tree_mask=torch.cat([forest_mask[:m], off]),
        dirty=torch.zeros(n, dtype=torch.bool, device=dev), version=0)


def live_graph(state: DynamicForest) -> Graph:
    """The pool as a sentinel-padded ``Graph`` (the from-scratch view):
    slot e < C is the pool direction src→dst, e + C its reverse, and
    empty slots are the row (n, n). The graph is ``padded``, so
    ``connected_components`` and ``rooted_spanning_tree`` clamp those rows
    to a self-loop, as the reference's gathers read them."""
    n = state.n_nodes
    u = torch.where(state.pool_valid, state.pool_src, n)
    v = torch.where(state.pool_valid, state.pool_dst, n)
    return Graph(n, torch.cat([u, v]), torch.cat([v, u]), padded=True)


def edge_slots(state: DynamicForest, del_u: torch.Tensor,
               del_v: torch.Tensor):
    """Resolve (u, v) deletion requests to pool slots, multiset-aware.

    The reference sorts pool slots and requests together by (lo, hi, is
    request, index), so within each equal-pair segment the pool copies come
    first, in slot order, then the requests, in input order, and the r-th
    request for a pair claims the r-th copy. Here the pool's keys
    ``lo·2^32 + hi`` are sorted once, stably (slot order within a pair), the
    requests' likewise (input order within a pair), and each request finds
    its pair's copies by binary search: the same claims, no scatter into
    one segment of the empty slots. Requests with no copy left (or sentinel
    padding ``u == n``) report not-found.

    Args:
      del_u, del_v: int32[D] endpoints; ``n_nodes`` marks padding slots.

    Returns:
      (delete_mask: bool[capacity], one True per matched request;
       found: bool[D], the request matched a live pool slot).
    """
    n = state.n_nodes
    cap = state.capacity
    dev = state.device
    d = del_u.numel()
    del_u = del_u.to(dev)
    del_v = del_v.to(dev)
    if cap == 0:
        return (torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(d, dtype=torch.bool, device=dev))

    q_ok = (del_u >= 0) & (del_v >= 0) & (del_u < n) & (del_v < n)
    qlo = torch.where(q_ok, torch.minimum(del_u, del_v), n).long()
    qhi = torch.where(q_ok, torch.maximum(del_u, del_v), n).long()
    plo = torch.where(state.pool_valid,
                      torch.minimum(state.pool_src, state.pool_dst), n)
    phi = torch.where(state.pool_valid,
                      torch.maximum(state.pool_src, state.pool_dst), n)
    pkey = (plo.long() << 32) + phi.long()
    qkey = (qlo << 32) + qhi

    psorted, porder = torch.sort(pkey, stable=True)
    qsorted, qorder = torch.sort(qkey, stable=True)
    # Each request's rank among the requests for its pair, in input order.
    pos = torch.arange(d, device=dev)
    rank = torch.empty(d, dtype=torch.int64, device=dev)
    rank[qorder] = pos - torch.searchsorted(qsorted, qsorted)
    # Its pair's copies: pool positions [first, first + c) in sorted order.
    first = torch.searchsorted(psorted, qkey)
    c = torch.searchsorted(psorted, qkey, right=True) - first
    matched = q_ok & (rank < c)
    claim = porder[torch.clamp(first + rank, 0, cap - 1)]
    return _mark(cap, claim, matched), matched


def apply_batch(state: DynamicForest, insert_src: torch.Tensor,
                insert_dst: torch.Tensor, delete_mask: torch.Tensor, *,
                max_rounds: int | None = None, n_jumps: int = DEFAULT_JUMPS,
                use_kernel: bool | None = None):
    """Apply one batch of edge deletions + insertions.

    Args:
      state: current forest (its invariants are the precondition); never
        written into.
      insert_src, insert_dst: int32[B] inserted undirected edges; slots
        with ``u == v`` or endpoints outside [0, n) are inert padding
        (use the ``n_nodes`` sentinel).
      delete_mask: bool[capacity] pool slots to delete (``edge_slots``
        resolves (u, v) pairs; already-empty slots are ignored).
      max_rounds: optional bound on productive link rounds. If it cuts the
        loop short, the spanning invariant is not restored and
        ``stats["pending"]`` counts the cross edges left unlinked.
      n_jumps: doubling steps between the engine's convergence checks.
      use_kernel: see ``repro_torch.kernels.kernel_wanted`` (the scoped
        compression and the link rounds' overlay compression run the
        pointer_jump kernel on the card).

    Returns:
      (state', stats): ``rounds`` (productive link rounds) is a host int;
      ``cuts`` (tree edges severed), ``links`` (components re-linked),
      ``overflow`` (insertions dropped, pool full) and ``pending`` (cross
      edges still unlinked) are 0-d int32 tensors, read by no one here.
    """
    n = state.n_nodes
    cap = state.capacity
    dev = state.device
    levels = max(1, (n - 1).bit_length())

    p, rt = state.parent, state.rep
    pool_src, pool_dst = state.pool_src, state.pool_dst
    pool_valid, tree_mask = state.pool_valid, state.tree_mask
    delete_mask = delete_mask.to(dev)
    insert_src = insert_src.to(dev, torch.int32)
    insert_dst = insert_dst.to(dev, torch.int32)

    # ---- deletions: cut tree edges, invalidate slots -----------------------
    del_mask = delete_mask & pool_valid
    del_tree = del_mask & tree_mask
    u_ = torch.clamp(pool_src, 0, n - 1)
    v_ = torch.clamp(pool_dst, 0, n - 1)
    child_is_v = p[v_.long()] == u_
    child = torch.where(child_is_v, v_, u_)
    other = torch.where(child_is_v, u_, v_)
    do_cut = del_tree & (child_is_v | (p[u_.long()] == v_))
    drop = _drop_slots(cap, n, dev)
    # A child has one parent edge, so each real slot has one writer.
    p = _put(p, torch.where(do_cut, child.long(), drop), child)
    touched = _mark(n, child, do_cut)
    touched = _mark(n, other, do_cut, touched)
    n_cuts = torch.sum(do_cut, dtype=torch.int32)

    pool_valid = pool_valid & ~del_mask
    tree_mask = tree_mask & ~del_mask
    pool_src = torch.where(del_mask, n, pool_src)
    pool_dst = torch.where(del_mask, n, pool_dst)

    # Representatives after cuts: a compression scoped to the components
    # that lost a tree edge (component-closed, so the contract holds).
    comp_cut = _mark(n, rt[child.long()], do_cut)
    active = comp_cut[rt.long()]
    rt = torch.where(active, compress_scoped(p, active, n_jumps=n_jumps,
                                             use_kernel=use_kernel), rt)

    # ---- insertions: append to free pool slots -----------------------------
    b = insert_src.numel()
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if b > 0:
        ins_ok = ((insert_src != insert_dst)
                  & (insert_src >= 0) & (insert_src < n)
                  & (insert_dst >= 0) & (insert_dst < n))
        free = _first_true(~pool_valid, b)
        rank = torch.cumsum(ins_ok, 0) - 1
        slot = torch.where(ins_ok, free[torch.clamp(rank, 0, b - 1)], cap)
        overflow = torch.sum(ins_ok & (slot >= cap), dtype=torch.int32)
        sidx = torch.where(slot < cap, slot,
                           cap + torch.arange(b, device=dev))
        pool_src = _put(pool_src, sidx, insert_src)
        pool_dst = _put(pool_dst, sidx, insert_dst)
        pool_valid = _put(pool_valid, sidx, True)
        tree_mask = _put(tree_mask, sidx, False)

    # ---- link loop: restore the spanning invariant -------------------------
    # A pool edge crossing two components is a fresh insertion or a
    # replacement exposed by a cut; the loop drains them all. A round links
    # something exactly when some edge crosses (every mover gets a winner),
    # so its one host read is of that.
    pu = torch.clamp(pool_src, 0, n - 1).long()
    pv = torch.clamp(pool_dst, 0, n - 1).long()
    bound = n if max_rounds is None else max_rounds
    rounds = 0
    links = torch.zeros((), dtype=torch.int32, device=dev)
    while rounds < bound:
        ru, rv = rt[pu], rt[pv]
        cand = pool_valid & (ru != rv)
        if not bool(torch.any(cand)):
            break
        # Union by size: the smaller component re-roots. (size, root id) is
        # a strict total order fixed for the round, so the graft overlay
        # inside link_components stays acyclic.
        size = _component_sizes(rt)
        su, sv = size[ru.long()], size[rv.long()]
        u_moves = (su < sv) | ((su == sv) & (ru > rv))
        start = torch.where(u_moves, pu, pv).to(torch.int32)
        target = torch.where(u_moves, pv, pu).to(torch.int32)
        p, rt, is_winner = link_components(
            p, rt, start, target, cand, levels=levels, n_jumps=n_jumps,
            use_kernel=use_kernel)
        tree_mask = tree_mask | is_winner
        touched = _mark(n, start, is_winner, touched)
        touched = _mark(n, target, is_winner, touched)
        links = links + torch.sum(is_winner, dtype=torch.int32)
        rounds += 1

    # Cross edges still pending: 0 unless ``max_rounds`` cut the loop.
    pending = torch.sum(pool_valid & (rt[pu] != rt[pv]), dtype=torch.int32)

    # ---- dirty propagation: whole components holding a touched vertex ------
    comp_touched = _mark(n, rt, touched)
    dirty = state.dirty | comp_touched[rt.long()]

    new_state = DynamicForest(
        n_nodes=n, parent=p, rep=rt, pool_src=pool_src, pool_dst=pool_dst,
        pool_valid=pool_valid, tree_mask=tree_mask, dirty=dirty,
        version=state.version + 1)
    stats = {"cuts": n_cuts, "links": links, "rounds": rounds,
             "overflow": overflow, "pending": pending}
    return new_state, stats
