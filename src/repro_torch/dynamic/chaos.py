"""Deterministic fault injection for the dynamic serving path (DESIGN.md §11).

The port of ``repro.dynamic.chaos``. Two fault families:

* **State corruption** (``INJECTORS``): the parent array gains a cycle or a
  dangling pointer, ``tree_mask`` desyncs from the pool, a representative
  goes stale, a ``DynamicBCC`` cache keeps labels for a state it no longer
  matches. Each injector takes ``(state, bcc, rng)`` and returns the
  corrupted ``(state, bcc, description)``; all randomness flows through the
  caller's ``numpy`` generator, drawn in the reference's order, so a seed
  gives the reference's fault and description exactly. The reference
  copies every field to the host and back; here only what the draws need
  comes to the host (a count of candidates, the picked entry), the picked
  candidate is found on the device (cumsum and binary search), and the few
  edited entries are written into a copy of the one field they change.
  ``Generator.choice(a)`` over a 1-D array draws ``a[integers(0, len(a))]``,
  and that is what is drawn here, without building ``a`` on the host.

* **Stream pollution** (``POLLUTERS``): malformed traffic (out-of-range
  ids, self-loops, duplicated or reordered batches, deletions of edges
  never inserted). Polluters rewrite a host batch list;
  ``sanitize_batch`` runs in front of ``apply_batch`` and rewrites
  malformed events to the inert ``n_nodes`` sentinel, counting each
  category. These are numpy on the host, as in the reference.

The edge pool is ground truth: injectors corrupt the derived structures
(parent, rep, tree_mask, caches) or redirect pool endpoints to other live
vertices, faults a pool-driven repair can heal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.streams import EdgeStream, StreamBatch
from repro_torch.dynamic.bcc import DynamicBCC
from repro_torch.dynamic.forest import DynamicForest


# ---------------------------------------------------------------------------
# state corruption
# ---------------------------------------------------------------------------

def _count(mask: torch.Tensor) -> int:
    return int(torch.sum(mask, dtype=torch.int64))


def _nth_true(mask: torch.Tensor, k: int) -> int:
    """The position of the k-th (0-based) True entry of ``mask``."""
    counts = torch.cumsum(mask, 0)
    want = torch.tensor([k + 1], dtype=counts.dtype, device=mask.device)
    return int(torch.searchsorted(counts, want)[0])


def _choice(mask: torch.Tensor, rng: np.random.Generator) -> int:
    """``int(rng.choice(np.nonzero(mask)[0]))`` for a non-empty mask."""
    return _nth_true(mask, int(rng.integers(0, _count(mask))))


def _with(t: torch.Tensor, i: int, value) -> torch.Tensor:
    """A copy of ``t`` with entry ``i`` set to ``value``."""
    out = t.clone()
    out[i] = value
    return out


def _nonroot(parent: torch.Tensor, rng: np.random.Generator) -> int:
    """A uniformly random non-root vertex (0 on an edgeless forest)."""
    verts = torch.arange(parent.numel(), dtype=parent.dtype,
                         device=parent.device)
    cand = parent != verts
    return _choice(cand, rng) if _count(cand) else 0


def _hops(parent: torch.Tensor, v: int, steps: int) -> int:
    """``parent`` applied ``steps`` times to ``v``, by binary lifting:
    where the reference walks the chain one host read a hop (stopping at a
    fixed point, which the lifting keeps), this is ⌈log2 steps⌉ gathers
    over the table. Raises ``ValueError`` if an entry lies outside [0, n)
    (where the reference's walk would index out of range)."""
    n = parent.numel()
    if bool(torch.any((parent < 0) | (parent >= n))):
        raise ValueError("parent_cycle: the parent table has entries "
                         f"outside [0, {n})")
    table = parent.long()
    r = torch.tensor([v], dtype=torch.long, device=parent.device)
    while steps:
        if steps & 1:
            r = table[r]
        steps >>= 1
        if steps:
            table = table[table]
    return int(r[0])


def inject_parent_bitflip(state: DynamicForest, bcc, rng):
    """Flip one bit of one parent entry: the classic soft-error model.

    The flipped pointer either leaves [0, n) (dangling) or lands on another
    vertex, and then v's claimed parent edge matches no tree slot (the
    audit's cover check) and usually crosses components.
    """
    p = state.parent
    n = state.n_nodes
    v = _nonroot(p, rng)
    old = int(p[v])
    bit = int(rng.integers(0, max(n.bit_length(), 1)))
    new = old ^ (1 << bit)
    if new == old:          # unreachable, but stay total
        new = old + 1
    return (dataclasses.replace(state, parent=_with(p, v, new)), bcc,
            f"parent_bitflip: parent[{v}] {old} -> {new} (bit {bit})")


def inject_parent_cycle(state: DynamicForest, bcc, rng):
    """Point a component's root back at one of its descendants.

    Pointer chasing from any vertex above the cycle never reaches a fixed
    point of the original table (the acyclicity check's failure).
    """
    p = state.parent
    v = _nonroot(p, rng)
    # v's root: the reference walks at most n hops from v, stopping at a
    # fixed point; on a table already cyclic it stops wherever n hops end.
    r = _hops(p, v, state.n_nodes)
    return (dataclasses.replace(state, parent=_with(p, r, v)), bcc,
            f"parent_cycle: parent[{r}] -> {v} (root re-entry)")


def inject_rep_corrupt(state: DynamicForest, bcc, rng):
    """Write a wrong representative: the incremental invariant breaks."""
    n = state.n_nodes
    v = int(rng.integers(0, n))
    old = int(state.rep[v])
    new = int(rng.integers(0, n))
    if new == old:
        new = (new + 1) % n
    return (dataclasses.replace(state, rep=_with(state.rep, v, new)), bcc,
            f"rep_corrupt: rep[{v}] {old} -> {new}")


def inject_tree_mask_desync(state: DynamicForest, bcc, rng):
    """Desync ``tree_mask`` from the forest: drop a tree slot or forge one
    (on a live non-tree slot, or on a dead slot when the pool is empty)."""
    tm, pv = state.tree_mask, state.pool_valid
    tree_slots = tm & pv
    nontree_slots = pv & ~tm
    n_tree, n_nontree = _count(tree_slots), _count(nontree_slots)
    if not n_tree and not n_nontree:
        return (dataclasses.replace(state, tree_mask=_with(tm, 0, True)),
                bcc, "tree_mask_desync: forged tree bit on dead slot 0")
    drop = bool(rng.integers(0, 2)) if n_tree and n_nontree \
        else bool(n_tree)
    if drop:
        s = _choice(tree_slots, rng)
        tm = _with(tm, s, False)
        desc = f"tree_mask_desync: dropped tree slot {s}"
    else:
        s = _choice(nontree_slots, rng)
        tm = _with(tm, s, True)
        desc = f"tree_mask_desync: forged tree slot {s}"
    return dataclasses.replace(state, tree_mask=tm), bcc, desc


def inject_pool_desync(state: DynamicForest, bcc, rng):
    """Redirect one endpoint of a live tree slot to another vertex.

    The pool is ground truth, so this changes the graph, but the parent
    array still encodes the old edge: repair must re-derive the forest.
    """
    n = state.n_nodes
    slots = state.tree_mask & state.pool_valid
    if not _count(slots):
        slots = state.pool_valid
    if not _count(slots):                # empty pool: a rep fault instead
        return inject_rep_corrupt(state, bcc, rng)
    s = _choice(slots, rng)
    side = "pool_src" if rng.integers(0, 2) else "pool_dst"
    other_side = "pool_dst" if side == "pool_src" else "pool_src"
    old = int(getattr(state, side)[s])
    other = int(getattr(state, other_side)[s])
    new = int(rng.integers(0, n))
    while new in (old, other):
        new = (new + 1) % n
    return (dataclasses.replace(state, **{side: _with(getattr(state, side),
                                                      s, new)}), bcc,
            f"pool_desync: {side}[{s}] {old} -> {new}")


def inject_stale_bcc(state: DynamicForest, bcc: DynamicBCC | None, rng):
    """Corrupt a BCC cache and its snapshot: the stale-cache fault.

    Scramble the labels of one component and perturb the parent snapshot
    inside it: the audit's freshness check flags it, and recovery
    re-derives the component from the live pool.
    """
    if bcc is None:
        return inject_rep_corrupt(state, bcc, rng)
    n = state.n_nodes
    v = int(rng.integers(0, n))
    comp = state.rep == state.rep[v]
    w = _choice(comp, rng)
    # Drift the snapshot at one in-component vertex and rot the labels.
    parent_snap = _with(bcc.parent, w, (int(bcc.parent[w]) + 1) % n)
    labels = torch.where(comp, torch.remainder(bcc.rep + 1, n), bcc.rep)
    arti = torch.where(comp, ~bcc.articulation, bcc.articulation)
    bcc2 = dataclasses.replace(bcc, parent=parent_snap, rep=labels,
                               articulation=arti)
    return state, bcc2, f"stale_bcc: component of {v} rotted (snap at {w})"


#: name -> injector(state, bcc, rng) -> (state, bcc, description)
INJECTORS = {
    "parent_bitflip": inject_parent_bitflip,
    "parent_cycle": inject_parent_cycle,
    "rep_corrupt": inject_rep_corrupt,
    "tree_mask_desync": inject_tree_mask_desync,
    "pool_desync": inject_pool_desync,
    "stale_bcc": inject_stale_bcc,
}


def inject(name: str, state: DynamicForest, bcc=None, seed: int = 0):
    """Run one named injector with a seeded generator (test entry point)."""
    rng = np.random.default_rng(seed)
    return INJECTORS[name](state, bcc, rng)


# ---------------------------------------------------------------------------
# stream pollution
# ---------------------------------------------------------------------------

def pollute_out_of_range(batches, n, rng):
    """Sprinkle ids outside [0, n) over insert/delete slots."""
    out = []
    for b in batches:
        iu, iv = b.ins_u.copy(), b.ins_v.copy()
        du, dv = b.del_u.copy(), b.del_v.copy()
        for arr in (iu, du):
            k = int(rng.integers(1, 3))
            idx = rng.integers(0, arr.shape[0], size=k)
            arr[idx] = rng.choice([-7, -1, n + 1, n + 13], size=k)
        out.append(StreamBatch(ins_u=iu, ins_v=iv, del_u=du, del_v=dv))
    return out


def pollute_self_loops(batches, n, rng):
    """Turn some insertions into self-loops (u, u)."""
    out = []
    for b in batches:
        iu, iv = b.ins_u.copy(), b.ins_v.copy()
        live = np.nonzero(iu < n)[0]
        if live.size:
            idx = rng.choice(live, size=max(1, live.size // 8),
                             replace=False)
            iv[idx] = iu[idx]
        out.append(StreamBatch(ins_u=iu, ins_v=iv, del_u=b.del_u,
                               del_v=b.del_v))
    return out


def pollute_duplicate_batches(batches, n, rng):
    """Replay a batch twice in a row (at-least-once delivery)."""
    if not batches:
        return list(batches)
    i = int(rng.integers(0, len(batches)))
    out = list(batches)
    out.insert(i, out[i])
    return out


def pollute_reordered_batches(batches, n, rng):
    """Swap two adjacent batches (out-of-order delivery)."""
    out = list(batches)
    if len(out) >= 2:
        i = int(rng.integers(0, len(out) - 1))
        out[i], out[i + 1] = out[i + 1], out[i]
    return out


def pollute_phantom_deletes(batches, n, rng):
    """Request deletions of edges that were never inserted."""
    out = []
    for b in batches:
        du, dv = b.del_u.copy(), b.del_v.copy()
        pad = np.nonzero(du >= n)[0]
        if pad.size:
            k = min(int(rng.integers(1, 3)), pad.size)
            idx = pad[:k]
            du[idx] = rng.integers(0, n, size=k)
            dv[idx] = rng.integers(0, n, size=k)
        out.append(StreamBatch(ins_u=b.ins_u, ins_v=b.ins_v, del_u=du,
                               del_v=dv))
    return out


#: name -> polluter(batches, n, rng) -> batches
POLLUTERS = {
    "out_of_range": pollute_out_of_range,
    "self_loops": pollute_self_loops,
    "duplicate_batches": pollute_duplicate_batches,
    "reordered_batches": pollute_reordered_batches,
    "phantom_deletes": pollute_phantom_deletes,
}


def pollute_stream(stream: EdgeStream, kinds, seed: int = 0) -> EdgeStream:
    """Apply named polluters to a stream's batch list, deterministically."""
    rng = np.random.default_rng(seed)
    batches = list(stream.batches)
    for kind in kinds:
        batches = POLLUTERS[kind](batches, stream.n_nodes, rng)
    return dataclasses.replace(stream, batches=tuple(batches))


# ---------------------------------------------------------------------------
# sanitizer
# ---------------------------------------------------------------------------

def sanitize_batch(b: StreamBatch, n_nodes: int):
    """Reject malformed events in front of ``apply_batch`` (DESIGN.md §11).

    Classification per event (an event is padding iff both endpoints are
    exactly the ``n_nodes`` sentinel; padding is never counted):

      * ``ins_out_of_range`` / ``del_out_of_range``: an endpoint outside
        [0, n) that is not the sentinel;
      * ``ins_self_loop`` / ``del_self_loop``: u == v.

    Rejected events are rewritten to sentinel padding, so the sanitized
    batch keeps its shapes. Deletions of never-inserted edges are
    well-formed traffic and pass through (``edge_slots`` counts them as
    unmatched).

    Returns:
      (StreamBatch sanitized, quarantine: dict[str, int]).
    """
    n = n_nodes
    out = {}
    arrs = {}
    for kind, (u, v) in (("ins", (b.ins_u, b.ins_v)),
                         ("del", (b.del_u, b.del_v))):
        u = np.asarray(u)
        v = np.asarray(v)
        padding = (u == n) & (v == n)
        in_range = (u >= 0) & (u < n) & (v >= 0) & (v < n)
        oor = ~padding & ~in_range
        self_loop = ~padding & in_range & (u == v)
        bad = oor | self_loop
        out[f"{kind}_out_of_range"] = int(oor.sum())
        out[f"{kind}_self_loop"] = int(self_loop.sum())
        arrs[f"{kind}_u"] = np.where(bad, n, u).astype(np.int32)
        arrs[f"{kind}_v"] = np.where(bad, n, v).astype(np.int32)
    clean = StreamBatch(ins_u=arrs["ins_u"], ins_v=arrs["ins_v"],
                        del_u=arrs["del_u"], del_v=arrs["del_v"])
    return clean, out


def merge_quarantine(total: dict, delta: dict) -> dict:
    """Accumulate per-category quarantine counters across batches."""
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v
    return total
