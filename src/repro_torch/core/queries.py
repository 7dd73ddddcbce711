"""Batched tree queries answered from the Euler-tour numbering (DESIGN.md §12).

The port of ``repro.core.queries``. The tour numbering is a query index:
``subtree(v) = [pre[v], last[v]]``, ``comp`` answers connectivity, and one
ancestor doubling table over the parent array gives O(log n) LCA and
exact-distance path decomposition.

``build_tables`` pays every engine sync once per tour: one ``rank_to_root``
depth pass plus ⌈log2 n⌉ doubling levels. Each query after it is a fixed
number of gathers with no sync. ``QueryTables.build_syncs`` carries the
build's cost, and ``build_tables`` records it in the ambient ``obs`` ledger
(phase ``build_tables``).

Conventions of every op:

  * queries are int32 tensors; out-of-range ids (the ``n`` padding
    sentinel, −1) are valid inputs that give the op's failure value:
    ``False`` for predicates, −1 for ``lca`` and ``depth_of``, the combine
    identity for aggregates;
  * cross-component pairs are not errors: ``connected`` says False, ``lca``
    −1 and ``path_agg`` the identity.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.core.compress import (DEFAULT_JUMPS, _COMBINE,
                                       _table_levels, rank_to_root,
                                       segment_reduce)
from repro_torch.core.euler import TourNumbering, _int32
from repro_torch.core.graph import resolve_device

INVALID = -1  # "no such vertex" answer of lca and depth_of


@dataclasses.dataclass(frozen=True)
class QueryTables:
    """Query index over one rooted forest.

    Attributes:
      pre, last, comp, parent: the ``TourNumbering`` arrays the tables were
        built from (``subtree(v) = [pre[v], last[v]]``).
      depth: int32[n] edges from v to its root.
      up:    int32[levels + 1, n]; ``up[k, v]`` is v's 2^k-th ancestor,
             stopping at the root.
      build_syncs: engine syncs of the build (rank_to_root checks plus
        ``levels``).
    """

    pre: torch.Tensor
    last: torch.Tensor
    comp: torch.Tensor
    parent: torch.Tensor
    depth: torch.Tensor
    up: torch.Tensor
    build_syncs: int

    @property
    def n_nodes(self) -> int:
        return self.pre.numel()

    @staticmethod
    def from_reference_arrays(pre, last, comp, parent, depth, up,
                              build_syncs, device=None) -> "QueryTables":
        """Rebuild tables from another implementation's arrays (for
        example ``np.asarray`` of each field of ``repro``'s tables)."""
        dev = resolve_device(device)
        return QueryTables(*(_int32(a, dev) for a in (pre, last, comp,
                                                      parent, depth, up)),
                           build_syncs=int(build_syncs))

    @property
    def levels(self) -> int:
        return self.up.shape[0] - 1


def build_tables(tn: TourNumbering, *,
                 n_jumps: int = DEFAULT_JUMPS) -> QueryTables:
    """Build the query index from a tour numbering.

    One ``rank_to_root`` pass for the depths, then ``levels = ⌈log2 n⌉``
    doublings ``p = p[p]`` for the ancestor table. Reports ``build_syncs``
    to the ambient ``obs`` ledger (phase ``build_tables``), lazily: with no
    ledger installed nothing is evaluated.
    """
    par = tn.parent
    n = par.numel()
    depth, _root, syncs = rank_to_root(par, n_jumps=n_jumps,
                                       return_syncs=True)
    levels = _table_levels(n)
    up = par.new_empty((levels + 1, n))
    up[0] = par
    for k in range(levels):
        up[k + 1] = up[k][up[k].long()]
    tables = QueryTables(pre=tn.pre, last=tn.last, comp=tn.comp,
                         parent=par, depth=depth, up=up,
                         build_syncs=syncs + levels)
    obs.record("build_tables", lambda: tables.build_syncs)
    return tables


def _ok(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >= 0) & (x < n)


def _clip(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(x, 0, n - 1).long()


def _identity(op: str, dtype: torch.dtype):
    """The value ``op`` leaves unchanged: the aggregates' failure value."""
    if op == "add":
        return 0
    info = (torch.iinfo(dtype) if not dtype.is_floating_point
            else torch.finfo(dtype))
    return info.max if op == "min" else info.min


def connected(tables: QueryTables, u: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """bool[B]: u and v in the same component (False on invalid ids)."""
    n = tables.n_nodes
    return (_ok(u, n) & _ok(v, n)
            & (tables.comp[_clip(u, n)] == tables.comp[_clip(v, n)]))


def depth_of(tables: QueryTables, v: torch.Tensor) -> torch.Tensor:
    """int32[B]: edges from v to its root (−1 on invalid ids)."""
    n = tables.n_nodes
    return torch.where(_ok(v, n), tables.depth[_clip(v, n)], INVALID)


def is_ancestor(tables: QueryTables, a: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """bool[B]: a lies on x's root path (a == x counts).

    Interval containment ``pre[a] <= pre[x] <= last[a]``; component blocks
    are disjoint, so no cross-component pair passes.
    """
    n = tables.n_nodes
    ac, xc = _clip(a, n), _clip(x, n)
    pre_x = tables.pre[xc]
    cov = (tables.pre[ac] <= pre_x) & (pre_x <= tables.last[ac])
    return _ok(a, n) & _ok(x, n) & cov


def lca(tables: QueryTables, u: torch.Tensor, v: torch.Tensor
        ) -> torch.Tensor:
    """int32[B]: lowest common ancestor; −1 for cross-component or invalid.

    Binary lifting against the interval test: u climbs from the highest
    power of two down, jumping only while the landing ancestor does not
    cover v. It stops at the deepest ancestor of u off v's root path, whose
    parent is the LCA. ``levels + 1`` gathers, no sync.
    """
    n = tables.n_nodes
    uc, vc = _clip(u, n), _clip(v, n)
    pre, last = tables.pre, tables.last
    pv = pre[vc]

    def covers(a):
        return (pre[a] <= pv) & (pv <= last[a])

    x = uc
    for k in range(tables.levels, -1, -1):
        cand = tables.up[k][x].long()
        x = torch.where(covers(cand), x, cand)
    res = torch.where(covers(uc), uc, tables.parent[x].long())
    same = _ok(u, n) & _ok(v, n) & (tables.comp[uc] == tables.comp[vc])
    return torch.where(same, res, INVALID).to(torch.int32)


def subtree_agg(tables: QueryTables, v: torch.Tensor, payload: torch.Tensor,
                op: str = "add", *,
                use_kernel: bool | None = None) -> torch.Tensor:
    """out[q] = op over payload[x] for every x in subtree(v[q]).

    The payload is laid out in preorder, where every subtree is the
    interval ``[pre[v], last[v]]``: ``add`` is a prefix-sum difference,
    ``min``/``max`` go through ``segment_reduce`` (the segment_table kernel
    on the card; ``use_kernel`` is passed on). Invalid v gives the op's
    identity.
    """
    n = tables.n_nodes
    vc = _clip(v, n)
    arr = payload.new_zeros(n)
    arr[tables.pre.long()] = payload
    lo, hi = tables.pre[vc], tables.last[vc]
    if op == "add":
        pref = torch.cumsum(arr, 0, dtype=arr.dtype)
        out = pref[hi.long()] - torch.where(lo > 0, pref[_clip(lo - 1, n)],
                                            0)
    else:
        out = segment_reduce(arr, lo, hi, op, use_kernel=use_kernel)
    return torch.where(_ok(v, n), out, _identity(op, payload.dtype))


def path_agg(tables: QueryTables, u: torch.Tensor, v: torch.Tensor,
             payload: torch.Tensor, op: str = "add") -> torch.Tensor:
    """op over payload on the tree path u..v, both endpoints included.

    Exact-distance decomposition, so ``add`` is safe: payload doubling
    tables ``pv[k][x]`` = op over the 2^k vertices from x rootward, then
    each endpoint climbs exactly ``depth[endpoint] − depth[lca]`` steps by
    the binary digits of that distance. The two climbs meet only at the
    LCA, which seeds the sum. Cross-component or invalid pairs give the
    op's identity.
    """
    n = tables.n_nodes
    combine = _COMBINE[op]
    w = lca(tables, u, v)
    valid = w >= 0
    uc, vc, wc = _clip(u, n), _clip(v, n), _clip(w, n)
    levels = tables.levels
    up = tables.up

    pv = [payload]
    t = payload
    for k in range(levels):
        t = combine(t, t[up[k]])
        pv.append(t)

    def climb(acc, x, d):
        for k in range(levels + 1):
            take = ((d >> k) & 1) == 1
            acc = torch.where(take, combine(acc, pv[k][x]), acc)
            x = torch.where(take, up[k][x], x)
        return acc

    acc = payload[wc]
    acc = climb(acc, uc, tables.depth[uc] - tables.depth[wc])
    acc = climb(acc, vc, tables.depth[vc] - tables.depth[wc])
    return torch.where(valid, acc, _identity(op, payload.dtype))


def _pair_key(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int64 key of the unordered int32 pair {a, b}: lo·2^32 + (hi − INT32_MIN),
    one key per pair. No pair gives ``_NO_PAIR`` (it would need lo > hi)."""
    lo = torch.minimum(a, b).long()
    hi = torch.maximum(a, b).long()
    return (lo << 32) + (hi - _INT32_MIN)


_INT32_MIN = torch.iinfo(torch.int32).min
_NO_PAIR = -1 - _INT32_MIN          # the key of (lo, hi) = (0, −1)


def edge_membership(qu: torch.Tensor, qv: torch.Tensor, e_src: torch.Tensor,
                    e_dst: torch.Tensor, e_valid: torch.Tensor,
                    flags: torch.Tensor):
    """Match query pairs against a flagged undirected edge set.

    For each (qu, qv) pair, the live slots whose unordered endpoints equal
    {qu, qv}. The reference compares every pair with every slot (B×E);
    here the slots' pair keys are sorted once and each query finds its
    run of equal keys by binary search, with the flags counted by a prefix
    sum over the sorted run: the same answers in O((B + E) log E), no
    sync, at a pool of 2^24 slots too.

    Returns:
      ``(hit, flagged)``: bool[B], some live slot matches the pair; bool[B],
      some matching live slot has its flag set.
    """
    ekey = torch.where(e_valid, _pair_key(e_src, e_dst), _NO_PAIR)
    skey, order = torch.sort(ekey)
    sflag = (flags & e_valid)[order]
    cum = torch.cat([sflag.new_zeros(1, dtype=torch.int64),
                     torch.cumsum(sflag, 0)])
    qkey = _pair_key(qu, qv)
    first = torch.searchsorted(skey, qkey)
    end = torch.searchsorted(skey, qkey, right=True)
    return end > first, cum[end] > cum[first]
