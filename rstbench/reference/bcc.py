"""Biconnectivity in plain PyTorch, and the check of a ``BCCResult``.

What the program states, and how each piece is judged:

* ``pre`` and ``size`` number some rooted spanning tree of the graph in
  preorder, with subtree sizes. Any spanning tree will do, so the check
  rebuilds the tree they describe (each vertex's parent is its deepest
  neighbour whose interval holds it) and counts every vertex at which
  they fail to be that tree's preorder and sizes (``bad_tree``).
* ``low`` and ``high``: over the subtree of v, the extreme preorder
  numbers of its vertices and of the far ends of their non-tree edges.
  Worked out on that tree; exact.
* The blocks do not depend on the tree: each edge's block, the bridges,
  the cut vertices and the number of blocks are the graph's own. A block
  is labelled by the smallest vertex that is the child end of one of its
  tree edges, which does not depend on the tree either (it is every
  vertex of the block but the one nearest the root). Blocks are the
  components of Tarjan and Vishkin's auxiliary graph on the tree edges;
  a vertex is a cut vertex when its tree edges lie in two blocks or more,
  and an edge is a bridge when its block holds it alone. All exact.

``numbering`` numbers a parent array the same way, for the control.
"""
from __future__ import annotations

import torch

INF = torch.iinfo(torch.int64).max


def components(u: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """int64[n]: each vertex's smallest connected vertex over edges (u, v).

    Rounds of hooking each tree's top to the smallest top across an edge,
    then jumping every pointer to its top; a top only ever hooks to a
    smaller one, so the last top of a component is its smallest vertex."""
    u, v = u.long(), v.long()
    top = torch.arange(n, device=u.device)
    while True:
        tu, tv = top[u], top[v]
        low = torch.minimum(tu, tv)
        nxt = top.clone()
        nxt.scatter_reduce_(0, tu, low, "amin")
        nxt.scatter_reduce_(0, tv, low, "amin")
        while True:
            jumped = nxt[nxt]
            if torch.equal(jumped, nxt):
                break
            nxt = jumped
        if torch.equal(nxt, top):
            return top
        top = nxt


def range_reduce(a: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 op) -> torch.Tensor:
    """``op`` (torch.minimum or torch.maximum) of a[lo[i] .. hi[i]],
    inclusive, for every i (hi >= lo), one doubling level at a time."""
    n = a.numel()
    length = hi - lo + 1
    k = torch.zeros_like(length)
    j = 1
    while (1 << j) <= n:
        k += length >= (1 << j)
        j += 1
    out = a[lo]
    level, j = a, 0
    while True:
        half = 1 << j
        out = torch.where(k == j, op(level[lo], level[hi - half + 1]), out)
        if 2 * half > n:
            return out
        nxt = level.clone()
        nxt[:n - half] = op(level[:n - half], level[half:])
        level, j = nxt, j + 1


def tree_from_numbering(src, dst, n: int, root: int, pre, size):
    """``(par, bad)``: the tree ``pre``/``size`` describe, and how many
    vertices break it (see the module's docstring)."""
    dev = src.device
    verts = torch.arange(n, device=dev)
    pre, size = pre.long(), size.long()
    bad = (pre < 0) | (pre >= n) | (size < 1) | (pre + size > n)
    pc, sc = pre.clamp(0, n - 1), size.clamp(1, n)
    bad |= torch.bincount(pc, minlength=n)[pc] != 1
    at = torch.full((n,), -1, dtype=torch.int64, device=dev)
    at[pc] = verts                                   # vertex at a position
    s, d = src.long(), dst.long()
    holds = (pc[s] < pc[d]) & (pc[d] < pc[s] + sc[s])
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, d, torch.where(holds, pc[s], -1), "amax")
    nonroot = verts != root
    child = nonroot & (best >= 0)
    bad |= nonroot & ~child
    par = torch.where(child, at[best.clamp_min(0)], verts)
    par = torch.where(par < 0, verts, par)
    bad[root] |= (pc[root] != 0) | (sc[root] != n)
    # Sizes add up: 1 + the children's.
    total = torch.ones(n, dtype=torch.int64, device=dev)
    total.scatter_add_(0, par[child], sc[child])
    bad |= total != sc
    # Children tile their parent's interval in preorder: the first right
    # after the parent, each next right after the one before, the last
    # ending with the parent.
    first = pc + 1
    fc = at[first.clamp_max(n - 1)]
    bad |= (sc > 1) & ((first >= n) | (fc < 0)
                       | (par[fc.clamp_min(0)] != verts))
    nxt = pc + sc
    after = at[nxt.clamp_max(n - 1)]
    fits = (nxt == pc[par] + sc[par]) | (
        (nxt < n) & (after >= 0) & (par[after.clamp_min(0)] == par))
    bad |= child & ~fits
    return par, int(bad.sum())


def is_tree_edge(src, dst, par):
    s, d = src.long(), dst.long()
    return (par[d] == s) | (par[s] == d)


def low_high(src, dst, n: int, par, pre, size):
    """int64[n] ``(low, high)`` of the tree ``par`` numbered by pre/size."""
    s, d = src.long(), dst.long()
    pre, size = pre.long().clamp(0, n - 1), size.long().clamp(1, n)
    off = ~is_tree_edge(src, dst, par)
    own_low = pre.clone().scatter_reduce_(0, s[off], pre[d[off]], "amin")
    own_high = pre.clone().scatter_reduce_(0, s[off], pre[d[off]], "amax")
    by_pos_low = torch.empty_like(pre)
    by_pos_low[pre] = own_low
    by_pos_high = torch.empty_like(pre)
    by_pos_high[pre] = own_high
    last = (pre + size - 1).clamp_max(n - 1)
    return (range_reduce(by_pos_low, pre, last, torch.minimum),
            range_reduce(by_pos_high, pre, last, torch.maximum))


def blocks(src, dst, n: int, par, pre, size, low, high) -> torch.Tensor:
    """int64[n]: each vertex's block label as the child end of a tree edge
    (a root labels only itself). Tarjan and Vishkin's rules:
    R1 joins the tree edges above the ends of a non-tree edge whose ends
    are unrelated; R2 and R3 join the tree edge above v to the one above
    its parent w when v's subtree reaches out of w's below or above."""
    dev = src.device
    verts = torch.arange(n, device=dev)
    s, d = src.long(), dst.long()
    pre, size = pre.long().clamp(0, n - 1), size.long().clamp(1, n)
    off = ~is_tree_edge(src, dst, par)
    related = (pre[s] <= pre[d]) & (pre[d] < pre[s] + size[s])
    r1 = off & (pre[s] < pre[d]) & ~related
    w = par
    below_root = (verts != par) & (par[w] != w)
    r2 = below_root & (low < pre[w])
    r3 = below_root & (high >= pre[w] + size[w])
    u = torch.cat([s[r1], verts[r2], verts[r3]])
    v = torch.cat([d[r1], w[r2], w[r3]])
    return components(u, v, n)


def reference_bcc(src, dst, n: int, par, pre, size) -> dict:
    """Every ``BCCResult`` field that follows from the graph and a tree
    numbered by ``pre``/``size``."""
    dev = src.device
    verts = torch.arange(n, device=dev)
    low, high = low_high(src, dst, n, par, pre, size)
    label = blocks(src, dst, n, par, pre, size, low, high)
    s, d = src.long(), dst.long()
    pre_c = pre.long().clamp(0, n - 1)
    deeper = torch.where(pre_c[d] > pre_c[s], d, s)
    edge_bcc = label[deeper]
    per_block = torch.bincount(edge_bcc, minlength=n)
    bridge = is_tree_edge(src, dst, par) & (per_block[edge_bcc] == 2)
    nonroot = verts != par
    lo = torch.where(nonroot, label, INF)
    hi = torch.where(nonroot, label, -1)
    lo = lo.scatter_reduce(0, par[nonroot], label[nonroot], "amin")
    hi = hi.scatter_reduce(0, par[nonroot], label[nonroot], "amax")
    articulation = (hi >= 0) & (lo != hi)
    return {"low": low, "high": high, "edge_bcc": edge_bcc, "bridge": bridge,
            "articulation": articulation,
            "n_bcc": int(torch.unique(edge_bcc).numel()) if s.numel() else 0}


def check_bcc(src, dst, n: int, root: int, got: dict) -> dict:
    """Counts of disagreement between a ``BCCResult``'s fields (``got``)
    and the reference; each is 0 when the result is right."""
    par, bad_tree = tree_from_numbering(src, dst, n, root, got["pre"],
                                        got["size"])
    want = reference_bcc(src, dst, n, par, got["pre"], got["size"])
    out = {"bad_tree": bad_tree}
    for k in ("low", "high", "articulation", "bridge", "edge_bcc"):
        out[f"bad_{k}"] = int((got[k].to(want[k].dtype) != want[k]).sum())
    out["bad_n_bcc"] = abs(int(got["n_bcc"]) - want["n_bcc"])
    return out


def numbering(parent: torch.Tensor, root: int):
    """int64 ``(pre, size)`` of a spanning tree rooted at ``root``,
    children in id order, one depth level at a time."""
    n = parent.numel()
    dev = parent.device
    verts = torch.arange(n, device=dev)
    par = parent.long().clone()
    par[root] = root
    nonroot = verts != root
    depth = nonroot.long()
    anc = par.clone()
    for _ in range(max(n, 2).bit_length()):
        depth = depth + depth[anc]
        anc = anc[anc]
    by_depth = torch.argsort(depth, stable=True)
    counts = torch.bincount(depth, minlength=int(depth.max()) + 1).tolist()
    starts = [0]
    for c in counts:
        starts.append(starts[-1] + c)
    size = torch.ones(n, dtype=torch.int64, device=dev)
    for lvl in range(len(counts) - 1, 0, -1):
        vs = by_depth[starts[lvl]:starts[lvl + 1]]
        size.index_add_(0, par[vs], size[vs])
    # Offset of each child inside its parent: the sizes of the siblings
    # before it, children in id order.
    kids = verts[nonroot]
    kids = kids[torch.argsort(par[kids] * n + kids)]
    ks = size[kids]
    before = torch.cumsum(ks, 0) - ks
    starts_group = torch.ones_like(kids, dtype=torch.bool)
    starts_group[1:] = par[kids[1:]] != par[kids[:-1]]
    idx = torch.arange(kids.numel(), device=dev)
    group_start = torch.cummax(torch.where(starts_group, idx, 0), 0).values
    offset = torch.zeros(n, dtype=torch.int64, device=dev)
    offset[kids] = before - before[group_start]
    pre = torch.zeros(n, dtype=torch.int64, device=dev)
    for lvl in range(1, len(counts)):
        vs = by_depth[starts[lvl]:starts[lvl + 1]]
        pre[vs] = pre[par[vs]] + 1 + offset[vs]
    return pre, size
