"""The reference judges outputs rightly: it passes the program's answers,
agrees with brute force on small graphs, and catches each broken
guarantee."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from rstbench.generators import kron
from rstbench.reference import bcc as ref_bcc
from rstbench.reference import bfs as ref_bfs
from rstbench.reference import tree as ref_tree

KRON = {"scale": 7, "edgefactor": 4, "a": 0.57, "b": 0.19, "c": 0.19,
        "graph_seed": 3, "implant_tree": True}


def _graph(edges, n):
    e = np.asarray(edges, np.int64)
    lo, hi = e.min(1), e.max(1)
    src = torch.from_numpy(np.concatenate([lo, hi])).int()
    dst = torch.from_numpy(np.concatenate([hi, lo])).int()
    return n, src, dst


# Two triangles joined by the bridge 2-3, the pendant edge 5-6 (a second
# bridge) and the square 0-7-8-9 on vertex 0: five blocks, cut vertices
# 0, 2, 3 and 5.
SMALL = _graph([(0, 1), (1, 2), (2, 0), (2, 3), (3, 4), (4, 5), (5, 3),
                (5, 6), (0, 7), (7, 8), (8, 9), (9, 0)], 10)


def _components(n, edges, drop_v=None, drop_e=None) -> int:
    label = list(range(n))

    def find(x):
        while label[x] != x:
            label[x] = label[label[x]]
            x = label[x]
        return x
    for i, (u, v) in enumerate(edges):
        if i == drop_e or drop_v in (u, v):
            continue
        label[find(u)] = find(v)
    return len({find(x) for x in range(n) if x != drop_v})


def _brute(n, src, dst):
    m = src.numel() // 2
    edges = list(zip(src[:m].tolist(), dst[:m].tolist()))
    base = _components(n, edges)
    art = [_components(n, edges, drop_v=v) > base - (1 if all(
        v not in e for e in edges) else 0) for v in range(n)]
    bridge = [_components(n, edges, drop_e=i) > base for i in range(m)]
    return np.array(art), np.array(bridge + bridge)


def _port_bcc(n, src, dst, root):
    from repro_torch.core.bcc import biconnectivity
    from repro_torch.core.graph import Graph
    r = biconnectivity(Graph(n, src, dst), root, device="cpu")
    return {k: getattr(r, k) for k in ("pre", "size", "low", "high",
                                       "articulation", "bridge", "edge_bcc",
                                       "n_bcc")}


def _port_rst(n, src, dst, root, method):
    from repro_torch.core.graph import Graph
    from repro_torch.core.rst import rooted_spanning_tree
    return rooted_spanning_tree(Graph(n, src, dst), root, method=method,
                                device="cpu")


@pytest.mark.parametrize("root", [0, 3, 6])
def test_bcc_reference_matches_brute_force_and_the_program(root):
    n, src, dst = SMALL
    got = _port_bcc(n, src, dst, root)
    assert ref_bcc.check_bcc(src, dst, n, root, got) == dict.fromkeys(
        ["bad_tree", "bad_low", "bad_high", "bad_articulation", "bad_bridge",
         "bad_edge_bcc", "bad_n_bcc"], 0)
    art, bridge = _brute(n, src, dst)
    assert np.array_equal(got["articulation"].numpy(), art)
    assert np.array_equal(got["bridge"].numpy(), bridge)
    assert got["n_bcc"] == 5


@pytest.mark.parametrize("seed", [0, 1])
def test_bcc_reference_on_a_power_law_graph(seed):
    n, src, dst = kron.build(dict(KRON, graph_seed=seed), 0, "cpu")
    root = 17
    got = _port_bcc(n, src, dst, root)
    counts = ref_bcc.check_bcc(src, dst, n, root, got)
    assert set(counts.values()) == {0}
    art, bridge = _brute(n, src, dst)
    assert np.array_equal(got["articulation"].numpy(), art)
    assert np.array_equal(got["bridge"].numpy(), bridge)


def test_bcc_reference_catches_a_wrong_label_and_field():
    n, src, dst = SMALL
    good = _port_bcc(n, src, dst, 0)
    for field, key in (("edge_bcc", "bad_edge_bcc"),
                       ("articulation", "bad_articulation"),
                       ("bridge", "bad_bridge"), ("low", "bad_low"),
                       ("high", "bad_high")):
        bad = dict(good)
        bad[field] = good[field].clone()
        bad[field][4] = (~bad[field][4] if bad[field].dtype == torch.bool
                         else bad[field][4] + 1)
        assert ref_bcc.check_bcc(src, dst, n, 0, bad)[key] >= 1
    bad = dict(good, n_bcc=good["n_bcc"] - 1)
    assert ref_bcc.check_bcc(src, dst, n, 0, bad)["bad_n_bcc"] == 1


def test_bcc_reference_catches_a_numbering_that_is_no_tree():
    n, src, dst = SMALL
    good = _port_bcc(n, src, dst, 0)
    pre = good["pre"].clone()
    a, b = 4, 8                      # two vertices in different subtrees
    pre[a], pre[b] = good["pre"][b], good["pre"][a]
    bad = dict(good, pre=pre)
    assert ref_bcc.check_bcc(src, dst, n, 0, bad)["bad_tree"] >= 1
    size = good["size"].clone()
    size[0] -= 1
    assert ref_bcc.check_bcc(src, dst, n, 0, dict(good, size=size))[
        "bad_tree"] >= 1


def test_numbering_is_a_preorder_the_check_accepts():
    n, src, dst = kron.build(KRON, 0, "cpu")
    dist, parent = ref_bfs.bfs(src, dst, n, 5)
    pre, size = ref_bcc.numbering(parent, 5)
    par, bad = ref_bcc.tree_from_numbering(src, dst, n, 5, pre, size)
    assert bad == 0
    assert torch.equal(par, parent)


@pytest.mark.parametrize("method", ["gconn_euler", "bfs"])
def test_tree_check_passes_the_program(method):
    n, src, dst = kron.build(KRON, 0, "cpu")
    out = _port_rst(n, src, dst, 9, method)
    keys = ref_tree.edge_keys(src, dst, n)
    counts, ends = ref_tree.check_spanning_tree(keys, n, 9, out.parent)
    assert counts == {"bad_parent": 0, "unrooted": 0}
    if method == "bfs":
        d, p = ref_bfs.bfs(src, dst, n, 9)
        assert ref_bfs.check_bfs_tree(d, p, out.parent, out.dist) == {
            "bad_bfs_parent": 0, "bad_dist": 0}
    else:
        assert ref_tree.check_component_rep(ends, out.rep) == {"bad_rep": 0}


def _tree():
    n, src, dst = kron.build(KRON, 0, "cpu")
    dist, parent = ref_bfs.bfs(src, dst, n, 9)
    return n, src, dst, parent, dist


def test_tree_check_catches_a_cycle():
    n, src, dst, parent, _ = _tree()
    x = int(torch.nonzero((parent != 9) & (parent[parent] != parent))[0])
    bad = parent.clone()
    bad[parent[x]] = x
    counts, _ = ref_tree.check_spanning_tree(
        ref_tree.edge_keys(src, dst, n), n, 9, bad)
    assert counts["unrooted"] >= 2 and counts["bad_parent"] == 0


def test_tree_check_catches_the_wrong_root():
    n, src, dst, parent, _ = _tree()
    y = int(torch.nonzero((parent == 9) & (torch.arange(n) != 9))[0])
    bad = parent.clone()
    bad[9], bad[y] = y, y
    counts, _ = ref_tree.check_spanning_tree(
        ref_tree.edge_keys(src, dst, n), n, 9, bad)
    assert counts["bad_parent"] == 2 and counts["unrooted"] == n


def test_tree_check_catches_a_non_edge():
    n, src, dst, parent, _ = _tree()
    keys = ref_tree.edge_keys(src, dst, n)
    verts = torch.arange(n)
    far = ~ref_tree.is_edge(keys, verts, torch.full_like(verts, 9), n)
    x = int(torch.nonzero(far & (verts != 9))[0])
    bad = parent.clone()
    bad[x] = 9
    counts, _ = ref_tree.check_spanning_tree(keys, n, 9, bad)
    assert counts == {"bad_parent": 1, "unrooted": 0}


def test_tree_check_catches_out_of_range_and_self_parents():
    n, src, dst, parent, _ = _tree()
    keys = ref_tree.edge_keys(src, dst, n)
    bad = parent.clone()
    bad[3], bad[4] = n, 4
    counts, _ = ref_tree.check_spanning_tree(keys, n, 9, bad)
    assert counts["bad_parent"] == 2 and counts["unrooted"] >= 2


def test_rep_check_catches_a_split_and_a_foreign_rep():
    n, src, dst, parent, _ = _tree()
    _, ends = ref_tree.check_spanning_tree(
        ref_tree.edge_keys(src, dst, n), n, 9, parent)
    rep = torch.full((n,), 3, dtype=torch.int32)
    assert ref_tree.check_component_rep(ends, rep) == {"bad_rep": 0}
    rep[7] = 4
    assert ref_tree.check_component_rep(ends, rep)["bad_rep"] == 1


def test_bfs_check_catches_a_valid_tree_that_is_not_the_min_one():
    n, src, dst, parent, dist = _tree()
    s, d = src.long(), dst.long()
    offer = (dist[d] == dist[s] + 1) & (s != parent[d])
    e = int(torch.nonzero(offer)[0])
    bad = parent.clone()
    bad[d[e]] = s[e]
    want = torch.where(dist < 0, ref_bfs.INF32, dist)
    assert ref_bfs.check_bfs_tree(dist, parent, bad, want) == {
        "bad_bfs_parent": 1, "bad_dist": 0}


def test_components_and_range_reduce():
    u = torch.tensor([5, 1, 7, 3])
    v = torch.tensor([2, 5, 3, 8])
    top = ref_bcc.components(u, v, 10)
    assert top.tolist() == [0, 1, 1, 3, 4, 1, 6, 3, 3, 9]
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 100, 37))
    lo = torch.from_numpy(rng.integers(0, 37, 200))
    hi = torch.minimum(lo + torch.from_numpy(rng.integers(0, 37, 200)),
                       torch.tensor(36))
    got = ref_bcc.range_reduce(a, lo, hi, torch.minimum)
    want = [int(a[x:y + 1].min()) for x, y in zip(lo.tolist(), hi.tolist())]
    assert got.tolist() == want
