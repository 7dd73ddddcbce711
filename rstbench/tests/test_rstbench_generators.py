"""The frozen graph generators: shapes, pairing, determinism."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from rstbench.generators import grid2d, kron
from rstbench.tests.conftest import REPO

KRON = {"scale": 8, "edgefactor": 16, "a": 0.57, "b": 0.19, "c": 0.19,
        "graph_seed": 20, "implant_tree": True}


def _edges(src, dst):
    m = src.numel() // 2
    return src[:m].numpy(), dst[:m].numpy(), src[m:].numpy(), dst[m:].numpy()


def _connected(n, lo, hi) -> bool:
    label = np.arange(n)
    while True:
        low = np.minimum(label[lo], label[hi])
        new = label.copy()
        np.minimum.at(new, lo, low)
        np.minimum.at(new, hi, low)
        new = new[new]
        if np.array_equal(new, label):
            return bool((label == 0).all())
        label = new


@pytest.mark.parametrize("side", [1, 2, 5, 16])
def test_grid_shape_and_order(side):
    n, src, dst = grid2d.build({"side": side}, 123, "cpu")
    assert n == side * side
    assert src.dtype == dst.dtype == torch.int32
    m = 2 * side * (side - 1)
    assert src.numel() == 2 * m
    lo, hi, rlo, rhi = _edges(src, dst)
    assert (rlo == hi).all() and (rhi == lo).all()    # rev(e) = e + M
    assert (lo < hi).all()
    key = lo.astype(np.int64) * n + hi
    assert (np.diff(key) > 0).all()                   # sorted, no repeats
    diff = hi - lo
    assert set(np.unique(diff)) <= {1, side}
    assert ((diff == 1) <= (lo % side != side - 1)).all()


def test_grid_ignores_the_seed():
    a = grid2d.build({"side": 9}, 1, "cpu")
    b = grid2d.build({"side": 9}, 2**40 + 3, "cpu")
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_grid_config_states_its_sizes():
    # The full grid is built on the card only; its stated sizes follow the
    # closed forms the small grids above are held to.
    cfg = json.loads((REPO / "rstbench/configs/grid5pt5000.json")
                     .read_text())
    side = cfg["params"]["side"]
    assert cfg["n_vertices"] == side * side
    assert cfg["n_edges"] == 2 * side * (side - 1)
    assert cfg["half_edges"] == 2 * cfg["n_edges"]
    assert cfg["diameter"] == 2 * (side - 1)


def test_kron_is_simple_connected_and_paired():
    n, src, dst = kron.build(KRON, 5, "cpu")
    assert n == 256
    lo, hi, rlo, rhi = _edges(src, dst)
    assert (rlo == hi).all() and (rhi == lo).all()
    assert (lo < hi).all()
    key = lo.astype(np.int64) * n + hi
    assert (np.diff(key) > 0).all()
    assert _connected(n, lo, hi)
    deg = np.bincount(np.concatenate([lo, hi]), minlength=n)
    assert deg.max() > 8 * np.median(deg)              # hubs


def test_kron_is_the_same_graph_for_every_run_seed():
    a = kron.build(KRON, 1, "cpu")
    b = kron.build(KRON, 2**35 + 11, "cpu")
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    other = dict(KRON, graph_seed=21)
    c = kron.build(other, 1, "cpu")
    assert not (c[1].numel() == a[1].numel() and torch.equal(c[1], a[1]))


def test_kron_without_tree_leaves_vertices_isolated():
    n, src, _ = kron.build(dict(KRON, implant_tree=False), 0, "cpu")
    assert torch.bincount(src.long(), minlength=n).eq(0).any()


def test_kron_config_follows_its_source():
    cfg = json.loads((REPO / "rstbench/configs/kron_logn20.json")
                     .read_text())
    p, src = cfg["params"], cfg["source_scale"]
    assert cfg["n_vertices"] == src["n_vertices"] == 1 << p["scale"]
    assert p["edgefactor"] << p["scale"] == src["edge_samples"]
    assert (p["a"], p["b"], p["c"]) == (0.57, 0.19, 0.19)


def test_kron_has_many_blocks_bridges_and_cut_vertices():
    """The BCC cell's graph: the leaves the implanted tree adds give the
    block comparison something to get wrong."""
    from rstbench import control
    cfg = json.loads((REPO / "rstbench/configs/kron_logn20.json")
                     .read_text())
    n, src, dst = kron.build(dict(cfg["params"], scale=10), 3, "cpu")
    got = control.reference_answer(src, dst, n, 0, "bcc")
    assert got["n_bcc"] > 10
    assert int(got["bridge"].sum()) > 20
    assert int(got["articulation"].sum()) > 10
