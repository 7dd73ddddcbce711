"""A whole run, the card's look skipped, with the timed path broken
underneath: ``correct`` has to come out false. The faults a cell of this
benchmark can have: a call that returns its state unchanged, and an
answer altered where it is produced. (No cell has a batch to halve or an
exchange between chips to leave out.)"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from rstbench.tests.conftest import run_cell

RST_CELLS = ["grid5pt5000.gconn_rst", "kron_logn20.gconn_rst",
             "kron_logn20.bfs_rst"]
INF32 = torch.iinfo(torch.int32).max


def _unchanged_rst(graph, root, method="gconn_euler", **kw):
    from repro_torch.core.rst import RSTResult
    n = graph.n_nodes
    verts = torch.arange(n, dtype=torch.int32)
    if method == "bfs":
        parent = torch.full((n,), -1, dtype=torch.int32)
        dist = torch.full((n,), INF32, dtype=torch.int32)
        parent[root], dist[root] = root, 0
        return RSTResult(parent=parent, method=method, steps=0, dist=dist)
    return RSTResult(parent=verts, method=method, steps=0, rep=verts,
                     rank_syncs=0, compress_syncs=0)


def _altered_rst(real):
    def call(graph, root, **kw):
        out = real(graph, root, **kw)
        parent = out.parent.clone()
        x = (root + 1) % graph.n_nodes
        parent[x] = (parent[x] + 1) % graph.n_nodes
        return dataclasses.replace(out, parent=parent)
    return call


def _unchanged_bcc(graph, root=0, **kw):
    from repro_torch.core.bcc import BCCResult
    n, m2 = graph.n_nodes, graph.n_half_edges
    verts = torch.arange(n, dtype=torch.int32)
    return BCCResult(articulation=torch.zeros(n, dtype=torch.bool),
                     bridge=torch.zeros(m2, dtype=torch.bool),
                     edge_bcc=torch.full((m2,), -1, dtype=torch.int32),
                     n_bcc=0, pre=verts, size=torch.ones_like(verts),
                     low=verts, high=verts, rst_steps=0, aux_rounds=0,
                     seg_syncs=0)


def _altered_bcc(real, field):
    def call(graph, root=0, **kw):
        out = real(graph, root, **kw)
        x = getattr(out, field).clone()
        x[3] = ~x[3] if x.dtype == torch.bool else x[3] + 1
        return dataclasses.replace(out, **{field: x})
    return call


@pytest.mark.parametrize("cell", RST_CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    result, log = run_cell(tiny_root, cell)
    assert result["correct"], log
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", RST_CELLS)
def test_rst_state_unchanged_is_not_correct(tiny_root, cell, monkeypatch):
    from repro_torch.core import rst
    monkeypatch.setattr(rst, "rooted_spanning_tree", _unchanged_rst)
    result, _ = run_cell(tiny_root, cell)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", RST_CELLS)
def test_rst_answer_altered_is_not_correct(tiny_root, cell, monkeypatch):
    from repro_torch.core import rst
    monkeypatch.setattr(rst, "rooted_spanning_tree",
                        _altered_rst(rst.rooted_spanning_tree))
    result, _ = run_cell(tiny_root, cell)
    assert result["correct"] is False


def test_bcc_sound_and_unchanged(tiny_root, monkeypatch):
    result, log = run_cell(tiny_root, "kron_logn20.bcc")
    assert result["correct"], log
    from repro_torch.core import bcc
    monkeypatch.setattr(bcc, "biconnectivity", _unchanged_bcc)
    result, _ = run_cell(tiny_root, "kron_logn20.bcc")
    assert result["correct"] is False


@pytest.mark.parametrize("field", ["edge_bcc", "articulation", "bridge",
                                   "low", "high", "pre"])
def test_bcc_answer_altered_is_not_correct(tiny_root, monkeypatch, field):
    from repro_torch.core import bcc
    monkeypatch.setattr(bcc, "biconnectivity",
                        _altered_bcc(bcc.biconnectivity, field))
    result, _ = run_cell(tiny_root, "kron_logn20.bcc")
    assert result["correct"] is False


def test_a_call_that_raises_is_counted_failed(tiny_root, monkeypatch):
    from repro_torch.core import rst
    real, calls = rst.rooted_spanning_tree, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 5:          # the third call of the window
            raise RuntimeError("device fault")
        return real(*a, **k)
    monkeypatch.setattr(rst, "rooted_spanning_tree", flaky)
    result, log = run_cell(tiny_root, "kron_logn20.gconn_rst", seconds=60)
    assert "device fault" in log
    assert (result["attempted"], result["failed"]) == (3, 1)
    assert result["correct"] is False
