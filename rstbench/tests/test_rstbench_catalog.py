"""Pieces are found by name, a new one needs only new files and entries,
and BENCHMARK.json keeps to the shape the benchmark's contract gives."""
from __future__ import annotations

import json
import re

import pytest

from rstbench import catalog
from rstbench.tests.conftest import REPO, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_named_piece_is_found():
    for c in BENCH["configs"]:
        cfg = catalog.config(REPO, BENCH, c["name"])
        assert cfg["name"] == c["name"]
        assert callable(catalog.generator(REPO, cfg["generator"]).build)
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        tr = catalog.traffic(REPO, w["traffic"])
        mod = catalog.entry(REPO, tr["entry"])
        assert hasattr(mod, "Entry") and callable(mod.check)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(catalog.metric(REPO, m["name"]).read)


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rstbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("rstbench/")
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (REPO / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for layer in layers:
        assert f"| {layer} |" in perf, layer
    for cell in cells:                    # every cell reports enough
        got = [m for m in BENCH["end_to_end"]
               if catalog.applies(m, cell, BENCH)]
        assert len(got) >= 2
        assert any(catalog.applies(m, cell, BENCH)
                   for m in BENCH["per_layer"])


def test_applies():
    assert catalog.applies({"name": "x", "workloads": ["a"]}, "a", BENCH)
    assert not catalog.applies({"name": "x", "workloads": ["a"]}, "b", BENCH)
    assert catalog.applies({"name": "setup_s"}, "anything", BENCH)
    assert catalog.applies({"name": "d", "moves": "bcc_ms"},
                           "kron_logn20.bcc", BENCH)
    assert not catalog.applies({"name": "d", "moves": "bcc_ms"},
                               "kron_logn20.bfs_rst", BENCH)


def test_a_new_config_traffic_metric_and_cell_need_only_new_files(
        tmp_path):
    """A throwaway configuration, traffic mix, metric and cell, added as
    files and entries to a copy of the benchmark, run with nothing else
    touched."""
    from rstbench.tests.conftest import make_root
    root = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "rstbench").rglob("*")
              if p.is_file()}
    (root / "rstbench/configs/ring_grid.json").write_text(json.dumps({
        "name": "ring_grid", "generator": "grid2d", "params": {"side": 6},
        "source": "made up", "reduced": [], "assumed": []}))
    (root / "rstbench/traffic/prrst_rst.json").write_text(json.dumps({
        "why": "pr_rst", "entry": "rst", "args": {"method": "pr_rst"},
        "warmup_calls": 1, "samples": 2, "trace_calls": 3, "sync_calls": 1,
        "guarantees": ["spanning_tree"],
        "limits": {"bad_parent": 0, "unrooted": 0}}))
    (root / "rstbench/metrics/calls_done.rst.py").write_text(
        "def read(w):\n    return float(w['calls'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ring_grid", "source": "made up",
                             "file": "rstbench/configs/ring_grid.json",
                             "reduced": [], "why": "throwaway"})
    bench["workloads"].append({"name": "ring_grid.prrst_rst",
                               "config": "ring_grid", "traffic": "prrst_rst",
                               "chips": 1, "why": "throwaway"})
    for m in bench["end_to_end"]:
        if m["name"] in ("rst_ms", "rst_p95_ms"):
            m["workloads"].append("ring_grid.prrst_rst")
    bench["per_layer"].append({"name": "calls_done.rst", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry points", "moves": "rst_ms",
                               "workloads": ["ring_grid.prrst_rst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = run_cell(root, "ring_grid.prrst_rst")
    assert result["correct"]
    assert set(result["metrics"]) == {"rst_ms", "rst_p95_ms", "setup_s"}
    traced, _ = run_cell(root, "ring_grid.prrst_rst", trace=True)
    assert traced["metrics"]["calls_done.rst"]["value"] >= 3
    for p, data in before.items():
        assert p.read_bytes() == data


def test_unknown_names_are_refused(tiny_root):
    with pytest.raises(SystemExit):
        catalog.cell(BENCH, "no_such.cell")
    with pytest.raises(SystemExit):
        catalog.metric(tiny_root, "no_such_metric")
