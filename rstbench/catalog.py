"""Find the benchmark's pieces by name under a checkout's root.

``BENCHMARK.json`` names the cells, configurations and metrics. Each piece
is a file of its own under ``rstbench/``:

  configs/<name>.json      a configuration (the path ``BENCHMARK.json`` gives)
  generators/<name>.py     ``build(params, seed, device) -> (n, src, dst)``
  traffic/<name>.json      a traffic mix: its entry, arguments and checks
  entries/<name>.py        ``Entry(graph, traffic)``: the call into the
                           program and the check of its outputs
  metrics/<name>.py        ``read(window) -> float | None``

Modules are loaded from their files, so a piece that a later change adds is
found without an edit anywhere.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import pathlib

PKG = "rstbench"


def benchmark(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                     + ", ".join(w["name"] for w in bench["workloads"]))


def config(root: pathlib.Path, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise SystemExit(f"unknown config {name!r}")


def traffic(root: pathlib.Path, name: str) -> dict:
    return json.loads((root / PKG / "traffic" / f"{name}.json").read_text())


def _module(path: pathlib.Path):
    if not path.is_file():
        raise SystemExit(f"missing {path}")
    tag = hashlib.sha256(str(path).encode()).hexdigest()[:12]
    spec = importlib.util.spec_from_file_location(
        f"{PKG}_{path.parent.name}_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(root: pathlib.Path, name: str):
    return _module(root / PKG / "generators" / f"{name}.py")


def entry(root: pathlib.Path, name: str):
    return _module(root / PKG / "entries" / f"{name}.py")


def metric(root: pathlib.Path, name: str):
    return _module(root / PKG / "metrics" / f"{name}.py")


def applies(metric_entry: dict, cell_name: str, bench: dict) -> bool:
    """Whether a metric is reported in a cell: in the cells its
    ``workloads`` lists, or, without that key, wherever the end-to-end
    metric it moves is reported (every cell for an end-to-end metric)."""
    if "workloads" in metric_entry:
        return cell_name in metric_entry["workloads"]
    moves = metric_entry.get("moves")
    if moves is None:
        return True
    target = next(m for m in bench["end_to_end"] if m["name"] == moves)
    return applies(target, cell_name, bench)
