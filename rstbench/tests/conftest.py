"""Shared set-up of the benchmark's own tests.

    python -m pytest -q rstbench/tests

They run on the CPU at tiny sizes; the one test marked ``cuda`` runs a
cell on the card and skips elsewhere. ``tiny_root`` is a throwaway
checkout: a copy of ``rstbench/`` beside the program's sources, with
``BENCHMARK.json``'s configurations cut to a few hundred vertices.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (REPO, REPO / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY = {"grid5pt5000": {"side": 12}, "kron_logn20": {"scale": 10}}


def make_root(dst: pathlib.Path) -> pathlib.Path:
    """A checkout at ``dst`` whose configurations are tiny."""
    shutil.copytree(REPO / "rstbench", dst / "rstbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dst / "src").symlink_to(REPO / "src")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dst / c["file"]
        cfg = json.loads(path.read_text())
        cfg["params"].update(TINY[c["name"]])
        path.write_text(json.dumps(cfg))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> pathlib.Path:
    return make_root(tmp_path_factory.mktemp("checkout"))


def run_cell(root, workload, *, seed=2**33 + 7, seconds=0.3, trace=False):
    from rstbench import bench
    import io
    import time
    log = io.StringIO()
    result = bench.run(root, workload, seed, seconds, trace,
                       t_start=time.perf_counter(), device="cpu", log=log)
    return result, log.getvalue()
