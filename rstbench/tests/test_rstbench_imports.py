"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's)."""
from __future__ import annotations

import ast
import subprocess
import sys

from rstbench import bench
from rstbench.tests.conftest import REPO

BANNED = {"jax", "jaxlib", "flax", "repro"}


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "repro" not in bench.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert bench.banned_modules() == ["repro"]


def test_no_source_imports_a_banned_name():
    for path in (REPO / "rstbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BANNED, (path, name)


def test_a_run_loads_no_banned_module(tmp_path):
    """A whole run of every cell, in a fresh process, on the CPU."""
    from rstbench.tests.conftest import make_root
    root = make_root(tmp_path)
    code = f"""
import sys, time
sys.path[:0] = [{str(root)!r}, {str(root / 'src')!r}]
from rstbench import bench, catalog
b = catalog.benchmark(bench.pathlib.Path({str(root)!r}))
for w in b["workloads"]:
    r = bench.run(bench.pathlib.Path({str(root)!r}), w["name"], 3, 0.05,
                  False, t_start=time.perf_counter(), device="cpu")
    assert r["correct"], w
print(sorted({{m.split(".")[0] for m in sys.modules}} & set({sorted(BANNED)!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                      "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_the_program_a_run_fails(tmp_path):
    """A directory with BENCHMARK.json and rstbench/ alone gives no
    result and a non-zero exit."""
    import shutil
    shutil.copytree(REPO / "rstbench", tmp_path / "rstbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "rstbench/run.py", "--workload",
         "kron_logn20.bfs_rst", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
