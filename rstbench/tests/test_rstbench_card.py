"""On the card: one short run of every cell through the command line,
correct and with its metrics. Skips where there is no CUDA device."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from rstbench.tests.conftest import REPO

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run([sys.executable, "rstbench/run.py", "--workload",
                          cell, "--seed", str(2**33 + 1), "--seconds", "2",
                          "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-3000:]
    assert result["device"]["platform"] == "gpu"
    assert "setup_s" in result["metrics"]
