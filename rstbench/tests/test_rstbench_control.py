"""The control: the reference's own answer passes the check, and each
answer with one stated guarantee broken fails it, in every cell."""
from __future__ import annotations

import io
import json

import pytest

from rstbench import control
from rstbench.tests.conftest import REPO

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(tiny_root, cell):
    lines = control.run_control(tiny_root, cell, [1, 2**34 + 9, 77], "cpu",
                                out=io.StringIO())
    by = {}
    for ln in lines:
        by.setdefault(ln["answer"], []).append(ln)
    assert all(ln["correct"] for ln in by.pop("reference"))
    assert len(by) >= 4
    for name, runs in by.items():
        assert len(runs) == 3
        assert not any(ln["correct"] for ln in runs), name
