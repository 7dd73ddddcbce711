#!/usr/bin/env python3
"""How evenly the port splits each cell's work over the production mesh.

Run from the repository root after the dry run, on the CPU (no card):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 8 --out DIR
    PYTHONPATH=src python scripts/cost_split.py --dryrun DIR [--jobs 8]

For each cell of the dry run's JSON under ``DIR`` it counts the same step
on a (1, 1) ``("data", "model")`` mesh over a fake world of one
(``launch.cost_analysis.analyze_cell``): the cell's whole flops, the
work of every card together. An even split over the mesh's n cards gives
each card whole / n; the dry run's per-card count above that is work the
port repeats on several cards (``ROADMAP.md``, "Standing departures").
Prints one JSON line a cell (``tflop_whole``, ``tflop_per_card``,
``split``: whole / per-card, against n; ``excess_tflop``: per-card −
whole / n; ``excess_ms``: that excess at the card's dense peak for the
cell's dtype, 989 TFLOP/s bf16 or 67 float32 on an H100 SXM), the cells
ranked by ``excess_ms``, and writes them to ``DIR/split.json``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PEAK_FLOP_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def whole_flops(arch: str, shape: str) -> tuple:
    """(the cell's flops on one card, its config's dtype)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_arch
    from repro_torch.launch.cost_analysis import analyze_cell
    from repro_torch.launch.dryrun import fake_world
    torch.set_num_threads(1)
    spec = get_arch(arch)
    with fake_world(1):
        mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                          mesh_dim_names=("data", "model"))
        flops = analyze_cell(spec, shape, mesh)["cost"].flops
    return flops, str(spec.make_config().dtype).removeprefix("torch.")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dryrun", type=pathlib.Path, required=True)
    ap.add_argument("--jobs", type=int, default=4)
    args = ap.parse_args(argv)
    cells = [json.loads(p.read_text()) for p in
             sorted(args.dryrun.glob("*__*.json"))]
    cells = [c for c in cells if c.get("ok")]
    keys = sorted({(c["arch"], c["shape"]) for c in cells})
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                mp_context=ctx) as pool:
        whole = dict(zip(keys, pool.map(whole_flops, *zip(*keys))))
    rows = []
    for c in cells:
        flops, dtype = whole[(c["arch"], c["shape"])]
        n, per_card = c["n_devices"], c["cost"]["flops"]
        excess = per_card - flops / n
        rows.append({"cell": f"{c['arch']}__{c['shape']}__{c['mesh']}",
                     "n": n, "tflop_whole": flops / 1e12,
                     "tflop_per_card": per_card / 1e12,
                     "split": flops / per_card if per_card else None,
                     "excess_tflop": excess / 1e12, "dtype": dtype,
                     "excess_ms": excess / PEAK_FLOP_PER_S[dtype] * 1e3})
    rows.sort(key=lambda r: -r["excess_ms"])
    for r in rows:
        print(json.dumps(r))
    (args.dryrun / "split.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
