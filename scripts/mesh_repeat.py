#!/usr/bin/env python3
"""Repeat a train cell's first step on one CUDA card, with no mesh and on a
world-1 ``("data", "model")`` NCCL mesh, and report which of the updated
master weights are bit-equal.

Run from the repository root on a machine with a card:

    python3 scripts/mesh_repeat.py [--arch gat-cora] [--shape minibatch_lg]
                                   [--tree DIR]

``--tree`` names another checkout whose ``src/`` to import (the default:
this one), so that two trees can be held to each other one after the
other in one call. Each way runs twice from the seed-0 weights, the step
at 5000 and the first synthetic batch; the JSON line says whether no mesh
repeats itself bit for bit, whether the mesh does, and whether the two
agree. A step whose backward adds into a row from several threads
(``index_add``'s float atomics on the card, as every GNN gather's
gradient) need not repeat itself bit for bit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gat-cora")
    ap.add_argument("--shape", default="minibatch_lg")
    ap.add_argument("--tree", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.train.step import build_cell
    if not torch.cuda.is_available():
        print("mesh_repeat: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    spec = get_arch(args.arch)
    shape, cfg = spec.shapes[args.shape], spec.make_config()
    mesh = make_host_mesh()
    runs: dict = {"plain": [], "mesh": []}
    try:
        for way, m in (("plain", None), ("mesh", mesh)) * 2:
            step_fn, state, _ = build_cell(spec, args.shape, m,
                                           device="cuda")
            state["opt"]["step"] = torch.tensor(5000, dtype=torch.int32,
                                                device="cuda")
            _, batch = next(synthetic_batches(spec, shape, cfg,
                                              device="cuda"))
            state, _metrics = step_fn(state, batch)
            runs[way].append({k: v.detach().clone() for k, v in gather_tree(
                state["opt"]["master"]).items()})
    finally:
        dist.destroy_process_group()

    def equal(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)
    print(json.dumps({
        "mesh_repeat": f"{args.arch}/{args.shape}",
        "tree": str(args.tree),
        "plain_repeats_bit_equal": equal(*runs["plain"]),
        "mesh_repeats_bit_equal": equal(*runs["mesh"]),
        "plain_vs_mesh_bit_equal": [equal(p, m) for p, m in
                                    zip(runs["plain"], runs["mesh"])]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
