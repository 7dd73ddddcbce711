"""Dry run: each card's bytes, flops, collectives and memory of every
(arch × shape) cell on the production meshes, without the cards.

The port of ``repro.launch.dryrun``. For each (arch, shape, mesh) cell it
starts a fake process group of 256 or 512 ranks (torch's ``fake`` backend:
no collective runs, no card is touched), builds the mesh with
``make_production_mesh``, builds the cell on that mesh on ``meta``
through ``train.step.build_cell``, whose state and inputs come back as
``Sharded`` pairs placed by the sharding rules (``distributed.sharding``;
AdamW's moments and master copy follow their parameter, its step is
replicated, as the reference's ``_opt_specs`` has it), and writes one
JSON a cell: the per-card bytes of the parameters, the optimizer state
and the inputs, and their global bytes (``bytes_per_device``,
``bytes_global``, ``host_leaves``); then one step of the cell run on
``meta`` DTensors under ``launch.cost_analysis`` (the counterpart of the
reference's compile and ``hlo_analysis``): ``cost`` (per-card ``flops``,
``bytes_accessed``, ``collective_bytes``, ``per_collective``) and
``memory_analysis`` (``argument``, ``output``, ``alias`` and
``temp_size_in_bytes``), the keys the reference's record has
(``hlo_parsed``, ``memory_analysis``), and ``timings_s`` of the build and
the analysis. The fake group is destroyed on the way out of every cell,
on success and on error; importing this module starts none. ``--jobs N``
runs the cells in N processes (a cell's step on ``meta`` takes from a
second to a minute of host time), the longest first.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # 40 cells x 2 meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod-only --jobs 8

Not ported: ``--save-hlo`` (there is no HLO), the reference's
``cost_analysis`` (XLA's own count, which it reports beside its parsed
one) and ``memory_analysis``'s ``generated_code_size_in_bytes``. The KV
cache's ``len`` is a host int in the port, so a decode cell's inputs hold
4 bytes fewer than the reference's (its int32 scalar).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import multiprocessing
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.distributed import sharding as shr
from repro_torch.launch.cost_analysis import analyze_cell
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_production_mesh
from repro_torch.train.step import build_cell

GROUPS = ("params", "opt", "inputs")


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` ranks, this process rank
    ``rank``, destroyed on exit. Refuses to start beside another group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "another one is initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, PRODUCTION_SHAPES[multi_pod][0]))


def _leaves(tree, prefix: str = ""):
    """(path, leaf) over nested dicts, modules (their named parameters)
    and ``Sharded`` pairs; other leaves as they are."""
    if isinstance(tree, torch.nn.Module):
        for k, v in tree.named_parameters():
            yield prefix + k, v
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def cell_bytes(spec, shape_name: str, mesh) -> dict:
    """Build the cell on ``mesh`` on ``meta``: per-card and global bytes
    by group (every tensor leaf is a ``Sharded`` pair), the host leaves,
    the build's seconds."""
    t0 = time.perf_counter()
    _step, state, inputs = build_cell(spec, shape_name, mesh, device="meta")
    t_build = time.perf_counter() - t0
    train = spec.shapes[shape_name]["kind"] == "train"
    trees = ({"params": state["params"], "opt": state["opt"]} if train
             else {"params": state, "opt": {}})
    trees["inputs"] = inputs
    local = dict.fromkeys(GROUPS, 0)
    total = dict.fromkeys(GROUPS, 0)
    host = []
    for group in GROUPS:
        for path, leaf in _leaves(trees[group]):
            if isinstance(leaf, shr.Sharded):
                t = leaf.tensor
                shp = leaf.sharding.local_shape(tuple(t.shape))
                local[group] += t.element_size() * math.prod(shp)
                total[group] += t.element_size() * t.numel()
            elif isinstance(leaf, torch.Tensor):
                raise RuntimeError(f"{group}.{path} is not placed on the "
                                   "mesh")
            else:
                host.append(f"{group}.{path}")
    local["total"] = sum(local[g] for g in GROUPS)
    total["total"] = sum(total[g] for g in GROUPS)
    return {"bytes_per_device": local, "bytes_global": total,
            "host_leaves": host, "build_s": t_build}


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             out_dir: pathlib.Path) -> dict:
    spec = get_arch(arch_id)
    name = mesh_name(multi_pod)
    tag = f"{arch_id}__{shape_name}__{name}"
    n_dev = 512 if multi_pod else 256
    with fake_world(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        got = cell_bytes(spec, shape_name, mesh)
        t0 = time.perf_counter()
        analysis = analyze_cell(spec, shape_name, mesh)
        t_analyze = time.perf_counter() - t0
    result = {
        "arch": arch_id, "shape": shape_name, "mesh": name,
        "n_devices": n_dev,
        "timings_s": {"build": round(got["build_s"], 4),
                      "analyze": round(t_analyze, 2)},
        "bytes_per_device": got["bytes_per_device"],
        "bytes_global": got["bytes_global"],
        "host_leaves": got["host_leaves"],
        "cost": analysis["cost"].to_json(),
        "memory_analysis": analysis["memory_analysis"],
        "ok": True,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=1))
    return result


def all_cells(meshes) -> list:
    return [(aid, sh, mp) for aid in ARCH_IDS
            for sh in get_arch(aid).shapes for mp in meshes]


#: The kinds whose step runs the most ops on ``meta``, first in a pool.
_SLOW_FIRST = ("prefill", "retrieval", "train")


def _slow_first(cell) -> int:
    kind = get_arch(cell[0]).shapes[cell[1]]["kind"]
    return _SLOW_FIRST.index(kind) if kind in _SLOW_FIRST else len(
        _SLOW_FIRST)


def ok_line(tag: str, res: dict) -> str:
    b, c = res["bytes_per_device"], res["cost"]
    temp = res["memory_analysis"]["temp_size_in_bytes"]
    return (f"[ok]   {tag}  build={res['timings_s']['build']}s "
            f"analyze={res['timings_s']['analyze']}s "
            f"per-device {b['total'] / 1e9:.4f} GB (params "
            f"{b['params'] / 1e9:.4f}, opt {b['opt'] / 1e9:.4f}, "
            f"inputs {b['inputs'] / 1e9:.4f}) "
            f"flops/dev={c['flops']:.3e} "
            f"coll/dev={c['collective_bytes']:.3e}B "
            f"temp={temp / 2**30:.2f}GiB")


def _run_one(cell, out_dir: pathlib.Path):
    """``(tag, result or None, error text)`` of one cell; a failing cell
    writes its traceback as its JSON."""
    aid, sh, mp = cell
    tag = f"{aid}__{sh}__{mesh_name(mp)}"
    try:
        return tag, run_cell(aid, sh, multi_pod=mp, out_dir=out_dir), ""
    except Exception as e:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{tag}.json").write_text(json.dumps(
            {"arch": aid, "shape": sh, "mesh": mesh_name(mp), "ok": False,
             "error": traceback.format_exc()}, indent=1))
        return tag, None, str(e)


def _worker_init() -> None:
    torch.set_num_threads(1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes to run the cells in")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)

    if args.all:
        meshes = [False, True]
        if args.single_pod_only:
            meshes = [False]
        if args.multi_pod_only:
            meshes = [True]
        cells = all_cells(meshes)
    else:
        assert args.arch and args.shape, "--arch/--shape or --all required"
        cells = [(args.arch, args.shape, args.multi_pod)]

    todo = []
    for cell in cells:
        aid, sh, mp = cell
        tag = f"{aid}__{sh}__{mesh_name(mp)}"
        if args.skip_existing and (out_dir / f"{tag}.json").exists():
            prev = json.loads((out_dir / f"{tag}.json").read_text())
            if prev.get("ok"):
                print(f"[skip] {tag}")
                continue
        todo.append(cell)

    failures = []
    t0 = time.time()

    def report(tag, res, err):
        if res is None:
            failures.append(tag)
            print(f"[FAIL] {tag}  {time.time() - t0:.1f}s  {err}",
                  flush=True)
        else:
            print(ok_line(tag, res), flush=True)

    if args.jobs > 1 and len(todo) > 1:
        todo.sort(key=_slow_first)
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=ctx, initializer=_worker_init) as pool:
            futures = [pool.submit(_run_one, cell, out_dir) for cell in todo]
            for fut in concurrent.futures.as_completed(futures):
                report(*fut.result())
    else:
        for cell in todo:
            report(*_run_one(cell, out_dir))
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print(f"\nall {len(cells)} cells OK")


if __name__ == "__main__":
    main()
