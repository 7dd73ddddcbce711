"""Dry run: each card's bytes of every (arch × shape) cell on the production
meshes, without the cards.

The port of ``repro.launch.dryrun``. For each (arch, shape, mesh) cell it
starts a fake process group of 256 or 512 ranks (torch's ``fake`` backend:
no collective runs, no card is touched), builds the mesh with
``make_production_mesh``, builds the cell's state and inputs on ``meta``
through ``train.step.build_cell``, places each tensor by the sharding
rules (``distributed.sharding``; AdamW's moments and master copy follow
their parameter, its step is replicated, as the reference's
``_opt_specs`` has it) and writes one JSON a cell: the per-card bytes of
the parameters, the optimizer state and the inputs, and their global
bytes. The fake group is destroyed on the way out of every cell, on
success and on error; importing this module starts none.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # 40 cells x 2 meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod-only

Not ported: what XLA's compiler and ``hlo_analysis.py`` report (the
reference's ``cost_analysis``, ``memory_analysis`` temp and output sizes,
``hlo_parsed`` collective bytes and the lower/compile timings) and
``--save-hlo``: there is no compiled HLO. The per-card bytes here are the
reference's argument bytes (state and inputs). The KV cache's ``len`` is
a host int in the port, so a decode cell's inputs hold 4 bytes fewer
than the reference's (its int32 scalar).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.distributed import sharding as shr
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_production_mesh
from repro_torch.train.step import ATOM_TYPES, POSITIONS, build_cell

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


def _gnn_label_spec(arch_id: str, mesh) -> shr.P:
    da = shr.data_axes(mesh)
    if arch_id == "gat-cora":
        return shr.P(da)
    if arch_id in ("schnet", "dimenet"):      # per-graph energies: replicated
        return shr.P()
    if arch_id == "meshgraphnet":
        return shr.P(da, None)
    raise KeyError(arch_id)


def cell_specs(spec, shape_name: str, mesh, params) -> dict:
    """The rules' specs of one full-config cell whose parameters are
    ``params``, by group, keyed as ``_leaves`` names the cell's state and
    inputs: ``{"params", "opt", "inputs"}`` (``opt`` empty for a serving
    cell)."""
    cfg = spec.make_config()
    shape = spec.shapes[shape_name]
    kind = shape["kind"]
    train = kind == "train"
    if spec.family == "lm":
        params = shr.flat_specs(shr.lm_param_specs(cfg, mesh,
                                                   fsdp=spec.fsdp))
        b, s = shape["batch"], shape["seq"]
        if train:
            inputs = shr.lm_input_specs(mesh, b, s)
        elif kind == "prefill":
            inputs = {"tokens": shr.abstract(mesh, (b, s), torch.int32,
                                              shr.data_axes(mesh), None)}
        else:
            cache, tok = shr.lm_cache_specs(cfg, mesh, b, s)
            inputs = {"token": tok["token"], "cache": cache}
    elif spec.family == "gnn":
        params = shr.gnn_param_specs(params)
        graph = shr.gnn_input_specs(
            mesh, n_nodes=shape["n_nodes"], n_edges=shape["n_edges"],
            d_feat=shape["d_feat"], positions=spec.arch_id in POSITIONS,
            atom_types=spec.arch_id in ATOM_TYPES,
            n_graphs=shape["n_graphs"],
            n_triplets=4 * shape["n_edges"] if spec.arch_id == "dimenet"
            else 0)
        inputs = {"graph": graph,
                  "labels": _gnn_label_spec(spec.arch_id, mesh)}
    elif spec.family == "recsys":
        params = shr.dien_param_specs(params, replicate_tables=not train)
        if kind == "retrieval":
            inputs = shr.dien_retrieval_specs(mesh, cfg,
                                              shape["n_candidates"])
        else:
            inputs = shr.dien_input_specs(mesh, cfg, shape["batch"])
            if not train:
                inputs.pop("label")
    else:
        raise KeyError(f"{spec.arch_id}: unknown family {spec.family!r}")
    opt = ({"m": params, "v": params, "master": params, "step": shr.P()}
           if train else {})
    return {"params": params, "opt": opt, "inputs": inputs}


def cell_bytes(spec, shape_name: str, mesh) -> dict:
    """Build the cell on ``meta`` and place it by the rules: per-card and
    global bytes by group, the host leaves, the build's seconds."""
    t0 = time.perf_counter()
    _step, state, inputs = build_cell(spec, shape_name, device="meta")
    t_build = time.perf_counter() - t0
    trees = ({"params": state["params"], "opt": state["opt"]}
             if isinstance(state, dict) else {"params": state, "opt": {}})
    trees["inputs"] = inputs
    specs = cell_specs(spec, shape_name, mesh, trees["params"])
    local = dict.fromkeys(GROUPS, 0)
    total = dict.fromkeys(GROUPS, 0)
    host = []
    for group in GROUPS:
        want = {}
        for path, s in _leaves(specs[group]):
            want[path] = s.sharding if isinstance(s, shr.Sharded) \
                else shr.NamedSharding(mesh, s)
        for path, t in _leaves(trees[group]):
            if not isinstance(t, torch.Tensor):
                host.append(f"{group}.{path}")
                continue
            if t.device.type != "meta":
                raise RuntimeError(f"{group}.{path} was built on {t.device}")
            if path not in want:
                raise KeyError(f"no sharding rule for {group}.{path}")
            shp = want.pop(path).local_shape(tuple(t.shape))
            local[group] += t.element_size() * math.prod(shp)
            total[group] += t.element_size() * t.numel()
        unused = sorted(p for p in want if f"{group}.{p}" not in host)
        if unused:
            raise KeyError(f"rules for leaves the cell lacks: {unused}")
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
    result = {
        "arch": arch_id, "shape": shape_name, "mesh": name,
        "n_devices": n_dev,
        "timings_s": {"build": round(got["build_s"], 4)},
        "bytes_per_device": got["bytes_per_device"],
        "bytes_global": got["bytes_global"],
        "host_leaves": got["host_leaves"],
        "ok": True,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=1))
    return result


def all_cells(meshes) -> list:
    return [(aid, sh, mp) for aid in ARCH_IDS
            for sh in get_arch(aid).shapes for mp in meshes]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
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

    failures = []
    for aid, sh, mp in cells:
        tag = f"{aid}__{sh}__{mesh_name(mp)}"
        if args.skip_existing and (out_dir / f"{tag}.json").exists():
            prev = json.loads((out_dir / f"{tag}.json").read_text())
            if prev.get("ok"):
                print(f"[skip] {tag}")
                continue
        t0 = time.time()
        try:
            res = run_cell(aid, sh, multi_pod=mp, out_dir=out_dir)
            b = res["bytes_per_device"]
            print(f"[ok]   {tag}  build={res['timings_s']['build']}s "
                  f"per-device {b['total'] / 1e9:.4f} GB (params "
                  f"{b['params'] / 1e9:.4f}, opt {b['opt'] / 1e9:.4f}, "
                  f"inputs {b['inputs'] / 1e9:.4f})")
        except Exception as e:
            failures.append(tag)
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / f"{tag}.json").write_text(json.dumps(
                {"arch": aid, "shape": sh, "mesh": mesh_name(mp), "ok": False,
                 "error": traceback.format_exc()}, indent=1))
            print(f"[FAIL] {tag}  {time.time() - t0:.1f}s  {e}")
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print(f"\nall {len(cells)} cells OK")


if __name__ == "__main__":
    main()
