"""One rank of the port's sharded-cell tests (gloo, CPU tensors), started
by ``tests/test_torch_mesh_cells.py`` once per module:

    python tests/torch_mesh_ranks.py RANK WORLD STORE JOB OUT

``STORE`` is a ``FileStore`` path (no TCP port), ``JOB`` an ``.npz`` of
each case's starting state (``<case>/p/<name>``, ``<case>/m/<name>``,
``<case>/v/<name>``, ``<case>/start``) and decode tokens, ``OUT`` the
directory this rank writes ``rank<RANK>.npz`` into. On the (2, WORLD / 2)
``("data", "model")`` host mesh it builds each case's cell with the mesh,
places the job's state by the cell's rules, runs one step on the first
synthetic batch and writes the loss and grad norm (every rank) and the
new parameters, m and v gathered whole (rank 0):
  * ``qwen3``: qwen3-1.7b's smoke train cell (float32);
  * ``moonshot``: moonshot's, with ``act_batch_axes=("data",)``,
    ``act_seq_axis="model"`` and ``moe_expert_axis="model"``; each MoE
    layer's routing of the first forward (``moonshot/route/<layer>/``: the
    rank's token table and its ``moe_route_local`` results);
  * ``llama`` and ``minicpm``: llama3.2-1b's and minicpm-2b's, with a full
    train cell's ``act_batch_axes`` and ``act_seq_axis``: attention with
    one query head a model rank (two sharing a kv head), and with 6 heads
    on 4 ranks two head blocks of 3, each over two query blocks;
  * ``moonshot_prefill``: its prefill cell on the same weights, batch axes
    and expert axis set (the logits, ``<case>/logits``);
  * ``gnn/<arch>``: the four GNN smoke train cells with their rows
    constrained over ``data``; ``gnn/dimenet@2`` DimeNet's again with its
    triplets in ``DIMENET_CHUNKS`` chunks (``_pick_chunks`` patched), from
    ``gnn/dimenet``'s starting state; the cases of ``GNN_LAYOUTS`` from
    their architecture's state: each cell again with every gather and
    scatter by blocks (``_blocks_cheaper`` patched; the smoke shapes make
    the whole table cheaper), and MeshGraphNet on a (4, 2) mesh by blocks
    and on an (8, 1) mesh whole;
  * ``prim/<layout>/``: ``gnn._gather_rows``, ``scatter_sum`` and
    ``_segment_max`` on ``prim_inputs()`` (24 nodes, 36 edges: pieces of
    5 rows, the last padded), rows constrained over ``data``, by blocks
    and whole: the results and the gradients of a weighted sum, whole;
  * ``dien``: DIEN's smoke train cell, tables row-split over ``model``;
  * ``decode/<case>/<batch>/<start>``: the decode cell of qwen3, llama,
    moonshot and minicpm (DECODE_CASES) on their train cases' weights,
    three steps on a cache of 16 positions (batch 4: batch over ``data``,
    positions over ``model``; batch 1: positions over ``data``, the heads
    over ``model``; minicpm's 6 heads on 4 ranks in 2 head blocks, each
    over 2 position ranges), from an empty cache (``empty``) and from the
    job's ``decode/<case>/k``, ``v`` at ``len`` DECODE_FILLED
    (``filled``: every rank's positions hold visible entries), the logits
    of each; moonshot's routing of every layer and step
    (``decode/moonshot/<batch>/<start>/route/<i>/``: the gathered logits
    and ``route_logits``'s results).
"""
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

LM_SHAPE = dict(kind="train", batch=4, seq=64)
#: A full train cell's activation fields on the (2, 4) host mesh.
TRAIN_FIELDS = dict(act_batch_axes=("data",), act_seq_axis="model")
FIELDS = {"qwen3": ("qwen3-1.7b", {}),
          "moonshot": ("moonshot-v1-16b-a3b",
                       dict(TRAIN_FIELDS, moe_expert_axis="model")),
          "llama": ("llama3.2-1b", TRAIN_FIELDS),
          "minicpm": ("minicpm-2b", TRAIN_FIELDS)}
PREFILL_FIELDS = dict(act_batch_axes=("data",), moe_expert_axis="model")
GNN_ARCHS = ("gat-cora", "schnet", "dimenet", "meshgraphnet")
DIMENET_CHUNKS = 2
#: Further GNN cases: name → (arch, mesh (data, model), triplet chunks or
#: None, every gather and scatter by blocks). Each is held to its
#: architecture's reference step (the name before ``#``).
GNN_LAYOUTS = {
    **{f"gnn/{a}#blocks": (a, (2, 4), None, True) for a in GNN_ARCHS},
    f"gnn/dimenet@{DIMENET_CHUNKS}#blocks": ("dimenet", (2, 4),
                                              DIMENET_CHUNKS, True),
    "gnn/meshgraphnet#4x2": ("meshgraphnet", (4, 2), None, True),
    "gnn/meshgraphnet#8x1": ("meshgraphnet", (8, 1), None, False),
}
#: ``prim_inputs``' graph: 36 edges over 2 data ranks are 18 a rank, cut
#: into 4 pieces of 5 rows (the last padded by 2).
PRIM_NODES, PRIM_EDGES = 24, 36
DECODE_LEN = 16
DECODE_STEPS = 3
DECODE_CASES = ("qwen3", "llama", "moonshot", "minicpm")
DECODE_FILLED = 12


def lm_spec(arch: str, shape: dict, **fields):
    """``arch``'s spec with one cell "smoke" of ``shape`` whose smoke
    config is float32 with ``fields``."""
    from repro_torch.configs import get_arch
    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.make_smoke_config(), dtype=torch.float32,
                              **fields)
    return dataclasses.replace(spec, shapes={"smoke": dict(shape)},
                               make_smoke_config=lambda: cfg), cfg


def named_arrays(data, prefix: str) -> dict:
    return {k[len(prefix):]: torch.from_numpy(np.array(data[k]))
            for k in data.files if k.startswith(prefix)}


def start_state(data, case: str, cls, specs_fn, mesh):
    """The job's parameters, moments and step for ``case``, placed."""
    from repro_torch.distributed import sharding as shr
    from repro_torch.optim import adamw_init
    params = cls.from_named(named_arrays(data, f"{case}/p/")).requires_grad_()
    opt = adamw_init(dict(params.named_parameters()))
    for part in ("m", "v"):
        got = named_arrays(data, f"{case}/{part}/")
        if got:
            opt[part] = got
    opt["step"] = torch.tensor(int(data[f"{case}/start"]), dtype=torch.int32)
    specs = specs_fn(params)
    return shr.place_tree({"params": params, "opt": opt},
                          {"params": specs, "opt": shr.opt_specs(specs)},
                          mesh)


def whole(t) -> np.ndarray:
    from repro_torch.distributed.sharding import is_dtensor
    t = t.full_tensor() if is_dtensor(t) else t
    return t.detach().numpy()


def train_case(res, rank, case, spec, cfg, step_fn, state):
    from repro_torch.launch.train import synthetic_batches
    _, batch = next(synthetic_batches(spec, spec.shapes["smoke"], cfg,
                                      device="cpu"))
    state, metrics = step_fn(state, batch)
    res[f"{case}/loss"] = metrics["loss"].numpy()
    res[f"{case}/gn"] = metrics["grad_norm"].numpy()
    named = dict(state["params"].named_parameters())
    for k, p in named.items():
        # full_tensor is a collective: every rank gathers, rank 0 keeps.
        got = {"p": whole(p), "m": whole(state["opt"]["m"][k]),
               "v": whole(state["opt"]["v"][k])}
        if rank == 0:
            for part, a in got.items():
                res[f"{case}/{part}/{k}"] = a
    res[f"{case}/step"] = np.array(int(state["opt"]["step"]))


def gnn_case(res, rank, data, mesh, arch: str, case: str, *,
             chunks: int | None = None, blocks: bool = False) -> None:
    """``arch``'s smoke train cell, rows constrained over ``data``, from
    the job's ``gnn/<arch>`` state; results under ``case``. With
    ``chunks`` DimeNet's triplets run in that many chunks; with ``blocks``
    every gather and scatter goes by blocks."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch.train import smoke_spec
    from repro_torch.models import gnn as tg
    from repro_torch.train import step as ts
    base = get_arch(arch)
    spec = smoke_spec(base, base.make_smoke_config())
    cfg = ts.gnn_cell_config(arch, spec.make_smoke_config(),
                             spec.shapes["smoke"])
    step_fn, _, _ = ts.gnn_train_cell(arch, cfg, spec.shapes["smoke"],
                                      device=torch.device("cpu"),
                                      mesh=mesh, constrain=True)
    state = start_state(data, f"gnn/{arch}", tg.GNNParams,
                        shr.gnn_param_specs, mesh)
    pick, cheaper = tg._pick_chunks, tg._blocks_cheaper
    if chunks is not None:
        tg._pick_chunks = lambda t, target: chunks
    if blocks:
        tg._blocks_cheaper = lambda sp, n, k: True
    try:
        train_case(res, rank, case, spec, cfg, step_fn, state)
    finally:
        tg._pick_chunks, tg._blocks_cheaper = pick, cheaper


def prim_inputs() -> dict:
    """Seeded tables, index rows (some ≥ PRIM_NODES: dropped by a
    scatter) and weights for the ``prim`` cases."""
    rng = np.random.default_rng(7)
    n, e = PRIM_NODES, PRIM_EDGES
    dst = rng.integers(0, n, e)
    dst[[5, 17, 30]] = n + 3
    f32 = np.float32
    return {"x": rng.standard_normal((n, 3)).astype(f32),
            "y": rng.standard_normal((n, 2)).astype(f32),
            "src": rng.integers(0, n, e).astype(np.int32),
            "dst": dst.astype(np.int32),
            "v": rng.standard_normal((e, 3)).astype(f32),
            "wx": rng.standard_normal((e, 3)).astype(f32),
            "wy": rng.standard_normal((e, 2)).astype(f32),
            "wn": rng.standard_normal((n, 3)).astype(f32)}


def prim_case(res, mesh, layout: str) -> None:
    """The ``prim/<layout>/`` results: ``x[src]`` and ``y[min(dst, n -
    1)]`` in one ``_gather_rows`` call, ``scatter_sum(v, dst, n)`` and
    ``_segment_max(v, dst, n)``, with the gradients of ``Σ wx·x[src] +
    Σ wy·y[dst]`` (x, y) and ``Σ wn·scatter_sum`` (v); whole."""
    from repro_torch.distributed import sharding as shr
    from repro_torch.models import gnn as tg
    inp = {k: torch.from_numpy(a) for k, a in prim_inputs().items()}
    n = PRIM_NODES

    def rows(t):
        spec = shr.P("data", *([None] * (t.dim() - 1)))
        return shr.place(t, shr.NamedSharding(mesh, spec))
    x, y, v = (rows(inp[k].requires_grad_()) for k in ("x", "y", "v"))
    src, dst = rows(inp["src"].long()), rows(inp["dst"])
    cheaper = tg._blocks_cheaper
    tg._blocks_cheaper = lambda sp, n_, k: layout == "blocks"
    tg.set_gnn_data_axes(("data",))
    try:
        gx, gy = tg._gather_rows((x, src), (y, tg._clip_index(dst, n)))
        total = tg.scatter_sum(v, dst, n)
        top = tg._segment_max(v, dst, n)
        loss = shr.replicated((gx * rows(inp["wx"])).sum()
                              + (gy * rows(inp["wy"])).sum())
        dx, dy = torch.autograd.grad(loss, [x, y])
        dv, = torch.autograd.grad(shr.replicated(
            (total * rows(inp["wn"])).sum()), [v])
    finally:
        tg._blocks_cheaper = cheaper
        tg.set_gnn_data_axes(())
    for name, t in (("gx", gx), ("gy", gy), ("sum", total), ("max", top),
                    ("dx", dx), ("dy", dy), ("dv", dv)):
        res[f"prim/{layout}/{name}"] = whole(t)


def main(rank: int, world: int, store: str, job: str, out: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import dien as td
    from repro_torch.models import transformer as tt
    from repro_torch.train import step as ts

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    data = np.load(job)
    mesh = make_host_mesh(2, world // 2, device_type="cpu")
    res = {"coordinate": np.array(mesh.get_coordinate())}

    # The LM train cells; moonshot's routing recorded on the way.
    route_calls = []
    local_route = tt.moe_route_local

    def recording(x, router_w, cfg, ridx, e_per):
        out = local_route(x, router_w, cfg, ridx, e_per)
        route_calls.append((x.detach().clone(), ridx, e_per, out))
        return out
    tt.moe_route_local = recording
    for case, (arch, fields) in FIELDS.items():
        spec, cfg = lm_spec(arch, LM_SHAPE, **fields)
        step_fn, _, _ = ts.build_cell(spec, "smoke", mesh, smoke=True,
                                      device="cpu")
        state = start_state(data, case, tt.LMParams, lambda p: shr.flat_specs(
            shr.lm_param_specs(cfg, mesh, fsdp=spec.fsdp)), mesh)
        route_calls.clear()
        train_case(res, rank, case, spec, cfg, step_fn, state)
        if case == "moonshot":
            routes = list(route_calls)
    tt.moe_route_local = local_route
    for i, (x, ridx, e_per, (_g, le, pos, keep, cap)) in enumerate(
            routes[:2]):
        tag = f"moonshot/route/{i}"
        res[f"{tag}/x"], res[f"{tag}/ridx"] = x.numpy(), np.array(ridx)
        res[f"{tag}/local_e"], res[f"{tag}/pos"] = le.numpy(), pos.numpy()
        res[f"{tag}/keep"], res[f"{tag}/cap"] = keep.numpy(), np.array(cap)

    # moonshot's prefill on the train case's weights.
    spec, cfg = lm_spec("moonshot-v1-16b-a3b",
                        dict(LM_SHAPE, kind="prefill"), **PREFILL_FIELDS)
    step_fn, _, _ = ts.build_cell(spec, "smoke", mesh, smoke=True,
                                  device="cpu")
    params = shr.place_tree(
        tt.LMParams.from_named(named_arrays(data, "moonshot/p/")),
        shr.flat_specs(shr.lm_param_specs(cfg, mesh, fsdp=spec.fsdp)), mesh)
    tokens = torch.from_numpy(data["prefill/tokens"])
    res["moonshot_prefill/logits"] = step_fn(params, {"tokens": tokens}
                                             ).numpy()

    # The GNN cells, rows constrained over the data axis; DimeNet again
    # with its triplets in chunks; the cells by blocks and on other meshes;
    # the gathers and scatters alone, by blocks and whole.
    for arch in GNN_ARCHS:
        gnn_case(res, rank, data, mesh, arch, f"gnn/{arch}")
    gnn_case(res, rank, data, mesh, "dimenet",
             f"gnn/dimenet@{DIMENET_CHUNKS}", chunks=DIMENET_CHUNKS)
    meshes = {(2, world // 2): mesh}
    for case, (arch, dims, chunks, blocks) in GNN_LAYOUTS.items():
        if dims not in meshes:
            meshes[dims] = make_host_mesh(*dims, device_type="cpu")
        gnn_case(res, rank, data, meshes[dims], arch, case, chunks=chunks,
                 blocks=blocks)
    for layout in ("blocks", "whole"):
        prim_case(res, mesh, layout)

    # DIEN's train cell, its tables' rows over the model axis.
    base = get_arch("dien")
    spec = dataclasses.replace(base, shapes={"smoke": dict(
        kind="train", batch=16)})
    step_fn, _, _ = ts.build_cell(spec, "smoke", mesh, smoke=True,
                                  device="cpu")
    state = start_state(data, "dien", td.DIENParams, shr.dien_param_specs,
                        mesh)
    train_case(res, rank, "dien", spec, spec.make_smoke_config(), step_fn,
               state)

    # The decode cells from an empty and a filled cache; moonshot's
    # routing recorded.
    route = tt.route_logits
    for case in DECODE_CASES:
        arch = FIELDS[case][0]
        for batch in (4, 1):
            spec, cfg = lm_spec(arch, dict(kind="decode", batch=batch,
                                           seq=DECODE_LEN))
            step_fn, _, _ = ts.build_cell(spec, "smoke", mesh, smoke=True,
                                          device="cpu")
            params = shr.place_tree(
                tt.LMParams.from_named(named_arrays(data, f"{case}/p/")),
                shr.flat_specs(shr.lm_param_specs(cfg, mesh,
                                                  fsdp=spec.fsdp)), mesh)
            toks = torch.from_numpy(data["decode/tokens"][:, :batch])
            for start in ("empty", "filled"):
                cache = tt.init_kv_cache(cfg, batch, DECODE_LEN,
                                         device="cpu")
                if start == "filled":
                    for k in ("k", "v"):
                        cache[k] = torch.from_numpy(np.ascontiguousarray(
                            data[f"decode/{case}/{k}"][:, :batch]))
                    cache["len"] = DECODE_FILLED
                tag = f"decode/{case}/{batch}/{start}"
                routes = []

                def recording(logits, cfg):
                    out = route(logits, cfg)
                    routes.append((logits.clone(), out))
                    return out
                tt.route_logits = recording
                try:
                    for i in range(DECODE_STEPS):
                        logits, cache = step_fn(params, {"token": toks[i],
                                                         "cache": cache})
                        res[f"{tag}/{i}"] = logits.numpy()
                finally:
                    tt.route_logits = route
                res[f"{tag}/len"] = np.array(cache["len"])
                for i, (lg, (_g, top_e, pos, keep, cap)) in enumerate(
                        routes):
                    rt = f"{tag}/route/{i}"
                    res[f"{rt}/logits"], res[f"{rt}/top_e"] = lg.numpy(), \
                        top_e.numpy()
                    res[f"{rt}/pos"], res[f"{rt}/keep"] = pos.numpy(), \
                        keep.numpy()
                    res[f"{rt}/cap"] = np.array(cap)

    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
