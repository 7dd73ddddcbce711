"""Cell factory: ``build_cell(spec, shape_name, mesh)`` → (step_fn, state,
inputs).

The port of ``repro.train.step``'s LM, DIEN and GNN cells. ``state`` is
real: for a serving cell the parameters drawn from seed 0, for a training
cell ``{"params", "opt"}`` (the same parameters, trainable, and their
AdamW state). Feed ``step_fn(state, batch)`` from
``repro_torch.launch.train.synthetic_batches``.

With no mesh a cell runs on one card and ``inputs`` gives each input's
shape and dtype as a tensor on the ``meta`` device (the reference's
abstract inputs). A cell of ``SHARDED_SHAPES`` or ``LM_SHARDED_CELLS`` at
its full shape does not fit one card and is then built with its state on
``meta``: its bytes can be read, its step is not run.

With a mesh (``launch.mesh``) the state is placed by
``distributed.sharding``'s rules as DTensors (``sharding.place_tree``:
AdamW's moments and master copy as their parameter, its step replicated,
the reference's ``_abstract`` / ``_opt_specs``), and ``inputs`` are
``Sharded`` pairs, as the reference's carry their ``NamedSharding``;
``step_fn`` places the plain batch by them and runs the sharded step. A
full LM train or prefill cell takes the reference's activation policy
(batch over the data axes, sequence over ``model`` and the remat groups in
training, experts over ``model``), a GNN cell constrains its rows over
the data axes unless ``smoke``. Losses and metrics come back as plain
tensors, the same on every rank. With ``device="meta"`` every cell is
built there (on a mesh as ``Sharded`` pairs, which ``launch.dryrun``
reads).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import resolve_device
from repro_torch.distributed import sharding as shr
from repro_torch.models import gnn
from repro_torch.models import transformer as tfm
from repro_torch.models.dien import (DIENParams, dien_forward, dien_init,
                                     dien_loss, dien_retrieval_score)
from repro_torch.optim import (adamw_init, adamw_update, cosine_schedule,
                               wsd_schedule)

CAND_BLOCK = 8192
#: GNN shapes whose cells are built on ``meta``: sharded over a pod in the
#: reference.
SHARDED_SHAPES = frozenset({"ogb_products"})
#: LM cells whose full shape does not fit one 80 GB card, built on ``meta``
#: without a mesh (bf16 weights; a KV cache of 2·L·B·S·Hkv·Dh bf16 values;
#: the reference runs them sharded over a pod):
#:   * train_4k (256 × 4096 tokens a step): one 512-position loss chunk's
#:     float32 logits alone are 256·512·V·4 bytes, 67 GB for llama3.2-1b,
#:     beside AdamW's float32 master and moments (12 B a parameter);
#:   * prefill_32k (32 × 32768 tokens): llama3.2-1b's MLP activations
#:     [1,048,576, 8192] are 17.2 GB each in bf16 and 34 GB as the float32
#:     gate, several live at once;
#:   * decode_32k (batch 128): KV 137 GB (llama3.2-1b) to 1,649 GB
#:     (moonshot);
#:   * long_500k (batch 1, 524,288 positions): KV 193 GB (minicpm-2b),
#:     206 GB (moonshot), 86 GB (dbrx);
#:   * every dbrx-132b cell: 263 GB of bf16 weights.
#: long_500k runs on one card for llama3.2-1b (17.2 GB of KV, 2.5 GB of
#: weights) and qwen3-1.7b (60.1 GB of KV, 3.4 GB of weights).
LM_SHARDED_CELLS = frozenset(
    (arch, shape)
    for arch in ("minicpm-2b", "llama3.2-1b", "qwen3-1.7b",
                 "moonshot-v1-16b-a3b", "dbrx-132b")
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k")
) - {("llama3.2-1b", "long_500k"), ("qwen3-1.7b", "long_500k")}
#: The reference's two-level remat groups of a full train cell, by depth.
REMAT_GROUPS = {16: 4, 28: 7, 40: 8, 48: 8}
#: The GNN architectures whose nodes carry 3D positions, and atom types.
POSITIONS = ("schnet", "dimenet", "meshgraphnet")
ATOM_TYPES = ("schnet", "dimenet")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def sharded_cell(arch_id: str, shape_name: str) -> bool:
    """Whether the cell at this full shape is built on ``meta`` when no
    mesh is given: it does not fit one card."""
    return (shape_name in SHARDED_SHAPES
            or (arch_id, shape_name) in LM_SHARDED_CELLS)


def _seeded(device) -> torch.Generator | None:
    """Seed 0 on ``device`` (None on ``meta``, where nothing is drawn)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(0)


def _serving(mesh):
    """A serving step's grad mode: ``inference_mode`` on one card;
    ``no_grad`` on a mesh (DTensor's views need version counters, which
    inference tensors lack)."""
    return torch.inference_mode() if mesh is None else torch.no_grad()


def _place_batch(batch: dict, specs: dict) -> dict:
    """The plain batch (the same on every rank) placed by the cell's
    ``Sharded`` input specs; a key the cell has no spec for is left as it
    is (a serving cell's ``label``)."""
    out = {}
    for k, v in batch.items():
        spec = specs.get(k)
        if isinstance(spec, dict):
            out[k] = _place_batch(v, spec)
        elif isinstance(spec, shr.Sharded):
            out[k] = shr.place(v, spec.sharding)
        else:
            out[k] = v
    return out


def _adamw_step(state: dict, loss_fn, lr_fn, compute_dtype, params_cls,
                place_grad=None):
    """One AdamW step of ``state = {"params", "opt"}`` on ``loss_fn(params)``
    at ``lr_fn(step)`` (the schedule at the state's step before the
    update): (new state, loss, grad norm, lr). On a mesh each gradient is
    placed as its parameter before the update (``place_grad(g,
    placements)`` where given, else DTensor's ``redistribute``)."""
    params = state["params"]
    names, leaves = zip(*params.named_parameters())
    loss = shr.replicated(loss_fn(params))
    grads = {}
    for n, g, p in zip(names, torch.autograd.grad(loss, leaves), leaves):
        if shr.is_dtensor(g) and g.placements != p.placements:
            g = (place_grad(g, p.placements) if place_grad is not None
                 else g.redistribute(p.device_mesh, p.placements))
        grads[n] = g
    lr = lr_fn(state["opt"]["step"])
    new_params, new_opt, gn = adamw_update(grads, state["opt"], lr,
                                           compute_dtype=compute_dtype)
    return ({"params": params_cls.from_named(new_params).requires_grad_(),
             "opt": new_opt}, loss.detach(), gn, lr)


def _train_state(params, mesh, specs):
    """``{"params", "opt"}`` of trainable ``params``, placed by the
    parameter ``specs`` on ``mesh`` (with no mesh, as they are)."""
    params = params.requires_grad_()
    state = {"params": params,
             "opt": adamw_init(dict(params.named_parameters()))}
    if mesh is None:
        return state
    return shr.place_tree(state, {"params": specs,
                                  "opt": shr.opt_specs(specs)}, mesh)


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def _lm_params(cfg, device, mesh, fsdp: bool):
    """Seed-0 parameters on ``device`` and their flat specs on ``mesh``
    (None with no mesh)."""
    params = tfm.init_params(cfg, generator=_seeded(device), device=device)
    specs = (None if mesh is None else
             shr.flat_specs(shr.lm_param_specs(cfg, mesh, fsdp=fsdp)))
    return params, specs


def lm_train_cell(cfg, *, batch: int, seq: int, device, mesh=None,
                  fsdp: bool = False, use_wsd: bool = False,
                  peak_lr: float = 3e-4):
    """One AdamW step on ``lm_loss``:
    ``step_fn(state, batch) = (new_state, {"loss", "grad_norm", "lr"})``,
    state ``{"params": LMParams, "opt": adamw state}``, batch ``{"tokens",
    "targets"}`` [B, S] int32. The learning rate is taken at the state's
    step before the update: ``wsd_schedule`` (warmup 2000, stable 100,000,
    decay 20,000) with ``use_wsd`` (minicpm-2b), else ``cosine_schedule``
    (warmup 2000, total 120,000), peak ``peak_lr``. Parameters are drawn
    from seed 0 on ``device`` (nothing on ``meta``); on ``mesh`` they are
    placed by ``lm_param_specs`` (``fsdp``), the tokens over the data
    axes."""
    if mesh is None:
        inputs = {"tokens": _meta((batch, seq), torch.int32),
                  "targets": _meta((batch, seq), torch.int32)}
    else:
        inputs = shr.lm_input_specs(mesh, batch, seq)

    def lr_fn(step):
        if use_wsd:
            return wsd_schedule(step, peak_lr=peak_lr, warmup=2000,
                                stable=100_000, decay=20_000)
        return cosine_schedule(step, peak_lr=peak_lr, warmup=2000,
                               total=120_000)

    def step_fn(state, batch_in):
        tfm.set_lm_mesh(mesh if cfg.moe_expert_axis is not None else None)
        if mesh is not None:
            batch_in = _place_batch(batch_in, inputs)
        new_state, loss, gn, lr = _adamw_step(
            state, lambda p: tfm.lm_loss(cfg, p, batch_in["tokens"],
                                         batch_in["targets"]),
            lr_fn, cfg.dtype, tfm.LMParams)
        return new_state, {"loss": loss, "grad_norm": gn, "lr": lr}

    params, specs = _lm_params(cfg, device, mesh, fsdp)
    return step_fn, _train_state(params, mesh, specs), inputs


def lm_prefill_cell(cfg, *, batch: int, seq: int, device, mesh=None,
                    fsdp: bool = False):
    """Serving prefill: ``step_fn(params, {"tokens"})`` = the last
    position's next-token logits [B, vocab] in float32 (the unembed on that
    position only), under ``inference_mode``; on a mesh the logits come
    back whole on every rank."""
    if mesh is None:
        inputs = {"tokens": _meta((batch, seq), torch.int32)}
    else:
        inputs = {"tokens": shr.abstract(mesh, (batch, seq), torch.int32,
                                         shr.data_axes(mesh), None)}

    @_serving(mesh)
    def step_fn(params, batch_in):
        tfm.set_lm_mesh(mesh if cfg.moe_expert_axis is not None else None)
        if mesh is not None:
            batch_in = _place_batch(batch_in, inputs)
        h = tfm.forward_hidden(cfg, params, batch_in["tokens"])
        logits = shr.replicated(h[:, -1, :] @ tfm._unembed(cfg, params))
        return logits[:, :cfg.vocab].float()

    params, specs = _lm_params(cfg, device, mesh, fsdp)
    return step_fn, (params if mesh is None
                     else shr.place_tree(params, specs, mesh)), inputs


def lm_decode_cell(cfg, *, batch: int, seq: int, device, mesh=None,
                   fsdp: bool = False):
    """One decode step against a ``seq``-long cache:
    ``step_fn(params, {"token", "cache"}) = decode_step(...)`` (the cache
    updated in place), under ``inference_mode``. The inputs give the
    token [B] and the cache's ``k``/``v`` ([L, B, Hkv, S, Dh]) on
    ``meta``, or on a mesh as ``lm_cache_specs`` places them (``step_fn``
    places a plain cache by them: place it once, then feed the returned
    one); ``tfm.init_kv_cache`` makes a real one."""
    if mesh is None:
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.d_head)
        inputs = {"token": _meta((batch,), torch.int32),
                  "cache": {"k": _meta(shape, cfg.dtype),
                            "v": _meta(shape, cfg.dtype), "len": 0}}
    else:
        cache, tok = shr.lm_cache_specs(cfg, mesh, batch, seq)
        inputs = {"token": tok["token"], "cache": {**cache, "len": 0}}

    @_serving(mesh)
    def step_fn(params, batch_in):
        if mesh is not None:
            batch_in = _place_batch(batch_in, inputs)
        return tfm.decode_step(cfg, params, batch_in["token"],
                               batch_in["cache"])

    params, specs = _lm_params(cfg, device, mesh, fsdp)
    return step_fn, (params if mesh is None
                     else shr.place_tree(params, specs, mesh)), inputs


def lm_cell(spec, cfg, shape_name: str, shape: dict, *, smoke: bool,
            device, mesh=None):
    """The LM branch of ``build_cell``. A full train cell takes the
    reference's remat groups (``REMAT_GROUPS``); on a mesh a full train or
    prefill cell also takes its activation policy (the reference's
    ``train/step.py:276-293``): the batch over the data axes, in training
    the sequence over ``model`` (sequence-parallel residual), and an MoE's
    experts over ``model``."""
    kind = shape["kind"]
    if not smoke and kind == "train":
        cfg = dataclasses.replace(
            cfg, remat_groups=REMAT_GROUPS.get(cfg.n_layers, 0))
    if not smoke and mesh is not None and kind in ("train", "prefill"):
        upd = {"act_batch_axes": shr.data_axes(mesh)}
        if kind == "train":
            upd["act_seq_axis"] = "model"
        if cfg.is_moe:
            upd["moe_expert_axis"] = "model"
        cfg = dataclasses.replace(cfg, **upd)
    dev = (torch.device("meta") if mesh is None and not smoke
           and sharded_cell(spec.arch_id, shape_name)
           else resolve_device(device))
    b, s = shape["batch"], shape["seq"]
    common = dict(batch=b, seq=s, device=dev, mesh=mesh, fsdp=spec.fsdp)
    if kind == "train":
        return lm_train_cell(cfg, use_wsd=spec.arch_id == "minicpm-2b",
                             **common)
    if kind == "prefill":
        return lm_prefill_cell(cfg, **common)
    if kind == "decode":
        return lm_decode_cell(cfg, **common)
    raise KeyError(f"{spec.arch_id}/{shape_name}")


def _init(cfg, device):
    return dien_init(cfg, generator=_seeded(device), device=device)


def _batch_inputs(cfg, batch: int) -> dict:
    t = cfg.seq_len
    return {"hist_items": _meta((batch, t), torch.int32),
            "hist_cates": _meta((batch, t), torch.int32),
            "hist_mask": _meta((batch, t), torch.bool),
            "target_item": _meta((batch,), torch.int32),
            "target_cate": _meta((batch,), torch.int32),
            "user_feats": _meta((batch, cfg.user_hot), torch.int32)}


def dien_train_cell(cfg, *, batch: int, device, use_kernel=None,
                    mesh=None):
    """One AdamW step on ``dien_loss``:
    ``step_fn(state, batch) = (new_state, {"loss", "grad_norm"})``, state
    ``{"params": DIENParams, "opt": adamw state}``. As in the reference, the
    learning rate is ``cosine_schedule`` at the state's step before the
    update (peak 1e-3, warmup 500, total 50,000), so step 0 has lr 0 and
    moves only the moments. The step computes in float32 and returns a new
    state (the old one is left as it was); nothing in it reads a value
    back to the host. On ``mesh`` the tables' rows are split over
    ``model`` and the batch over the data axes (``dien_param_specs``)."""
    if mesh is None:
        inputs = {**_batch_inputs(cfg, batch),
                  "label": _meta((batch,), torch.int32)}
    else:
        inputs = shr.dien_input_specs(mesh, cfg, batch)

    def step_fn(state, batch_in):
        if mesh is not None:
            batch_in = _place_batch(batch_in, inputs)
        new_state, loss, gn, _lr = _adamw_step(
            state, lambda p: dien_loss(cfg, p, batch_in, device=device,
                                       use_kernel=use_kernel),
            lambda step: cosine_schedule(step, peak_lr=1e-3, warmup=500,
                                         total=50_000),
            cfg.dtype, DIENParams)
        return new_state, {"loss": loss, "grad_norm": gn}

    params = _init(cfg, device)
    specs = None if mesh is None else shr.dien_param_specs(params)
    return step_fn, _train_state(params, mesh, specs), inputs


def gnn_loss(arch_id: str, cfg, params, g: gnn.GraphBatch,
             labels: torch.Tensor) -> torch.Tensor:
    """The reference's ``_gnn_forward_and_loss``: GAT's mean cross-entropy
    over nodes, the others' mean squared error (per-graph energies,
    MeshGraphNet's per-node outputs)."""
    if arch_id == "gat-cora":
        logits = gnn.gat_forward(cfg, params, g).float()
        logz = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
        return torch.mean(logz - gold)
    if arch_id not in gnn.FORWARD:
        raise KeyError(arch_id)
    out = gnn.FORWARD[arch_id](cfg, params, g)
    return torch.mean((out - labels) ** 2)


def gnn_label_spec(arch_id: str, shape: dict, mesh=None):
    """The labels' shape and dtype, as a ``meta`` tensor; on a mesh a
    ``Sharded`` pair: GAT's per-node classes and MeshGraphNet's per-node
    targets over the data axes, the per-graph energies replicated (there
    may be fewer graphs than ranks)."""
    if arch_id == "gat-cora":
        shape_dtype, rows = ((shape["n_nodes"],), torch.int32), True
    elif arch_id in ("schnet", "dimenet"):              # per-graph energies
        shape_dtype, rows = ((shape["n_graphs"],), torch.float32), False
    elif arch_id == "meshgraphnet":
        shape_dtype, rows = ((shape["n_nodes"], 3), torch.float32), True
    else:
        raise KeyError(arch_id)
    if mesh is None:
        return _meta(*shape_dtype)
    spec = (shr.data_axes(mesh),) if rows else ()
    return shr.abstract(mesh, *shape_dtype, *spec)


def gnn_input_spec(arch_id: str, shape: dict) -> dict:
    """The graph's tensors as ``meta`` tensors: what
    ``synthetic_batches`` gives a step (``n_triplets = 4 E`` for
    DimeNet)."""
    n, e = shape["n_nodes"], shape["n_edges"]
    g = {"node_feat": (_meta((n,), torch.int32) if arch_id in ATOM_TYPES
                       else _meta((n, shape["d_feat"]), torch.float32)),
         "src": _meta((e,), torch.int32), "dst": _meta((e,), torch.int32),
         "graph_id": _meta((n,), torch.int32)}
    if arch_id in POSITIONS:
        g["positions"] = _meta((n, 3), torch.float32)
    if arch_id == "dimenet":
        g["trip_in"] = _meta((4 * e,), torch.int32)
        g["trip_out"] = _meta((4 * e,), torch.int32)
    return g


def gnn_cell_config(arch_id: str, cfg, shape: dict):
    """``cfg`` with the input width the shape gives: GAT's ``d_in`` and
    MeshGraphNet's ``d_in_node`` are its ``d_feat``."""
    if arch_id == "gat-cora":
        return dataclasses.replace(cfg, d_in=shape["d_feat"])
    if arch_id == "meshgraphnet":
        return dataclasses.replace(cfg, d_in_node=shape["d_feat"])
    return cfg


def gnn_make_init(arch_id: str):
    """The architecture's init: ``init(cfg, generator=..., device=...)``."""
    return gnn.INIT[arch_id]


def gnn_train_cell(arch_id: str, cfg, shape: dict, *, device,
                   peak_lr: float = 1e-3, mesh=None,
                   constrain: bool = True):
    """One AdamW step on ``gnn_loss``:
    ``step_fn(state, batch) = (new_state, {"loss", "grad_norm"})``, state
    ``{"params": GNNParams, "opt": adamw state}``, batch ``{"graph": dict
    of the ``GraphBatch`` tensors, "labels"}``. The learning rate is
    ``cosine_schedule`` at the state's step before the update (peak 1e-3,
    warmup 100, total 10,000), so step 0 has lr 0. The parameters are drawn
    from seed 0 on ``device`` (on ``meta`` without a generator). On
    ``mesh`` the parameters are replicated, nodes, edges and triplets split
    over the data axes (``gnn_input_specs``), and with ``constrain`` the
    activations' rows are too (``gnn.set_gnn_data_axes``)."""
    n_nodes, n_graphs = shape["n_nodes"], shape["n_graphs"]
    if mesh is None:
        graph = gnn_input_spec(arch_id, shape)
    else:
        graph = shr.gnn_input_specs(
            mesh, n_nodes=n_nodes, n_edges=shape["n_edges"],
            d_feat=shape["d_feat"], positions=arch_id in POSITIONS,
            atom_types=arch_id in ATOM_TYPES, n_graphs=n_graphs,
            n_triplets=4 * shape["n_edges"] if arch_id == "dimenet" else 0)
    inputs = {"graph": graph, "labels": gnn_label_spec(arch_id, shape, mesh)}
    data_axes = shr.data_axes(mesh) if mesh is not None and constrain \
        else ()

    def step_fn(state, batch_in):
        gnn.set_gnn_data_axes(data_axes)
        if mesh is not None:
            batch_in = _place_batch(batch_in, inputs)
        g = gnn.GraphBatch(n_nodes=n_nodes, n_graphs=n_graphs,
                           **batch_in["graph"])
        new_state, loss, gn, _lr = _adamw_step(
            state, lambda p: gnn_loss(arch_id, cfg, p, g,
                                      batch_in["labels"]),
            lambda step: cosine_schedule(step, peak_lr=peak_lr, warmup=100,
                                         total=10_000),
            cfg.dtype, gnn.GNNParams, place_grad=shr.reduced)
        return new_state, {"loss": loss, "grad_norm": gn}

    params = gnn_make_init(arch_id)(cfg, generator=_seeded(device),
                                    device=device)
    specs = None if mesh is None else shr.gnn_param_specs(params)
    return step_fn, _train_state(params, mesh, specs), inputs


def _serving_params(cfg, device, mesh):
    """Seed-0 DIEN parameters, on a mesh all replicated (serving's tables
    are replicated, as the reference's ``replicate_tables=True``)."""
    params = _init(cfg, device)
    if mesh is None:
        return params
    return shr.place_tree(
        params, shr.dien_param_specs(params, replicate_tables=True), mesh)


def dien_serve_cell(cfg, *, batch: int, device, use_kernel=None, mesh=None):
    """Batched CTR scoring: ``step_fn(params, batch) = sigmoid(logits)``;
    on a mesh the rows are split over the data axes and the scores come
    back whole on every rank."""
    if mesh is None:
        inputs = _batch_inputs(cfg, batch)
    else:
        inputs = shr.dien_input_specs(mesh, cfg, batch)
        inputs.pop("label")

    @_serving(mesh)
    def step_fn(params, batch_in):
        if mesh is not None:
            batch_in = _place_batch(batch_in, inputs)
        return shr.replicated(torch.sigmoid(dien_forward(
            cfg, params, batch_in, device=device, use_kernel=use_kernel)))

    return step_fn, _serving_params(cfg, device, mesh), inputs


def dien_retrieval_cell(cfg, *, n_candidates: int, device, use_kernel=None,
                        mesh=None):
    """One user against ``n_candidates``: logits, padded to whole blocks of
    ``CAND_BLOCK`` as the reference's are. On a mesh the candidates are
    placed over the data axes (``dien_retrieval_specs``) and each rank
    scores them all against the replicated parameters, so the padding is
    the reference's."""
    if mesh is None:
        t = cfg.seq_len
        inputs = {"hist_items": _meta((1, t), torch.int32),
                  "hist_cates": _meta((1, t), torch.int32),
                  "hist_mask": _meta((1, t), torch.bool),
                  "user_feats": _meta((1, cfg.user_hot), torch.int32),
                  "cand_items": _meta((n_candidates,), torch.int32),
                  "cand_cates": _meta((n_candidates,), torch.int32)}
    else:
        inputs = shr.dien_retrieval_specs(mesh, cfg, n_candidates)

    @_serving(mesh)
    def step_fn(params, batch_in):
        if mesh is not None:
            batch_in = _place_batch(batch_in, inputs)
        return dien_retrieval_score(cfg, params, batch_in,
                                    cand_block=CAND_BLOCK, device=device,
                                    use_kernel=use_kernel)

    return step_fn, _serving_params(cfg, device, mesh), inputs


def build_cell(spec, shape_name: str, mesh=None, *, smoke: bool = False,
               device: str | torch.device | None = None,
               use_kernel: bool | None = None):
    """(step_fn, state, inputs) for one cell of ``spec``: a serving cell's
    state is its parameters, the training cell's ``{"params", "opt"}``.

    Runs on ``device``: the card unless the caller passes another. With no
    ``mesh``, a cell for which ``sharded_cell`` holds is built on ``meta``
    at its full shape; on a ``mesh`` every cell is placed by the sharding
    rules and built on ``device``. ``use_kernel`` goes to ``embed_bag``
    (the full config runs the kernel on the card, as the smoke config
    does, in training as in serving). A GNN's input width (GAT's ``d_in``,
    MeshGraphNet's ``d_in_node``) is the shape's ``d_feat``; on a mesh its
    rows are constrained over the data axes unless ``smoke`` (the
    reference's ``constrain=not smoke``). A full LM train cell takes the
    reference's two-level remat groups (``REMAT_GROUPS``), and on a mesh
    its activation policy (``lm_cell``).
    """
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    shape = spec.shapes[shape_name]
    kind = shape["kind"]
    if spec.family == "gnn":
        dev = (torch.device("meta") if mesh is None
               and shape_name in SHARDED_SHAPES else resolve_device(device))
        return gnn_train_cell(spec.arch_id, gnn_cell_config(spec.arch_id, cfg,
                                                            shape),
                              shape, device=dev, mesh=mesh,
                              constrain=not smoke)
    if spec.family == "lm":
        return lm_cell(spec, cfg, shape_name, shape, smoke=smoke,
                       device=device, mesh=mesh)
    if spec.family != "recsys":
        raise KeyError(f"{spec.arch_id}: unknown family {spec.family!r}")
    dev = resolve_device(device)
    common = dict(device=dev, use_kernel=use_kernel, mesh=mesh)
    if kind == "train":
        return dien_train_cell(cfg, batch=shape["batch"], **common)
    if kind == "serve":
        return dien_serve_cell(cfg, batch=shape["batch"], **common)
    if kind == "retrieval":
        return dien_retrieval_cell(cfg, n_candidates=shape["n_candidates"],
                                   **common)
    raise KeyError(f"{spec.arch_id}/{shape_name}")
