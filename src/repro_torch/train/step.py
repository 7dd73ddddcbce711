"""Cell factory: ``build_cell(spec, shape_name)`` → (step_fn, state, inputs).

The port of ``repro.train.step``'s LM, DIEN and GNN cells. A cell runs on one
card (no mesh). ``state`` is real: for a serving cell the parameters drawn
from seed 0, for a training cell ``{"params", "opt"}`` (the same
parameters, trainable, and their AdamW state). ``inputs`` gives each
input's shape and dtype as a tensor on the ``meta`` device (the
reference's abstract inputs). Feed ``step_fn(state, batch)`` from
``repro_torch.launch.train.synthetic_batches``.

A GNN cell at a shape of ``SHARDED_SHAPES`` is built with its state on
``meta`` too: it does not fit one card (ogb_products: MeshGraphNet's edge
input [E, 384] float32 alone is 95 GB, SchNet's RBF [E, 300] 74 GB), and
the reference runs it sharded over a pod, which waits for the mesh code
(ROADMAP §1 item 15). Its bytes can be read; its step is not run. So is
an LM cell of ``LM_SHARDED_CELLS`` at its full shape.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import resolve_device
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
#: (bf16 weights; a KV cache of 2·L·B·S·Hkv·Dh bf16 values; the reference
#: runs them sharded over a pod):
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
    """Whether the cell at this full shape is built on ``meta``: it does
    not fit one card and waits for the mesh code."""
    return (shape_name in SHARDED_SHAPES
            or (arch_id, shape_name) in LM_SHARDED_CELLS)


def _seeded(device) -> torch.Generator | None:
    """Seed 0 on ``device`` (None on ``meta``, where nothing is drawn)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(0)


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def lm_train_cell(cfg, *, batch: int, seq: int, device,
                  use_wsd: bool = False, peak_lr: float = 3e-4):
    """One AdamW step on ``lm_loss``:
    ``step_fn(state, batch) = (new_state, {"loss", "grad_norm", "lr"})``,
    state ``{"params": LMParams, "opt": adamw state}``, batch ``{"tokens",
    "targets"}`` [B, S] int32. The learning rate is taken at the state's
    step before the update: ``wsd_schedule`` (warmup 2000, stable 100,000,
    decay 20,000) with ``use_wsd`` (minicpm-2b), else ``cosine_schedule``
    (warmup 2000, total 120,000), peak ``peak_lr``. Parameters are drawn
    from seed 0 on ``device`` (nothing on ``meta``)."""
    inputs = {"tokens": _meta((batch, seq), torch.int32),
              "targets": _meta((batch, seq), torch.int32)}

    def step_fn(state, batch_in):
        params = state["params"]
        names, leaves = zip(*params.named_parameters())
        loss = tfm.lm_loss(cfg, params, batch_in["tokens"],
                           batch_in["targets"])
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        if use_wsd:
            lr = wsd_schedule(state["opt"]["step"], peak_lr=peak_lr,
                              warmup=2000, stable=100_000, decay=20_000)
        else:
            lr = cosine_schedule(state["opt"]["step"], peak_lr=peak_lr,
                                 warmup=2000, total=120_000)
        new_params, new_opt, gn = adamw_update(grads, state["opt"], lr,
                                               compute_dtype=cfg.dtype)
        return ({"params": tfm.LMParams.from_named(new_params
                                                   ).requires_grad_(),
                 "opt": new_opt},
                {"loss": loss.detach(), "grad_norm": gn, "lr": lr})

    params = tfm.init_params(cfg, generator=_seeded(device),
                             device=device).requires_grad_()
    opt = adamw_init(dict(params.named_parameters()))
    return step_fn, {"params": params, "opt": opt}, inputs


def lm_prefill_cell(cfg, *, batch: int, seq: int, device):
    """Serving prefill: ``step_fn(params, {"tokens"})`` = the last
    position's next-token logits [B, vocab] in float32 (the unembed on that
    position only), under ``inference_mode``."""
    inputs = {"tokens": _meta((batch, seq), torch.int32)}

    @torch.inference_mode()
    def step_fn(params, batch_in):
        h = tfm.forward_hidden(cfg, params, batch_in["tokens"])
        logits = h[:, -1, :] @ tfm._unembed(cfg, params)
        return logits[:, :cfg.vocab].float()

    return step_fn, tfm.init_params(cfg, generator=_seeded(device),
                                    device=device), inputs


def lm_decode_cell(cfg, *, batch: int, seq: int, device):
    """One decode step against a ``seq``-long cache:
    ``step_fn(params, {"token", "cache"}) = decode_step(...)`` (the cache
    updated in place), under ``inference_mode``. The inputs give the
    token [B] and the cache's ``k``/``v`` ([L, B, Hkv, S, Dh]) on
    ``meta``; ``tfm.init_kv_cache`` makes a real one."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.d_head)
    inputs = {"token": _meta((batch,), torch.int32),
              "cache": {"k": _meta(shape, cfg.dtype),
                        "v": _meta(shape, cfg.dtype), "len": 0}}

    @torch.inference_mode()
    def step_fn(params, batch_in):
        return tfm.decode_step(cfg, params, batch_in["token"],
                               batch_in["cache"])

    return step_fn, tfm.init_params(cfg, generator=_seeded(device),
                                    device=device), inputs


def lm_cell(spec, cfg, shape_name: str, shape: dict, *, smoke: bool,
            device):
    """The LM branch of ``build_cell``: a full train cell's remat groups
    from ``REMAT_GROUPS`` (no activation or expert sharding: no mesh)."""
    kind = shape["kind"]
    if not smoke and kind == "train":
        cfg = dataclasses.replace(
            cfg, remat_groups=REMAT_GROUPS.get(cfg.n_layers, 0))
    dev = (torch.device("meta") if not smoke
           and sharded_cell(spec.arch_id, shape_name)
           else resolve_device(device))
    b, s = shape["batch"], shape["seq"]
    if kind == "train":
        return lm_train_cell(cfg, batch=b, seq=s, device=dev,
                             use_wsd=spec.arch_id == "minicpm-2b")
    if kind == "prefill":
        return lm_prefill_cell(cfg, batch=b, seq=s, device=dev)
    if kind == "decode":
        return lm_decode_cell(cfg, batch=b, seq=s, device=dev)
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


def dien_train_cell(cfg, *, batch: int, device, use_kernel=None):
    """One AdamW step on ``dien_loss``:
    ``step_fn(state, batch) = (new_state, {"loss", "grad_norm"})``, state
    ``{"params": DIENParams, "opt": adamw state}``. As in the reference, the
    learning rate is ``cosine_schedule`` at the state's step before the
    update (peak 1e-3, warmup 500, total 50,000), so step 0 has lr 0 and
    moves only the moments. The step computes in float32 and returns a new
    state (the old one is left as it was); nothing in it reads a value
    back to the host."""
    inputs = {**_batch_inputs(cfg, batch),
              "label": _meta((batch,), torch.int32)}

    def step_fn(state, batch_in):
        params = state["params"]
        names, leaves = zip(*params.named_parameters())
        loss = dien_loss(cfg, params, batch_in, device=device,
                         use_kernel=use_kernel)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        lr = cosine_schedule(state["opt"]["step"], peak_lr=1e-3,
                             warmup=500, total=50_000)
        new_params, new_opt, gn = adamw_update(grads, state["opt"], lr,
                                               compute_dtype=cfg.dtype)
        return ({"params": DIENParams.from_named(new_params).requires_grad_(),
                 "opt": new_opt},
                {"loss": loss.detach(), "grad_norm": gn})

    params = _init(cfg, device).requires_grad_()
    opt = adamw_init(dict(params.named_parameters()))
    return step_fn, {"params": params, "opt": opt}, inputs


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


def gnn_label_spec(arch_id: str, shape: dict) -> torch.Tensor:
    """The labels' shape and dtype, as a ``meta`` tensor."""
    if arch_id == "gat-cora":
        return _meta((shape["n_nodes"],), torch.int32)
    if arch_id in ("schnet", "dimenet"):                # per-graph energies
        return _meta((shape["n_graphs"],), torch.float32)
    if arch_id == "meshgraphnet":
        return _meta((shape["n_nodes"], 3), torch.float32)
    raise KeyError(arch_id)


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
                   peak_lr: float = 1e-3):
    """One AdamW step on ``gnn_loss``:
    ``step_fn(state, batch) = (new_state, {"loss", "grad_norm"})``, state
    ``{"params": GNNParams, "opt": adamw state}``, batch ``{"graph": dict
    of the ``GraphBatch`` tensors, "labels"}``. The learning rate is
    ``cosine_schedule`` at the state's step before the update (peak 1e-3,
    warmup 100, total 10,000), so step 0 has lr 0. The parameters are drawn
    from seed 0 on ``device`` (on ``meta`` without a generator)."""
    inputs = {"graph": gnn_input_spec(arch_id, shape),
              "labels": gnn_label_spec(arch_id, shape)}
    n_nodes, n_graphs = shape["n_nodes"], shape["n_graphs"]

    def step_fn(state, batch_in):
        g = gnn.GraphBatch(n_nodes=n_nodes, n_graphs=n_graphs,
                           **batch_in["graph"])
        params = state["params"]
        names, leaves = zip(*params.named_parameters())
        loss = gnn_loss(arch_id, cfg, params, g, batch_in["labels"])
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        lr = cosine_schedule(state["opt"]["step"], peak_lr=peak_lr,
                             warmup=100, total=10_000)
        new_params, new_opt, gn = adamw_update(grads, state["opt"], lr,
                                               compute_dtype=cfg.dtype)
        return ({"params": gnn.GNNParams.from_named(new_params
                                                    ).requires_grad_(),
                 "opt": new_opt},
                {"loss": loss.detach(), "grad_norm": gn})

    params = gnn_make_init(arch_id)(cfg, generator=_seeded(device),
                                    device=device).requires_grad_()
    opt = adamw_init(dict(params.named_parameters()))
    return step_fn, {"params": params, "opt": opt}, inputs


def dien_serve_cell(cfg, *, batch: int, device, use_kernel=None):
    """Batched CTR scoring: ``step_fn(params, batch) = sigmoid(logits)``."""
    inputs = _batch_inputs(cfg, batch)

    @torch.inference_mode()
    def step_fn(params, batch_in):
        return torch.sigmoid(dien_forward(cfg, params, batch_in, device=device,
                                          use_kernel=use_kernel))

    return step_fn, _init(cfg, device), inputs


def dien_retrieval_cell(cfg, *, n_candidates: int, device, use_kernel=None):
    """One user against ``n_candidates``: logits, padded to whole blocks of
    ``CAND_BLOCK`` as the reference's are."""
    t = cfg.seq_len
    inputs = {"hist_items": _meta((1, t), torch.int32),
              "hist_cates": _meta((1, t), torch.int32),
              "hist_mask": _meta((1, t), torch.bool),
              "user_feats": _meta((1, cfg.user_hot), torch.int32),
              "cand_items": _meta((n_candidates,), torch.int32),
              "cand_cates": _meta((n_candidates,), torch.int32)}

    @torch.inference_mode()
    def step_fn(params, batch_in):
        return dien_retrieval_score(cfg, params, batch_in,
                                    cand_block=CAND_BLOCK, device=device,
                                    use_kernel=use_kernel)

    return step_fn, _init(cfg, device), inputs


def build_cell(spec, shape_name: str, *, smoke: bool = False,
               device: str | torch.device | None = None,
               use_kernel: bool | None = None):
    """(step_fn, state, inputs) for one cell of ``spec``: a serving cell's
    state is its parameters, the training cell's ``{"params", "opt"}``.

    Runs on ``device``: the card unless the caller passes another (a cell
    for which ``sharded_cell`` holds, at its full shape: on ``meta``).
    ``use_kernel`` goes to ``embed_bag`` (the full config runs the kernel
    on the card, as the smoke config does, in training as in serving). A
    GNN's input width (GAT's ``d_in``, MeshGraphNet's ``d_in_node``) is
    the shape's ``d_feat``. A full LM train cell takes the reference's
    two-level remat groups (``REMAT_GROUPS``).
    """
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    shape = spec.shapes[shape_name]
    kind = shape["kind"]
    if spec.family == "gnn":
        dev = (torch.device("meta") if shape_name in SHARDED_SHAPES
               else resolve_device(device))
        return gnn_train_cell(spec.arch_id, gnn_cell_config(spec.arch_id, cfg,
                                                            shape),
                              shape, device=dev)
    if spec.family == "lm":
        return lm_cell(spec, cfg, shape_name, shape, smoke=smoke,
                       device=device)
    if spec.family != "recsys":
        raise KeyError(f"{spec.arch_id}: unknown family {spec.family!r}")
    dev = resolve_device(device)
    if kind == "train":
        return dien_train_cell(cfg, batch=shape["batch"], device=dev,
                               use_kernel=use_kernel)
    if kind == "serve":
        return dien_serve_cell(cfg, batch=shape["batch"], device=dev,
                               use_kernel=use_kernel)
    if kind == "retrieval":
        return dien_retrieval_cell(cfg, n_candidates=shape["n_candidates"],
                                   device=dev, use_kernel=use_kernel)
    raise KeyError(f"{spec.arch_id}/{shape_name}")
