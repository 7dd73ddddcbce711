"""Cell factory: ``build_cell(spec, shape_name)`` → (step_fn, state, inputs).

The port of ``repro.train.step``'s DIEN cells. A cell runs on one card (no
mesh). ``state`` is real: for a serving cell the parameters drawn from seed
0, for the training cell ``{"params", "opt"}`` (the same parameters,
trainable, and their AdamW state). ``inputs`` gives each input's shape and
dtype as a tensor on the ``meta`` device (the reference's abstract inputs).
Feed ``step_fn(state, batch)`` from
``repro_torch.launch.train.synthetic_batches``.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import resolve_device
from repro_torch.models.dien import (DIENParams, dien_forward, dien_init,
                                     dien_loss, dien_retrieval_score)
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule

CAND_BLOCK = 8192


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _init(cfg, device):
    gen = torch.Generator(device=device).manual_seed(0)
    return dien_init(cfg, generator=gen, device=device)


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

    Runs on ``device``: the card unless the caller passes another.
    ``use_kernel`` goes to ``embed_bag`` (the full config runs the kernel
    on the card, as the smoke config does, in training as in serving).
    """
    dev = resolve_device(device)
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    shape = spec.shapes[shape_name]
    kind = shape["kind"]
    if spec.family != "recsys":
        raise NotImplementedError(
            f"{spec.arch_id}: the {spec.family!r} cells are not ported yet "
            "(ROADMAP §1 item 15)")
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
