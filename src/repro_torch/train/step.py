"""Cell factory: ``build_cell(spec, shape_name)`` → (step_fn, params, inputs).

The port of ``repro.train.step``'s DIEN serving cells. A cell runs on one
card (no mesh); ``params`` are real parameters drawn from seed 0 and
``inputs`` gives each input's shape and dtype as a tensor on the ``meta``
device (the reference's abstract inputs). Feed ``step_fn(params, batch)``
from ``repro_torch.launch.train.synthetic_batches``.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import resolve_device
from repro_torch.models.dien import (dien_forward, dien_init,
                                     dien_retrieval_score)

CAND_BLOCK = 8192


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _init(cfg, device):
    gen = torch.Generator(device=device).manual_seed(0)
    return dien_init(cfg, generator=gen, device=device)


def dien_serve_cell(cfg, *, batch: int, device, use_kernel=None):
    """Batched CTR scoring: ``step_fn(params, batch) = sigmoid(logits)``."""
    t = cfg.seq_len
    inputs = {"hist_items": _meta((batch, t), torch.int32),
              "hist_cates": _meta((batch, t), torch.int32),
              "hist_mask": _meta((batch, t), torch.bool),
              "target_item": _meta((batch,), torch.int32),
              "target_cate": _meta((batch,), torch.int32),
              "user_feats": _meta((batch, cfg.user_hot), torch.int32)}

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
    """(step_fn, params, inputs) for one serving cell of ``spec``.

    Runs on ``device``: the card unless the caller passes another.
    ``use_kernel`` goes to ``embed_bag`` (the full config runs the kernel
    on the card, as the smoke config does).
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
        raise NotImplementedError(
            f"{spec.arch_id}/{shape_name}: DIEN training is not ported yet "
            "(ROADMAP §1 item 10)")
    if kind == "serve":
        return dien_serve_cell(cfg, batch=shape["batch"], device=dev,
                               use_kernel=use_kernel)
    if kind == "retrieval":
        return dien_retrieval_cell(cfg, n_candidates=shape["n_candidates"],
                                   device=dev, use_kernel=use_kernel)
    raise KeyError(f"{spec.arch_id}/{shape_name}")
