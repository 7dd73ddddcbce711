"""Synthetic data for the port's cells (``repro.launch.train``'s
``synthetic_batches``, recsys family only) and its smoke shapes. The
training CLI (``main``) waits for the fault-tolerant loop and checkpoints
(ROADMAP §1 items 12 and 15)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import resolve_device


# The reference's shape of a ``--smoke`` run, by family: the cell named
# "smoke" (the other families are not ported, ROADMAP §1 item 15).
SMOKE_SHAPES = {"recsys": dict(kind="train", batch=16)}


def synthetic_batches(spec, shape, cfg, seed=0, *,
                      device: str | torch.device | None = None):
    """Yield (cursor, batch) forever — DIEN's synthetic sessions.

    The same numpy draws in the same order as the reference, so one seed
    gives the reference's integer arrays exactly, as int32 (bool mask)
    tensors on ``device`` (the card unless the caller passes another).
    For a ``retrieval`` shape the batch also holds ``cand_items`` and
    ``cand_cates`` [n_candidates], drawn from a second generator (seeded
    ``[seed, 1]``) so that the reference's draws stay as they are (the
    reference has no retrieval data).
    """
    if spec.family != "recsys":
        raise NotImplementedError(
            f"synthetic data for the {spec.family!r} family is not ported "
            "yet (ROADMAP §1 item 15)")
    return _recsys_batches(shape, cfg, seed, resolve_device(device))


def _recsys_batches(shape, cfg, seed, dev):
    rng = np.random.default_rng(seed)
    cand_rng = np.random.default_rng([seed, 1])

    def i32(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    cursor = 0
    while True:
        b, t = shape["batch"], cfg.seq_len
        batch = {
            "hist_items": i32(rng.integers(0, cfg.n_items, (b, t))),
            "hist_cates": i32(rng.integers(0, cfg.n_cates, (b, t))),
            "hist_mask": torch.from_numpy(rng.random((b, t)) < 0.9).to(dev),
            "target_item": i32(rng.integers(0, cfg.n_items, b)),
            "target_cate": i32(rng.integers(0, cfg.n_cates, b)),
            "user_feats": i32(rng.integers(0, cfg.n_user_feats,
                                           (b, cfg.user_hot))),
            "label": i32(rng.integers(0, 2, b)),
        }
        if shape["kind"] == "retrieval":
            n = shape["n_candidates"]
            batch["cand_items"] = i32(cand_rng.integers(0, cfg.n_items, n))
            batch["cand_cates"] = i32(cand_rng.integers(0, cfg.n_cates, n))
        yield cursor, batch
        cursor += 1
