"""DIEN — Deep Interest Evolution Network  [arXiv:1809.03672].

The port of ``repro.models.dien``: the forward path, its loss and the
retrieval scorer. Config (assigned):
embed_dim=18, seq_len=100, gru_dim=108, mlp=200-80, interaction=augru.

Structure:
  1. sparse embeddings: item + category tables, and the multi-hot user
     profile through the ``embed_bag`` kernel (mean);
  2. interest extractor: GRU over the behavior sequence (a loop over T);
  3. interest evolution: attention scores w.r.t. the target item drive an
     AUGRU (attention-gated update);
  4. prediction MLP 200→80→1 on [final_state ‖ target ‖ user ‖ sum-pool].

Serving shapes:
  serve_p99/serve_bulk — batched CTR scoring (one target per row);
  retrieval_cand       — ONE user vs 10^6 candidates: the target-independent
      interest GRU runs once, then attention+AUGRU run over candidate
      blocks (a loop over blocks, each a batch of candidates).

Training: ``dien_loss`` (binary cross-entropy on the logits) through the
same forward; the embed_bag kernel's backward is its wrapper's hand-written
VJP.

Parameters keep the reference's names and its ``[in, out]`` layout
(``x @ w + b``), so ``params_from_reference`` transposes nothing. They are
built without gradients, for serving; ``params.requires_grad_()`` makes
them trainable.

Over a device mesh (DTensor parameters and batch, placed by
``distributed.sharding``'s rules) each rank runs the forward on its block
of the batch rows against the replicated dense weights. A table whose
rows are split (training: ``P("model", None)``) is read by a masked
lookup on this rank's rows, summed over the ranks that split them; the
user profile's bag runs the ``embed_bag`` kernel on the rank's rows as a
weighted sum (weight 0 for an id outside them), then the sum over the
ranks is divided by the whole bag's weight. Retrieval gathers its
replicated parameters and candidates and scores them all on every rank.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.graph import resolve_device
from repro_torch.distributed import sharding as shr
from repro_torch.kernels.embed_bag.ops import embed_bag


@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: tuple = (200, 80)
    n_items: int = 1_000_000
    n_cates: int = 10_000
    n_user_feats: int = 100_000
    user_hot: int = 8            # multi-hot user profile field width
    dtype: torch.dtype = torch.float32

    @property
    def d_behavior(self) -> int:
        return 2 * self.embed_dim     # item ‖ cate


_GRU_KEYS = ("wz", "wr", "wh", "bz", "br", "bh")


class DIENParams(nn.Module):
    """DIEN's parameters under the reference's names: ``item_table``,
    ``cate_table``, ``user_table``, ``gru1`` and ``augru`` (``wz``, ``wr``,
    ``wh``, ``bz``, ``br``, ``bh``), ``att_w``, ``proj_target`` and ``mlp``
    (a list of ``(w, b)``). ``params[name]`` reads one, as the reference's
    dict does. Built frozen; ``requires_grad_()`` makes them trainable.
    ``named_parameters()`` names them ``item_table``, ``gru1.wz`` and
    ``mlp.<layer>.<0 for w, 1 for b>``; ``from_named`` inverts it."""

    def __init__(self, tree: dict):
        super().__init__()

        def frozen(t):
            return nn.Parameter(t, requires_grad=False)

        for name in ("item_table", "cate_table", "user_table", "att_w",
                     "proj_target"):
            setattr(self, name, frozen(tree[name]))
        for name in ("gru1", "augru"):
            setattr(self, name, nn.ParameterDict(
                {k: frozen(tree[name][k]) for k in _GRU_KEYS}))
        self.mlp = nn.ModuleList(nn.ParameterList([frozen(w), frozen(b)])
                                 for w, b in tree["mlp"])

    def __getitem__(self, name: str):
        return getattr(self, name)

    @classmethod
    def from_named(cls, named: dict) -> "DIENParams":
        """Frozen parameters from tensors under ``named_parameters()``'s
        names."""
        tree = {"gru1": {}, "augru": {}}
        mlp = {}
        for name, t in named.items():
            head, *rest = name.split(".")
            if head == "mlp":
                mlp.setdefault(int(rest[0]), {})[int(rest[1])] = t
            elif rest:
                tree[head][rest[0]] = t
            else:
                tree[head] = t
        tree["mlp"] = [(mlp[i][0], mlp[i][1]) for i in sorted(mlp)]
        return cls(tree)

    @property
    def device(self) -> torch.device:
        return self.item_table.device

    def to_reference(self) -> dict:
        """The reference's parameter tree, numpy leaves (bf16 as float32)."""
        def arr(t):
            t = t.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        tree = {name: arr(self[name]) for name in (
            "item_table", "cate_table", "user_table", "att_w", "proj_target")}
        for name in ("gru1", "augru"):
            tree[name] = {k: arr(self[name][k]) for k in _GRU_KEYS}
        tree["mlp"] = [(arr(w), arr(b)) for w, b in self.mlp]
        return tree


def dien_init(cfg: DIENConfig, *, generator: torch.Generator,
              device: str | torch.device | None = None) -> DIENParams:
    """Random parameters with the reference's distributions (``dien.py``
    ``dien_init``), drawn from ``generator``, which lies on ``device``."""
    dev = resolve_device(device)
    d_in = cfg.d_behavior
    g = cfg.gru_dim

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev) * scale
                ).to(cfg.dtype)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=dev)

    def gru_params(d_x, d_h):
        s = (d_x + d_h) ** -0.5
        return {"wz": normal((d_x + d_h, d_h), s),
                "wr": normal((d_x + d_h, d_h), s),
                "wh": normal((d_x + d_h, d_h), s),
                "bz": zeros(d_h), "br": zeros(d_h), "bh": zeros(d_h)}

    mlp_in = g + d_in + cfg.embed_dim + g   # final ‖ target ‖ user ‖ sumpool
    dims = [mlp_in, *cfg.mlp_dims, 1]
    return DIENParams({
        "item_table": normal((cfg.n_items, cfg.embed_dim), 0.05),
        "cate_table": normal((cfg.n_cates, cfg.embed_dim), 0.05),
        "user_table": normal((cfg.n_user_feats, cfg.embed_dim), 0.05),
        "gru1": gru_params(d_in, g),
        "augru": gru_params(d_in, g),
        "att_w": normal((g, g), g ** -0.5),
        "proj_target": normal((d_in, g), d_in ** -0.5),
        "mlp": [(normal((a, b), a ** -0.5), zeros(b))
                for a, b in zip(dims[:-1], dims[1:])],
    })


def params_from_reference(tree: dict, *,
                          device: str | torch.device | None = None
                          ) -> DIENParams:
    """The reference's parameter tree (``repro.models.dien.dien_init``), as
    numpy arrays, as the port's parameters on ``device``."""
    dev = resolve_device(device)

    def tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    return DIENParams({
        **{name: tensor(tree[name]) for name in (
            "item_table", "cate_table", "user_table", "att_w",
            "proj_target")},
        **{name: {k: tensor(v) for k, v in tree[name].items()}
           for name in ("gru1", "augru")},
        "mlp": [(tensor(w), tensor(b)) for w, b in tree["mlp"]],
    })


def _gru_cell(p, x, h):
    xh = torch.cat([x, h], -1)
    z = torch.sigmoid(xh @ p["wz"] + p["bz"])
    r = torch.sigmoid(xh @ p["wr"] + p["br"])
    xh2 = torch.cat([x, r * h], -1)
    h_tilde = torch.tanh(xh2 @ p["wh"] + p["bh"])
    return (1 - z) * h + z * h_tilde


def _augru_cell(p, x, h, a):
    """AUGRU: attention score a scales the update gate."""
    xh = torch.cat([x, h], -1)
    z = torch.sigmoid(xh @ p["wz"] + p["bz"]) * a[..., None]
    r = torch.sigmoid(xh @ p["wr"] + p["br"])
    xh2 = torch.cat([x, r * h], -1)
    h_tilde = torch.tanh(xh2 @ p["wh"] + p["bh"])
    return (1 - z) * h + z * h_tilde


def interest_extractor(cfg: DIENConfig, params, behavior):
    """GRU over behavior [B, T, d] → hidden states [B, T, g]."""
    b, t, _ = behavior.shape
    h = behavior.new_zeros((b, cfg.gru_dim), dtype=cfg.dtype)
    # Without autograd each step writes its state into one preallocated
    # [B, T, g] tensor: stacking the T states at the end would hold them
    # twice (11.3 GB each at serve_bulk). Under autograd the states are
    # kept for the backward anyway, and T writes into one tensor would make
    # each step's backward copy the whole [B, T, g] gradient, so they are
    # stacked. The steps' inputs come from one ``unbind``: its backward
    # stacks their T gradients once, where T ``behavior[:, i]`` would each
    # add a zero-filled [B, T, d] gradient.
    tracked = torch.is_grad_enabled() and any(
        x.requires_grad for x in (behavior, *params["gru1"].values()))
    if tracked:
        states = []
    else:
        hs = behavior.new_empty((b, t, cfg.gru_dim), dtype=cfg.dtype)
    for i, x in enumerate(behavior.unbind(1)):
        h = _gru_cell(params["gru1"], x, h)
        if tracked:
            states.append(h)
        else:
            hs[:, i] = h
    return torch.stack(states, 1) if tracked else hs


def interest_evolution(cfg: DIENConfig, params, hs, behavior, target_vec,
                       mask):
    """Attention (vs target) + AUGRU → final state [B, g].

    ``hs``, ``behavior`` and ``mask`` may be expanded views of one user's
    rows (retrieval): nothing here writes to them or copies them whole.
    """
    t_proj = target_vec @ params["proj_target"]          # [B, g]
    # The reference's einsum("btg,gh,bh->bt") contracted as att_w · t_proj
    # first, then one batched product with hs: no [B, T, g] temporary.
    u = t_proj @ params["att_w"].T                        # [B, g]
    scores = torch.bmm(hs, u.unsqueeze(-1)).squeeze(-1)   # [B, T]
    scores = scores.masked_fill(~mask, -1e30)
    alpha = torch.softmax(scores.float(), -1).to(cfg.dtype)

    h = hs.new_zeros((hs.shape[0], cfg.gru_dim))
    for x, a in zip(behavior.unbind(1), alpha.unbind(1)):
        h = _augru_cell(params["augru"], x, h, a)
    return h


def _behavior(lookup, batch):
    """[B, T, 2e] item ‖ cate embeddings of the history, zero where
    masked; ``lookup(table name, ids)`` reads the rows."""
    behavior = torch.cat([lookup("item_table", batch["hist_items"]),
                          lookup("cate_table", batch["hist_cates"])], -1)
    return behavior.masked_fill_(~batch["hist_mask"][..., None], 0)


def _target(lookup, items, cates):
    return torch.cat([lookup("item_table", items),
                      lookup("cate_table", cates)], -1)


def _sumpool(hs, mask):
    """Mean of hs over the unmasked steps, [B, g]. The mask as a [B, 1, T]
    row times hs sums without the [B, T, g] temporary of a masked copy."""
    pooled = torch.bmm(mask.to(hs.dtype).unsqueeze(1), hs).squeeze(1)
    return pooled / mask.sum(-1, keepdim=True).clamp_min(1).to(hs.dtype)


def _mlp(params, x):
    n = len(params["mlp"])
    for i, (w, b) in enumerate(params["mlp"]):
        x = x @ w + b
        if i + 1 < n:
            x = torch.relu(x)
    return x[:, 0]


def _on_device(params: DIENParams, batch: dict, device) -> dict:
    """Resolve ``device``, check that ``params`` lie on it, and move
    ``batch`` there."""
    dev = resolve_device(device)
    have = params.device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"DIEN parameters are on {have}, the call runs on "
                         f"{dev}; move them with params.to(device)")
    return {k: v.to(dev) for k, v in batch.items()}


def dien_forward(cfg: DIENConfig, params: DIENParams, batch: dict, *,
                 device: str | torch.device | None = None,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """CTR logits [B].

    batch: dict with
      hist_items, hist_cates: [B, T] int32; hist_mask: [B, T] bool
      target_item, target_cate: [B] int32
      user_feats: [B, hot] int32 (multi-hot → embedding bag)
    Runs on ``device``: the card unless the caller passes another; the
    parameters must lie there, the batch is moved there. ``use_kernel``
    goes to ``embed_bag``. DTensor parameters and batch (a mesh) give
    DTensor logits split as the batch rows.
    """
    if shr.is_dtensor(params["item_table"]):
        return _sharded_forward(cfg, params, batch, use_kernel)
    batch = _on_device(params, batch, device)
    return _forward(cfg, params, batch, lambda name, ids: params[name][ids],
                    lambda ids: embed_bag(ids, params["user_table"],
                                          mean=True, use_kernel=use_kernel))


def _forward(cfg: DIENConfig, params, batch: dict, lookup, user_bag):
    """The forward on one device's rows: ``lookup(table, ids)`` reads the
    item and category rows, ``user_bag(ids)`` the user profile's mean."""
    mask = batch["hist_mask"]
    behavior = _behavior(lookup, batch)                  # [B, T, 2e]
    tgt = _target(lookup, batch["target_item"], batch["target_cate"])
    hs = interest_extractor(cfg, params, behavior)
    final = interest_evolution(cfg, params, hs, behavior, tgt, mask)
    user = user_bag(batch["user_feats"])
    feat = torch.cat([final, tgt, user.to(cfg.dtype), _sumpool(hs, mask)],
                     -1)
    return _mlp(params, feat)


def _sharded_forward(cfg: DIENConfig, params: DIENParams, batch: dict,
                     use_kernel) -> torch.Tensor:
    """``dien_forward`` over a mesh: this rank's rows of the batch against
    the replicated dense weights (their gradients are partial sums over
    the ranks that split the rows) and the tables' row blocks."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = params["item_table"].device_mesh
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate()
                 for p in batch["hist_items"].placements)
    split = shr.sharded_dims(rows)
    rep = (Replicate(),) * mesh.ndim
    lb = {k: shr.local(v, rows) for k, v in batch.items()}
    dense = {n: shr.local(t, rep, partial=split)
             for n, t in params.named_parameters()
             if n not in shr.DIEN_TABLES}
    local_params = {
        **{n: {k: dense[f"{n}.{k}"] for k in _GRU_KEYS}
           for n in ("gru1", "augru")},
        "att_w": dense["att_w"], "proj_target": dense["proj_target"],
        "mlp": [(dense[f"mlp.{i}.0"], dense[f"mlp.{i}.1"])
                for i in range(len(params["mlp"]))]}
    tables = {}
    for name in shr.DIEN_TABLES:
        t = params[name]
        pl = tuple(Shard(0) if p.is_shard(0) else Replicate()
                   for p in t.placements)
        block = shr.local(t, pl, partial=split)
        tables[name] = (block, t.shape[0], shr.block_offset(
            mesh, pl, 0, block.shape[0]), shr.sharded_dims(pl))

    def summed(part, row_dims):
        """The blocks' partial results summed over ``row_dims``."""
        return shr.from_local(part, mesh, tuple(
            Partial() if i in row_dims else p for i, p in enumerate(rows))
        ).redistribute(mesh, rows).to_local()

    def in_block(name, ids):
        block, v, r0, _dims = tables[name]
        i = ids.long()
        i = torch.where(i < 0, i + v, i) - r0
        ok = (i >= 0) & (i < block.shape[0])
        return torch.where(ok, i, 0), ok

    def lookup(name, ids):
        block, _v, _r0, row_dims = tables[name]
        if not row_dims:
            return block[ids]
        i, ok = in_block(name, ids)
        return summed(torch.where(ok[..., None], block[i], 0), row_dims)

    def user_bag(ids):
        block, _v, _r0, row_dims = tables["user_table"]
        if not row_dims:
            return embed_bag(ids, block, mean=True, use_kernel=use_kernel)
        i, ok = in_block("user_table", ids)
        w = ok.to(torch.float32)
        part = embed_bag(i.to(torch.int32), block, w, mean=False,
                         use_kernel=use_kernel)
        return summed(part, row_dims) / max(float(ids.shape[1]), 1e-9)

    logits = _forward(cfg, local_params, lb, lookup, user_bag)
    return shr.from_local(logits, mesh, rows)


def dien_loss(cfg: DIENConfig, params: DIENParams, batch: dict, *,
              device: str | torch.device | None = None,
              use_kernel: bool | None = None) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``batch["label"]``
    ([B] int32, 0 or 1), in float32, in the reference's stable form
    max(x, 0) − x·y + log1p(exp(−|x|)). Device and ``use_kernel`` as for
    ``dien_forward``."""
    logits = dien_forward(cfg, params, batch, device=device,
                          use_kernel=use_kernel).float()
    y = batch["label"].to(logits.device, torch.float32)
    return torch.mean(torch.maximum(logits, logits.new_zeros(()))
                      - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def dien_retrieval_score(cfg: DIENConfig, params: DIENParams, batch: dict,
                         *, cand_block: int = 8192,
                         device: str | torch.device | None = None,
                         use_kernel: bool | None = None) -> torch.Tensor:
    """One user vs n_candidates: logits [n_blocks · cand_block].

    batch: hist_items/hist_cates/hist_mask [1, T]; user_feats [1, hot];
           cand_items, cand_cates: [C] int32.
    The interest GRU runs ONCE; attention+AUGRU evolve per candidate, one
    block of ``cand_block`` candidates at a time. As in the reference, the
    candidates are padded with id 0 up to a whole number of blocks and the
    padding's scores are returned too (``C`` rounded up to ``cand_block``).
    Device and ``use_kernel`` as for ``dien_forward``. On a mesh every
    rank gathers the (replicated) parameters and all the candidates and
    scores them all.
    """
    if shr.is_dtensor(params["item_table"]):
        params = DIENParams.from_named(
            {n: p.full_tensor() for n, p in params.named_parameters()})
        batch = {k: v.full_tensor() if shr.is_dtensor(v) else v
                 for k, v in batch.items()}
    batch = _on_device(params, batch, device)
    mask = batch["hist_mask"]
    behavior = _behavior(lambda name, ids: params[name][ids],
                         batch)                          # [1, T, 2e]
    hs = interest_extractor(cfg, params, behavior)       # [1, T, g]
    user = embed_bag(batch["user_feats"], params["user_table"], mean=True,
                     use_kernel=use_kernel)
    sumpool = _sumpool(hs, mask)

    c = batch["cand_items"].shape[0]
    n_blocks = -(-c // cand_block)
    pad = n_blocks * cand_block - c
    cand_items = F.pad(batch["cand_items"], (0, pad)).view(n_blocks, -1)
    cand_cates = F.pad(batch["cand_cates"], (0, pad)).view(n_blocks, -1)
    hs_b = hs.expand(cand_block, -1, -1)
    beh_b = behavior.expand(cand_block, -1, -1)
    mask_b = mask.expand(cand_block, -1)
    fixed = torch.cat([user.to(cfg.dtype), sumpool], -1).expand(cand_block, -1)
    scores = hs.new_empty(n_blocks * cand_block)
    for i in range(n_blocks):
        tgt = _target(lambda name, ids: params[name][ids], cand_items[i],
                      cand_cates[i])
        final = interest_evolution(cfg, params, hs_b, beh_b, tgt, mask_b)
        feat = torch.cat([final, tgt, fixed], -1)
        scores[i * cand_block:(i + 1) * cand_block] = _mlp(params, feat)
    return scores
