"""LLaMA-family transformer LM: dense and MoE variants.

The port of ``repro.models.transformer``. One config dataclass covers the
five LM architectures:
  minicpm-2b     dense, GQA kv=36 (MHA-like), WSD schedule
  llama3.2-1b    dense, GQA kv=8
  qwen3-1.7b     dense, GQA kv=8, qk_norm
  moonshot-v1    MoE 64 experts top-6 (fine-grained, d_ff=1408)
  dbrx-132b      MoE 16 experts top-4

The reference computes all of this outside any Pallas kernel, so the port
is torch ops: ``torch.matmul``/``bmm`` for the products, elementwise ops
with the reference's cast points for the rest.
  * layers run as a loop over the stacked ``[L, ...]`` parameters, read
    through one ``torch.unbind`` a forward, each layer under
    ``torch.utils.checkpoint`` when ``cfg.remat`` (two levels with
    ``remat_groups``), as the reference's ``lax.scan`` under
    ``jax.checkpoint``;
  * attention is the reference's chunked online softmax (flash-style, in
    plain ops): query blocks against key/value blocks with running (max,
    sum) statistics, never the S × S scores. Grouped-query heads are
    contracted grouped (q viewed as ``[B, Hkv, rep, ...]`` against its kv
    head) rather than repeated: the same sums, without the repeat's copy.
    A key block that lies wholly after a causal query block adds exactly
    nothing (its weights are ``exp(-1e30 - m) = 0`` and ``m`` is finite
    from the first key block on), so it is skipped;
  * the decode path keeps a KV cache ``{"k", "v", "len"}`` with ``k`` and
    ``v`` laid out ``[L, B, Hkv, S, Dh]`` (heads before positions, so a
    decode step's products read the cache in place) and ``len`` a host
    int; ``decode_step`` writes the new token's K and V into it in place,
    where the reference returns a new cache;
  * MoE dispatch is the reference's sort-free capacity bucketing: tokens
    go to per-expert buckets by cumulative position, the kept rows by one
    indexed copy a top-k slot into ``E·cap + 1`` rows whose last row takes
    the dropped slots and is cut off; dropped tokens fall back to the
    residual.

Over a device mesh (a sharded cell of ``train.step.build_cell``) the
parameters and the tokens are DTensors placed by
``distributed.sharding``'s rules, and the forward runs on them:
  * the products, norms and elementwise steps are DTensor ops, which
    place their results and insert the collectives, as GSPMD does for the
    reference;
  * ``_constrain_act``, ``_constrain_moe_tokens``, ``_constrain_moe_buckets``
    and ``_gather_moe_weight`` are ``DTensor.redistribute`` to the
    placements of the reference's ``with_sharding_constraint`` specs, at
    its call sites; handed a plain tensor while the config sets an axis
    field, they raise;
  * the embedding is a masked lookup on this rank's vocab rows, summed over
    the ranks that split the rows (DTensor's own vocab-parallel embedding
    builds its mask from the tokens' placement, which is wrong for
    batch-sharded tokens);
  * a layer's attention and dense MLP run on each rank's share of the
    model axis (``sharding.local``), every rank on the whole rows of its
    batch block: the MLP on its column block of ``w_gate``/``w_up`` and
    row block of ``w_down``, the attention on the query heads and query
    chunks ``HeadSplit`` gives it (gcd(H, m) head blocks, the rest of the
    axis over causally balanced query chunks, so no head count leaves a
    rank idle) through its rows of ``wo``. Each returns a partial sum over
    the model ranks, reduce-scattered to the residual's placement, so the
    backward hands every product its gradient whole;
  * the loss's chunked cross-entropy and the MoE dispatch run on each
    rank's block: the loss over the batch (and sequence) block, and with
    ``moe_expert_axis`` set ``moe_block_shard_map`` on the blocks of the
    reference's ``shard_map`` specs. Without it the MoE routes the whole
    token table on every rank, as the reference's unsharded routing does,
    and its expert products are DTensor ops on the constrained buckets;
  * the decode step runs each layer on the rank's rows and weight blocks
    as plain tensors with its collectives written out (``DecodeSplit``):
    every product on the rank's share, the attention on its heads
    (``HeadSplit`` where the positions lie over the data axes) and cache
    block, the MoE's router, experts and dispatch on its share, routed
    over the whole token table.
``set_lm_mesh`` keeps the mesh handle that turns on the expert-parallel
path, as in the reference.
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.graph import resolve_device
from repro_torch.distributed import sharding as shr


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # MoE (n_experts == 0 → dense)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # attention
    qk_norm: bool = False
    rope_theta: float = 1e4
    # runtime
    dtype: Any = torch.bfloat16
    q_chunk: int = 1024
    kv_chunk: int = 2048
    remat: bool = True
    remat_groups: int = 0      # 0 = flat per-layer remat; G>0 = 2-level
    tie_embeddings: bool = False
    # Activation sharding over a mesh: the residual stream is constrained
    # to P(batch_axes, seq_axis, None), MoE buckets to P(expert_axis, None,
    # batch_axes).
    act_batch_axes: tuple = ()
    act_seq_axis: Any = None
    moe_expert_axis: Any = None
    # Token-chunked MoE dispatch: bounds the [E, cap, d] bucket working set
    # to one chunk at a time.
    moe_chunk: int = 65536

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 256 (padded classes are ordinary softmax
        slots that targets never index)."""
        return -(-self.vocab // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Total parameters (embeddings counted once if tied)."""
        d, f = self.d_model, self.d_ff
        attn = d * (self.n_heads * self.d_head) + 2 * d * (self.n_kv_heads * self.d_head) \
            + (self.n_heads * self.d_head) * d
        if self.is_moe:
            mlp = 3 * d * f * self.n_experts
        else:
            mlp = 3 * d * f
        per_layer = attn + mlp + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_mlp = 3 * d * f * self.n_experts
        active_mlp = 3 * d * f * self.top_k
        return self.param_count() - self.n_layers * (dense_mlp - active_mlp)


# ---------------------------------------------------------------------------
# Parameters: a module over the reference's tree
# ---------------------------------------------------------------------------

#: The top-level leaves besides ``layers`` (``unembed`` unless tied).
_TOP = ("embed", "unembed", "ln_out")


class LMParams(nn.Module):
    """An LM's parameters under the reference's names: ``embed``,
    ``unembed`` (unless tied), ``ln_out`` and ``layers.<name>`` stacked on a
    leading ``[L]`` axis (an ``nn.ParameterDict``, its keys sorted as the
    reference's tree flattens them). ``params[name]`` and
    ``params.get(name)`` read one entry, as the reference's dict does.
    Matrices are in the config's dtype; ``ln_*``, ``q_norm`` and ``k_norm``
    are float32. Built frozen; ``requires_grad_()`` makes them trainable.
    ``from_named`` inverts ``named_parameters()``; ``to_reference`` gives
    the reference's tree back."""

    def __init__(self, tree: dict):
        super().__init__()
        for k in _TOP:
            if k in tree:
                setattr(self, k, nn.Parameter(tree[k], requires_grad=False))
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in tree["layers"].items()})

    def __getitem__(self, name: str):
        return getattr(self, name)

    def get(self, name: str, default=None):
        return getattr(self, name, default)

    @classmethod
    def from_named(cls, named: dict) -> "LMParams":
        """Frozen parameters from tensors under ``named_parameters()``'s
        names."""
        tree: dict = {"layers": {}}
        for name, t in named.items():
            if name.startswith("layers."):
                tree["layers"][name.removeprefix("layers.")] = t
            else:
                tree[name] = t
        return cls(tree)

    def to_reference(self) -> dict:
        """The reference's parameter tree, numpy leaves (bf16 as
        float32)."""
        def host(t):
            t = t.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        tree = {k: host(self[k]) for k in _TOP if self.get(k) is not None}
        tree["layers"] = {k: host(v) for k, v in self.layers.items()}
        return tree


def params_from_reference(tree: dict, *,
                          device: str | torch.device | None = None
                          ) -> LMParams:
    """The reference's parameter tree (``init_params``; numpy leaves, bf16
    as ``ml_dtypes.bfloat16``) as the port's parameters on ``device``."""
    keys = set(tree) - {"unembed"}
    if keys != {"embed", "layers", "ln_out"}:
        raise ValueError(f"LM parameter tree keys {sorted(tree)}, expected "
                         "embed, layers, ln_out[, unembed]")
    dev = resolve_device(device)

    def convert(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(dev,
                                                             torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    out = {k: convert(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: convert(v) for k, v in tree["layers"].items()}
    return LMParams(out)


def init_params(cfg: LMConfig, *, generator: torch.Generator | None,
                device: str | torch.device | None = None) -> LMParams:
    """Random parameters with the reference's distributions: float32
    normals × fan_in^-½ cast to ``cfg.dtype``, ones for the norms. A
    stacked leaf is drawn a layer at a time, so the float32 temporary is
    one layer's (moonshot's ``w_gate`` is [48, 64, 2048, 1408]). Drawn from
    ``generator`` on ``device``; on ``meta`` nothing is drawn (no
    generator)."""
    dev = resolve_device(device)
    meta = dev.type == "meta"
    if generator is None and not meta:
        raise ValueError("a generator is needed outside the meta device")
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    hq = cfg.n_heads * cfg.d_head
    hkv = cfg.n_kv_heads * cfg.d_head

    def normal(shape, fan_in):
        if meta:
            return torch.empty(shape, dtype=cfg.dtype, device=dev)
        x = torch.randn(shape, generator=generator, device=dev)
        return (x * fan_in ** -0.5).to(cfg.dtype)

    def stack(shape, fan_in):
        out = torch.empty((L,) + shape, dtype=cfg.dtype, device=dev)
        if not meta:
            for layer in range(L):
                out[layer] = normal(shape, fan_in)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    e = cfg.n_experts
    layer = {"wq": stack((d, hq), d), "wk": stack((d, hkv), d),
             "wv": stack((d, hkv), d), "wo": stack((hq, d), hq),
             "ln_attn": ones((L, d)), "ln_mlp": ones((L, d))}
    if cfg.qk_norm:
        layer["q_norm"] = ones((L, cfg.d_head))
        layer["k_norm"] = ones((L, cfg.d_head))
    if cfg.is_moe:
        layer["router"] = stack((d, e), d)
        layer["w_gate"] = stack((e, d, f), d)
        layer["w_up"] = stack((e, d, f), d)
        layer["w_down"] = stack((e, f, d), f)
    else:
        layer["w_gate"] = stack((d, f), d)
        layer["w_up"] = stack((d, f), d)
        layer["w_down"] = stack((f, d), f)
    tree = {"embed": normal((cfg.vocab_padded, d), d), "layers": layer,
            "ln_out": ones((d,))}
    if not cfg.tie_embeddings:
        tree["unembed"] = normal((d, cfg.vocab_padded), d)
    return LMParams(tree)


def _unstack(params: LMParams) -> list[dict]:
    """Each layer's parameters as a dict of views: one ``torch.unbind``
    per stacked leaf (its backward is one stack, where ``w[l]`` per layer
    would be L selects)."""
    names = list(params.layers.keys())
    per_leaf = [torch.unbind(params.layers[k], 0) for k in names]
    return [dict(zip(names, leaves)) for leaves in zip(*per_leaf)]


def _remat(fn, *args):
    """``jax.checkpoint``: keep ``fn``'s inputs, recompute its insides in
    the backward (a plain call where no gradient is recorded)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Activation and expert placement over a mesh
# ---------------------------------------------------------------------------

def _replicate(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def _redistribute(x, spec, what: str):
    """``x`` redistributed to ``spec``'s placements on its mesh; a plain
    tensor raises (an axis field is set, so ``x`` must lie on a mesh)."""
    if not shr.is_dtensor(x):
        raise TypeError(f"{what}: the config places this tensor on a mesh "
                        f"({spec}), so it must be a DTensor; got a plain "
                        f"{type(x).__name__}")
    mesh = x.device_mesh
    return x.redistribute(mesh, shr.NamedSharding(mesh, spec).placements)


def _act_spec(cfg: LMConfig) -> shr.P:
    return shr.P(cfg.act_batch_axes or None, cfg.act_seq_axis, None)


def _placed_as(t, like):
    """DTensor ``t`` redistributed to ``like``'s placements (a product's
    output before it joins the residual: the backward then hands the
    product a gradient placed as its output, never split along the
    sequence); a plain tensor as it is."""
    if not shr.is_dtensor(t) or t.placements == like.placements:
        return t
    return t.redistribute(like.device_mesh, like.placements)


def _whole_seq(x):
    """DTensor x [B, S, ...] with its sequence gathered (its batch split
    kept): a product's input, which views [B, S] as one dim, and DTensor
    flattens only dims whose split is on the outermost."""
    from torch.distributed.tensor import Replicate
    if not shr.is_dtensor(x) or not any(p.is_shard(1)
                                        for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_shard(1) else p for p in x.placements))


def _constrain_act(cfg: LMConfig, x):
    """Sequence-parallel residual stream: P(batch_axes, seq_axis, None)."""
    if not cfg.act_batch_axes and cfg.act_seq_axis is None:
        return x
    return _redistribute(x, _act_spec(cfg), "_constrain_act")


def _constrain_moe_buckets(cfg: LMConfig, b):
    """Buckets [E, cap, d]: experts over the expert axis, capacity over
    the batch axes, d replicated."""
    if cfg.moe_expert_axis is None:
        return b
    return _redistribute(b, shr.P(cfg.moe_expert_axis, None,
                                  cfg.act_batch_axes or None),
                         "_constrain_moe_buckets")


def _gather_moe_weight(cfg: LMConfig, w):
    """FSDP un-shard: [E, d, f] weight → experts sharded, d/f gathered."""
    if cfg.moe_expert_axis is None:
        return w
    return _redistribute(w, shr.P(cfg.moe_expert_axis, None, None),
                         "_gather_moe_weight")


def _constrain_moe_tokens(cfg: LMConfig, x):
    """Flat token table [T, d]: T = batch×seq over the batch axes and the
    sequence-parallel axis."""
    if not cfg.act_batch_axes and cfg.act_seq_axis is None:
        return x
    axes = tuple(cfg.act_batch_axes)
    if cfg.act_seq_axis is not None:
        axes = axes + (cfg.act_seq_axis,)
    return _redistribute(x, shr.P(axes or None, None),
                         "_constrain_moe_tokens")


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """float32 statistics, the result in ``x.dtype``."""
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S]. float32, on split (not
    interleaved) halves."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs   # [..., S, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def chunked_attention(q, k, v, *, causal: bool, q_offset: int, q_chunk: int,
                      kv_chunk: int) -> torch.Tensor:
    """Flash-style online-softmax attention in plain ops.

    q: [B, Sq, Hq, Dh]; k, v: [B, Skv, Hkv, Dh]; query head h reads kv head
    h // rep (rep = Hq // Hkv), contracted grouped. The reference's split:
    ``n_q = max(Sq // q_chunk, 1)`` query blocks of ``Sq // n_q`` and
    likewise for keys; each block's scores are ``[B, Hkv, rep·qc, kvc]``
    (batch and heads inside one product). Scores are the product in the
    inputs' dtype, then ``float() * scale``, masked with -1e30; ``p`` is
    cast to ``v``'s dtype for the PV product; the sum is floored at 1e-30.
    """
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    rep = hq // hkv
    scale = dh ** -0.5
    n_q = max(sq // q_chunk, 1)
    qc = sq // n_q
    n_kv = max(skv // kv_chunk, 1)
    kvc = skv // n_kv

    # [B, Hkv, rep, Sq, Dh] and [B, Hkv, Skv, Dh].
    qg = q.reshape(b, sq, hkv, rep, dh).permute(0, 2, 3, 1, 4)
    kg = k.permute(0, 2, 1, 3)
    vg = v.permute(0, 2, 1, 3)
    dev = q.device
    outs = []
    for i in range(n_q):
        q_blk = qg[:, :, :, i * qc:(i + 1) * qc].reshape(b, hkv, rep * qc, dh)
        q_first = q_offset + i * qc
        q_pos = q_first + torch.arange(qc, device=dev)
        m = torch.full((b, hkv, rep * qc), -1e30, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, rep * qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, rep * qc, dh), dtype=torch.float32,
                          device=dev)
        for j in range(n_kv):
            if causal and j * kvc > q_first + qc - 1:
                break                   # wholly masked: adds exactly nothing
            k_blk = kg[:, :, j * kvc:(j + 1) * kvc]
            v_blk = vg[:, :, j * kvc:(j + 1) * kvc]
            s = (q_blk @ k_blk.transpose(-1, -2)).float() * scale
            if causal and (j + 1) * kvc - 1 > q_first:
                k_pos = j * kvc + torch.arange(kvc, device=dev)
                mask = (q_pos[:, None] >= k_pos[None, :]).repeat(rep, 1)
                s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + (p.to(v_blk.dtype) @ v_blk).float()
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.reshape(b, hkv, rep, qc, dh))
    out = torch.cat(outs, dim=3)                       # [B, Hkv, rep, Sq, Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_route(x: torch.Tensor, router_w: torch.Tensor, cfg: LMConfig):
    """The routing of a flat token table x: [T, d]: ``(top_g, top_e, pos,
    keep, cap)``. Gates are the float32 softmax of the router logits, the
    top k taken sorted (descending) and renormalized; ``pos`` is each
    (token, slot)'s place in its expert's bucket, from a cumulative sum over
    the flattened [T·k, E] one-hot in (token, slot) order, which also
    decides the dropped ones (``keep = pos < cap``). ``cap``, each expert's
    bucket rows for the ``T`` tokens, is rounded up to a multiple of 8."""
    return route_logits(x.float() @ router_w.float(), cfg)


def route_logits(logits: torch.Tensor, cfg: LMConfig):
    """``moe_route`` from the float32 router logits [T, E] of the whole
    token table."""
    t = logits.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = int(max(1, round(t * k / e * cfg.capacity_factor)))
    cap = -(-cap // 8) * 8
    gates = torch.softmax(logits, dim=-1)               # [T, E]
    top_g, top_e = torch.topk(gates, k, dim=-1)         # [T, k]
    top_g = top_g / torch.clamp_min(top_g.sum(-1, keepdim=True), 1e-9)
    flat_e = top_e.reshape(t * k, 1)
    onehot = F.one_hot(flat_e[:, 0], e)                 # [T·k, E]
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, flat_e)
    pos = pos.reshape(t, k)
    return top_g, top_e, pos, pos < cap, cap


def _dispatch(x, rows, n_e: int, cap: int):
    """Kept (token, slot)s to their bucket rows [n_e, cap, d], one indexed
    copy a slot (no [T·k, d] staging copy); dropped slots all land on the
    trash row n_e·cap, which is cut off."""
    buckets = x.new_zeros((n_e * cap + 1, x.shape[1]))
    for j in range(rows.shape[1]):
        buckets.index_copy_(0, rows[:, j], x)
    return buckets[:n_e * cap].view(n_e, cap, x.shape[1])


def _ffn(b3, w_gate, w_up, w_down):
    """The experts' FFN on their buckets: [n_e, cap, d] → [n_e, cap, d]."""
    g = torch.bmm(b3, w_gate)
    u = torch.bmm(b3, w_up)
    h = F.silu(g.float()).to(b3.dtype) * u
    return torch.bmm(h, w_down)


def _combine(y, rows, keep, top_g, x):
    """Per-slot gather of the flat expert outputs y [n_e·cap, d] and
    gate-weighted accumulate in x.dtype."""
    safe = torch.clamp_max(rows, y.shape[0] - 1)
    out = torch.zeros_like(x)
    for j in range(rows.shape[1]):
        yj = torch.where(keep[:, j:j + 1], y.index_select(0, safe[:, j]), 0)
        out = out + yj * top_g[:, j:j + 1].to(x.dtype)
    return out


def _experts(x, top_g, top_e, pos, keep, cap: int, n_e: int, w_gate, w_up,
             w_down):
    """Dispatch, expert FFN and combine of a routed flat token table x:
    [T, d] over ``n_e`` experts (``top_e`` in [0, n_e) where kept)."""
    rows = torch.where(keep, top_e * cap + pos, n_e * cap)
    y = _ffn(_dispatch(x, rows, n_e, cap), w_gate, w_up, w_down)
    return _combine(y.reshape(n_e * cap, x.shape[1]), rows, keep, top_g, x)


def _moe_block_flat(x, router_w, w_gate, w_up, w_down, cfg: LMConfig):
    """Route, dispatch, expert FFN and combine of a flat token table x [T,
    d], with the reference's constraints on the tokens, the buckets and
    the gathered weights. On DTensors every rank routes, dispatches and
    combines the whole token table (the routing counts positions over all
    T tokens, as the reference's does), so each rank's copy, and its
    gradient, is the same; the expert products are DTensor ops on the
    constrained buckets, as GSPMD places the reference's."""
    x = _constrain_moe_tokens(cfg, x)
    mesh = x.device_mesh if shr.is_dtensor(x) else None
    rep = None if mesh is None else _replicate(mesh)
    xr = x if mesh is None else shr.local(x, rep)
    rw = router_w if mesh is None else shr.local(router_w, rep)
    top_g, top_e, pos, keep, cap = moe_route(xr, rw, cfg)
    n_e, d = cfg.n_experts, xr.shape[1]
    rows = torch.where(keep, top_e * cap + pos, n_e * cap)
    b3 = _dispatch(xr, rows, n_e, cap)
    if mesh is not None:
        b3 = shr.from_local(b3, mesh, rep)
    y = _constrain_moe_buckets(cfg, _ffn(
        _constrain_moe_buckets(cfg, b3), _gather_moe_weight(cfg, w_gate),
        _gather_moe_weight(cfg, w_up), _gather_moe_weight(cfg, w_down)))
    if mesh is not None:
        y = shr.local(y, rep)
    out = _combine(y.reshape(n_e * cap, d), rows, keep, top_g, xr)
    if mesh is not None:
        out = shr.from_local(out, mesh, rep)
    return _constrain_moe_tokens(cfg, out)


def moe_block(x, router_w, w_gate, w_up, w_down, cfg: LMConfig):
    """Token-chunked capacity-bucketed top-k MoE (deterministic).

    x: [B, S, d]. Returns [B, S, d]. Tokens beyond an expert's per-chunk
    capacity are dropped (Switch behaviour). With ``n_ch > 1`` chunks of
    whole batch rows (``moe_chunk // S`` rows a chunk, ``B % n_ch == 0``),
    chunk c holds rows c, c + n_ch, ... (the reference's ``[bc, n_ch, S,
    d]`` view), each under checkpoint. On DTensors each chunk's table is
    constrained by ``_constrain_moe_tokens``, as in the reference.
    """
    x = _whole_seq(x)
    b, s, d = x.shape
    rows_per_chunk = max(1, cfg.moe_chunk // s)
    n_ch = b // rows_per_chunk if rows_per_chunk else 1
    if n_ch > 1 and b % n_ch == 0:
        bc = b // n_ch
        view = x.reshape(bc, n_ch, s, d)

        def one_chunk(x_blk):
            y = _moe_block_flat(x_blk.reshape(bc * s, d), router_w, w_gate,
                                w_up, w_down, cfg)
            return y.reshape(bc, s, d)

        ys = [_remat(one_chunk, view[:, c]) for c in range(n_ch)]
        return torch.stack(ys, dim=1).reshape(b, s, d)
    flat = _moe_block_flat(x.reshape(b * s, d), router_w, w_gate, w_up,
                           w_down, cfg)
    return flat.reshape(b, s, d)


# ---------------------------------------------------------------------------
# Expert-parallel MoE over a mesh
# ---------------------------------------------------------------------------

_LM_MESH: contextvars.ContextVar = contextvars.ContextVar("lm_mesh",
                                                          default=None)


def set_lm_mesh(mesh) -> None:
    """Mesh handle for the expert-parallel MoE path (set by the step
    factory)."""
    _LM_MESH.set(mesh)


def moe_route_local(x: torch.Tensor, router_w: torch.Tensor, cfg: LMConfig,
                    ridx: int, e_per: int):
    """The routing of rank ``ridx``'s experts [ridx·e_per, (ridx+1)·e_per)
    for a flat token table x: [T, d]: ``(top_g, local_e, pos, keep, cap)``.
    Every token is routed over all experts (``moe_route``); a (token, slot)
    whose expert lies elsewhere has ``keep`` False, ``local_e`` and ``pos``
    0. A kept slot's position is its place among the (token, slot)s of its
    expert, so it is ``moe_route``'s; ``cap`` is counted over all
    ``n_experts``."""
    top_g, top_e, pos, keep, cap = moe_route(x, router_w, cfg)
    local_e = top_e - ridx * e_per
    mine = (local_e >= 0) & (local_e < e_per)
    return (top_g, torch.where(mine, local_e, 0), torch.where(mine, pos, 0),
            mine & keep, cap)


def _tracked(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _autograd_collective(name: str):
    """torch's differentiable ``all_gather`` / ``reduce_scatter``: the
    ``*_single_autograd`` name where this torch has it, else the older
    ``*_tensor_autograd`` (the same signature)."""
    import torch.distributed._functional_collectives as fc
    return getattr(fc, f"{name}_single_autograd", None) \
        or getattr(fc, f"{name}_tensor_autograd")


def _gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Tiled all-gather along ``dim``: the group's blocks concatenated in
    rank order (the collective works on dim 0). Under autograd its
    backward is the reduce-scatter of the gradient: each rank used the
    gathered copy on its own share of the work."""
    world = dist.get_world_size(group)
    if world == 1:
        return t
    if _tracked(t):
        return _autograd_collective("all_gather")(t.contiguous(), dim, group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((world * src.shape[0],) + src.shape[1:])
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Sum over the group, then rank r keeps block r of ``dim``; under
    autograd its backward is the all-gather of the gradient."""
    world = dist.get_world_size(group)
    if world == 1:
        return t
    if _tracked(t):
        return _autograd_collective("reduce_scatter")(t.contiguous(), "sum",
                                                      dim, group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // world,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) of each rank's partial output. The sum feeds the
    same replicated computation on every rank of the group, so each
    partial's gradient is the sum's: the backward passes it through."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def moe_block_shard_map(x, router_w, w_gate, w_up, w_down, cfg: LMConfig,
                        mesh):
    """Expert-parallel MoE with explicit collectives.

    Takes this rank's shards, as the reference's ``shard_map`` in_specs
    give them: x ``P(act_batch_axes, act_seq_axis, None)`` [b_l, s_l, d],
    the router replicated, ``w_gate`` / ``w_up`` ``P(model, "data", None)``
    [e_per, d/|data|, f] and ``w_down`` ``P(model, None, "data")``. It
    returns this rank's block of the output, placed as x.

      * the expert weights are FSDP-stored (d over ``data``) and
        all-gathered over the mesh's ``data`` group before the products;
      * with ``act_seq_axis`` set, the sequence shard of x is all-gathered
        over that axis;
      * this rank (``mesh.get_local_rank(moe_expert_axis)``) routes every
        local token but buckets ONLY the experts it owns, a local scatter;
      * the partial outputs (each rank's experts' share) are combined with
        one reduce-scatter over ``act_seq_axis`` along the sequence, or an
        all-reduce over the expert axis's group when it is None.
    """
    seq_ax = cfg.act_seq_axis
    model_ax = cfg.moe_expert_axis
    names = mesh.mesh_dim_names
    e_total = cfg.n_experts
    model_size = mesh.size(names.index(model_ax))
    assert e_total % model_size == 0
    e_per = e_total // model_size

    data_group = mesh.get_group("data")
    wg = _gather_dim(w_gate, data_group, 1)
    wu = _gather_dim(w_up, data_group, 1)
    wd = _gather_dim(w_down, data_group, 2)
    x_full = x if seq_ax is None else _gather_dim(x, mesh.get_group(seq_ax),
                                                   1)
    bl, s, d = x_full.shape
    xf = x_full.reshape(bl * s, d)
    ridx = mesh.get_local_rank(model_ax)
    top_g, local_e, pos, keep, cap = moe_route_local(xf, router_w, cfg, ridx,
                                                     e_per)
    out = _experts(xf, top_g, local_e, pos, keep, cap, e_per, wg, wu,
                   wd).reshape(bl, s, d)
    if seq_ax is not None:
        return _reduce_scatter_dim(out, mesh.get_group(seq_ax), 1)
    if model_size == 1:
        return out
    if _tracked(out):
        return _SumOverGroup.apply(out, mesh.get_group(model_ax))
    dist.all_reduce(out, op=dist.ReduceOp.SUM,
                    group=mesh.get_group(model_ax))
    return out


def _moe_expert_parallel(cfg: LMConfig, x, lp, mesh):
    """``moe_block_shard_map`` on the blocks of DTensor ``x`` [B, S, d] and
    of the layer's weights, as the reference's ``shard_map`` in_specs cut
    them, and its output block as a DTensor placed as x. The router is
    replicated and each rank routes its own tokens for its own experts, so
    its gradient is a partial sum over every dim that splits the work; so
    is x's over the expert axis when x is whole along it (no
    ``act_seq_axis``)."""
    if not shr.is_dtensor(x):
        raise TypeError("moe_expert_axis with a mesh set: the MoE input "
                        "must be a DTensor on that mesh")
    if not cfg.act_batch_axes:
        raise ValueError("the expert-parallel MoE needs act_batch_axes: "
                         "its weights are gathered over the data axis")
    names = mesh.mesh_dim_names
    x_pl = shr.NamedSharding(mesh, _act_spec(cfg)).placements
    model = names.index(cfg.moe_expert_axis)
    split = tuple(sorted(set(shr.sharded_dims(x_pl)) | {model}))
    w_in = shr.NamedSharding(mesh, shr.P(cfg.moe_expert_axis, "data",
                                         None)).placements
    w_out = shr.NamedSharding(mesh, shr.P(cfg.moe_expert_axis, None,
                                          "data")).placements
    out = moe_block_shard_map(
        shr.local(x, x_pl, partial=() if cfg.act_seq_axis else (model,)),
        shr.local(lp["router"], _replicate(mesh), partial=split),
        shr.local(lp["w_gate"], w_in, partial=split),
        shr.local(lp["w_up"], w_in, partial=split),
        shr.local(lp["w_down"], w_out, partial=split), cfg, mesh)
    return shr.from_local(out, mesh, x_pl)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _mlp(cfg: LMConfig, h2, lp, *, sharded: bool = False):
    """The dense or MoE MLP. With ``sharded`` (the training and prefill
    layers, not decode, as in the reference) a DTensor input takes the
    mesh path: a dense MLP runs ``_mlp_sharded``, and an MoE with a mesh
    set by ``set_lm_mesh`` and ``moe_expert_axis`` ``moe_block_shard_map``."""
    if cfg.is_moe:
        mesh = _LM_MESH.get()
        if sharded and mesh is not None \
                and cfg.moe_expert_axis is not None:
            return _moe_expert_parallel(cfg, h2, lp, mesh)
        return moe_block(h2, lp["router"], lp["w_gate"], lp["w_up"],
                         lp["w_down"], cfg)
    if sharded and shr.is_dtensor(h2):
        return _mlp_sharded(h2, lp)
    g = F.silu((h2 @ lp["w_gate"]).float()).to(h2.dtype)
    return (g * (h2 @ lp["w_up"])) @ lp["w_down"]


def _qkv(cfg: LMConfig, h, lp, positions):
    b, s, _ = h.shape
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = (h @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = (h @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    return rope(q, positions, cfg.rope_theta), \
        rope(k, positions, cfg.rope_theta), v


# ---------------------------------------------------------------------------
# A layer's products on the model axis: each rank's share, then one
# reduce-scatter
# ---------------------------------------------------------------------------

def _model_dim(mesh):
    """The index of the mesh's ``model`` dim, or None without one."""
    names = mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def _rows(h) -> tuple:
    """(``h``'s placements with the sequence and the model dim whole, the
    mesh dims that split the batch, the model dim) for DTensor h [B, S,
    d]: every rank of the model axis works on the same rows."""
    from torch.distributed.tensor import Replicate
    mi = _model_dim(h.device_mesh)
    pl = tuple(Replicate() if i == mi or p.is_shard(1) else p
               for i, p in enumerate(h.placements))
    return pl, shr.sharded_dims(pl), mi


def _weight(w, mi, dim: int | None, split: tuple):
    """This rank's copy of a layer weight w: split along ``dim`` over the
    model dim as the rules store it, or gathered whole (``dim`` None),
    gathered over every other mesh dim. Its gradient is a partial sum over
    the dims of ``split`` (each rank's batch block) and, gathered, over
    the model dim (each model rank's share of the work)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Shard(dim) if i == mi and dim is not None else Replicate()
               for i in range(w.device_mesh.ndim))
    mine = split if dim is not None or mi is None else split + (mi,)
    return shr.local(w, pl, partial=mine)


def _partial_sum(y, mesh, pl, mi):
    """DTensor of each rank's block ``y`` of a sum over the model ranks
    (its other dims placed as ``pl``); ``_placed_as`` then reduce-scatters
    it to the residual's placement, and the backward hands ``y`` the
    gradient whole (``from_local`` of a partial takes it replicated)."""
    from torch.distributed.tensor import Partial
    return shr.from_local(y, mesh, tuple(Partial() if i == mi else p
                                         for i, p in enumerate(pl)))


def _mlp_sharded(h2, lp):
    """The dense MLP of DTensor h2 [B, S, d] over the model axis: each rank
    multiplies the whole rows of its batch block by its column block of
    ``w_gate`` and ``w_up`` and its row block of ``w_down``; the result is
    a partial sum over the model ranks (``_partial_sum``)."""
    pl, split, mi = _rows(h2)
    h = shr.local(h2, pl, partial=() if mi is None else (mi,))
    g = F.silu((h @ _weight(lp["w_gate"], mi, 1, split)).float()).to(h.dtype)
    y = (g * (h @ _weight(lp["w_up"], mi, 1, split))) \
        @ _weight(lp["w_down"], mi, 0, split)
    return _partial_sum(y, h2.device_mesh, pl, mi)


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """One rank's share of the attention on a model axis of ``m`` ranks.

    The H query heads fall into ``g = gcd(H, m)`` blocks of ``H / g`` and
    the sequence into ``2·n_q`` chunks, ``n_q = m / g``. Model rank ``r``
    takes head block ``r // n_q`` and query chunks ``j`` and ``2·n_q − 1 −
    j`` (``j = r % n_q``), so every rank does the same causal work; its
    block reads kv heads ``kv0 .. kv0 + n_kv − 1`` (query head h reads
    h // rep). With ``n_q`` 1 the rank's heads are exactly its column
    block of wq and row block of wo."""
    n_q: int
    head_block: int
    q_block: int
    heads: int
    kv0: int
    n_kv: int

    @classmethod
    def of(cls, cfg: LMConfig, m: int, r: int) -> "HeadSplit":
        g = math.gcd(cfg.n_heads, m)
        n_q = m // g
        heads = cfg.n_heads // g
        rep = cfg.n_heads // cfg.n_kv_heads
        if heads % rep and rep % heads:
            raise ValueError(
                f"{cfg.name}: a block of {heads} query heads (of "
                f"{cfg.n_heads} on a model axis of {m}) straddles kv "
                f"heads, {rep} query heads each")
        hb, qb = divmod(r, n_q)
        return cls(n_q=n_q, head_block=hb, q_block=qb, heads=heads,
                   kv0=hb * heads // rep, n_kv=max(heads // rep, 1))

    def chunks(self, seq: int) -> tuple:
        """The first position of each query chunk this rank takes, and
        the chunks' length."""
        if self.n_q == 1:
            return [0], seq
        n = 2 * self.n_q
        if seq % n:
            raise ValueError(f"{seq} positions do not split into {n} "
                             "query chunks")
        c = seq // n
        return [self.q_block * c, (n - 1 - self.q_block) * c], c


def _attention_sharded(cfg: LMConfig, h, lp):
    """Causal self-attention of DTensor h [B, S, d] through the output
    product, split over the model axis by ``HeadSplit``. Each rank takes
    the whole rows of its batch block and
      * computes q for its query heads and chunks (its column block of wq,
        or with query chunks its head block's columns of wq gathered);
      * computes its column block of k and v for every row, as wk and wv
        are stored; unless that block is the kv heads its queries read, it
        gathers the blocks over the model ranks and keeps those heads:
        each (row, kv head) is computed once, and its gradient is summed
        back to the rank that computed it;
      * runs the norms, rope and ``chunked_attention`` (no collective
        inside; wholly masked key blocks skipped) and multiplies its heads
        by their rows of wo.
    The result is a partial sum over the model ranks (``_partial_sum``),
    zero outside the rank's query chunks."""
    from torch.distributed.tensor import Shard
    s = h.shape[1]
    mesh = h.device_mesh
    pl, split, mi = _rows(h)
    m, r = (1, 0) if mi is None else (mesh.size(mi), mesh.get_local_rank(mi))
    hs = HeadSplit.of(cfg, m, r)
    whole = hs.n_q == 1
    dh = cfg.d_head
    x = shr.local(h, pl, partial=() if mi is None else (mi,))
    b = x.shape[0]
    starts, c = hs.chunks(s)

    def heads(t, first: int, n: int):
        """Heads first .. first + n − 1 of t [b, s, H·Dh] as [b, s, n,
        Dh]."""
        if n * dh != t.shape[-1]:
            t = t[..., first * dh:(first + n) * dh]
        return t.reshape(t.shape[0], t.shape[1], n, dh)

    def kv(w):
        t = x @ _weight(w, mi, 1, split)
        if t.shape[-1] == hs.n_kv * dh and hs.kv0 * dh == r * t.shape[-1]:
            return heads(t, 0, hs.n_kv)          # the rank's own block
        t = shr.local(shr.from_local(t, mesh, tuple(
            Shard(2) if i == mi else p for i, p in enumerate(pl))),
            pl, partial=(mi,))
        return heads(t, hs.kv0, hs.n_kv)

    if whole:
        q = heads(x @ _weight(lp["wq"], mi, 1, split), 0, hs.heads)
        wo = _weight(lp["wo"], mi, 0, split)
    else:
        first = hs.head_block * hs.heads
        xq = torch.cat([x[:, i:i + c] for i in starts], 1)
        wq = _weight(lp["wq"], mi, None, split)
        q = heads(xq @ wq[:, first * dh:(first + hs.heads) * dh], 0,
                  hs.heads)
        wo = _weight(lp["wo"], mi, None, split)[
            first * dh:(first + hs.heads) * dh]
    k, v = kv(lp["wk"]), kv(lp["wv"])
    if cfg.qk_norm:
        rep = _replicate(mesh)
        norm = split if mi is None else split + (mi,)
        q = rms_norm(q, shr.local(lp["q_norm"], rep, partial=norm))
        k = rms_norm(k, shr.local(lp["k_norm"], rep, partial=norm))
    positions = torch.arange(s, device=q.device)
    q = rope(q, positions if whole else torch.cat(
        [positions[i:i + c] for i in starts]), cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    outs = [chunked_attention(q[:, j * c:(j + 1) * c], k, v, causal=True,
                              q_offset=i, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk)
            for j, i in enumerate(starts)]
    out = outs[0] if whole else torch.cat(outs, 1)
    y = out.reshape(b, out.shape[1], -1) @ wo
    if not whole:
        zero = y.new_zeros(())
        pieces, at = [], 0
        for j, i in enumerate(starts):
            pieces += [zero.expand(b, i - at, y.shape[2]),
                       y[:, j * c:(j + 1) * c]]
            at = i + c
        y = torch.cat(pieces + [zero.expand(b, s - at, y.shape[2])], 1)
    return _partial_sum(y, mesh, pl, mi)


def _layer_fwd(cfg: LMConfig, x, lp, positions, kv_cache=None):
    """One transformer layer. x: [B, S, d]. Returns (x, new_kv).

    With ``kv_cache = (ck, cv)`` ([B, Skv, Hkv, Dh], already holding the
    new tokens' K/V) the queries attend to it unmasked, one query a block,
    and ``new_kv`` is this layer's (k, v). A DTensor x (no cache) takes
    ``_attention_sharded`` and the sharded MLP, each a partial sum over
    the model ranks reduce-scattered to x's placement before it joins the
    residual."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["ln_attn"])
    new_kv = None
    if shr.is_dtensor(x) and kv_cache is None:
        y = _attention_sharded(cfg, h, lp)
    else:
        q, k, v = _qkv(cfg, h, lp, positions)
        if kv_cache is None:
            attn = chunked_attention(q, k, v, causal=True, q_offset=0,
                                     q_chunk=cfg.q_chunk,
                                     kv_chunk=cfg.kv_chunk)
        else:
            ck, cv = kv_cache
            attn = chunked_attention(q, ck, cv, causal=False, q_offset=0,
                                     q_chunk=1, kv_chunk=cfg.kv_chunk)
            new_kv = (k, v)
        y = attn.reshape(b, s, -1) @ lp["wo"]
    x = x + _placed_as(y, x)
    del h, y                   # [B, S, d] each: not held through the MLP
    y = _mlp(cfg, rms_norm(x, lp["ln_mlp"]), lp, sharded=True)
    return (x + _placed_as(y, x)).to(cfg.dtype), new_kv


def _embed(cfg: LMConfig, params: LMParams, tokens, placements=None):
    """The token embeddings in ``cfg.dtype``. On a mesh (DTensor table and
    tokens): the table's vocab rows stay where they are and its columns
    are gathered; each rank looks up the tokens that fall in its row block
    (zeros elsewhere, which the sum leaves exact) and the blocks' results
    are summed over the ranks that split the rows, landing at
    ``placements`` (the tokens' placement by default)."""
    table = params["embed"]
    if not shr.is_dtensor(table):
        return F.embedding(tokens, table).to(cfg.dtype)
    from torch.distributed.tensor import Partial, Replicate, Shard
    if not shr.is_dtensor(tokens):
        raise TypeError("the embedding table is a DTensor: the tokens must "
                        "be one too")
    mesh = table.device_mesh
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate()
                 for p in table.placements)
    row_dims = shr.sharded_dims(rows)
    tok_pl = tuple(Replicate() if i in row_dims else p
                   for i, p in enumerate(tokens.placements))
    ids = shr.local(tokens, tok_pl).long()
    block = shr.local(table, rows, partial=shr.sharded_dims(tok_pl))
    ids = ids - shr.block_offset(mesh, rows, 0, block.shape[0])
    ok = (ids >= 0) & (ids < block.shape[0])
    out = torch.where(ok[..., None],
                      F.embedding(torch.where(ok, ids, 0), block), 0)
    out = shr.from_local(out.to(cfg.dtype), mesh,
                         tuple(Partial() if i in row_dims else p
                               for i, p in enumerate(tok_pl)))
    return out.redistribute(mesh, placements or tuple(
        Replicate() if p.is_partial() else p for p in out.placements))


def forward_hidden(cfg: LMConfig, params: LMParams, tokens) -> torch.Tensor:
    """Backbone forward → post-ln hidden states [B, S, d].

    Each layer under checkpoint when ``cfg.remat``; with ``remat_groups =
    G`` dividing ``n_layers``, also G groups of L/G layers, each group under
    checkpoint (the residual stash falls from L to G + L/G slices for one
    extra forward recompute).
    """
    b, s = tokens.shape
    act = cfg.act_batch_axes or cfg.act_seq_axis is not None
    x = _constrain_act(cfg, _embed(
        cfg, params, tokens,
        shr.NamedSharding(tokens.device_mesh, _act_spec(cfg)).placements
        if act and shr.is_dtensor(tokens) else None))
    positions = torch.arange(s, device=x.device)
    layers = _unstack(params)

    def one_layer(x, lp):
        return _constrain_act(cfg, _layer_fwd(cfg, x, lp, positions)[0])

    def run(x, lps):
        for lp in lps:
            x = _remat(one_layer, x, lp) if cfg.remat else one_layer(x, lp)
        return x

    g = cfg.remat_groups
    if g and cfg.n_layers % g == 0:
        per = cfg.n_layers // g
        for i in range(g):
            x = _remat(run, x, layers[i * per:(i + 1) * per])
    else:
        x = run(x, layers)
    return rms_norm(x, params["ln_out"])


def _unembed(cfg: LMConfig, params: LMParams) -> torch.Tensor:
    unemb = params.get("unembed")
    if unemb is None:
        unemb = params["embed"].T.to(cfg.dtype)
    return unemb


def forward(cfg: LMConfig, params: LMParams, tokens) -> torch.Tensor:
    """Training/prefill forward → logits [B, S, vocab_padded]."""
    return forward_hidden(cfg, params, tokens) @ _unembed(cfg, params)


def _chunked_ce(x, unemb, targets, loss_chunk: int) -> torch.Tensor:
    """The summed cross-entropy of x [B, S, d] against targets [B, S]:
    each sequence chunk's unembed and logsumexp in float32 under
    checkpoint (recomputed in the backward), so one chunk's [B, c, V]
    logits live at a time."""
    b, s, d = x.shape
    n_chunks = max(s // loss_chunk, 1)
    c = s // n_chunks
    xc = x.reshape(b, n_chunks, c, d)
    tc = targets.reshape(b, n_chunks, c).long()

    def chunk_loss(x_blk, t_blk):
        logits = (x_blk @ unemb).float()               # [B, c, V]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t_blk[..., None])[..., 0]
        return torch.sum(logz - gold)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        total = total + _remat(chunk_loss, xc[:, i], tc[:, i])
    return total


def lm_loss(cfg: LMConfig, params: LMParams, tokens, targets, *,
            loss_chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy with sequence-chunked logits (``_chunked_ce``):
    the summed losses divided by B·S. On a mesh each rank sums its block
    of the batch (and of the sequence, where the residual is
    sequence-parallel) against the whole unembedding, and the loss is the
    blocks' sum, a plain scalar on every rank."""
    x = forward_hidden(cfg, params, tokens)            # [B, S, d]
    unemb = _unembed(cfg, params)
    b, s, _ = x.shape
    if not shr.is_dtensor(x):
        return _chunked_ce(x, unemb, targets, loss_chunk) / (b * s)
    from torch.distributed.tensor import Partial, Replicate
    if not shr.is_dtensor(targets):
        raise TypeError("the hidden states are a DTensor: the targets must "
                        "be one too")
    mesh = x.device_mesh
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    split = shr.sharded_dims(pl)
    total = _chunked_ce(shr.local(x, pl),
                        shr.local(unemb, _replicate(mesh), partial=split),
                        shr.local(targets, pl), loss_chunk)
    total = shr.from_local(total, mesh, tuple(
        Partial() if i in split else Replicate() for i in range(mesh.ndim)))
    return total.full_tensor() / (b * s)


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LMConfig, batch: int, seq_len: int, *,
                  device: str | torch.device | None = None) -> dict:
    """Zeroed ``k`` and ``v`` of shape [L, B, Hkv, S, Dh] in ``cfg.dtype``
    on ``device`` and ``len`` 0 (a host int)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq_len, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev), "len": 0}


def _decode_attention(cfg: LMConfig, h, lp, ck, cv, pos: int, positions,
                      visible):
    """One layer's decode attention: the new token's K and V written into
    the layer's cache ck, cv [B, Hkv, S, Dh] at ``pos``, then the masked
    attention over the static-length cache, grouped → [B, 1, Hq·Dh]."""
    b = h.shape[0]
    q, k, v = _qkv(cfg, h, lp, positions)
    ck[:, :, pos] = k[:, 0]                                # [B, Hkv, Dh]
    cv[:, :, pos] = v[:, 0]
    rep = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, rep, cfg.d_head)
    s = (qg @ ck.transpose(-1, -2)).float() * cfg.d_head ** -0.5
    s = torch.where(visible, s, -1e30)                     # [B, Hkv, rep, S]
    p = torch.softmax(s, dim=-1)
    return (p.to(cv.dtype) @ cv).reshape(b, 1, -1)         # [B, 1, Hq·Dh]


# ---------------------------------------------------------------------------
# Decode over a mesh: each rank's share of every product, written out
# ---------------------------------------------------------------------------

def _split_by(pl, dim: int) -> tuple:
    """The mesh dims on which placements ``pl`` split tensor dim ``dim``,
    outermost first."""
    return tuple(i for i, p in enumerate(pl) if p.is_shard(dim))


def _less_layer_dim(placements) -> tuple:
    """The placements of one layer of a stacked [L, ...] DTensor (no rule
    splits L)."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(p.dim - 1) if p.is_shard() else p
                 for p in placements)


def _local_layers(cfg: LMConfig, params: LMParams) -> list[dict]:
    """Each layer's ``{name: (block, placements)}``: the stacked DTensor
    leaves' blocks unbound once."""
    out = [{} for _ in range(cfg.n_layers)]
    for name, leaf in params.layers.items():
        pl = _less_layer_dim(leaf.placements)
        for layer, block in zip(out, leaf.to_local().unbind(0)):
            layer[name] = (block, pl)
    return out


@dataclasses.dataclass(frozen=True)
class DecodeSplit:
    """How a sharded decode step splits its work, read from the layer
    cache's placements ``pl`` of [B, Hkv, S, Dh] (``lm_cache_specs``): the
    mesh dims that split the batch (``rows``) and the positions
    (``seq``), and the ``model`` dim (``mi``, size ``m``, this rank
    ``r``). Every activation is this rank's rows [n, ...], whole along d,
    and every weight this rank's block with its placements; the
    collectives are written out (``torch.distributed`` on the mesh's
    groups).
      * With the positions over ``model`` (decode_32k: the batch over the
        data axes) each rank scores every head of its rows against its
        position block.
      * Otherwise (long_500k: one request, the positions over the data
        axes, the cache block replicated over ``model``) the model ranks
        split the heads by ``HeadSplit``: rank r scores its head block
        against those heads' kv heads in its cache block, and the n_q
        ranks that share a head block take disjoint position ranges of
        the block (q_block j the j-th of n_q)."""
    mesh: Any
    mi: int
    m: int
    r: int
    rows: tuple
    seq: tuple

    @classmethod
    def of(cls, mesh, pl) -> "DecodeSplit":
        mi = _model_dim(mesh)
        if mi is None:
            raise ValueError("a sharded decode step needs a 'model' mesh "
                             f"dim; the mesh has {mesh.mesh_dim_names}")
        return cls(mesh=mesh, mi=mi, m=mesh.size(mi),
                   r=mesh.get_local_rank(mi), rows=_split_by(pl, 0),
                   seq=_split_by(pl, 2))

    def rows_placements(self) -> tuple:
        """Placements of a [B, ...] activation held as this rank's rows."""
        from torch.distributed.tensor import Replicate, Shard
        return tuple(Shard(0) if i in self.rows else Replicate()
                     for i in range(self.mesh.ndim))

    def gather(self, t: torch.Tensor, dims, dim: int) -> torch.Tensor:
        """Block ``t`` whole along ``dim``, split over mesh ``dims``
        (outermost first): gathered over the innermost first."""
        for i in reversed(dims):
            t = _gather_dim(t, self.mesh.get_group(i), dim)
        return t

    def reduce(self, t: torch.Tensor, dims) -> torch.Tensor:
        """``t`` summed in place over each of mesh ``dims``."""
        for i in dims:
            if self.mesh.size(i) > 1:
                dist.all_reduce(t, group=self.mesh.get_group(i))
        return t

    def in_block(self, x, w) -> torch.Tensor:
        """x [n, k] (this rank's rows) times w [k, c] (``(block,
        placements)``, c over ``model``): this rank's column block [n,
        c/m]. With the rows split over the data axes w's k is gathered
        where it is stored split (FSDP); with the rows whole each rank
        contracts over the block of k it stores, and the partial sums are
        all-reduced."""
        t, pl = w
        if self.rows:
            return x @ self.gather(t, _split_by(pl, 0), 0)
        k0 = shr.block_offset(self.mesh, pl, 0, t.shape[0])
        return self.reduce(x[:, k0:k0 + t.shape[0]] @ t, _split_by(pl, 0))

    def out_block(self, a, w) -> torch.Tensor:
        """a [n, c/m] (this rank's column block) times w [c, d] (c over
        ``model`` as a's columns): the sum over the model ranks as this
        rank's rows [n, d]. With the rows split w's d is gathered where it
        is split; with the rows whole each rank multiplies its stored
        block, and the columns are gathered after the sum."""
        t, pl = w
        if self.rows:
            return self.reduce(a @ self.gather(t, _split_by(pl, 1), 1),
                               (self.mi,))
        return self.gather(self.reduce(a @ t, (self.mi,)), _split_by(pl, 1),
                           1)

    def heads(self, cfg: LMConfig, s_l: int) -> tuple:
        """``(HeadSplit, first position, positions)``: this rank's heads
        and its range of the cache block's ``s_l`` positions."""
        if self.mi in self.seq:
            return HeadSplit(n_q=1, head_block=0, q_block=0,
                             heads=cfg.n_heads, kv0=0,
                             n_kv=cfg.n_kv_heads), 0, s_l
        hs = HeadSplit.of(cfg, self.m, self.r)
        if s_l % hs.n_q:
            raise ValueError(f"a cache block of {s_l} positions does not "
                             f"split into {hs.n_q} position ranges")
        sub = s_l // hs.n_q
        return hs, hs.q_block * sub, sub


def _decode_attention_sharded(cfg: LMConfig, sp: DecodeSplit, x, lp, ck,
                              cv, pl, pos: int) -> torch.Tensor:
    """One layer's decode attention on a mesh, through wo: x [n, d] this
    rank's normed rows, ck, cv its cache blocks [n, Hkv, s_l, Dh] (``pl``
    their placements). Returns [n, d], the output product summed over the
    model ranks.
      * q, k and v: each rank multiplies its column block of wq, wk and wv
        (``in_block``) and the blocks are gathered whole: every model rank
        holds the cache block, and the one holding position ``pos`` writes
        the new K and V of every kv head;
      * each rank scores its heads against their kv heads in its position
        range (``DecodeSplit``), reading only those heads' bytes;
      * the softmax's max and sum and the weighted values are combined
        over the dims that split the positions and over ``model`` (each
        rank's heads in a whole-heads buffer, zero or -1e30 elsewhere);
      * the whole attention output's block of rows of wo, as stored,
        gives a partial sum over ``model`` (``out_block``)."""
    n, dh, hq = x.shape[0], cfg.d_head, cfg.n_heads

    def heads(w, count):
        return sp.gather(sp.in_block(x, w), (sp.mi,), 1).reshape(n, count,
                                                                 dh)

    q, k, v = heads(lp["wq"], hq), heads(lp["wk"], cfg.n_kv_heads), \
        heads(lp["wv"], cfg.n_kv_heads)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"][0])
        k = rms_norm(k, lp["k_norm"][0])
    positions = torch.full((n, 1), pos, dtype=torch.int64, device=x.device)
    q = rope(q[:, None], positions, cfg.rope_theta)[:, 0]
    k = rope(k[:, None], positions, cfg.rope_theta)[:, 0]
    s_l = ck.shape[2]
    s0 = shr.block_offset(sp.mesh, pl, 2, s_l)
    if s0 <= pos < s0 + s_l:
        ck[:, :, pos - s0] = k
        cv[:, :, pos - s0] = v
    hs, p0, p_n = sp.heads(cfg, s_l)
    h0 = hs.head_block * hs.heads
    qg = q[:, h0:h0 + hs.heads].reshape(n, hs.n_kv, hs.heads // hs.n_kv, dh)
    kb = ck[:, hs.kv0:hs.kv0 + hs.n_kv, p0:p0 + p_n]
    vb = cv[:, hs.kv0:hs.kv0 + hs.n_kv, p0:p0 + p_n]
    s = (qg @ kb.transpose(-1, -2)).float() * dh ** -0.5
    visible = s0 + p0 + torch.arange(p_n, device=s.device) <= pos
    s = torch.where(visible, s, -1e30)              # [n, n_kv, rep_l, p_n]
    groups = [sp.mesh.get_group(i)
              for i in sorted(set(sp.seq) | {sp.mi})
              if sp.mesh.size(i) > 1]
    if not groups:
        attn = (torch.softmax(s, dim=-1).to(cv.dtype) @ vb).reshape(n, -1)
    else:
        mine = slice(h0, h0 + hs.heads)
        shape = s.shape[:-1] + (1,)

        def combined(t, fill, op):
            """Each rank's heads of t in a whole-heads buffer, reduced."""
            full = t.new_full((n, hq) + t.shape[3:], fill)
            full[:, mine] = t.reshape((n, hs.heads) + t.shape[3:])
            for g in groups:
                dist.all_reduce(full, op=op, group=g)
            return full

        m = combined(s.amax(-1), -1e30, dist.ReduceOp.MAX)[:, mine]
        e = torch.exp(s - m.reshape(shape))
        den = combined(e.sum(-1), 0.0, dist.ReduceOp.SUM)[:, mine]
        o = ((e / den.reshape(shape)).to(cv.dtype) @ vb).float()
        attn = combined(o, 0.0, dist.ReduceOp.SUM).to(cv.dtype).reshape(n, -1)
    rows = attn.shape[1] // sp.m
    return sp.out_block(attn[:, sp.r * rows:(sp.r + 1) * rows], lp["wo"])


def _mlp_decode_sharded(cfg: LMConfig, sp: DecodeSplit, x, lp):
    """The dense MLP of this rank's rows x [n, d]: its column block of
    ``w_gate`` and ``w_up`` and row block of ``w_down`` (``in_block``,
    ``out_block``); [n, d] summed over the model ranks."""
    g = F.silu(sp.in_block(x, lp["w_gate"]).float()).to(x.dtype)
    return sp.out_block(g * sp.in_block(x, lp["w_up"]), lp["w_down"])


def _moe_decode_sharded(cfg: LMConfig, sp: DecodeSplit, x, lp):
    """The MoE of this rank's rows x [n, d] on a mesh, routed as
    ``moe_block`` routes the whole token table (capacity, positions and
    drops over all T tokens):
      * each rank multiplies its rows by its model block of the router's
        expert columns, and the float32 logits are gathered whole, so
        every rank routes the same [T, E] (``route_logits``); the table
        [T, d] is gathered over the dims that split the rows;
      * rank r dispatches to its experts only ([r·E/m, (r+1)·E/m), as the
        expert weights are stored), the columns of d its ``w_gate`` and
        ``w_up`` blocks hold; their partial sums are all-reduced over the
        dims that split d, and ``w_down``'s block gives its columns of d;
      * the combine of its experts' slots is a partial sum over ``model``,
        summed, gathered along d and cut to this rank's rows."""
    e_l = cfg.n_experts // sp.m
    if e_l * sp.m != cfg.n_experts:
        raise ValueError(f"{cfg.n_experts} experts on a model axis of {sp.m}")
    router = lp["router"][0][:, sp.r * e_l:(sp.r + 1) * e_l]
    logits = sp.gather(sp.gather(x.float() @ router.float(), (sp.mi,), 1),
                       sp.rows, 0)
    table = sp.gather(x, sp.rows, 0)
    top_g, top_e, pos, keep, cap = route_logits(logits, cfg)
    local_e = top_e - sp.r * e_l
    keep = keep & (local_e >= 0) & (local_e < e_l)
    rows = torch.where(keep, local_e * cap + pos, e_l * cap)
    (wg, gate_pl), (wu, _), (wd, down_pl) = (
        lp[k] for k in ("w_gate", "w_up", "w_down"))
    k0 = shr.block_offset(sp.mesh, gate_pl, 1, wg.shape[1])
    b3 = _dispatch(table[:, k0:k0 + wg.shape[1]], rows, e_l, cap)
    g, u = sp.reduce(torch.stack([torch.bmm(b3, wg), torch.bmm(b3, wu)]),
                     _split_by(gate_pl, 1))
    y = torch.bmm(F.silu(g.float()).to(x.dtype) * u, wd)
    out = _combine(y.reshape(e_l * cap, wd.shape[2]), rows, keep, top_g,
                   y.new_empty((table.shape[0], wd.shape[2])))
    out = sp.gather(sp.reduce(out, (sp.mi,)), _split_by(down_pl, 2), 1)
    r0 = shr.block_offset(sp.mesh, sp.rows_placements(), 0, x.shape[0])
    return out[r0:r0 + x.shape[0]]


def _decode_step_sharded(cfg: LMConfig, params: LMParams, token, cache):
    """``decode_step`` on a mesh: the parameters, token and cache DTensors
    placed by the sharding rules. Every layer runs on this rank's rows
    and blocks as plain tensors (``DecodeSplit``): each product on this
    rank's blocks of its weights, so every product's work is split over
    the whole mesh where the rows are split, and over the model ranks (as
    the weights' storage splits it) where they are not. Returns the
    logits whole on every rank."""
    pos = cache["len"]
    pl = _less_layer_dim(cache["k"].placements)
    sp = DecodeSplit.of(cache["k"].device_mesh, pl)
    x = _embed(cfg, params, token, sp.rows_placements()).to_local()
    mlp = _moe_decode_sharded if cfg.is_moe else _mlp_decode_sharded
    for lp, ck, cv in zip(_local_layers(cfg, params),
                          cache["k"].to_local().unbind(0),
                          cache["v"].to_local().unbind(0)):
        x = x + _decode_attention_sharded(
            cfg, sp, rms_norm(x, lp["ln_attn"][0]), lp, ck, cv, pl, pos)
        x = x + mlp(cfg, sp, rms_norm(x, lp["ln_mlp"][0]), lp)
    x = rms_norm(x, params["ln_out"].to_local())
    unemb = _unembed(cfg, params)
    logits = sp.in_block(x, (unemb.to_local(), unemb.placements))
    return sp.gather(sp.gather(logits, (sp.mi,), 1), sp.rows, 0)


def decode_step(cfg: LMConfig, params: LMParams, token: torch.Tensor,
                cache: dict):
    """One decode step. token: [B] int → (logits [B, vocab] float32,
    cache).

    The new token's K and V go into the cache at position ``len``, in
    place, and ``len`` goes up by one: the cache passed in is updated and
    returned. Attention runs against the whole static cache length, masked
    to positions ``<= len``. Nothing here reads the card from the host.
    On a mesh (DTensor parameters, token and cache, placed by
    ``lm_cache_specs``) each rank runs its share of every product
    (``_decode_step_sharded``) and the logits come back whole on every
    rank.
    """
    b = token.shape[0]
    pos = cache["len"]
    s_max = cache["k"].shape[3]
    if not 0 <= pos < s_max:
        raise IndexError(f"decode at position {pos} of a {s_max}-long cache")
    if shr.is_dtensor(cache["k"]):
        logits = _decode_step_sharded(cfg, params, token, cache)
    else:
        x = _embed(cfg, params, token)[:, None, :]         # [B, 1, d]
        positions = torch.full((b, 1), pos, dtype=torch.int64,
                               device=x.device)
        visible = torch.arange(s_max, device=x.device) <= pos
        for lp, ck, cv in zip(_unstack(params), cache["k"].unbind(0),
                              cache["v"].unbind(0)):
            attn = _decode_attention(cfg, rms_norm(x, lp["ln_attn"]), lp,
                                     ck, cv, pos, positions, visible)
            x = x + (attn @ lp["wo"])
            x = x + _mlp(cfg, rms_norm(x, lp["ln_mlp"]), lp)
        x = rms_norm(x, params["ln_out"])
        logits = x[:, 0] @ _unembed(cfg, params)
    cache["len"] = pos + 1
    return logits[:, :cfg.vocab].float(), cache
