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
  * the attention, the loss's chunked cross-entropy and the MoE dispatch
    run on each rank's block (``sharding.local``): attention over the
    batch and head blocks, the loss over the batch (and sequence) block,
    and with ``moe_expert_axis`` set ``moe_block_shard_map`` on the
    blocks of the reference's ``shard_map`` specs. Without it the MoE
    routes the whole token table on every rank, as the reference's
    unsharded routing does, and its expert products are DTensor ops on the
    constrained buckets.
``set_lm_mesh`` keeps the mesh handle that turns on the expert-parallel
path, as in the reference.
"""
from __future__ import annotations

import contextvars
import dataclasses
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
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = int(max(1, round(t * k / e * cfg.capacity_factor)))
    cap = -(-cap // 8) * 8
    logits = x.float() @ router_w.float()
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

def _mlp(cfg: LMConfig, h2, lp, *, expert_parallel: bool = False):
    """The dense or MoE MLP; with ``expert_parallel`` (the training and
    prefill layers, not decode, as in the reference) and a mesh set by
    ``set_lm_mesh``, the MoE runs ``moe_block_shard_map``."""
    if cfg.is_moe:
        mesh = _LM_MESH.get()
        if expert_parallel and mesh is not None \
                and cfg.moe_expert_axis is not None:
            return _moe_expert_parallel(cfg, h2, lp, mesh)
        return moe_block(h2, lp["router"], lp["w_gate"], lp["w_up"],
                         lp["w_down"], cfg)
    h2 = _whole_seq(h2)
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


def _head_placements(cfg: LMConfig, x) -> tuple:
    """The attention's placements of [B, S, H, Dh] for DTensor x [B, S,
    d]: the batch as x splits it, heads over every other mesh dim whose
    size divides both head counts (query head h reads kv head h // rep,
    so equal blocks of both line up), the sequence whole."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, out, n = x.device_mesh, [], 1
    for i, p in enumerate(x.placements):
        size = mesh.size(i)
        if p.is_shard(0):
            out.append(Shard(0))
        elif cfg.n_heads % (n * size) == 0 \
                and cfg.n_kv_heads % (n * size) == 0:
            n *= size
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return tuple(out)


def _heads(cfg: LMConfig, h, w, n: int, pl):
    """This rank's block [b, s, n_l, Dh] of the heads ``h @ w`` (DTensor h
    [B, S, d]): the product placed at ``pl`` first (whole heads a rank),
    then viewed as heads."""
    b, s, _ = h.shape
    t = (h @ w).redistribute(h.device_mesh, pl)
    return shr.local(t.reshape(b, s, n, cfg.d_head), pl)


def _attention_sharded(cfg: LMConfig, h, lp):
    """Causal self-attention of DTensor h [B, S, d]: q, k and v are
    DTensor products, then each rank runs the norms, rope and
    ``chunked_attention`` on its batch and head block (no collective
    inside); the result is a DTensor [B, S, H·Dh], each rank's heads
    flattened on its own block (DTensor cannot view a dim split over more
    ranks than the heads it holds, as the output product's gradient is,
    back into heads)."""
    s = h.shape[1]
    mesh = h.device_mesh
    h = _whole_seq(h)
    pl = _head_placements(cfg, h)
    split = shr.sharded_dims(pl)
    q = _heads(cfg, h, lp["wq"], cfg.n_heads, pl)
    k = _heads(cfg, h, lp["wk"], cfg.n_kv_heads, pl)
    v = _heads(cfg, h, lp["wv"], cfg.n_kv_heads, pl)
    if cfg.qk_norm:
        rep = _replicate(mesh)
        q = rms_norm(q, shr.local(lp["q_norm"], rep, partial=split))
        k = rms_norm(k, shr.local(lp["k_norm"], rep, partial=split))
    positions = torch.arange(s, device=q.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=True, q_offset=0,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return shr.from_local(out.reshape(out.shape[0], s, -1), mesh, pl)


def _layer_fwd(cfg: LMConfig, x, lp, positions, kv_cache=None):
    """One transformer layer. x: [B, S, d]. Returns (x, new_kv).

    With ``kv_cache = (ck, cv)`` ([B, Skv, Hkv, Dh], already holding the
    new tokens' K/V) the queries attend to it unmasked, one query a block,
    and ``new_kv`` is this layer's (k, v). A DTensor x (no cache) takes
    ``_attention_sharded``."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["ln_attn"])
    if shr.is_dtensor(x) and kv_cache is None:
        attn, new_kv = _attention_sharded(cfg, h, lp), None
    elif kv_cache is None:
        q, k, v = _qkv(cfg, h, lp, positions)
        attn = chunked_attention(q, k, v, causal=True, q_offset=0,
                                 q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        new_kv = None
    else:
        q, k, v = _qkv(cfg, h, lp, positions)
        ck, cv = kv_cache
        attn = chunked_attention(q, ck, cv, causal=False, q_offset=0,
                                 q_chunk=1, kv_chunk=cfg.kv_chunk)
        new_kv = (k, v)
    x = x + _placed_as(attn.reshape(b, s, -1) @ lp["wo"], x)
    y = _mlp(cfg, rms_norm(x, lp["ln_mlp"]), lp, expert_parallel=True)
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


def _decode_attention_sharded(cfg: LMConfig, h, lp, ck, cv, pl, pos: int):
    """``_decode_attention`` for DTensor h [B, 1, d] against this rank's
    cache blocks ck, cv (``pl``: the layer cache's placements of [B, Hkv,
    S, Dh], batch and positions split, heads whole). The queries are cut
    as the cache's batch; the rank holding position ``pos`` writes the new
    K and V; the softmax over positions split across ranks takes the
    global max and sum (all-reduce over each dim that splits them) and
    the weighted values are summed likewise. Returns a DTensor [B, 1,
    Hq·Dh]."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = h.device_mesh
    q_pl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pl)
    q = _heads(cfg, h, lp["wq"], cfg.n_heads, q_pl)
    k = _heads(cfg, h, lp["wk"], cfg.n_kv_heads, q_pl)
    v = _heads(cfg, h, lp["wv"], cfg.n_kv_heads, q_pl)
    if cfg.qk_norm:
        q = rms_norm(q, shr.local(lp["q_norm"], _replicate(mesh)))
        k = rms_norm(k, shr.local(lp["k_norm"], _replicate(mesh)))
    positions = torch.full((q.shape[0], 1), pos, dtype=torch.int64,
                           device=q.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    s_l = ck.shape[2]
    s0 = shr.block_offset(mesh, pl, 2, s_l)
    if s0 <= pos < s0 + s_l:
        ck[:, :, pos - s0] = k[:, 0]
        cv[:, :, pos - s0] = v[:, 0]
    groups = [mesh.get_group(i) for i, p in enumerate(pl) if p.is_shard(2)]
    rep = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(q.shape[0], cfg.n_kv_heads, rep, cfg.d_head)
    s = (qg @ ck.transpose(-1, -2)).float() * cfg.d_head ** -0.5
    visible = s0 + torch.arange(s_l, device=s.device) <= pos
    s = torch.where(visible, s, -1e30)
    if groups:
        m = s.amax(-1, keepdim=True)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        e = torch.exp(s - m)
        den = e.sum(-1, keepdim=True)
        for g in groups:
            dist.all_reduce(den, group=g)
        attn = ((e / den).to(cv.dtype) @ cv).float()
        for g in groups:
            dist.all_reduce(attn, group=g)
        attn = attn.to(cv.dtype)
    else:
        attn = torch.softmax(s, dim=-1).to(cv.dtype) @ cv
    return shr.from_local(attn.reshape(q.shape[0], 1, -1), mesh, q_pl)


def decode_step(cfg: LMConfig, params: LMParams, token: torch.Tensor,
                cache: dict):
    """One decode step. token: [B] int → (logits [B, vocab] float32,
    cache).

    The new token's K and V go into the cache at position ``len``, in
    place, and ``len`` goes up by one: the cache passed in is updated and
    returned. Attention runs against the whole static cache length, masked
    to positions ``<= len``. Nothing here reads the card from the host.
    On a mesh (DTensor parameters, token and cache, placed by
    ``lm_cache_specs``) each rank attends over its cache block
    (``_decode_attention_sharded``), no activation is constrained, as in
    the reference, and the logits come back whole on every rank.
    """
    b = token.shape[0]
    pos = cache["len"]
    s_max = cache["k"].shape[3]
    if not 0 <= pos < s_max:
        raise IndexError(f"decode at position {pos} of a {s_max}-long cache")
    x = _embed(cfg, params, token)[:, None, :]             # [B, 1, d]
    layers = _unstack(params)
    if shr.is_dtensor(cache["k"]):
        from torch.distributed.tensor import Shard
        pl = tuple(Shard(p.dim - 1) if p.is_shard() else p
                   for p in cache["k"].placements)

        def attend(h, lp, ck, cv):
            return _decode_attention_sharded(cfg, h, lp, ck, cv, pl, pos)
        caches = zip(cache["k"].to_local().unbind(0),
                     cache["v"].to_local().unbind(0))
    else:
        positions = torch.full((b, 1), pos, dtype=torch.int64,
                               device=x.device)
        visible = torch.arange(s_max, device=x.device) <= pos

        def attend(h, lp, ck, cv):
            return _decode_attention(cfg, h, lp, ck, cv, pos, positions,
                                     visible)
        caches = zip(cache["k"].unbind(0), cache["v"].unbind(0))
    for lp, (ck, cv) in zip(layers, caches):
        x = x + (attend(rms_norm(x, lp["ln_attn"]), lp, ck, cv) @ lp["wo"])
        x = x + _mlp(cfg, rms_norm(x, lp["ln_mlp"]), lp)
    x = rms_norm(x, params["ln_out"])
    logits = x[:, 0] @ _unembed(cfg, params)
    if shr.is_dtensor(logits):
        logits = logits.full_tensor()
    cache["len"] = pos + 1
    return logits[:, :cfg.vocab].float(), cache
