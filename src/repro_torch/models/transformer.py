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

Not ported: ``set_lm_mesh``, ``moe_block_shard_map`` and the
``_constrain_*`` / ``_gather_moe_weight`` helpers, which place activations
and experts on a device mesh; they wait for the mesh code (ROADMAP §1
item 15). The config keeps ``act_batch_axes``, ``act_seq_axis`` and
``moe_expert_axis``; the forward raises ``NotImplementedError`` when any is
set.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.graph import resolve_device


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
    # Mesh plumbing (activation and expert sharding): kept as fields; the
    # forward refuses them until the mesh code is ported.
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


def _check_no_mesh(cfg: LMConfig) -> None:
    if cfg.act_batch_axes or cfg.act_seq_axis is not None \
            or cfg.moe_expert_axis is not None:
        raise NotImplementedError(
            f"{cfg.name}: act_batch_axes, act_seq_axis and moe_expert_axis "
            "place activations and experts on a device mesh, which waits "
            "for the mesh code (ROADMAP §1 item 15)")


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


def _moe_block_flat(x, router_w, w_gate, w_up, w_down, cfg: LMConfig):
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    top_g, top_e, pos, keep, cap = moe_route(x, router_w, cfg)

    # Kept (token, slot)s to their bucket rows, one indexed copy a slot (no
    # [T·k, d] staging copy); dropped slots all land on the trash row e·cap.
    rows = torch.where(keep, top_e * cap + pos, e * cap)
    buckets = x.new_zeros((e * cap + 1, d))
    for j in range(k):
        buckets.index_copy_(0, rows[:, j], x)
    b3 = buckets[:e * cap].view(e, cap, d)

    g = torch.bmm(b3, w_gate)
    u = torch.bmm(b3, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(h, w_down).reshape(e * cap, d)          # [E·cap, d]

    # Combine: per-slot gather + gate-weighted accumulate in x.dtype.
    safe = torch.clamp_max(rows, e * cap - 1)
    out = torch.zeros_like(x)
    for j in range(k):
        yj = torch.where(keep[:, j:j + 1], y.index_select(0, safe[:, j]), 0)
        out = out + yj * top_g[:, j:j + 1].to(x.dtype)
    return out


def moe_block(x, router_w, w_gate, w_up, w_down, cfg: LMConfig):
    """Token-chunked capacity-bucketed top-k MoE (deterministic).

    x: [B, S, d]. Returns [B, S, d]. Tokens beyond an expert's per-chunk
    capacity are dropped (Switch behaviour). With ``n_ch > 1`` chunks of
    whole batch rows (``moe_chunk // S`` rows a chunk, ``B % n_ch == 0``),
    chunk c holds rows c, c + n_ch, ... (the reference's ``[bc, n_ch, S,
    d]`` view), each under checkpoint.
    """
    _check_no_mesh(cfg)
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
# Forward passes
# ---------------------------------------------------------------------------

def _mlp(cfg: LMConfig, h2, lp):
    if cfg.is_moe:
        return moe_block(h2, lp["router"], lp["w_gate"], lp["w_up"],
                         lp["w_down"], cfg)
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


def _layer_fwd(cfg: LMConfig, x, lp, positions, kv_cache=None):
    """One transformer layer. x: [B, S, d]. Returns (x, new_kv).

    With ``kv_cache = (ck, cv)`` ([B, Skv, Hkv, Dh], already holding the
    new tokens' K/V) the queries attend to it unmasked, one query a block,
    and ``new_kv`` is this layer's (k, v)."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["ln_attn"])
    q, k, v = _qkv(cfg, h, lp, positions)
    if kv_cache is None:
        attn = chunked_attention(q, k, v, causal=True, q_offset=0,
                                 q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        new_kv = None
    else:
        ck, cv = kv_cache
        attn = chunked_attention(q, ck, cv, causal=False, q_offset=0,
                                 q_chunk=1, kv_chunk=cfg.kv_chunk)
        new_kv = (k, v)
    x = x + (attn.reshape(b, s, -1) @ lp["wo"])
    y = _mlp(cfg, rms_norm(x, lp["ln_mlp"]), lp)
    return (x + y).to(cfg.dtype), new_kv


def _embed(cfg: LMConfig, params: LMParams, tokens):
    return F.embedding(tokens, params["embed"]).to(cfg.dtype)


def forward_hidden(cfg: LMConfig, params: LMParams, tokens) -> torch.Tensor:
    """Backbone forward → post-ln hidden states [B, S, d].

    Each layer under checkpoint when ``cfg.remat``; with ``remat_groups =
    G`` dividing ``n_layers``, also G groups of L/G layers, each group under
    checkpoint (the residual stash falls from L to G + L/G slices for one
    extra forward recompute).
    """
    _check_no_mesh(cfg)
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    layers = _unstack(params)

    def one_layer(x, lp):
        return _layer_fwd(cfg, x, lp, positions)[0]

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


def lm_loss(cfg: LMConfig, params: LMParams, tokens, targets, *,
            loss_chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy with sequence-chunked logits: each chunk's
    unembed and logsumexp in float32 under checkpoint (recomputed in the
    backward), so one chunk's [B, c, V] logits live at a time; the summed
    losses are divided by B·S."""
    x = forward_hidden(cfg, params, tokens)            # [B, S, d]
    unemb = _unembed(cfg, params)
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
    return total / (b * s)


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


def decode_step(cfg: LMConfig, params: LMParams, token: torch.Tensor,
                cache: dict):
    """One decode step. token: [B] int → (logits [B, vocab] float32,
    cache).

    The new token's K and V go into the cache at position ``len``, in
    place, and ``len`` goes up by one: the cache passed in is updated and
    returned. Attention runs against the whole static cache length, masked
    to positions ``<= len``. Nothing here reads the card from the host.
    """
    _check_no_mesh(cfg)
    b = token.shape[0]
    pos = cache["len"]
    s_max = cache["k"].shape[3]
    if not 0 <= pos < s_max:
        raise IndexError(f"decode at position {pos} of a {s_max}-long cache")
    rep = cfg.n_heads // cfg.n_kv_heads
    x = _embed(cfg, params, token)[:, None, :]             # [B, 1, d]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    visible = torch.arange(s_max, device=x.device) <= pos
    layers = _unstack(params)
    for lp, ck, cv in zip(layers, cache["k"].unbind(0), cache["v"].unbind(0)):
        h = rms_norm(x, lp["ln_attn"])
        q, k, v = _qkv(cfg, h, lp, positions)
        ck[:, :, pos] = k[:, 0]                            # [B, Hkv, Dh]
        cv[:, :, pos] = v[:, 0]

        # Masked decode attention over the static-length cache, grouped.
        qg = q.reshape(b, cfg.n_kv_heads, rep, cfg.d_head)
        s = (qg @ ck.transpose(-1, -2)).float() * cfg.d_head ** -0.5
        s = torch.where(visible, s, -1e30)                 # [B, Hkv, rep, S]
        p = torch.softmax(s, dim=-1)
        attn = p.to(cv.dtype) @ cv                         # [B, Hkv, rep, Dh]

        x = x + (attn.reshape(b, 1, -1) @ lp["wo"])
        x = x + _mlp(cfg, rms_norm(x, lp["ln_mlp"]), lp)
    x = rms_norm(x, params["ln_out"])
    logits = (x[:, 0] @ _unembed(cfg, params))[:, :cfg.vocab]
    cache["len"] = pos + 1
    return logits.float(), cache
