"""The LM (``models/transformer.py``) in the port against the JAX package on
the CPU, at the smoke configs of the five LMs.

The same numpy-seeded inputs and the reference's parameters (its
``init_params``, carried over with ``params_from_reference``) go through
``repro`` (jitted once per config and dtype, shared through
``functools.cache``) and ``repro_torch``: the configs and parameter counts,
``rms_norm``, ``rope``, ``chunked_attention`` (causal and not, GQA rep 1, 2
and 3, ``q_chunk != kv_chunk``, chunks that do not divide the requested
size), the MoE routing and block (unchunked and token-chunked),
``forward``, ``forward_hidden`` (flat and two-level remat) and three
``decode_step``s (logits and the cache's K and V).

The routing's keep masks, bucket positions and capacity are bit-equal to
the reference's formula (``_moe_block_flat``'s lines, run in jnp here on the
same tokens: the reference does not return them).

Both dtypes run the same weights: the reference's bf16 init, cast to
float32 for the float32 runs. Tolerances, of each output's scale
(max |got - want| <= tol · max |want|):
  * configs replaced to float32: 1e-5 of the reference's result (sums in
    other orders; measured below 1e-6);
  * bf16, the building blocks (``rms_norm``, ``rope``, attention, the MoE
    block) on the same bf16 inputs: 2e-2 of the reference's bf16 result;
  * bf16, the model: held against the float32 reference on the same weights, no
    further from it than the reference's own bf16 result, plus 2e-2 of
    scale (``assert_bf16_near``). The two bf16 runs cannot be held to each
    other: XLA keeps excess precision inside its fusions (a bf16 dot
    followed by a cast to float32 becomes one float32-output dot) where
    torch rounds after every op, and that rounding, carried through the
    layers, puts each side 1.0e-2 to 1.4e-2 of the logits' scale from
    float32 and up to 2.0e-2 from the other; and where it decides a
    discrete choice (an MoE token whose k-th and (k+1)-th gates lie within
    it takes another expert) one side's logits move 13-55 % of scale (the
    reference's moonshot smoke forward: 54 % from float32; the port's: 1.4
    %). The routing itself is bit-equal in float32 and, on the same bf16
    input, in ``test_moe_block``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as jt
from repro_torch.configs import LM_SHAPES, get_arch
from repro_torch.models import transformer as tt

LM_ARCHS = ("llama3.2-1b", "qwen3-1.7b", "minicpm-2b", "moonshot-v1-16b-a3b",
            "dbrx-132b")
MOE_ARCHS = ("moonshot-v1-16b-a3b", "dbrx-132b")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BATCH, SEQ = 2, 24
CACHE = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops while this module
    runs: the suite runs several worker processes on a few cores, and a
    small op's parallel region then waits on its descheduled threads (this
    module's tests took 3-10 times longer so). The previous count is put
    back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch: str, dtype: str, **changes):
    """(reference config, port config) of the smoke config in ``dtype``."""
    jd, td = DTYPES[dtype]
    jc = dataclasses.replace(jax_get_arch(arch).make_smoke_config(), dtype=jd,
                             **changes)
    tc = dataclasses.replace(get_arch(arch).make_smoke_config(), dtype=td,
                             **changes)
    return jc, tc


@functools.cache
def reference_params(arch: str, dtype: str):
    """The reference's parameters: its bf16 init (key 0), cast to float32
    for the float32 runs, so that both dtypes run the same weights."""
    jc, _ = configs(arch, "bfloat16")
    p = jt.init_params(jc, jax.random.key(0))
    if dtype == "float32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    return p


def port_params(arch: str, dtype: str) -> tt.LMParams:
    tree = jax.tree.map(np.asarray, reference_params(arch, dtype))
    return tt.params_from_reference(tree, device="cpu")


def tokens(vocab: int, shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def as64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def scaled_err(got, want) -> float:
    got, want = as64(got), as64(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_close(got, want, tol: float, what: str) -> float:
    err = scaled_err(got, want)
    assert err <= tol, f"{what}: {err:.3e} of scale > {tol}"
    return err


def assert_bf16_near(got, want, want32, what: str) -> float:
    """A bf16 result held against the float32 reference on the same
    weights: no further from it than the reference's own bf16 result, plus
    2e-2 of its scale."""
    err, own = scaled_err(got, want32), scaled_err(want, want32)
    assert err <= own + TOL["bfloat16"], \
        f"{what}: {err:.3e} of scale from float32 > {own:.3e} + 2e-2"
    return err


def hold(got, want, dtype: str, what: str, want32=None) -> float:
    """float32: ``assert_close`` at 1e-5; bf16: ``assert_bf16_near`` (the
    float32 reference's result ``want32``)."""
    if dtype == "bfloat16":
        return assert_bf16_near(got, want, want32, what)
    return assert_close(got, want, TOL[dtype], what)


def flat_reference_tree(tree) -> dict:
    """The reference's tree under the port's parameter names."""
    out = {f"layers.{k}": v for k, v in tree["layers"].items()}
    out.update({k: v for k, v in tree.items() if k != "layers"})
    return out


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(d["dtype"]).rsplit(".", 1)[-1]
    return d


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_and_counts_match_reference(arch):
    spec, ref = get_arch(arch), jax_get_arch(arch)
    assert (spec.arch_id, spec.family, spec.fsdp, spec.notes) == \
        (ref.arch_id, ref.family, ref.fsdp, ref.notes)
    assert spec.shapes == ref.shapes == LM_SHAPES
    for make in ("make_config", "make_smoke_config"):
        got, want = getattr(spec, make)(), getattr(ref, make)()
        assert got.dtype is torch.bfloat16
        assert _fields(got) == {**_fields(want), "dtype": "bfloat16"}, make
        for prop in ("d_head", "vocab_padded", "is_moe"):
            assert getattr(got, prop) == getattr(want, prop), (make, prop)
        assert got.param_count() == want.param_count(), make
        assert got.active_param_count() == want.active_param_count(), make


def test_full_param_counts():
    """The five full configs' sizes, from the reference's own formula."""
    counts = {a: (get_arch(a).make_config().param_count(),
                  get_arch(a).make_config().active_param_count())
              for a in LM_ARCHS}
    assert counts == {
        "llama3.2-1b": (1_235_814_400, 1_235_814_400),
        "qwen3-1.7b": (1_720_567_808, 1_720_567_808),
        "minicpm-2b": (2_724_880_896, 2_724_880_896),
        "moonshot-v1-16b-a3b": (28_051_703_808, 3_968_010_240),
        "dbrx-132b": (131_592_591_360, 36_465_776_640)}


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_layout(arch):
    """``init_params`` gives the reference's tree: names, shapes and
    dtypes; each matrix N(0, 1/fan_in) in bf16, the norms ones; the same
    draws from the same seed; nothing drawn on ``meta``."""
    spec = get_arch(arch)
    cfg = spec.make_smoke_config()
    ref = flat_reference_tree(jt.init_params(
        jax_get_arch(arch).make_smoke_config(), jax.random.key(0)))
    gen = torch.Generator().manual_seed(3)
    p = tt.init_params(cfg, generator=gen, device="cpu")
    named = dict(p.named_parameters())
    assert set(named) == set(ref)
    for k, t in named.items():
        assert tuple(t.shape) == ref[k].shape, k
        assert str(t.dtype).rsplit(".", 1)[-1] == ref[k].dtype.name, k
        assert not t.requires_grad
        if k.split(".")[-1] in ("ln_attn", "ln_mlp", "ln_out", "q_norm",
                                "k_norm"):
            assert torch.equal(t, torch.ones_like(t)), k
        else:
            fan_in = t.shape[-1] if k == "embed" else t.shape[-2]
            std = float(t.float().std()) * fan_in ** 0.5
            assert 0.8 < std < 1.2, (k, std)
    again = tt.init_params(cfg, generator=torch.Generator().manual_seed(3),
                           device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(p.parameters(), again.parameters()))
    full = spec.make_config()
    meta = tt.init_params(full, generator=None, device="meta")
    assert all(t.device.type == "meta" for t in meta.parameters())
    # param_count counts the true vocab and leaves out the router and the
    # q/k norms; the tables hold vocab_padded rows.
    extra = full.n_layers * (full.d_model * full.n_experts
                             + 2 * full.d_head * full.qk_norm)
    pad = ((full.vocab_padded - full.vocab) * full.d_model
           * (1 if full.tie_embeddings else 2))
    assert sum(t.numel() for t in meta.parameters()) == \
        full.param_count() + extra + pad
    with pytest.raises(ValueError, match="generator"):
        tt.init_params(cfg, generator=None, device="cpu")


def test_params_round_trip():
    tree = jax.tree.map(np.asarray, reference_params("moonshot-v1-16b-a3b",
                                                     "bfloat16"))
    p = tt.params_from_reference(tree, device="cpu")
    back = p.to_reference()
    assert set(back) == set(tree) and set(back["layers"]) == \
        set(tree["layers"])
    for k, v in flat_reference_tree(tree).items():
        assert np.array_equal(flat_reference_tree(back)[k],
                              v.astype(np.float32)), k
    again = tt.LMParams.from_named(dict(p.named_parameters()))
    assert [n for n, _ in again.named_parameters()] == \
        [n for n, _ in p.named_parameters()]
    assert p.get("unembed") is not None and p["embed"].dtype == torch.bfloat16
    tied = port_params("llama3.2-1b", "bfloat16")
    assert tied.get("unembed") is None
    with pytest.raises(ValueError, match="keys"):
        tt.params_from_reference({"embed": tree["embed"]}, device="cpu")


def test_mesh_fields_raise():
    """An activation or expert axis set on plain tensors (no mesh): the
    constraint that places them raises, as the reference's constraint
    does without a mesh; the sharded forward is in
    ``tests/test_torch_mesh_cells.py``."""
    toks = torch.zeros((1, 8), dtype=torch.int32)
    for arch, change in (
            ("llama3.2-1b", dict(act_batch_axes=("data",))),
            ("llama3.2-1b", dict(act_seq_axis="model")),
            ("moonshot-v1-16b-a3b", dict(moe_expert_axis="model"))):
        _, tc = configs(arch, "float32")
        p = port_params(arch, "float32")
        with pytest.raises(TypeError, match="must be a DTensor"):
            tt.forward(dataclasses.replace(tc, **change), p, toks)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_and_rope(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32) * 3
    w = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 600_000, (2, 12))
    jx = jnp.asarray(x, jd)
    tx = torch.from_numpy(x).to(td)
    got = tt.rms_norm(tx, torch.from_numpy(w))
    assert got.dtype == td
    assert_close(got, jt.rms_norm(jx, jnp.asarray(w)), TOL[dtype], "rms_norm")
    for theta in (1e4, 5e5):
        got = tt.rope(tx, torch.from_numpy(pos), theta)
        assert got.dtype == td
        want = jax.jit(lambda a, p: jt.rope(a, p, theta))(jx, pos)
        assert_close(got, want, TOL[dtype], f"rope {theta}")


# (B, Sq, Skv, Hq, Hkv, causal, q_chunk, kv_chunk): rep 1, 2 and 3; chunks
# that divide the length and chunks that do not (24 // 10 = 2 blocks of 12,
# 24 // 7 = 3 blocks of 8); a decode-like non-causal case (q_chunk 1).
ATTENTION = [
    (2, 24, 24, 4, 4, True, 8, 8),
    (2, 24, 24, 4, 2, True, 8, 12),
    (2, 24, 24, 6, 2, True, 10, 7),
    (1, 32, 32, 6, 3, True, 16, 8),
    (2, 24, 24, 4, 2, False, 12, 6),
    (2, 3, 24, 6, 2, False, 1, 8),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTENTION, ids=lambda c: "-".join(map(str, c)))
def test_chunked_attention(case, dtype):
    b, sq, skv, hq, hkv, causal, qc, kvc = case
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(sum(case[:5]))
    q = rng.standard_normal((b, sq, hq, 16)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, 16)).astype(np.float32)
    want = jax.jit(lambda q, k, v: jt.chunked_attention(
        q, k, v, causal=causal, q_offset=0, q_chunk=qc, kv_chunk=kvc))(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd))
    got = tt.chunked_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                               causal=causal, q_offset=0, q_chunk=qc,
                               kv_chunk=kvc)
    assert got.dtype == td
    assert_close(got, want, TOL[dtype], "attention")


def test_chunked_attention_is_grouped_repeat():
    """Query head h reads kv head h // rep: the grouped contraction equals
    attention over ``repeat_interleave``d heads (not tiled ones)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 16, 6, 8), (2, 16, 2, 8), (2, 16, 2, 8)))
    kw = dict(causal=True, q_offset=0, q_chunk=8, kv_chunk=4)
    got = tt.chunked_attention(q, k, v, **kw)
    rep = tt.chunked_attention(q, k.repeat_interleave(3, dim=2),
                               v.repeat_interleave(3, dim=2), **kw)
    tiled = tt.chunked_attention(q, k.repeat(1, 1, 3, 1),
                                 v.repeat(1, 1, 3, 1), **kw)
    torch.testing.assert_close(got, rep, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(got, tiled, atol=1e-3)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def reference_route(x, router_w, cfg):
    """``repro.models.transformer._moe_block_flat``'s routing lines (the
    reference returns only the block's output)."""
    t, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = int(max(1, round(t * k / e * cfg.capacity_factor)))
    cap = -(-cap // 8) * 8
    logits = x.astype(jnp.float32) @ router_w.astype(jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    top_g, top_e = jax.lax.top_k(gates, k)
    top_g = top_g / jnp.maximum(top_g.sum(-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(top_e, e, dtype=jnp.int32)
    flat = onehot.reshape(t * k, e)
    pos = jnp.sum(flat * (jnp.cumsum(flat, axis=0) - flat),
                  axis=-1).reshape(t, k)
    return top_g, top_e, pos, pos < cap, cap


# (B, S, moe_chunk, capacity_factor): one flat table; 4 chunks of two rows
# (rows c, c + 4: the reference's [bc, n_ch, S, d] view); a table where
# tokens drop.
MOE_CASES = [(2, 12, 65536, 1.25), (8, 12, 12, 1.25), (16, 16, 65536, 0.5)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block(arch, case, dtype):
    b, s, chunk, factor = case
    jc, tc = configs(arch, dtype, moe_chunk=chunk, capacity_factor=factor)
    jd, td = DTYPES[dtype]
    tree = reference_params(arch, dtype)
    lw = {k: v[0] for k, v in tree["layers"].items()}
    pw = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(td)
          for k, v in lw.items()}
    x = np.random.default_rng(b * s).standard_normal(
        (b, s, jc.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)

    # Routing, chunk by chunk as moe_block splits the table.
    n_ch = b // max(1, chunk // s)
    n_ch = n_ch if n_ch > 1 and b % n_ch == 0 else 1
    kept = 0
    for c in range(n_ch):
        rows = slice(c, None, n_ch)
        jflat = jx[rows].reshape(-1, jc.d_model)
        tflat = tx[rows].reshape(-1, tc.d_model)
        rg, re_, rp, rk, rcap = reference_route(jflat, lw["router"], jc)
        pg, pe, pp, pk, pcap = tt.moe_route(tflat, pw["router"], tc)
        assert pcap == rcap
        assert np.array_equal(pe.numpy(), np.asarray(re_))
        assert np.array_equal(pp.numpy(), np.asarray(rp))
        assert np.array_equal(pk.numpy(), np.asarray(rk))
        assert_close(pg, rg, 1e-6, "top gates")
        kept += int(pk.sum())
    if factor < 1:
        assert kept < b * s * jc.top_k, "no token dropped"

    want = jax.jit(lambda x, w: jt.moe_block(
        x, w["router"], w["w_gate"], w["w_up"], w["w_down"], jc))(jx, lw)
    got = tt.moe_block(tx, pw["router"], pw["w_gate"], pw["w_up"],
                       pw["w_down"], tc)
    assert got.dtype == td
    assert_close(got, want, TOL[dtype], "moe_block")


# ---------------------------------------------------------------------------
# Forward and decode
# ---------------------------------------------------------------------------

@functools.cache
def reference_runs(arch: str, dtype: str):
    """The reference's hidden states with two-level remat (remat_groups =
    2) and the logits over them (``forward``'s product), and three decode
    steps' logits and final cache, on ``tokens(vocab, (BATCH, SEQ))``."""
    jc, _ = configs(arch, dtype)
    p = reference_params(arch, dtype)
    toks = tokens(jc.vocab, (BATCH, SEQ))
    jc2 = dataclasses.replace(jc, remat_groups=2)

    def both(p, t):
        hidden = jt.forward_hidden(jc2, p, t)
        return hidden, hidden @ jt._unembed(jc2, p)

    hidden, logits = jax.jit(both)(p, toks)
    step = jax.jit(lambda p, t, c: jt.decode_step(jc, p, t, c))
    cache = jt.init_kv_cache(jc, BATCH, CACHE)
    dec = []
    for i in range(3):
        out, cache = step(p, toks[:, i], cache)
        dec.append(out)
    return toks, logits, hidden, dec, cache


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_hidden_and_decode(arch, dtype):
    _, tc = configs(arch, dtype)
    toks, logits, hidden, dec, cache = reference_runs(arch, dtype)
    f32 = reference_runs(arch, "float32")
    p = port_params(arch, dtype)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        got = tt.forward(tc, p, t)
        assert got.dtype == tc.dtype and got.shape[-1] == tc.vocab_padded
        hold(got, logits, dtype, "forward", f32[1])
        for changes in (dict(remat_groups=2), dict(remat=False)):
            h = tt.forward_hidden(dataclasses.replace(tc, **changes), p, t)
            hold(h, hidden, dtype, f"forward_hidden {changes}", f32[2])
        pc = tt.init_kv_cache(tc, BATCH, CACHE, device="cpu")
        k_buf = pc["k"]
        for i in range(3):
            out, pc = tt.decode_step(tc, p, t[:, i], pc)
            assert out.dtype == torch.float32 and out.shape == (BATCH,
                                                                tc.vocab)
            hold(out, dec[i], dtype, f"decode step {i}", f32[3][i])
    assert pc["len"] == 3 and int(cache["len"]) == 3
    assert pc["k"] is k_buf, "the cache is written in place"
    # The port's cache is [L, B, Hkv, S, Dh]; the reference's [L, B, S, Hkv, Dh].
    for name in ("k", "v"):
        hold(pc[name].transpose(2, 3), cache[name], dtype, f"cache {name}",
             f32[4][name])
        assert not pc[name][:, :, :, 3:].any()
    with pytest.raises(IndexError):
        tt.decode_step(tc, p, t[:, 0], {**pc, "len": CACHE})
