"""The port's DIEN serving path against the JAX package on the CPU.

The same parameters (drawn by ``repro.models.dien.dien_init`` and carried
over with ``params_from_reference``) and the same numpy inputs go through
``repro.models.dien`` and ``repro_torch.models.dien``. Tolerance for
float32 hidden states, logits and scores: 1e-5 abs and rel. The two sum in
other orders (MKL's matmuls against XLA's dot, the port's attention
contracted as ``att_w · t_proj`` then a batched product, the masked
sum-pool as a product with the mask), so they agree to rounding, not bit
for bit: at the full widths the largest differences measured were 2.6e-8 on
the 100 hidden states and 4.4e-9 on logits of magnitude up to 0.014.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.mesh import make_host_mesh
from repro.launch.train import synthetic_batches as jax_synthetic_batches
from repro.models import dien as jd
from repro.train.step import build_cell as jax_build_cell
from repro.train.step import dien_serve_cell as jax_dien_serve_cell
from repro_torch.configs import ARCH_IDS, RECSYS_SHAPES, get_arch
from repro_torch.launch.train import synthetic_batches
from repro_torch.models import dien as td
from repro_torch.train.step import build_cell

TOL = dict(rtol=1e-5, atol=1e-5)
# The assigned widths (embed 18, T 100, GRU 108, MLP 200-80) with small
# tables, so the reference's full-width recurrences run on the CPU.
FULL_WIDTHS = dict(embed_dim=18, seq_len=100, gru_dim=108, mlp_dims=(200, 80),
                   n_items=1000, n_cates=50, n_user_feats=300, user_hot=8)
SMOKE = dataclasses.asdict(get_arch("dien").make_smoke_config())


def _configs(widths):
    kw = {k: v for k, v in widths.items() if k not in ("name", "dtype")}
    return jd.DIENConfig(**kw), td.DIENConfig(**kw)


def _params(jcfg, seed):
    """The reference's parameters (JAX arrays) and the port's copy."""
    tree = jd.dien_init(jcfg, jax.random.key(seed))
    return tree, td.params_from_reference(jax.tree.map(np.asarray, tree),
                                          device="cpu")


def _batch(cfg, b, seed, all_masked_row=None):
    rng = np.random.default_rng(seed)
    t = cfg.seq_len
    batch = {
        "hist_items": rng.integers(0, cfg.n_items, (b, t)).astype(np.int32),
        "hist_cates": rng.integers(0, cfg.n_cates, (b, t)).astype(np.int32),
        "hist_mask": rng.random((b, t)) < 0.8,
        "target_item": rng.integers(0, cfg.n_items, b).astype(np.int32),
        "target_cate": rng.integers(0, cfg.n_cates, b).astype(np.int32),
        "user_feats": rng.integers(0, cfg.n_user_feats,
                                   (b, cfg.user_hot)).astype(np.int32),
    }
    if all_masked_row is not None:
        batch["hist_mask"][all_masked_row] = False
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def test_params_from_reference_round_trips_the_tree():
    jcfg, _ = _configs(SMOKE)
    tree, params = _params(jcfg, 0)
    back = params.to_reference()
    assert (jax.tree.structure(back) == jax.tree.structure(tree))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert not any(p.requires_grad for p in params.parameters())
    names = {n for n, _ in params.named_parameters()}
    assert {"item_table", "gru1.wz", "augru.bh", "mlp.2.0"} <= names


@pytest.mark.parametrize("widths", [SMOKE, FULL_WIDTHS],
                         ids=["smoke", "full_widths"])
@pytest.mark.parametrize("cell", ["gru", "augru"])
def test_cells_match_jax(widths, cell):
    jcfg, _ = _configs(widths)
    tree, params = _params(jcfg, 1)
    rng = np.random.default_rng(2)
    b, d, g = 16, jcfg.d_behavior, jcfg.gru_dim
    x = rng.standard_normal((b, d)).astype(np.float32)
    h = rng.standard_normal((b, g)).astype(np.float32)
    a = rng.random(b).astype(np.float32)
    if cell == "gru":
        want = jd._gru_cell(tree["gru1"], x, h)
        got = td._gru_cell(params["gru1"], torch.from_numpy(x),
                           torch.from_numpy(h))
    else:
        want = jd._augru_cell(tree["augru"], x, h, a)
        got = td._augru_cell(params["augru"], torch.from_numpy(x),
                             torch.from_numpy(h), torch.from_numpy(a))
    _close(got, want)


@pytest.mark.parametrize("widths", [SMOKE, FULL_WIDTHS],
                         ids=["smoke", "full_widths"])
def test_interest_extractor_and_evolution_match_jax(widths):
    jcfg, tcfg = _configs(widths)
    tree, params = _params(jcfg, 3)
    rng = np.random.default_rng(4)
    b, t = 16, jcfg.seq_len
    behavior = (rng.standard_normal((b, t, jcfg.d_behavior)) * 0.05
                ).astype(np.float32)
    target = (rng.standard_normal((b, jcfg.d_behavior)) * 0.05
              ).astype(np.float32)
    mask = rng.random((b, t)) < 0.8
    mask[5] = False
    hs_want = jd.interest_extractor(jcfg, tree, jnp.asarray(behavior))
    hs = td.interest_extractor(tcfg, params, torch.from_numpy(behavior))
    assert hs.shape == (b, t, jcfg.gru_dim)
    _close(hs, hs_want)
    want = jd.interest_evolution(jcfg, tree, hs_want, jnp.asarray(behavior),
                                 jnp.asarray(target), jnp.asarray(mask))
    got = td.interest_evolution(tcfg, params, hs, torch.from_numpy(behavior),
                                torch.from_numpy(target),
                                torch.from_numpy(mask))
    _close(got, want)


@pytest.mark.parametrize("widths,embed_kernel", [
    (SMOKE, True), (SMOKE, False), (FULL_WIDTHS, False)],
    ids=["smoke-pallas", "smoke-plain", "full_widths"])
def test_dien_forward_matches_jax(widths, embed_kernel):
    """Batch 16 with row 7 all masked: uniform attention in both."""
    jcfg, tcfg = _configs(widths)
    jcfg = dataclasses.replace(jcfg, use_embed_kernel=embed_kernel)
    tree, params = _params(jcfg, 5)
    batch = _batch(jcfg, 16, seed=6, all_masked_row=7)
    want = jd.dien_forward(jcfg, tree, _jax(batch))
    got = td.dien_forward(tcfg, params, _torch(batch), device="cpu")
    assert got.shape == (16,) and got.dtype == torch.float32
    _close(got, want)


def test_dien_retrieval_score_pads_like_jax():
    """100 candidates in blocks of 32: 128 scores, the padding's included."""
    jcfg, tcfg = _configs(FULL_WIDTHS)
    tree, params = _params(jcfg, 7)
    rng = np.random.default_rng(8)
    user = _batch(jcfg, 1, seed=9)
    batch = {k: user[k] for k in ("hist_items", "hist_cates", "hist_mask",
                                  "user_feats")}
    batch["cand_items"] = rng.integers(0, jcfg.n_items, 100).astype(np.int32)
    batch["cand_cates"] = rng.integers(0, jcfg.n_cates, 100).astype(np.int32)
    want = jd.dien_retrieval_score(jcfg, tree, _jax(batch), cand_block=32)
    got = td.dien_retrieval_score(tcfg, params, _torch(batch), cand_block=32,
                                  device="cpu")
    assert got.shape == (128,) == want.shape
    _close(got, want)


@pytest.mark.parametrize("shape_name", ["serve_p99", "serve_bulk",
                                        "retrieval_cand"])
def test_build_cell_matches_jax(shape_name):
    """The port's cell (smoke config, CPU) against the reference's cell on
    the port's seeded parameters and the shared synthetic batch. At
    serve_bulk the reference runs its full-config branch
    (``use_embed_kernel=False``): 262,144 bags through the Pallas kernel in
    interpret mode would take minutes on the CPU."""
    spec, jspec = get_arch("dien"), jax_get_arch("dien")
    step, params, inputs = build_cell(spec, shape_name, smoke=True,
                                      device="cpu")
    jcfg = jspec.make_smoke_config()
    shape = spec.shapes[shape_name]
    if shape_name == "serve_bulk":
        jstep, _, _ = jax_dien_serve_cell(
            dataclasses.replace(jcfg, use_embed_kernel=False),
            make_host_mesh(), batch=shape["batch"])
    else:
        jstep, _, _ = jax_build_cell(jspec, shape_name, make_host_mesh(),
                                     smoke=True)
    _, batch = next(synthetic_batches(spec, shape, spec.make_smoke_config(),
                                      seed=11, device="cpu"))
    batch = {k: batch[k] for k in inputs}
    for k, v in inputs.items():
        assert v.device.type == "meta"
        assert v.shape == batch[k].shape and v.dtype == batch[k].dtype, k
    got = step(params, batch)
    want = jstep(jax.tree.map(jnp.asarray, params.to_reference()),
                 {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    n = shape.get("n_candidates", shape["batch"])
    assert got.shape == want.shape == (-(-n // 8192) * 8192 if
                                       shape["kind"] == "retrieval" else n,)
    _close(got, want)


@pytest.mark.parametrize("shape_name", ["serve_p99", "retrieval_cand"])
def test_synthetic_batches_equal_the_references(shape_name):
    spec, jspec = get_arch("dien"), jax_get_arch("dien")
    cfg = spec.make_config()
    shape = dict(spec.shapes[shape_name], n_candidates=5000)
    mine = synthetic_batches(spec, shape, cfg, seed=3, device="cpu")
    theirs = jax_synthetic_batches(jspec, shape, jspec.make_config(), seed=3)
    for step in range(2):
        cursor, got = next(mine)
        jcursor, want = next(theirs)
        assert cursor == jcursor == step
        for k, v in want.items():
            assert got[k].dtype == (torch.bool if k == "hist_mask"
                                    else torch.int32)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
        assert set(got) - set(want) == ({"cand_items", "cand_cates"}
                                        if shape["kind"] == "retrieval"
                                        else set())
    if shape["kind"] == "retrieval":
        assert got["cand_items"].shape == (5000,)
        assert int(got["cand_cates"].max()) < cfg.n_cates


def test_registry_and_unported_kinds():
    assert ARCH_IDS == tuple(jax_get_arch.__globals__["ARCH_IDS"])
    # The reference's shapes, on the keys the port reads (kind, batch,
    # n_candidates).
    ref_shapes = jax_get_arch.__globals__["RECSYS_SHAPES"]
    assert RECSYS_SHAPES.keys() == ref_shapes.keys()
    for name, shape in RECSYS_SHAPES.items():
        assert shape == {k: ref_shapes[name][k] for k in shape}, name
    spec = get_arch("dien")
    assert spec.make_config() == td.DIENConfig()
    with pytest.raises(NotImplementedError, match="not ported"):
        get_arch("llama3.2-1b")
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    # The train kind is ported (tests/test_torch_train.py); the other
    # families' cells are not.
    _, state, _ = build_cell(spec, "train_batch", smoke=True, device="cpu")
    assert set(state) == {"params", "opt"}
    with pytest.raises(NotImplementedError, match="item 15"):
        build_cell(dataclasses.replace(spec, family="lm"), "train_batch",
                   smoke=True, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        synthetic_batches(dataclasses.replace(spec, family="lm"), {}, None,
                          device="cpu")


def test_params_on_another_device_raise():
    jcfg, tcfg = _configs(SMOKE)
    _, params = _params(jcfg, 0)
    with pytest.raises(ValueError, match="params.to"):
        td.dien_forward(tcfg, params.to("meta"), _torch(_batch(jcfg, 2, 0)),
                        device="cpu")
