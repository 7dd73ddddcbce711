"""DIEN training in the port against the JAX package on the CPU.

The same numpy inputs (and the same parameters, carried over with
``params_from_reference`` / ``to_reference``) go through ``repro`` and
``repro_torch``: the learning-rate schedules, AdamW, ``dien_loss`` and its
gradients, and the ``train`` cell over three steps. The reference is run on
both of its routes for the embedding bag: the Pallas kernel in interpret
mode with its hand-written VJP (the smoke config's), and ``embed_bag_ref``
under XLA autodiff (the full config's, ``use_embed_kernel=False``).

Tolerances:
  * schedules: bit-equal in warmup and in the WSD schedule (float32 adds,
    products and divisions in the reference's order); 2 ulp (rtol 2.4e-7)
    in the cosine phase, where XLA's and PyTorch's float32 ``cos`` differ
    by one ulp at some steps;
  * AdamW on given gradients: 1e-6 abs and rel (float32 in the same order;
    ``b ** step`` may differ by an ulp); parameters cast to bf16 within one
    bf16 ulp (rel 2^-8);
  * loss, gradients and three train steps: 1e-5 abs and rel. The two sum
    in other orders (matmuls, the gathers' backward accumulating many rows
    into one table row, the global norm over leaves in pytree order against
    ``named_parameters`` order), so they agree to rounding, not bit for bit;
  * and each leaf also against its own scale, since most of DIEN's leaves
    lie wholly below 1e-5 (the recurrences' gradients go down to 2e-8 at
    batch 8, v is about 0.05 g^2): max |got - want| <= 1e-5 * max |want|
    for every gradient, m and v (measured at most 9.7e-7 of the scale),
    and, for the parameters' change over the steps, <= 1e-4 * max |change|
    plus two float32 ulps of the leaf's largest entry (the change is a
    difference of two rounded parameters; measured at most 1.2e-5 of
    the change beyond those ulps).
The train cell is run from step 0, whose lr is 0 (the parameters after it
must equal the initial ones exactly, which pins that the lr is taken at the
step before the increment), and from steps 250 (warmup, lr 5e-4) and
30,000 (cosine, lr 4.2e-4), where three updates move each parameter by
about 1e-3 and the change is held to its own scale: a wrong peak lr,
warmup, total, weight decay, beta or bias correction shows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.mesh import make_host_mesh
from repro.launch.train import SMOKE_SHAPES as JAX_SMOKE_SHAPES
from repro.models import dien as jd
from repro.optim import adamw as jax_adamw
from repro.optim import schedule as jax_schedule
from repro.train.step import build_cell as jax_build_cell
from repro.train.step import dien_train_cell as jax_dien_train_cell
from repro_torch.configs import get_arch
from repro_torch.launch.train import SMOKE_SHAPES, synthetic_batches
from repro_torch.models import dien as td
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule, wsd_schedule)
from repro_torch.train.step import build_cell

TOL = dict(rtol=1e-5, atol=1e-5)
ADAM_TOL = dict(rtol=1e-6, atol=1e-6)
# The assigned widths (embed 18, T 100, GRU 108, MLP 200-80) with small
# tables, as in tests/test_torch_dien.py.
FULL_WIDTHS = dict(embed_dim=18, seq_len=100, gru_dim=108, mlp_dims=(200, 80),
                   n_items=1000, n_cates=50, n_user_feats=300, user_hot=8)
SMOKE = {k: v for k, v in dataclasses.asdict(
    get_arch("dien").make_smoke_config()).items() if k not in ("name",
                                                                  "dtype")}


def _named(tree):
    """A reference parameter tree's leaves under the port's
    ``named_parameters`` names."""
    out = {}
    for k, v in tree.items():
        if k == "mlp":
            out.update({f"mlp.{i}.{j}": x for i, pair in enumerate(v)
                        for j, x in enumerate(pair)})
        elif isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


SCALED_RTOL = 1e-5
DELTA_RTOL = 1e-4


def _close_to_scale(got, want, rtol: float, what: str, floor: float = 0.0):
    """max |got - want| <= rtol * max |want| + floor over a whole leaf: a
    limit set by the leaf's own scale, so that a leaf whose entries all lie
    below an absolute tolerance is still compared."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale > 0, f"{what}: the reference is all zero"
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale + floor, (
        f"{what}: max |diff| {err:.3e} against {rtol} * {scale:.3e} "
        f"+ {floor:.3e}")


# ---- schedules -----------------------------------------------------------------

SCHEDULES = {
    "cosine_dien": ("cosine", dict(peak_lr=1e-3, warmup=500, total=50_000)),
    "cosine_short": ("cosine", dict(peak_lr=3e-4, warmup=7, total=40,
                                    final_frac=0.2)),
    "cosine_no_warmup": ("cosine", dict(peak_lr=1e-2, warmup=0, total=30)),
    "wsd_lm": ("wsd", dict(peak_lr=3e-4, warmup=2000, stable=100_000,
                           decay=20_000)),
    "wsd_short": ("wsd", dict(peak_lr=1e-3, warmup=5, stable=11, decay=9,
                              final_frac=0.3)),
}


def _boundary_steps(kind, kw):
    """Steps 0-2, and each phase boundary with its neighbours, and past the
    end."""
    w = kw["warmup"]
    ends = [w, kw["total"]] if kind == "cosine" else [
        w, w + kw["stable"], w + kw["stable"] + kw["decay"]]
    steps = {0, 1, 2, 3 * ends[-1]}
    for e in ends:
        steps |= {max(e - 1, 0), e, e + 1}
    steps |= {(a + b) // 2 for a, b in zip(ends, ends[1:])}
    return sorted(steps)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    kind, kw = SCHEDULES[name]
    mine = cosine_schedule if kind == "cosine" else wsd_schedule
    theirs = getattr(jax_schedule, f"{kind}_schedule")
    steps = _boundary_steps(kind, kw)
    got = np.array([mine(torch.tensor(s, dtype=torch.int32), **kw).numpy()
                    for s in steps])
    assert got.dtype == np.float32
    want = np.array([np.asarray(theirs(jnp.int32(s), **kw)) for s in steps])
    # A Python int step gives the same value as an int32 tensor.
    np.testing.assert_array_equal(
        np.array([mine(s, **kw).numpy() for s in steps]), got)
    exact = np.array([kind == "wsd" or s < kw["warmup"] for s in steps])
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)


# ---- AdamW -----------------------------------------------------------------------

SHAPES = {"emb": (40, 6), "w1": (6, 5), "b1": (5,), "w2": (5, 1),
          "b2": (1,)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("max_norm", [1.0, 0.05, None],
                         ids=["clip_default", "clip_active", "no_clip"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(max_norm, compute_dtype):
    """Three updates with lr != 0 on given gradients: parameters, m, v,
    master, step and the global norm."""
    rng = np.random.default_rng(5)
    params = _tree(rng)
    t_dtype = getattr(torch, compute_dtype)
    j_dtype = getattr(jnp, compute_dtype)
    state = adamw_init({k: torch.from_numpy(v) for k, v in params.items()})
    jstate = jax_adamw.adamw_init({k: jnp.asarray(v)
                                   for k, v in params.items()})
    for step, lr in enumerate((1e-2, 3e-3, 5e-2)):
        grads = _tree(rng, scale=0.1 * (step + 1))
        new, state, gn = adamw_update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, state,
            torch.tensor(lr, dtype=torch.float32), max_norm=max_norm,
            compute_dtype=t_dtype)
        jnew, jstate, jgn = jax_adamw.adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate,
            jnp.float32(lr), max_norm=max_norm, compute_dtype=j_dtype)
        _close(gn, jgn, **ADAM_TOL)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        assert state["step"].dtype == torch.int32
        for k in SHAPES:
            for part in ("m", "v", "master"):
                assert state[part][k].dtype == torch.float32
                _close(state[part][k], jstate[part][k], **ADAM_TOL)
            assert new[k].dtype == t_dtype
            _close(new[k], jnew[k].astype(jnp.float32),
                   **(ADAM_TOL if compute_dtype == "float32"
                      else dict(rtol=2 ** -8, atol=1e-6)))
    if max_norm is None:
        assert float(gn) == 0.0


@pytest.mark.parametrize("max_norm", [0.1, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(6)
    grads = _tree(rng)
    got, gn = clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in grads.items()}, max_norm)
    want, jgn = jax_adamw.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
    _close(gn, jgn, **ADAM_TOL)
    for k in SHAPES:
        _close(got[k], want[k], **ADAM_TOL)


def test_adamw_init_layout():
    """The reference's layout: zero float32 moments, a float32 master copy
    (its own storage, not the parameter's) and an int32 step 0."""
    p = {"a": torch.randn(3, 2), "b": torch.randn(4).to(torch.bfloat16)}
    state = adamw_init(p)
    assert set(state) == {"m", "v", "master", "step"}
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for k, t in p.items():
        for part in ("m", "v"):
            assert state[part][k].dtype == torch.float32
            assert not state[part][k].any()
        assert torch.equal(state["master"][k], t.float())
        assert state["master"][k].data_ptr() != t.data_ptr()


# ---- dien_loss and its gradients ------------------------------------------------

def _configs(widths, embed_kernel):
    return (jd.DIENConfig(**widths, use_embed_kernel=embed_kernel),
            td.DIENConfig(**widths))


def _batch(cfg, b, seed):
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
        "label": rng.integers(0, 2, b).astype(np.int32),
    }
    batch["hist_mask"][3] = False            # one row with no history
    return batch


@pytest.mark.parametrize("widths,embed_kernel", [
    (SMOKE, True), (FULL_WIDTHS, True), (FULL_WIDTHS, False)],
    ids=["smoke-pallas_vjp", "full_widths-pallas_vjp",
         "full_widths-xla_autodiff"])
def test_dien_loss_and_every_gradient_match_jax(widths, embed_kernel):
    """Batch 8 (row 3 with no history): the loss and every leaf's gradient
    against ``jax.value_and_grad(dien_loss)``. At the full widths this is a
    backward through 100 GRU and 100 AUGRU steps."""
    jcfg, tcfg = _configs(widths, embed_kernel)
    tree = jd.dien_init(jcfg, jax.random.key(7))
    params = td.params_from_reference(jax.tree.map(np.asarray, tree),
                                      device="cpu").requires_grad_()
    batch = _batch(jcfg, 8, seed=8)
    loss_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jd.dien_loss(jcfg, p, b)))
    want_loss, want_grads = loss_fn(tree, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    loss = td.dien_loss(tcfg, params, {k: torch.from_numpy(v)
                                       for k, v in batch.items()},
                        device="cpu")
    assert loss.dtype == torch.float32 and loss.shape == ()
    names, leaves = zip(*params.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    _close(loss, want_loss)
    want = _named(want_grads)
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g.shape == want[k].shape, k
        _close(g, want[k])
        _close_to_scale(g, want[k], SCALED_RTOL, f"gradient of {k}")
    # The user table's gradient went through embed_bag's backward: only the
    # rows the batch names are nonzero.
    touched = np.zeros(jcfg.n_user_feats, bool)
    touched[batch["user_feats"].ravel()] = True
    assert not grads["user_table"][torch.from_numpy(~touched)].any()


def test_interest_extractor_same_states_with_and_without_autograd():
    """Under autograd the states are stacked, without it written into one
    tensor: the same values either way."""
    jcfg, tcfg = _configs(FULL_WIDTHS, False)
    params = td.params_from_reference(
        jax.tree.map(np.asarray, jd.dien_init(jcfg, jax.random.key(9))),
        device="cpu")
    behavior = torch.from_numpy((np.random.default_rng(10).standard_normal(
        (4, jcfg.seq_len, jcfg.d_behavior)) * 0.05).astype(np.float32))
    with torch.inference_mode():
        frozen = td.interest_extractor(tcfg, params, behavior)
    params.requires_grad_()
    tracked = td.interest_extractor(tcfg, params, behavior)
    assert tracked.requires_grad and not frozen.requires_grad
    assert torch.equal(tracked.detach(), frozen)


def test_params_from_named_round_trips():
    _, tcfg = _configs(SMOKE, False)
    params = td.dien_init(tcfg, generator=torch.Generator().manual_seed(1),
                          device="cpu")
    named = dict(params.named_parameters())
    back = td.DIENParams.from_named(named)
    assert list(dict(back.named_parameters())) == list(named)
    for k, p in back.named_parameters():
        assert torch.equal(p, named[k]) and not p.requires_grad
    assert all(p.requires_grad for p in back.requires_grad_().parameters())


# ---- the train cell ----------------------------------------------------------------

def _smoke_specs():
    spec = dataclasses.replace(get_arch("dien"),
                               shapes={"smoke": SMOKE_SHAPES["recsys"]})
    jspec = dataclasses.replace(jax_get_arch("dien"),
                                shapes={"smoke": JAX_SMOKE_SHAPES["recsys"]})
    return spec, jspec


@pytest.mark.parametrize("start", [0, 250, 30_000])
@pytest.mark.parametrize("route", ["build_cell", "xla_autodiff"])
def test_train_cell_matches_jax_over_three_steps(route, start):
    """The port's ``build_cell(..., "smoke", smoke=True, device="cpu")``
    against the reference's smoke cell (``build_cell``: the Pallas VJP) and
    its full-config route (``use_embed_kernel=False``), from the port's
    seed-0 parameters with both optimizer states at step ``start``, on the
    shared synthetic batches: loss, grad_norm, every parameter's change,
    m, v, master and step after each of three steps."""
    spec, jspec = _smoke_specs()
    assert SMOKE_SHAPES["recsys"] == JAX_SMOKE_SHAPES["recsys"]
    step, state, inputs = build_cell(spec, "smoke", smoke=True, device="cpu")
    if route == "build_cell":
        jstep, _, _ = jax_build_cell(jspec, "smoke", make_host_mesh(),
                                     smoke=True)
    else:
        jstep, _, _ = jax_dien_train_cell(
            dataclasses.replace(jspec.make_smoke_config(),
                                use_embed_kernel=False),
            make_host_mesh(), batch=SMOKE_SHAPES["recsys"]["batch"])
    jstep = jax.jit(jstep)
    tree = jax.tree.map(jnp.asarray, state["params"].to_reference())
    jstate = {"params": tree, "opt": jax_adamw.adamw_init(tree)}
    state["opt"]["step"] = torch.tensor(start, dtype=torch.int32)
    jstate["opt"]["step"] = jnp.int32(start)
    batches = synthetic_batches(spec, spec.shapes["smoke"],
                                spec.make_smoke_config(), seed=0,
                                device="cpu")
    initial = {k: p.detach().clone()
               for k, p in state["params"].named_parameters()}
    for i in range(3):
        _, batch = next(batches)
        assert set(batch) == set(inputs)
        old = state
        state, metrics = step(state, batch)
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v.numpy())
                                          for k, v in batch.items()})
        assert old["params"] is not state["params"]
        _close(metrics["loss"], jmetrics["loss"])
        _close(metrics["grad_norm"], jmetrics["grad_norm"])
        assert (int(state["opt"]["step"]) == int(jstate["opt"]["step"])
                == start + i + 1)
        named = dict(state["params"].named_parameters())
        assert all(p.requires_grad for p in named.values())
        want = {part: _named(jstate["opt"][part])
                for part in ("m", "v", "master")}
        want["params"] = _named(jstate["params"])
        for k, p in named.items():
            _close(p, want["params"][k])
            for part in ("m", "v", "master"):
                _close(state["opt"][part][k], want[part][k])
            for part in ("m", "v"):
                _close_to_scale(state["opt"][part][k], want[part][k],
                                SCALED_RTOL, f"{part} of {k} at step {i}")
        moved = [not torch.equal(p, initial[k]) for k, p in named.items()]
        # lr is 0 at step 0 (the schedule at the step before the update).
        assert not any(moved) if start + i == 0 else all(moved)
        if start + i == 0:
            continue
        for k, p in named.items():
            p0 = initial[k].numpy().astype(np.float64)
            _close_to_scale(
                p.detach().numpy() - p0, np.asarray(want["params"][k]) - p0,
                DELTA_RTOL, f"change of {k} after step {i}",
                floor=2 * float(np.finfo(np.float32).eps) * np.abs(p0).max())


def test_train_cell_state_and_inputs_at_the_full_config():
    """``train_batch`` at the full config on the CPU (built, not run):
    65,536 rows with labels, trainable parameters and their AdamW state."""
    spec = get_arch("dien")
    cfg = spec.make_config()
    _, state, inputs = build_cell(spec, "train_batch", device="cpu")
    assert set(state) == {"params", "opt"}
    _, batch = next(synthetic_batches(spec, {"kind": "train", "batch": 4},
                                      cfg, device="cpu"))
    assert set(inputs) == set(batch)
    for k, v in inputs.items():
        assert v.device.type == "meta" and v.dtype == batch[k].dtype, k
        assert v.shape[0] == 65536 and v.shape[1:] == batch[k].shape[1:], k
    params = dict(state["params"].named_parameters())
    assert params["item_table"].shape == (cfg.n_items, cfg.embed_dim)
    assert all(p.requires_grad for p in params.values())
    for part in ("m", "v", "master"):
        assert list(state["opt"][part]) == list(params)
    assert int(state["opt"]["step"]) == 0


def test_train_cell_without_cuda_raises(monkeypatch):
    """The train cell resolves to the card, as every entry point does, and
    never drops to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = get_arch("dien")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_cell(spec, "train_batch", smoke=True)
    step, state, _ = build_cell(spec, "train_batch", smoke=True,
                                device="cpu")
    _, batch = next(synthetic_batches(spec, {"kind": "train", "batch": 4},
                                      spec.make_smoke_config(),
                                      device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.dien_loss(spec.make_smoke_config(), state["params"], batch)
    _, metrics = step(state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
