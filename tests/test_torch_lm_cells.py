"""The LM cells of ``train/step.py`` in the port against the JAX package on
the CPU, and the cells built on ``meta``.

The train cell: three steps of the reference's jitted ``lm_train_cell``
and the port's on the same weights (the reference's bf16 init, cast to
float32 for the float32 runs), the same AdamW state and the same batches
(``synthetic_batches`` at the smoke shape, bit-equal to the reference's),
for the five LMs on both schedules: cosine from step 1999 (the end of the
warmup) and, for minicpm-2b, WSD from step 101,999 (the end of the stable
phase). Both start from the same mid-training moments, drawn from a seeded
numpy generator (m ~ N(0, 1e-6), v ~ U(1e-6, 2e-6) a leaf): from zero
moments the first normalized step of an element whose gradient lies at
float32's noise floor (1e-8 against a scale of 1e-2) is decided by that
noise, as it is between two float32 runs of the reference (minicpm-2b's
wv[1, 22, 6]: m 1.1e-9 against 8.1e-10, the step 2.6e-5 against 2.1e-5). Each step's loss, grad_norm and lr, and after the steps every
parameter, m, v and master leaf. The bf16 runs are built by ``build_cell``
at the smoke shape, as ``launch.train`` builds them; the float32 runs by
``lm_train_cell`` with the config replaced.

Tolerances as in ``tests/test_torch_transformer.py``: 1e-5 of each leaf's
scale in float32; in bf16 each result no further from the float32
reference's than the reference's own bf16 result, plus 2e-2 of its scale.
In bf16 the MoE archs' moments are not held leaf by leaf: over three steps
the tokens that bf16 rounding sends to another expert (on either side)
land in a few entries of the router's and the experts' m and v (moonshot's
m: 5.3e-2 of scale beyond the reference's own distance from float32);
their loss, grad_norm, lr, parameters and master weights are held, and
every leaf of all five archs in float32.

The meta cells: every LM cell of ``LM_SHARDED_CELLS`` at its full shape is
built on ``meta`` with its bytes readable (parameters, AdamW state, inputs
and KV cache, from the shapes), and the smoke cells and llama3.2-1b's and
qwen3-1.7b's ``long_500k`` are not.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.mesh import make_host_mesh
from repro.launch.train import synthetic_batches as jax_batches
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.train import step as jax_step
from repro_torch.configs import LM_SHAPES, get_arch
from repro_torch.launch.train import SMOKE_SHAPES, smoke_spec, synthetic_batches
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw_init
from repro_torch.train.step import (LM_SHARDED_CELLS, build_cell,
                                    lm_train_cell, sharded_cell)
from test_torch_transformer import (DTYPES, LM_ARCHS, configs,
                                    flat_reference_tree, hold, port_params,
                                    reference_params)
from test_torch_transformer import one_torch_thread  # noqa: F401 (autouse)

STEPS = 3
SHAPE = SMOKE_SHAPES["lm"]


def start_step(arch: str) -> int:
    return 101_999 if arch == "minicpm-2b" else 1999


def moments(names_shapes) -> dict:
    """Mid-training m and v a leaf, as float32 numpy arrays."""
    rng = np.random.default_rng(11)
    out = {}
    for name, shape in names_shapes:
        out[name] = (rng.standard_normal(shape).astype(np.float32) * 1e-3,
                     rng.uniform(1e-6, 2e-6, shape).astype(np.float32))
    return out


@functools.cache
def reference_train(arch: str, dtype: str):
    """The reference's three steps: metrics per step and the final state's
    leaves (params, m, v, master) under the port's names."""
    jc, _ = configs(arch, dtype)
    spec = jax_get_arch(arch)
    step_fn, _, _ = jax_step.lm_train_cell(
        jc, make_host_mesh(), batch=SHAPE["batch"], seq=SHAPE["seq"],
        fsdp=spec.fsdp, use_wsd=arch == "minicpm-2b")
    step_fn = jax.jit(step_fn)
    params = reference_params(arch, dtype)
    opt = jax_adamw_init(params)
    flat = flat_reference_tree(params)
    mv = moments(sorted((k, v.shape) for k, v in flat.items()))

    def tree(i):
        out = {k: jnp.asarray(mv[k][i]) for k in params if k != "layers"}
        out["layers"] = {k: jnp.asarray(mv[f"layers.{k}"][i])
                         for k in params["layers"]}
        return out
    opt["m"], opt["v"] = tree(0), tree(1)
    opt["step"] = jnp.int32(start_step(arch))
    state = {"params": params, "opt": opt}
    data = jax_batches(spec, SHAPE, spec.make_smoke_config())
    metrics = []
    for _ in range(STEPS):
        _, batch = next(data)
        state, m = step_fn(state, batch)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    leaves = {part: flat_reference_tree(state["opt"][part])
              for part in ("m", "v", "master")}
    leaves["params"] = flat_reference_tree(state["params"])
    return metrics, leaves, int(state["opt"]["step"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_cell_three_steps(arch, dtype):
    spec = get_arch(arch)
    _, tc = configs(arch, dtype)
    if dtype == "bfloat16":
        step_fn, state, inputs = build_cell(
            smoke_spec(spec, spec.make_smoke_config()), "smoke", smoke=True,
            device="cpu")
        assert state["params"].embed.dtype == torch.bfloat16
    else:
        step_fn, state, inputs = lm_train_cell(
            tc, batch=SHAPE["batch"], seq=SHAPE["seq"],
            device=torch.device("cpu"), use_wsd=arch == "minicpm-2b")
    assert {k: (tuple(v.shape), v.dtype, v.device.type)
            for k, v in inputs.items()} == {
        k: ((SHAPE["batch"], SHAPE["seq"]), torch.int32, "meta")
        for k in ("tokens", "targets")}
    assert set(dict(state["params"].named_parameters())) == \
        set(flat_reference_tree(reference_params(arch, dtype)))
    params = port_params(arch, dtype).requires_grad_()
    opt = adamw_init(dict(params.named_parameters()))
    mv = moments(sorted((k, tuple(v.shape))
                        for k, v in params.named_parameters()))
    opt["m"] = {k: torch.from_numpy(mv[k][0]) for k in opt["m"]}
    opt["v"] = {k: torch.from_numpy(mv[k][1]) for k in opt["v"]}
    opt["step"] = torch.tensor(start_step(arch), dtype=torch.int32)
    state = {"params": params, "opt": opt}
    data = synthetic_batches(spec, SHAPE, spec.make_smoke_config(),
                             device="cpu")
    metrics, want, step = reference_train(arch, dtype)
    metrics32, want32, _ = reference_train(arch, "float32")
    for i in range(STEPS):
        _, batch = next(data)
        state, got = step_fn(state, batch)
        assert set(got) == {"loss", "grad_norm", "lr"}
        for k in got:
            hold(got[k], metrics[i][k], dtype, f"step {i} {k}",
                 metrics32[i][k])
    assert int(state["opt"]["step"]) == step == start_step(arch) + STEPS
    named = dict(state["params"].named_parameters())
    assert all(p.requires_grad and p.dtype == tc.dtype or p.ndim <= 2
               and p.dtype == torch.float32 for p in named.values())
    moments_held = dtype == "float32" or not tc.is_moe
    parts = {"params": named, "master": state["opt"]["master"],
             **{k: state["opt"][k] for k in ("m", "v") if moments_held}}
    for part, leaves in parts.items():
        assert set(leaves) == set(want[part]), part
        for k, t in leaves.items():
            hold(t, want[part][k], dtype, f"{part} {k}", want32[part][k])


# ---------------------------------------------------------------------------
# Cells on meta
# ---------------------------------------------------------------------------

def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_cells_on_meta(arch):
    """Each full-shape cell that does not fit one card is on ``meta``, its
    state's and inputs' bytes those its shapes give; ``long_500k`` for
    llama3.2-1b and qwen3-1.7b is not in the table."""
    spec = get_arch(arch)
    cfg = spec.make_config()
    n_params = sum(t.numel() for t in tt.init_params(
        cfg, generator=None, device="meta").parameters())
    dh, kv = cfg.d_head, cfg.n_kv_heads
    # bf16 matrices, float32 norms (ln_attn, ln_mlp, ln_out, q/k norms).
    n_norms = cfg.n_layers * (2 * cfg.d_model + 2 * dh * cfg.qk_norm) \
        + cfg.d_model
    param_bytes = 2 * n_params + 2 * n_norms
    for shape_name, shape in LM_SHAPES.items():
        on_meta = sharded_cell(arch, shape_name)
        assert on_meta == ((arch, shape_name) in LM_SHARDED_CELLS)
        assert on_meta != (shape_name == "long_500k"
                           and arch in ("llama3.2-1b", "qwen3-1.7b"))
        if not on_meta:
            continue
        step_fn, state, inputs = build_cell(spec, shape_name)
        leaves = _leaves(state) + _leaves(inputs)
        assert all(t.device.type == "meta" for t in leaves)
        b, s = shape["batch"], shape["seq"]
        if shape["kind"] == "train":
            assert _bytes(_leaves(state)) == param_bytes + n_params * 12 + 4
            assert _bytes(_leaves(inputs)) == 2 * b * s * 4
            assert state["params"].layers.wq.requires_grad
        else:
            assert _bytes(_leaves(state)) == param_bytes
        if shape["kind"] == "decode":
            assert inputs["cache"]["len"] == 0
            assert _bytes(_leaves(inputs)) == \
                2 * cfg.n_layers * b * s * kv * dh * 2 + 4 * b
        if shape["kind"] == "prefill":
            assert _bytes(_leaves(inputs)) == 4 * b * s


def test_smoke_cells_are_real_and_full_train_cells_remat():
    spec = get_arch("qwen3-1.7b")
    _, state, _ = build_cell(smoke_spec(spec, spec.make_smoke_config()),
                             "smoke", smoke=True, device="cpu")
    assert all(t.device.type == "cpu" for t in _leaves(state))
    # A full train cell sets the reference's two-level remat groups (the
    # step's closure holds the config).
    step_fn, _, _ = build_cell(spec, "train_4k")
    cfg = step_fn.__closure__[[c.cell_contents.__class__.__name__ for c in
                               step_fn.__closure__].index("LMConfig")
                              ].cell_contents
    assert cfg.remat_groups == 7 and cfg.n_layers == 28
    assert dataclasses.replace(cfg, remat_groups=0) == spec.make_config()
