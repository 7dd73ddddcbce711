"""The LM loss and its gradients in the port against the JAX package on the
CPU, and the LM synthetic data.

At the smoke configs of the five LMs, on the same weights (the reference's
bf16 init, cast to float32 for the float32 runs) and the same numpy-seeded
tokens: ``lm_loss`` (two 16-position loss chunks) and every gradient leaf
against the reference's jitted ``jax.value_and_grad``, with flat per-layer
remat and with two-level remat (``remat_groups = 2``). Tolerances as in
``tests/test_torch_transformer.py``: 1e-5 of each leaf's scale in float32;
in bf16 each leaf no further from the float32 reference's than the
reference's own bf16 leaf, plus 2e-2 of its scale (the reference's bf16
gradients lie 1.4e-2 to 2.8e-2 of scale from its float32 ones).

``synthetic_batches``' LM arrays are bit-equal to the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.train import SMOKE_SHAPES as JAX_SMOKE_SHAPES
from repro.launch.train import synthetic_batches as jax_batches
from repro.models import transformer as jt
from repro_torch.configs import get_arch
from repro_torch.launch.train import SMOKE_SHAPES, synthetic_batches
from repro_torch.models import transformer as tt
from test_torch_transformer import (DTYPES, LM_ARCHS, configs,
                                    flat_reference_tree, hold, port_params,
                                    reference_params, tokens)
from test_torch_transformer import one_torch_thread  # noqa: F401 (autouse)

SHAPE = (2, 32)
LOSS_CHUNK = 16


@functools.cache
def reference_loss(arch: str, dtype: str, groups: int):
    jc, _ = configs(arch, dtype, remat_groups=groups)
    toks = tokens(jc.vocab, SHAPE, seed=1)
    tgts = tokens(jc.vocab, SHAPE, seed=2)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jt.lm_loss(jc, p, toks, tgts, loss_chunk=LOSS_CHUNK)))(
        reference_params(arch, dtype))
    return toks, tgts, loss, flat_reference_tree(grads)


# (arch, dtype, remat_groups): every arch in both dtypes with flat remat,
# two-level remat in float32 for a dense and an MoE arch.
CASES = ([(a, d, 0) for a in LM_ARCHS for d in DTYPES]
         + [("llama3.2-1b", "float32", 2),
            ("moonshot-v1-16b-a3b", "float32", 2)])


@pytest.mark.parametrize("arch,dtype,groups", CASES,
                         ids=lambda v: str(v))
def test_lm_loss_and_every_gradient(arch, dtype, groups):
    _, tc = configs(arch, dtype, remat_groups=groups)
    toks, tgts, loss, grads = reference_loss(arch, dtype, groups)
    _, _, loss32, grads32 = reference_loss(arch, "float32", groups)
    p = port_params(arch, dtype).requires_grad_()
    names, leaves = zip(*p.named_parameters())
    got = tt.lm_loss(tc, p, torch.from_numpy(toks), torch.from_numpy(tgts),
                     loss_chunk=LOSS_CHUNK)
    assert got.dtype == torch.float32 and got.shape == ()
    hold(got.detach(), loss, dtype, "loss", loss32)
    got_grads = dict(zip(names, torch.autograd.grad(got, leaves)))
    assert set(got_grads) == set(grads)
    for k, g in got_grads.items():
        assert g.dtype == dict(p.named_parameters())[k].dtype, k
        hold(g, grads[k], dtype, f"d{k}", grads32[k])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "dbrx-132b"])
def test_synthetic_lm_batches_bit_equal(arch):
    """``tokens``/``targets`` from one (b, s + 1) draw a batch, for the
    smoke shape and a cell's shape, from two seeds."""
    assert SMOKE_SHAPES["lm"] == JAX_SMOKE_SHAPES["lm"]
    spec, ref = get_arch(arch), jax_get_arch(arch)
    cfg = spec.make_config()
    for shape in (SMOKE_SHAPES["lm"], dict(kind="train", batch=3, seq=40)):
        for seed in (0, 7):
            mine = synthetic_batches(spec, shape, cfg, seed, device="cpu")
            theirs = jax_batches(ref, shape, ref.make_config(), seed)
            for _ in range(3):
                (c1, b1), (c2, b2) = next(mine), next(theirs)
                assert c1 == c2 and set(b1) == set(b2) == {"tokens",
                                                           "targets"}
                for k in b1:
                    assert b1[k].dtype == torch.int32 and b1[k].is_contiguous()
                    assert np.array_equal(b1[k].numpy(), np.asarray(b2[k])), k
                assert torch.equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])
