"""The port's embed_bag against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version (``ref.py``);
it is held against ``repro``'s ``embed_bag`` (the Pallas kernel in
interpret mode) and its ``embed_bag_ref`` on the same numpy inputs, over
the sweep of ``tests/test_kernels.py`` and the hot counts and widths the
kernel treats apart (hot 9 and 33 on its runtime path, D = 1). Tolerance: the reference's own,
1e-6 for float32 and 2e-2 for bf16 (abs and rel): the port sums in float32
in another order, and the reference multiplies and sums a bf16 table in
bf16 where the port rounds once at the end. ``test_torch_cuda.py`` holds
the CUDA kernel against the plain version on the card; here the plan the
wrapper gives the kernel (``ops.launch_plan``, a pure function of the shapes
and addresses) is checked for every case of those card tests. The backward
(``ops.embed_bag_backward``, behind the plain forward here as behind the
kernel on the card) is held against the reference's custom VJP, ``jax.vjp``
of its ``embed_bag`` with the Pallas forward in interpret mode, at the same
tolerances: 1e-6 for the float32 ``d_table`` and ``d_w``, 2e-2 for the bf16
``d_table``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embed_bag.ops import embed_bag as jax_embed_bag
from repro.kernels.embed_bag.ref import embed_bag_ref as jax_embed_bag_ref
from repro_torch.kernels.embed_bag.ops import (LaunchPlan, embed_bag,
                                               launch_plan)

SWEEP = [(4, 3, 20, 18), (33, 8, 100, 128), (8, 1, 10, 300),
         (128, 16, 512, 64), (8, 9, 40, 18), (16, 33, 64, 7),
         (12, 8, 30, 1)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, hot, v, d, dtype, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, v, (b, hot)).astype(np.int32)
    w = rng.random((b, hot)).astype(np.float32)
    tab = np.array(jnp.asarray(rng.standard_normal((v, d)), DTYPES[dtype][0])
                   .astype(jnp.float32))            # values exact in dtype
    return idx, w, tab


def _port(idx, w, tab, dtype, mean):
    out = embed_bag(torch.from_numpy(idx),
                    torch.from_numpy(tab).to(DTYPES[dtype][1]),
                    None if w is None else torch.from_numpy(w), mean=mean)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (idx.shape[0],
                                                           tab.shape[1])
    return out.float().numpy()


@pytest.mark.parametrize("against", ["pallas", "ref"])
@pytest.mark.parametrize("b,hot,v,d", SWEEP)
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_embed_bag_matches_jax(b, hot, v, d, mean, dtype, against):
    idx, w, tab = _inputs(b, hot, v, d, dtype, seed=b * 1000 + d)
    jt = jnp.asarray(tab, DTYPES[dtype][0])
    if against == "pallas":
        want = jax_embed_bag(jnp.asarray(idx), jt, jnp.asarray(w), mean=mean)
    else:
        want = jax_embed_bag_ref(jnp.asarray(idx), jnp.asarray(w), jt,
                                 mean=mean)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_port(idx, w, tab, dtype, mean),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("b,hot,v,d", SWEEP)
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_embed_bag_without_weights_matches_jax(b, hot, v, d, mean, dtype):
    """``weights=None`` is all ones, in the port and in the reference."""
    idx, _, tab = _inputs(b, hot, v, d, dtype, seed=b * 1000 + d + 1)
    want = jax_embed_bag(jnp.asarray(idx), jnp.asarray(tab, DTYPES[dtype][0]),
                         mean=mean)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_port(idx, None, tab, dtype, mean),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_embed_bag_mean_of_zero_weights_is_zero():
    """Σw = 0 divides by 1e-9, as the reference does: a zero sum stays 0."""
    idx, w, tab = _inputs(5, 4, 30, 18, "float32", seed=3)
    w[2] = 0.0
    got = _port(idx, w, tab, "float32", mean=True)
    want = np.asarray(jax_embed_bag_ref(jnp.asarray(idx), jnp.asarray(w),
                                        jnp.asarray(tab), mean=True))
    assert np.all(got[2] == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_embed_bag_use_kernel_true_on_cpu_raises():
    idx, _, tab = _inputs(4, 3, 20, 18, "float32", seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        embed_bag(torch.from_numpy(idx), torch.from_numpy(tab),
                  use_kernel=True)


def test_embed_bag_negative_ids_count_from_the_end_as_in_jax():
    """An id in [-V, 0) is the row V + id, in the port and in the
    reference (and in the kernel, ``test_torch_cuda.py``)."""
    idx, w, tab = _inputs(6, 4, 30, 18, "float32", seed=5)
    idx[0, 0], idx[3, 2], idx[5, 3] = -1, -30, -7
    want = jax_embed_bag_ref(jnp.asarray(idx), jnp.asarray(w),
                             jnp.asarray(tab))
    np.testing.assert_allclose(_port(idx, w, tab, "float32", mean=False),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", [30, 1 << 30, -31])
def test_embed_bag_out_of_range_id_raises(bad):
    """An id outside [-V, V) raises in the port (the reference clamps it;
    ROADMAP §3). On the card the kernel traps, ``test_torch_cuda.py``."""
    idx, w, tab = _inputs(6, 4, 30, 18, "float32", seed=6)
    idx[4, 1] = bad
    with pytest.raises(IndexError):
        _port(idx, w, tab, "float32", mean=False)


# The card tests' hot counts and widths (tests/test_torch_cuda.py), and the
# vector width each width gets with aligned tensors, by element size.
CARD_HOTS = [1, 3, 4, 8, 9, 16, 33]
CARD_VECTORS = {1: {4: 1, 2: 1}, 7: {4: 1, 2: 1}, 18: {4: 2, 2: 2},
                128: {4: 4, 2: 8}, 300: {4: 4, 2: 4}}
BASE = 1 << 40          # a 512-byte aligned address, as the allocator gives


@pytest.mark.parametrize("hot", CARD_HOTS)
@pytest.mark.parametrize("d", list(CARD_VECTORS))
@pytest.mark.parametrize("elem_size", [4, 2], ids=["float32", "bfloat16"])
def test_launch_plan_for_the_card_tests(hot, d, elem_size):
    """Aligned tensors get the widest load of at most 16 bytes that divides
    D; a table one element into its storage gets scalar loads; 16-byte
    index loads only where hot % 4 == 0 and idx (and weights) are
    aligned."""
    for row_offset, idx_offset, weighted in itertools.product(
            (0, 1), (0, 1), (False, True)):
        idx_addr = BASE + 4 * idx_offset
        w_addr = BASE + (1 << 30) + 4 * idx_offset if weighted else None
        table_addr = BASE + (2 << 30) + elem_size * row_offset
        out_addr = BASE + (3 << 30)
        plan = launch_plan(hot, d, elem_size, idx_addr, table_addr,
                           out_addr, w_addr)
        vector = 1 if row_offset else CARD_VECTORS[d][elem_size]
        assert plan == LaunchPlan(vector, hot % 4 == 0 and idx_offset == 0)
        assert (d % plan.vector == 0 and plan.vector * elem_size <= 16
                and table_addr % (plan.vector * elem_size) == 0)


def test_launch_plan_output_alignment_and_weights():
    """The output's alignment counts as the table's does, and misaligned
    weights stop 16-byte index loads as misaligned indices do."""
    assert launch_plan(8, 128, 4, BASE, BASE, BASE + 8, None).vector == 2
    assert launch_plan(8, 128, 4, BASE, BASE, BASE, BASE + 4) == LaunchPlan(
        4, False)


# The backward: the reference's custom VJP (``repro``'s ``embed_bag``, the
# Pallas forward in interpret mode) against the port's ``embed_bag_backward``
# behind its plain forward, on the same inputs and output gradient.
BACKWARD_CASES = [(13, hot, 40, 18) for hot in (1, 8, 9)] + [(6, 4, 30, 7)]


@pytest.mark.parametrize("b,hot,v,d", BACKWARD_CASES)
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_embed_bag_backward_matches_jax_vjp(b, hot, v, d, mean, weighted,
                                           dtype):
    """d_table (float32 and bf16) and d_w (float32 weights, given and
    needing a gradient) within the reference's tolerance; ids include
    negative ones, which count from the end in both."""
    idx, w, tab = _inputs(b, hot, v, d, dtype, seed=b * 100 + hot)
    idx[::3, 0] -= v                                  # some ids in [-V, 0)
    g = np.random.default_rng(hot).standard_normal((b, d)).astype(np.float32)
    jdt, tdt, tol = DTYPES[dtype]
    jt, jg = jnp.asarray(tab, jdt), jnp.asarray(g, jdt)
    if weighted:
        _, vjp = jax.vjp(lambda t, ww: jax_embed_bag(jnp.asarray(idx), t, ww,
                                                      mean=mean),
                         jt, jnp.asarray(w))
    else:
        _, vjp = jax.vjp(lambda t: jax_embed_bag(jnp.asarray(idx), t,
                                                  mean=mean), jt)
    want = vjp(jg)
    table = torch.from_numpy(tab).to(tdt).requires_grad_()
    weights = torch.from_numpy(w).requires_grad_() if weighted else None
    out = embed_bag(torch.from_numpy(idx), table, weights, mean=mean)
    got = torch.autograd.grad(out, (table, weights) if weighted else (table,),
                              torch.from_numpy(g).to(tdt))
    assert got[0].dtype == tdt and got[0].shape == (v, d)
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32), rtol=tol,
                               atol=tol)
    if weighted:
        assert got[1].dtype == torch.float32 and got[1].shape == (b, hot)
        if dtype == "float32":
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                       rtol=tol, atol=tol)


def test_embed_bag_backward_weights_gradient_only_when_needed():
    """The table's gradient alone when the weights need none, and the
    weights' alone when the table needs none; a forward under
    ``inference_mode`` (serving) keeps no graph."""
    from repro_torch.kernels.embed_bag import ops
    idx, w, tab = _inputs(5, 8, 30, 18, "float32", seed=7)
    table = torch.from_numpy(tab).requires_grad_()
    weights = torch.from_numpy(w)
    out = embed_bag(torch.from_numpy(idx), table, weights, mean=True)
    d_table, = torch.autograd.grad(out.sum(), table)
    want, _ = ops.embed_bag_backward(
        torch.ones(5, 18), torch.from_numpy(idx), table.detach(), weights,
        out.detach(), mean=True)
    assert torch.equal(d_table, want)
    weights.requires_grad_()
    frozen = table.detach()
    out = embed_bag(torch.from_numpy(idx), frozen, weights, mean=True)
    d_w, = torch.autograd.grad(out.sum(), weights)
    assert d_w.shape == (5, 8)
    with torch.inference_mode():
        served = embed_bag(torch.from_numpy(idx), table, weights, mean=True)
    assert not served.requires_grad
    assert torch.equal(served, out.detach())
