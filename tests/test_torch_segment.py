"""The port's sparse table and range reductions against ``repro``, bit for bit.

``segment_table`` (its plain version, on the CPU) is held against the JAX
plain table and the Pallas kernel in interpret mode; ``segment_reduce`` and
``segment_reduce_scoped`` against the JAX functions on the same numpy
inputs. Tolerance: bit-equal, for int32 and for float32 min/max (a NaN
must sit where the reference has one).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.compress import segment_reduce as jax_segment_reduce
from repro.core.compress import (segment_reduce_scoped as
                                 jax_segment_reduce_scoped)
from repro.kernels.segment_table.ops import segment_table as jax_pallas_table
from repro.kernels.segment_table.ref import segment_table_ref as jax_table_ref
from repro_torch.core import segment_reduce, segment_reduce_scoped
from repro_torch.kernels.segment_table.ops import segment_table

DTYPES = {"int32": np.int32, "float32": np.float32}


def _values(n, dtype, rng):
    if dtype == "int32":
        return rng.integers(-1000, 1000, n).astype(np.int32)
    v = rng.standard_normal(n).astype(np.float32)
    if n >= 3:
        v[n // 2] = np.nan
    return v


def _queries(n, rng):
    lo = rng.integers(0, n, 4 * n).astype(np.int32)
    hi = np.asarray([rng.integers(lo_q, n) for lo_q in lo], np.int32)
    return lo, hi


@pytest.mark.parametrize("n", [1, 2, 3, 64, 1025, 5000])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_table_matches_jax_plain_and_pallas(n, dtype, op):
    values = _values(n, dtype, np.random.default_rng(n))
    levels = max(1, (n - 1).bit_length())
    got = segment_table(torch.from_numpy(values), levels=levels, op=op)
    assert got.shape == (levels + 1, n)
    assert got.dtype == torch.from_numpy(values).dtype
    want_plain = jax_table_ref(jnp.asarray(values), levels=levels, op=op)
    want_pallas = jax_pallas_table(jnp.asarray(values), levels=levels, op=op,
                                   interpret=True)
    np.testing.assert_array_equal(np.asarray(want_plain), got.numpy())
    np.testing.assert_array_equal(np.asarray(want_pallas), got.numpy())


def _same_bits(want, got):
    """NaN where the reference has NaN (its payload aside), the same bits
    everywhere else."""
    want, got = np.asarray(want), np.asarray(got)
    nan = np.isnan(want)
    np.testing.assert_array_equal(nan, np.isnan(got))
    np.testing.assert_array_equal(want[~nan].view(np.int32),
                                  got[~nan].view(np.int32))


@pytest.mark.parametrize("op", ["min", "max"])
def test_signed_zero_ties_match_jax_bit_for_bit(op):
    """A tie of +0.0 and -0.0 gives -0.0 for min and +0.0 for max, as
    jnp.minimum/maximum order them (torch on the CPU would keep the first
    operand): the table against the JAX plain table and the Pallas kernel,
    and ``segment_reduce`` against the JAX one, compared as bits (NaN for
    NaN)."""
    values = np.array([0.0, -0.0, 0.0, -0.0, -0.0, 0.0, 1.0, -0.0, 0.0,
                       np.inf, -np.inf, -0.0, np.nan, 0.0], np.float32)
    n = values.size
    levels = (n - 1).bit_length()
    got = segment_table(torch.from_numpy(values), levels=levels, op=op)
    for want in (jax_table_ref(jnp.asarray(values), levels=levels, op=op),
                 jax_pallas_table(jnp.asarray(values), levels=levels, op=op,
                                  interpret=True)):
        _same_bits(want, got.numpy())
    lo, hi = _queries(n, np.random.default_rng(1))
    got = segment_reduce(torch.from_numpy(values), torch.from_numpy(lo),
                         torch.from_numpy(hi), op)
    want = jax_segment_reduce(jnp.asarray(values), jnp.asarray(lo),
                              jnp.asarray(hi), op)
    _same_bits(want, got.numpy())


def test_segment_table_rejects_other_ops_and_cpu_kernel():
    v = torch.arange(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="'min' or 'max'"):
        segment_table(v, levels=3, op="add")
    with pytest.raises(ValueError, match="CUDA"):
        segment_table(v, levels=3, op="min", use_kernel=True)


@pytest.mark.parametrize("n", [1, 2, 64, 257])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_reduce_matches_jax(n, dtype, op):
    rng = np.random.default_rng(n + 7)
    values = _values(n, dtype, rng)
    lo, hi = _queries(n, rng)
    got = segment_reduce(torch.from_numpy(values), torch.from_numpy(lo),
                         torch.from_numpy(hi), op)
    for use_kernel in (False, True):
        want = jax_segment_reduce(jnp.asarray(values), jnp.asarray(lo),
                                  jnp.asarray(hi), op, use_kernel=use_kernel)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    npop = np.min if op == "min" else np.max
    np.testing.assert_array_equal(
        np.asarray([npop(values[a:b + 1]) for a, b in zip(lo, hi)]),
        got.numpy())


@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_reduce_boundary_windows(op):
    """Suffix queries and windows whose length is a power of two, near n."""
    n = 130
    values = np.random.default_rng(3).integers(-50, 50, n).astype(np.int32)
    lo = np.asarray([0, n - 1, n - 2, 1, n - 64, n - 65, 2, 0], np.int32)
    hi = np.asarray([n - 1, n - 1, n - 1, n - 2, n - 1, n - 2, 129, 127],
                    np.int32)
    got = segment_reduce(torch.from_numpy(values), torch.from_numpy(lo),
                         torch.from_numpy(hi), op)
    for use_kernel in (False, True):
        want = jax_segment_reduce(jnp.asarray(values), jnp.asarray(lo),
                                  jnp.asarray(hi), op, use_kernel=use_kernel)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("n,max_active", [(300, 1), (300, 5), (300, 40),
                                          (300, 300), (1, 1)])
@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_reduce_scoped_matches_jax_on_active(n, max_active, op):
    """Active queries exact, and ``built`` equal to the reference's count."""
    rng = np.random.default_rng(n + max_active)
    values = rng.integers(-1000, 1000, n).astype(np.int32)
    lo, hi = _queries(n, rng)
    length = hi - lo + 1
    active = length <= max_active
    active[: min(3, n)] = False
    got, built = segment_reduce_scoped(
        torch.from_numpy(values), torch.from_numpy(lo), torch.from_numpy(hi),
        torch.from_numpy(active), op, return_syncs=True)
    want, want_built = jax_segment_reduce_scoped(
        jnp.asarray(values), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(active), op, return_syncs=True)
    assert built == int(want_built)
    np.testing.assert_array_equal(np.asarray(want)[active],
                                  got.numpy()[active])
    full = segment_reduce(torch.from_numpy(values), torch.from_numpy(lo),
                          torch.from_numpy(hi), op)
    assert torch.equal(got[torch.from_numpy(active)],
                       full[torch.from_numpy(active)])


def test_non_idempotent_op_raises():
    v = torch.arange(8, dtype=torch.int32)
    q = torch.tensor([0, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="idempotent"):
        segment_reduce(v, q, q + 1, "add")
    with pytest.raises(ValueError, match="idempotent"):
        segment_reduce_scoped(v, q, q + 1, torch.ones(2, dtype=torch.bool),
                              "add")
