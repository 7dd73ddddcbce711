"""``optim/compression.py`` (int8 gradient compression with error feedback)
in the port against ``repro.optim.compression`` on the CPU.

The same numpy-seeded inputs go through both. The scales and padding are
held bit-equal. A quotient ``block / scale`` that XLA's CPU division puts
one ulp from the IEEE one may round to the other int8 at a .5 tie
(``jnp.round`` and ``torch.round`` both round half to even); such entries
are counted, each must lie within one int8 step and at a tie (its float64
quotient within 1e-4 of .5 from an integer), and every other entry is
bit-equal. Measured here: none.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import compression as jc
from repro_torch import optim
from repro_torch.optim import compression as tc


def check_payload(x32: np.ndarray, got, want) -> int:
    """Hold (q, scale, pad) to the reference's; return the tie count."""
    q, s, pad = got
    wq, ws, wpad = (np.asarray(v) if not isinstance(v, int) else v
                    for v in want)
    assert pad == wpad
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(s.numpy(), ws)
    diff = q.numpy().astype(np.int32) - wq.astype(np.int32)
    off = np.flatnonzero(diff)
    assert np.abs(diff).max(initial=0) <= 1
    if off.size:
        flat = np.pad(x32.reshape(-1), (0, pad)).astype(np.float64)
        quot = flat.reshape(-1, tc.BLOCK) / np.maximum(
            s.numpy().astype(np.float64), 1e-12)
        frac = np.abs(np.abs(quot.reshape(-1)[off]) % 1 - 0.5)
        assert frac.max() < 1e-4, "an off entry is not at a .5 tie"
    return int(off.size)


# (shape, scale): padded and not, a long vector, a 3-D tensor.
CASES = [((1000,), 1.0), ((256, 4), 3.0), ((3, 5, 7), 0.01),
         ((1 << 16,), 100.0), ((2, 128), 1e-30)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[0])))
def test_compress_roundtrip(case):
    shape, scale = case
    x = (np.random.default_rng(len(shape)).standard_normal(shape)
         * scale).astype(np.float32)
    got = tc.compress_int8(torch.from_numpy(x))
    want = jc.compress_int8(jnp.asarray(x))
    assert check_payload(x, got, want) == 0
    back = tc.decompress_int8(*got, shape)
    wback = jc.decompress_int8(*want, shape)
    assert back.shape == shape and back.dtype == torch.float32
    assert np.array_equal(back.numpy(), np.asarray(wback))


def test_all_zero_block_and_reexports():
    x = np.random.default_rng(1).standard_normal(3 * 256).astype(np.float32)
    x[256:512] = 0.0
    q, s, pad = optim.compress_int8(torch.from_numpy(x))
    assert optim.decompress_int8 is tc.decompress_int8
    assert check_payload(x, (q, s, pad), jc.compress_int8(jnp.asarray(x))) \
        == 0
    assert s[1, 0] == 0 and not q[1].any()
    back = optim.decompress_int8(q, s, pad, x.shape)
    assert not back[256:512].any() and torch.isfinite(back).all()


def test_bf16_input():
    x = (np.random.default_rng(2).standard_normal((7, 100)) * 4).astype(
        ml_dtypes.bfloat16)
    tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    got = tc.compress_int8(tx)
    want = jc.compress_int8(jnp.asarray(x))
    assert check_payload(x.astype(np.float32), got, want) == 0
    back = tc.decompress_int8(*got, x.shape, dtype=torch.bfloat16)
    wback = np.asarray(jc.decompress_int8(*want, x.shape,
                                          dtype=jnp.bfloat16))
    assert back.dtype == torch.bfloat16
    assert np.array_equal(back.float().numpy(), wback.astype(np.float32))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_error_feedback_five_steps(dtype):
    """Five steps of ``compress_with_error_feedback``, the residual carried
    on each side: every returned gradient and residual bit-equal."""
    rng = np.random.default_rng(5)
    shape = (33, 40)                                 # 1320: padded
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jres = jnp.zeros(shape, jnp.float32)
    tres = torch.zeros(shape, dtype=torch.float32)
    for step in range(5):
        g = (rng.standard_normal(shape) * 10.0 ** (step - 2)).astype(
            np.float32)
        jg = jnp.asarray(g).astype(jd)
        tg = torch.from_numpy(g).to(td)
        want, jres = jc.compress_with_error_feedback(jg, jres)
        got, tres = tc.compress_with_error_feedback(tg, tres)
        assert got.dtype == td and tres.dtype == torch.float32
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want).astype(np.float32)), step
        assert np.array_equal(tres.numpy(), np.asarray(jres)), step
        assert float(tres.abs().max()) > 0
