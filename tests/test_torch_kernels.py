"""The port's three kernels against the JAX package, bit for bit.

On the CPU each port wrapper runs its plain PyTorch version (``ref.py``);
it is held against the JAX plain version and against the Pallas kernel in
interpret mode on the same numpy inputs. ``test_torch_cuda.py`` holds the
CUDA kernels against the plain version on the card. Tolerance: bit-equal
(every output is int32).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro_torch.kernels.hook_edges.ops import hook_edges
from repro_torch.kernels.list_rank.ops import list_rank_double_k
from repro_torch.kernels.pointer_jump.ops import pointer_jump_double_k
from repro_torch.kernels.pointer_jump.ref import pointer_jump_double_ref

SIZES = [1, 100, 1024, 3000]


def _same(jax_arr, t: torch.Tensor):
    np.testing.assert_array_equal(np.asarray(jax_arr), t.cpu().numpy())


def _forest(n, rng, kind):
    """int32[n] acyclic parent table (roots self-point)."""
    if kind == "chain":
        p = np.maximum(np.arange(n) - 1, 0)
    else:
        p = (rng.random(n) * np.arange(n)).astype(np.int64)
        roots = rng.random(n) < 0.05
        p[roots] = np.arange(n)[roots]
        p[0] = 0
    perm = rng.permutation(n)  # relabel so ids carry no order
    q = np.empty(n, np.int64)
    q[perm] = perm[p]
    return q.astype(np.int32)


def _lists(n, rng, kind):
    """int32[n] successor table of disjoint −1-terminated lists."""
    perm = rng.permutation(n) if kind == "random" else np.arange(n)
    succ = np.full(n, -1, np.int32)
    succ[perm[:-1]] = perm[1:]
    if kind == "random":
        cut = perm[rng.random(n) < 0.02]
        succ[cut] = -1
    return succ


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["chain", "forest"])
@pytest.mark.parametrize("k", [1, 5])
def test_pointer_jump_double_matches_jax(n, kind, k):
    from repro.kernels.pointer_jump.ops import (pad_to_tile,
                                                pointer_jump_double_k as jk)
    from repro.core.compress import jump_k as jax_jump_k
    p = _forest(n, np.random.default_rng(n + k), kind)
    out = pointer_jump_double_k(torch.from_numpy(p), n_jumps=k)
    _same(jax_jump_k(jnp.asarray(p), k), out)
    p2d, _ = pad_to_tile(jnp.asarray(p))
    _same(jk(p2d, n_jumps=k, interpret=True).reshape(-1)[:n], out)
    assert torch.equal(out, pointer_jump_double_ref(torch.from_numpy(p), k))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["chain", "random"])
@pytest.mark.parametrize("k", [1, 5])
def test_list_rank_double_matches_jax(n, kind, k):
    from repro.kernels.list_rank.list_rank import list_rank_double_pallas
    from repro.kernels.list_rank.ops import pad_to_tile
    succ = _lists(n, np.random.default_rng(n + k), kind)
    dist = (succ != -1).astype(np.int32)
    s, d = list_rank_double_k(torch.from_numpy(succ), torch.from_numpy(dist),
                              n_steps=k)
    s2d, d2d, _ = pad_to_tile(jnp.asarray(succ), jnp.asarray(dist))
    js, jd = list_rank_double_pallas(s2d, d2d, n_steps=k, interpret=True)
    _same(js.reshape(-1)[:n], s)
    _same(jd.reshape(-1)[:n], d)


@pytest.mark.parametrize("n,e", [(1, 4), (100, 400), (1024, 4096),
                                 (3000, 9000)])
@pytest.mark.parametrize("use_min", [True, False])
def test_hook_edges_matches_jax(n, e, use_min):
    from repro.kernels.hook_edges.ops import hook_edges as jax_hook
    from repro.kernels.hook_edges.ref import hook_edges_ref as jax_ref
    rng = np.random.default_rng(n + e)
    rep = rng.integers(0, n, n).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    tgt, val = hook_edges(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(rep), use_min, n_nodes=n)
    jt, jv = jax_hook(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(rep),
                      use_min, n_nodes=n, interpret=True)
    _same(jt, tgt)
    _same(jv, val)
    rt, rv = jax_ref(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(rep),
                     use_min, n)
    _same(rt, tgt)
    _same(rv, val)


def test_use_kernel_true_on_cpu_raises():
    p = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pointer_jump_double_k(p, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        list_rank_double_k(p, p, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        hook_edges(p, p, p, True, n_nodes=4, use_kernel=True)


def test_cpu_wrappers_do_not_launch():
    before = (pointer_jump_double_k.launches, list_rank_double_k.launches,
              hook_edges.launches)
    p = torch.zeros(8, dtype=torch.int32)
    pointer_jump_double_k(p)
    list_rank_double_k(p - 1, p)
    hook_edges(p, p, p, True, n_nodes=8)
    assert (pointer_jump_double_k.launches, list_rank_double_k.launches,
            hook_edges.launches) == before
