"""The port's compression engine against ``repro.core.compress``.

Same numpy inputs through the JAX engine (plain and Pallas-interpret paths)
and the port on the CPU; outputs and ``syncs`` must be bit-equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import compress as jc
from repro.core.validate import reaches_root as jax_reaches_root
from repro_torch.core import compress as tc
from repro_torch.core.validate import reaches_root


def _same(jax_arr, t: torch.Tensor):
    np.testing.assert_array_equal(np.asarray(jax_arr), t.numpy())


def _forests(n, seed=7):
    rng = np.random.default_rng(seed)
    ids = np.arange(n)
    random_forest = np.where(ids == 0, 0, rng.integers(0, np.maximum(ids, 1)))
    perm = rng.permutation(n)
    relabelled = np.empty(n, np.int64)
    relabelled[perm] = perm[random_forest]
    padded = random_forest.copy()
    padded[n // 2:] = ids[n // 2:]
    cases = {"chain": np.maximum(ids - 1, 0), "star": np.zeros(n),
             "self_loops": ids, "random_forest": random_forest,
             "relabelled": relabelled, "padded_tail": padded}
    return {k: v.astype(np.int32) for k, v in cases.items()}


def _lists(n, seed):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    succ = np.full(n, -1, np.int32)
    succ[perm[:-1]] = perm[1:]
    succ[perm[rng.random(n) < 0.01]] = -1
    return succ


@pytest.mark.parametrize("case", list(_forests(8)))
@pytest.mark.parametrize("k", [1, 5])
def test_compress_full_matches_jax(case, k):
    p = _forests(1000)[case]
    jax_out, jax_syncs = jc.compress_full(jnp.asarray(p), n_jumps=k,
                                          return_syncs=True)
    jax_kout, jax_ksyncs = jc.compress_full(jnp.asarray(p), n_jumps=k,
                                            use_kernel=True, interpret=True,
                                            return_syncs=True)
    out, syncs = tc.compress_full(torch.from_numpy(p), n_jumps=k,
                                  return_syncs=True)
    _same(jax_out, out)
    _same(jax_kout, out)
    assert syncs == int(jax_syncs) == int(jax_ksyncs)
    _same(jc.roots_of(jnp.asarray(p), n_jumps=k),
          tc.roots_of(torch.from_numpy(p), n_jumps=k))
    _same(jc.jump_k(jnp.asarray(p), k), tc.jump_k(torch.from_numpy(p), k))


@pytest.mark.parametrize("k,want", [(5, 4), (1, 13)])
def test_chain_4k_sync_counts(k, want):
    """The ``ablation_compress/chain_4k`` rows of BENCH_rst.json."""
    chain = np.maximum(np.arange(4096) - 1, 0).astype(np.int32)
    out, syncs = tc.compress_full(torch.from_numpy(chain), n_jumps=k,
                                  return_syncs=True)
    assert syncs == want
    assert int(out.max()) == 0
    _, jax_syncs = jc.compress_full(jnp.asarray(chain), n_jumps=k,
                                    return_syncs=True)
    assert syncs == int(jax_syncs)


@pytest.mark.parametrize("max_syncs", [1, 2, 3])
def test_compress_full_max_syncs(max_syncs):
    chain = np.maximum(np.arange(3000) - 1, 0).astype(np.int32)
    jax_out, jax_syncs = jc.compress_full(jnp.asarray(chain), n_jumps=1,
                                          max_syncs=max_syncs,
                                          return_syncs=True)
    out, syncs = tc.compress_full(torch.from_numpy(chain), n_jumps=1,
                                  max_syncs=max_syncs, return_syncs=True)
    _same(jax_out, out)
    assert syncs == int(jax_syncs) == max_syncs


@pytest.mark.parametrize("k,max_syncs", [(1, 3), (5, 2), (2, None), (2, 6),
                                         (4, 5)])
def test_compress_full_three_cycle(k, max_syncs):
    """A 3-cycle (beside a chain) never converges for odd k: each group
    moves the cycle on, the flag stays set, and ``max_syncs`` ends the
    loop; for even k, p^(2^k) = p on the cycle, so the flag falls once the
    chain (depth 36) is done, before ``max_syncs``. Outputs and syncs are the reference's, whose flag is the
    same ``any(q2 != q)``."""
    p = np.concatenate([[1, 2, 0], np.maximum(np.arange(3, 40) - 1, 3)])
    p = p.astype(np.int32)
    outs = [jc.compress_full(jnp.asarray(p), n_jumps=k, max_syncs=max_syncs,
                             use_kernel=u, interpret=True, return_syncs=True)
            for u in (False, True)]
    out, syncs = tc.compress_full(torch.from_numpy(p), n_jumps=k,
                                  max_syncs=max_syncs, return_syncs=True)
    for jax_out, jax_syncs in outs:
        _same(jax_out, out)
        assert syncs == int(jax_syncs)
    if k % 2:
        assert syncs == max_syncs
    else:
        assert max_syncs is None or syncs < max_syncs


@pytest.mark.parametrize("n", [1, 100, 255, 1024, 3000, 4097])
@pytest.mark.parametrize("k", [1, 5])
def test_wyllie_rank_matches_jax(n, k):
    succ = _lists(n, n + k)
    valid = np.random.default_rng(n).random(n) < 0.9
    outs = [jc.wyllie_rank(jnp.asarray(succ), jnp.asarray(valid), n_jumps=k,
                           use_kernel=u, return_syncs=True)
            for u in (False, True)]
    d, syncs = tc.wyllie_rank(torch.from_numpy(succ), torch.from_numpy(valid),
                              n_jumps=k, return_syncs=True)
    for jd, js in outs:
        _same(jd, d)
        assert syncs == int(js)


@pytest.mark.parametrize("case", ["chain", "star", "relabelled"])
@pytest.mark.parametrize("k", [0, -1, -5])
def test_compress_full_non_positive_count_returns_input(case, k):
    """A count <= 0 runs no doubling step: the input back after one check,
    as both paths of the reference give (``range(k)`` is empty)."""
    p = _forests(1000)[case]
    out, syncs = tc.compress_full(torch.from_numpy(p), n_jumps=k,
                                  return_syncs=True)
    assert torch.equal(out, torch.from_numpy(p)) and syncs == 1
    for u in (False, True):
        jax_out, jax_syncs = jc.compress_full(jnp.asarray(p), n_jumps=k,
                                              use_kernel=u, interpret=True,
                                              return_syncs=True)
        _same(jax_out, out)
        assert int(jax_syncs) == syncs


@pytest.mark.parametrize("n", [1, 100, 4097])
@pytest.mark.parametrize("k", [-1, -5])
def test_wyllie_rank_negative_count_matches_jax(n, k):
    """With a count < 0 a group runs no step, so the loop ends only on
    lists that are closed already: every slot ranks 0 after no group, as
    in the reference. (With a list open, the reference's loop and the
    port's never end alike.)"""
    succ = np.full(n, -1, np.int32)
    valid = np.random.default_rng(n).random(n) < 0.9
    d, syncs = tc.wyllie_rank(torch.from_numpy(succ), torch.from_numpy(valid),
                              n_jumps=k, return_syncs=True)
    assert syncs == 0 and not bool(d.any())
    for u in (False, True):
        jd, js = jc.wyllie_rank(jnp.asarray(succ), jnp.asarray(valid),
                                n_jumps=k, use_kernel=u, return_syncs=True)
        _same(jd, d)
        assert syncs == int(js)


@pytest.mark.parametrize("case", ["chain", "random_forest", "relabelled"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_reduce_to_root_matches_jax(case, op):
    p = _forests(700)[case]
    payload = np.where(p == np.arange(700), 0,
                       np.random.default_rng(3).integers(-50, 50, 700))
    payload = payload.astype(np.int32)
    jred, jroot, jsyncs = jc.reduce_to_root(jnp.asarray(p),
                                            jnp.asarray(payload), op,
                                            return_syncs=True)
    red, root, syncs = tc.reduce_to_root(torch.from_numpy(p),
                                         torch.from_numpy(payload), op,
                                         return_syncs=True)
    _same(jred, red)
    _same(jroot, root)
    assert syncs == int(jsyncs)


@pytest.mark.parametrize("case", list(_forests(8)))
def test_rank_to_root_matches_jax(case):
    p = _forests(900)[case]
    jdepth, jroot, jsyncs = jc.rank_to_root(jnp.asarray(p), return_syncs=True)
    depth, root, syncs = tc.rank_to_root(torch.from_numpy(p),
                                         return_syncs=True)
    _same(jdepth, depth)
    _same(jroot, root)
    assert syncs == int(jsyncs)


def test_compress_scoped_matches_jax():
    p = _forests(1000)["random_forest"]
    roots = jc.compress_full(jnp.asarray(p))
    active = np.asarray(roots) % 3 == 0     # closed under p: whole trees
    jout, jsyncs = jc.compress_scoped(jnp.asarray(p), jnp.asarray(active),
                                      return_syncs=True)
    out, syncs = tc.compress_scoped(torch.from_numpy(p),
                                    torch.from_numpy(active),
                                    return_syncs=True)
    _same(jout, out)
    assert syncs == int(jsyncs)


def test_reaches_root_matches_jax():
    parent = np.asarray([1, 0, 2, 4, 5, 3, 2, -1], np.int32)
    got = reaches_root(torch.from_numpy(parent))
    _same(jax_reaches_root(jnp.asarray(parent)), got)
    assert got.tolist() == [False, False, True, False, False, False, True,
                            True]
