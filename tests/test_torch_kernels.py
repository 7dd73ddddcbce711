"""The port's kernels against the JAX package, bit for bit.

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

from repro_torch.kernels.frontier_relax.ops import frontier_relax
from repro_torch.kernels.frontier_relax.ref import INF32
from repro_torch.kernels.hook_edges.ops import hook_edges
from repro_torch.kernels.hops import c_schedule, gathers, hop_schedule
from repro_torch.kernels.list_rank.ops import list_rank_double_k, list_rank_k
from repro_torch.kernels.list_rank.ref import (list_rank_double_ref,
                                               list_rank_steps_ref)
from repro_torch.kernels.pointer_jump.ops import (pointer_jump_double_k,
                                                  pointer_jump_k)
from repro_torch.kernels.pointer_jump.ref import (pointer_jump_double_ref,
                                                  pointer_jump_ref)

SIZES = [1, 100, 1024, 3000]
# The doubling kernels' sizes: empty, one entry, around one (8, 128) tile
# of the reference's layout, and past four.
DOUBLING_SIZES = [0, 1, 100, 255, 1024, 3000, 4097]


def _same(jax_arr, t: torch.Tensor):
    np.testing.assert_array_equal(np.asarray(jax_arr), t.cpu().numpy())


def _forest(n, rng, kind):
    """int32[n] parent table: acyclic (roots self-point), for "cycles" a
    random permutation (disjoint cycles of every length, fixed points among
    them), for "function" a random function (cycles with trees into
    them)."""
    if kind == "cycles":
        return rng.permutation(n).astype(np.int32)
    if kind == "function":
        return rng.integers(0, n, n).astype(np.int32)
    if kind == "chain":
        p = np.maximum(np.arange(n) - 1, 0)
    else:
        p = (rng.random(n) * np.arange(n)).astype(np.int64)
        roots = rng.random(n) < 0.05
        p[roots] = np.arange(n)[roots]
        p[:1] = 0
    perm = rng.permutation(n)  # relabel so ids carry no order
    q = np.empty(n, np.int64)
    q[perm] = perm[p]
    return q.astype(np.int32)


def _lists(n, rng, kind):
    """int32[n] successor table of disjoint −1-terminated lists: one chain,
    random lists (2 % cuts), or many short ones (50 % cuts); for "function"
    a random successor function with 2 % of the entries −1 (cycles that
    never end, and trees into them or into a list's end)."""
    if kind == "function":
        succ = rng.integers(0, n, n).astype(np.int32)
        succ[rng.random(n) < 0.02] = -1
        return succ
    perm = rng.permutation(n) if kind != "chain" else np.arange(n)
    succ = np.full(n, -1, np.int32)
    succ[perm[:-1]] = perm[1:]
    if kind != "chain":
        cut = perm[rng.random(n) < (0.02 if kind == "random" else 0.5)]
        succ[cut] = -1
    return succ


@pytest.mark.parametrize("n", DOUBLING_SIZES)
@pytest.mark.parametrize("kind", ["chain", "forest", "cycles"])
@pytest.mark.parametrize("k", [1, 5, 0, -1])
def test_pointer_jump_double_matches_jax(n, kind, k):
    """The table and the group's convergence flag, any(out != p), which the
    engine reads (``return_changed``). A count <= 0 runs no step: the input
    back, unchanged, as the reference's ``range(k)`` gives."""
    from repro.kernels.pointer_jump.ops import (pad_to_tile,
                                                pointer_jump_double_k as jk)
    from repro.core.compress import jump_k as jax_jump_k
    p = _forest(n, np.random.default_rng(n + abs(k)), kind)
    out, changed = pointer_jump_double_k(torch.from_numpy(p), n_jumps=k,
                                         return_changed=True)
    jax_out = jax_jump_k(jnp.asarray(p), k)
    _same(jax_out, out)
    if n:   # the Pallas kernel's (8, 128) tiling cannot take an empty table
        p2d, _ = pad_to_tile(jnp.asarray(p))
        _same(jk(p2d, n_jumps=k, interpret=True).reshape(-1)[:n], out)
    assert torch.equal(out, pointer_jump_double_ref(torch.from_numpy(p), k))
    assert changed.dtype == torch.bool and changed.shape == ()
    assert bool(changed) == bool(torch.any(out != torch.from_numpy(p)))
    assert bool(changed) == bool(jnp.any(jax_out != jnp.asarray(p)))
    if k <= 0:
        assert torch.equal(out, torch.from_numpy(p)) and not bool(changed)
    assert torch.equal(pointer_jump_double_k(torch.from_numpy(p), n_jumps=k),
                       out)


@pytest.mark.parametrize("n", DOUBLING_SIZES)
@pytest.mark.parametrize("kind", ["chain", "random", "short"])
@pytest.mark.parametrize("k", [1, 5, 0, -1])
def test_list_rank_double_matches_jax(n, kind, k):
    """The tables and the "any list still open" flag, any(succ' != -1),
    which the engine reads (``return_open``). A count <= 0 runs no step:
    the inputs back."""
    from repro.kernels.list_rank.list_rank import list_rank_double_pallas
    from repro.kernels.list_rank.ops import pad_to_tile
    succ = _lists(n, np.random.default_rng(n + abs(k)), kind)
    dist = (succ != -1).astype(np.int32)
    s, d, still_open = list_rank_double_k(
        torch.from_numpy(succ), torch.from_numpy(dist), n_steps=k,
        return_open=True)
    if n:   # the Pallas kernel's (8, 128) tiling cannot take an empty table
        s2d, d2d, _ = pad_to_tile(jnp.asarray(succ), jnp.asarray(dist))
        js, jd = list_rank_double_pallas(s2d, d2d, n_steps=k, interpret=True)
        js, jd = js.reshape(-1)[:n], jd.reshape(-1)[:n]
        _same(js, s)
        _same(jd, d)
        assert bool(still_open) == bool(jnp.any(js != -1))
    rs, rd = list_rank_double_ref(torch.from_numpy(succ),
                                  torch.from_numpy(dist), k)
    assert torch.equal(s, rs) and torch.equal(d, rd)
    assert still_open.dtype == torch.bool and still_open.shape == ()
    assert bool(still_open) == bool(torch.any(s != -1))
    if k <= 0:
        assert torch.equal(s, torch.from_numpy(succ))
        assert torch.equal(d, torch.from_numpy(dist))
    two = list_rank_double_k(torch.from_numpy(succ), torch.from_numpy(dist),
                             n_steps=k)
    assert len(two) == 2 and torch.equal(two[0], s) and torch.equal(two[1], d)


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


def _bfs_state(n, e, rng):
    """A mid-BFS dist (levels 0..3 set, the rest INF32) and random edges."""
    dist = rng.integers(0, 4, n).astype(np.int32)
    dist[rng.random(n) < 0.5] = INF32
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return dist, src, dst


@pytest.mark.parametrize("n,e", [(1, 1), (1, 4), (100, 400), (1024, 4096),
                                 (3000, 9001)])
@pytest.mark.parametrize("level", [0, 2, 7])
def test_frontier_relax_matches_jax(n, e, level):
    from repro.kernels.frontier_relax.ops import frontier_relax as jax_fr
    from repro.kernels.frontier_relax.ref import frontier_relax_ref as jax_ref
    dist, src, dst = _bfs_state(n, e, np.random.default_rng(n + e + level))
    got = frontier_relax(*(torch.from_numpy(a) for a in (dist, src, dst)),
                         level)
    assert got.dtype == torch.bool and got.shape == (e,)
    jargs = [jnp.asarray(a) for a in (dist, src, dst)]
    _same(jax_fr(*jargs, level, interpret=True), got)
    _same(jax_ref(*jargs, level), got)


# The chain kernels' counts: k <= 0 (a copy), single hops, the default 5,
# the counts around it whose plans differ (6: 4 gathers in 2 passes, 7: 3
# in 3), and 31 (five squarings).
CHAIN_KS = [0, 1, 5, -1, 2, 6, 7, 31]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["chain", "forest", "function"])
@pytest.mark.parametrize("k", CHAIN_KS)
def test_pointer_jump_k_matches_jax(n, kind, k):
    from repro.kernels.pointer_jump.ops import pointer_jump_k as jax_pjk
    from repro.kernels.pointer_jump.ref import pointer_jump_ref as jax_ref
    p = _forest(n, np.random.default_rng(n + k + 7), kind)
    out = pointer_jump_k(torch.from_numpy(p), n_jumps=k)
    _same(jax_pjk(jnp.asarray(p), n_jumps=k, interpret=True), out)
    _same(jax_ref(jnp.asarray(p), k), out)
    assert torch.equal(out, pointer_jump_ref(torch.from_numpy(p), k))
    assert torch.equal(_replay_pointer(torch.from_numpy(p), k), out)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["chain", "random", "function",
                                  "chain/wrap", "random/wrap",
                                  "function/wrap"])
@pytest.mark.parametrize("k", CHAIN_KS)
def test_list_rank_k_matches_jax(n, kind, k):
    """"/wrap": every dist in [2^31 - 16, 2^31), so that two of them wrap
    to a negative int32 sum, in JAX and in the port alike."""
    from repro.kernels.list_rank.ops import list_rank_k as jax_lrk
    from repro.kernels.list_rank.ref import list_rank_steps_ref as jax_ref
    kind, _, wrap = kind.partition("/")
    rng = np.random.default_rng(n + k + 11)
    succ = _lists(n, rng, kind)
    dist = (rng.integers(2**31 - 16, 2**31, n) if wrap
            else rng.integers(0, 5, n)).astype(np.int32)
    s, d = list_rank_k(torch.from_numpy(succ), torch.from_numpy(dist),
                       n_steps=k)
    for js, jd in (jax_lrk(jnp.asarray(succ), jnp.asarray(dist), n_steps=k,
                           interpret=True),
                   jax_ref(jnp.asarray(succ), jnp.asarray(dist), k)):
        _same(js, s)
        _same(jd, d)
    rs, rd = list_rank_steps_ref(torch.from_numpy(succ),
                                 torch.from_numpy(dist), k)
    assert torch.equal(s, rs) and torch.equal(d, rd)
    ps, pd = _replay_lists(torch.from_numpy(succ), torch.from_numpy(dist), k)
    assert torch.equal(ps, s) and torch.equal(pd, d)
    if wrap and k >= 1 and kind == "chain" and n > 2:
        assert (d < 0).any()


def _replay_pointer(p: torch.Tensor, k: int) -> torch.Tensor:
    """``hop_schedule(k)`` run with plain gathers, as the card's chain
    kernel runs it: each pass reads its first table at i and gathers once
    from each further one."""
    tables = [p.long()]
    for terms in hop_schedule(k):
        assert all(t < len(tables) for t in terms)
        x = tables[terms[0]]
        for t in terms[1:]:
            x = tables[t][x]
        tables.append(x)
    return tables[-1].to(p.dtype)


def _replay_lists(succ: torch.Tensor, dist: torch.Tensor, k: int):
    """``hop_schedule(k, pack_input=True)`` on (succ, dist), as the card's
    list-ranking chain kernel runs it: a gather from table t at the
    successor s reached adds t's dist and moves to t's succ; a list's end
    (−1) stays, adding nothing. int32 sums, which wrap."""
    tables = [(succ, dist)]
    for terms in hop_schedule(k, pack_input=True):
        assert all(t < len(tables) for t in terms)
        s, d = tables[terms[0]]
        for t in terms[1:]:
            ts, td = tables[t]
            has = s != -1
            safe = torch.where(has, s, 0).long()
            d = d + torch.where(has, td[safe], 0)
            s = torch.where(has, ts[safe], -1)
        tables.append((s, d))
    return tables[-1]


@pytest.mark.parametrize("k", list(range(65)) + [100, 127, 1000])
def test_hop_schedule_replays_bit_equal(k):
    """The plan the card's chain kernels run, replayed with plain gathers,
    is bit-equal to the chain's plain versions on a forest, a random
    function and open lists with wrapping sums (k <= 64 searched, the
    rest square-and-multiply), and never takes more gathers than k."""
    rng = np.random.default_rng(k)
    n = 3000
    for kind in ("forest", "function"):
        p = torch.from_numpy(_forest(n, rng, kind))
        assert torch.equal(_replay_pointer(p, k), pointer_jump_ref(p, k))
    for kind in ("random", "function"):
        succ = torch.from_numpy(_lists(n, rng, kind))
        dist = torch.from_numpy(
            rng.integers(2**31 - 16, 2**31, n).astype(np.int32))
        got = _replay_lists(succ, dist, k)
        want = list_rank_steps_ref(succ, dist, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert gathers(hop_schedule(k)) <= max(k, 0)


def test_hop_schedule_plans():
    """k <= 0: one copy pass; k = 5: T^2, then T^2∘T^2∘T^2 (3 gathers, one
    barrier), and for list ranking a packing pass first; k = 31: five
    squarings; the plan's gathers never exceed square-and-multiply's,
    floor(log2(k+1)) + popcount(k+1) - 1."""
    assert hop_schedule(0) == hop_schedule(-3) == ((0,),)
    assert hop_schedule(0, pack_input=True) == ((0,),)
    assert hop_schedule(5) == ((0, 0), (1, 1, 1))
    assert hop_schedule(5, pack_input=True) == ((0,), (1, 1), (2, 2, 2))
    assert hop_schedule(31) == ((0, 0), (1, 1), (2, 2), (3, 3), (4, 4))
    for k in range(1, 200):
        hops = k + 1
        assert gathers(hop_schedule(k)) <= (hops.bit_length() - 1
                                            + bin(hops).count("1") - 1)
    assert list(c_schedule(hop_schedule(5))) == [2, 0, 0, 3, 1, 1, 1]


@pytest.mark.parametrize("call", [
    lambda p: frontier_relax(p, p, p, 0, use_kernel=True),
    lambda p: pointer_jump_k(p, use_kernel=True),
    lambda p: list_rank_k(p, p, use_kernel=True)],
    ids=["frontier_relax", "pointer_jump_k", "list_rank_k"])
def test_new_wrappers_on_cpu(call):
    """``use_kernel=True`` on a CPU tensor raises; the default runs the
    plain version and launches nothing."""
    p = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        call(p)
    counters = (frontier_relax, pointer_jump_k, list_rank_k)
    before = [c.launches for c in counters]
    frontier_relax(p, p, p, 0)
    pointer_jump_k(p)
    list_rank_k(p - 1, p)
    assert [c.launches for c in counters] == before
