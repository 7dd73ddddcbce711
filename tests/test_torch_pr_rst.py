"""The PR-RST flavor of the port and its re-rooting module against
``repro``, bit for bit.

Graphs are the ``GRAPHS`` set of ``test_torch_rst.py``, carried over with
``Graph.from_reference_arrays``; the ``core.reroot`` functions are held on
numpy-seeded random forests. The JAX side runs with ``use_kernel=False``
and, where stated, ``use_kernel=True`` (Pallas interpret mode); the port
runs on the CPU. Tolerance: bit-equal (every output is an integer).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rooted_spanning_tree as jax_rst
from repro.core.pr_rst import pr_rst as jax_pr_rst
from repro.core.reroot import ancestor_tables as jax_ancestor_tables
from repro.core.reroot import link_components as jax_link
from repro.core.reroot import mark_paths as jax_mark_paths
from repro.core.reroot import reverse_and_graft as jax_reverse
from repro.data import graphs as jax_graphs
from repro_torch.core import (ancestor_tables, link_components, mark_paths,
                              pr_rst, reverse_and_graft,
                              rooted_spanning_tree, validate_rst)
from repro_torch.kernels.pointer_jump.ops import pointer_jump_double_k
from test_torch_rst import GRAPHS, _port, _same


def _jax_pr_rst_syncs(jg, alternate_hooking):
    """The reference's PR-RST rounds, run eagerly with
    ``link_components(..., return_syncs=True)``: the sum of the overlay
    compressions' checks, and rounds minus one."""
    n = jg.n_nodes
    levels = max(1, (n - 1).bit_length())
    p = rt = jnp.arange(n, dtype=jnp.int32)
    rnd, total, hooked = 0, 0, True
    while hooked and rnd < n:
        ru, rv = rt[jg.src], rt[jg.dst]
        use_min = rnd % 2 == 0 or not alternate_hooking
        mover = jnp.maximum(ru, rv) if use_min else jnp.minimum(ru, rv)
        is_u = mover == ru
        start = jnp.where(is_u, jg.src, jg.dst)
        target = jnp.where(is_u, jg.dst, jg.src)
        p, rt, win, syncs = jax_link(p, rt, start, target, ru != rv,
                                     levels=levels, return_syncs=True)
        total += int(syncs)
        hooked = bool(jnp.any(win))
        rnd += 1
    return total, rnd - 1


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("root_pick", ["zero", "nonzero"])
@pytest.mark.parametrize("alternate_hooking", [False, True])
def test_pr_rst_matches_jax(name, root_pick, alternate_hooking):
    jg = GRAPHS[name]()
    g = _port(jg)
    root = 0 if root_pick == "zero" else jg.n_nodes // 3 + 1
    r = rooted_spanning_tree(g, root, "pr_rst", device="cpu",
                             alternate_hooking=alternate_hooking)
    for use_kernel in (False, True) if not alternate_hooking else (False,):
        jr = jax_rst(jg, root, "pr_rst", use_kernel=use_kernel,
                     alternate_hooking=alternate_hooking)
        _same(jr.parent, r.parent)
        assert r.steps == int(jr.steps)
    assert (r.compress_syncs, r.steps) == _jax_pr_rst_syncs(
        jg, alternate_hooking)
    assert validate_rst(g, r.parent, root,
                        connected=name != "disconnected_40")["all_ok"]


@pytest.mark.parametrize("name", ["rmat_8", "er_500", "disconnected_40"])
@pytest.mark.parametrize("max_rounds", [0, 1, 2])
@pytest.mark.parametrize("alternate_hooking", [False, True])
def test_pr_rst_max_rounds_matches_jax(name, max_rounds, alternate_hooking):
    jg = GRAPHS[name]()
    parent, rounds = pr_rst(_port(jg), 7, max_rounds=max_rounds,
                            alternate_hooking=alternate_hooking, n_jumps=2)
    jp, jrounds = jax_pr_rst(jg, 7, max_rounds=max_rounds,
                             alternate_hooking=alternate_hooking, n_jumps=2)
    _same(jp, parent)
    assert rounds == int(jrounds)


@pytest.mark.parametrize("make,rounds", [
    (lambda: jax_graphs.chain(256), 1),
    (lambda: jax_graphs.rmat(6, edge_factor=4), 2)])
def test_table1_smoke_prrst_rounds(make, rounds):
    """The ``table1/smoke_*`` rows of BENCH_rst.json: prrst_rounds."""
    r = rooted_spanning_tree(_port(make()), 0, "pr_rst", device="cpu")
    assert r.steps == rounds


def test_pr_rst_on_cpu_launches_no_kernel():
    before = pointer_jump_double_k.launches
    rooted_spanning_tree(_port(GRAPHS["er_500"]()), 0, "pr_rst",
                         device="cpu")
    assert pointer_jump_double_k.launches == before


# --- core.reroot on random forests ---------------------------------------

def _forest(n, rng, kind):
    """int32[n] acyclic parent table (roots self-point), relabelled so ids
    carry no order. ``random``: uniform attachment, ~5 % roots, shallow;
    ``deep``: a few long paths."""
    if kind == "random":
        p = (rng.random(n) * np.arange(n)).astype(np.int64)
        roots = rng.random(n) < 0.05
    else:
        p = np.arange(n) - 1
        roots = rng.random(n) < 4 / n
    roots[0] = True
    p[roots] = np.arange(n)[roots]
    perm = rng.permutation(n)
    q = np.empty(n, np.int64)
    q[perm] = perm[p]
    return q.astype(np.int32)


def _roots(p):
    r = p.copy()
    while not np.array_equal(r, r[r]):
        r = r[r]
    return r


def _one_start_per_tree(p, rng):
    """Slot-indexed starts: for about half the trees one random vertex of
    the tree, in the slot of its root; ``(starts, active)``."""
    n = p.size
    rt = _roots(p)
    starts = np.full(n, -1, np.int32)
    for r in np.unique(rt):
        if rng.random() < 0.5:
            starts[r] = rng.choice(np.flatnonzero(rt == r))
    return starts, starts >= 0


CASES = [(n, kind, seed) for n in (1, 40, 300, 2000)
         for kind in ("random", "deep") for seed in (0, 1)]


@pytest.mark.parametrize("n,kind,seed", CASES)
def test_ancestor_tables_matches_jax(n, kind, seed):
    p = _forest(n, np.random.default_rng(seed), kind)
    levels = max(1, (n - 1).bit_length())
    ja, jp, jv, jused = jax_ancestor_tables(jnp.asarray(p), levels)
    a, pr, v, used = ancestor_tables(torch.from_numpy(p), levels)
    assert used == int(jused)
    _same(ja[:used], a[:used])
    _same(jp[:used], pr[:used])
    _same(jv[:used], v[:used])
    assert not v[used:].any()


@pytest.mark.parametrize("n,kind,seed", CASES)
def test_mark_paths_and_reverse_and_graft_match_jax(n, kind, seed):
    rng = np.random.default_rng(100 + seed)
    p = _forest(n, rng, kind)
    levels = max(1, (n - 1).bit_length())
    starts, active = _one_start_per_tree(p, rng)
    grafts = rng.integers(0, n, n).astype(np.int32)
    jm, jpred = jax_mark_paths(jnp.asarray(p), jnp.asarray(starts),
                               jnp.asarray(active), levels)
    tp, ts, ta, tg = (torch.from_numpy(a) for a in (p, starts, active,
                                                    grafts))
    mark, prednode = mark_paths(tp, ts, ta, levels)
    _same(jm, mark)
    _same(jpred, prednode)
    want = jax_reverse(jnp.asarray(p), jm, jpred, jnp.asarray(starts),
                       jnp.asarray(grafts), jnp.asarray(active))
    _same(want, reverse_and_graft(tp, mark, prednode, ts, tg, ta))


@pytest.mark.parametrize("n,kind,seed", [c for c in CASES if c[0] > 1])
@pytest.mark.parametrize("n_jumps", [1, 5])
def test_link_components_matches_jax(n, kind, seed, n_jumps):
    """Random cross edges between the trees of a random forest; the mover
    is the endpoint whose root id is larger (min-hooking's strict order)."""
    rng = np.random.default_rng(200 + seed)
    p = _forest(n, rng, kind)
    rt = _roots(p)
    m = 3 * n
    u = rng.integers(0, n, m).astype(np.int32)
    v = rng.integers(0, n, m).astype(np.int32)
    cand = (rt[u] != rt[v]) & (rng.random(m) < 0.7)
    u_moves = rt[u] > rt[v]
    start = np.where(u_moves, u, v).astype(np.int32)
    target = np.where(u_moves, v, u).astype(np.int32)
    levels = max(1, (n - 1).bit_length())
    args = (p, rt.astype(np.int32), start, target, cand)
    got = link_components(*(torch.from_numpy(a) for a in args),
                          levels=levels, n_jumps=n_jumps, return_syncs=True)
    for use_kernel in (False, True):
        want = jax_link(*(jnp.asarray(a) for a in args), levels=levels,
                        n_jumps=n_jumps, use_kernel=use_kernel,
                        return_syncs=True)
        for w, g in zip(want[:3], got[:3]):
            _same(w, g)
        assert got[3] == int(want[3])
    # Every winner's component is re-rooted at its start and grafted.
    p2, rt2 = got[0].numpy(), got[1].numpy()
    np.testing.assert_array_equal(rt2, _roots(p2))
