"""The port on the card: each CUDA kernel against its plain version, and
the three RST flavors, biconnectivity and the tree queries on the card
against the same call on the CPU and with ``use_kernel=False``.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one. The file imports no JAX, so it also runs on a machine that has
only PyTorch: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerance: bit-equal (every output is int32 or bool, or a float32 min/max
table, where a NaN must sit where the plain version has one).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (biconnectivity, build_tables, compress_full,
                              queries, rooted_spanning_tree, tour_numbering,
                              validate_rst, wyllie_rank)
from repro_torch.data import graphs
from repro_torch.kernels.frontier_relax.ops import frontier_relax
from repro_torch.kernels.frontier_relax.ref import INF32, frontier_relax_ref
from repro_torch.kernels.hook_edges.ops import hook_edges
from repro_torch.kernels.hook_edges.ref import hook_edges_ref
from repro_torch.kernels.list_rank.ops import list_rank_double_k, list_rank_k
from repro_torch.kernels.list_rank.ref import (list_rank_double_ref,
                                               list_rank_steps_ref)
from repro_torch.kernels.pointer_jump.ops import (pointer_jump_double_k,
                                                  pointer_jump_k)
from repro_torch.kernels.pointer_jump.ref import (pointer_jump_double_ref,
                                                  pointer_jump_ref)
from repro_torch.kernels.segment_table.ops import segment_table
from repro_torch.kernels.segment_table.ref import segment_table_ref

pytestmark = pytest.mark.cuda

SIZES = [1, 100, 3000, 1 << 20]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _forest(n, seed, device):
    rng = np.random.default_rng(seed)
    p = (rng.random(n) * np.arange(n)).astype(np.int64)
    perm = rng.permutation(n)
    q = np.empty(n, np.int64)
    q[perm] = perm[p]
    return torch.from_numpy(q.astype(np.int32)).to(device)


def _lists(n, seed, device):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    succ = np.full(n, -1, np.int32)
    succ[perm[:-1]] = perm[1:]
    succ[perm[rng.random(n) < 0.02]] = -1
    return torch.from_numpy(succ).to(device)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", [1, 2, 5])
def test_pointer_jump_kernel(cuda, n, k):
    p = _forest(n, n, cuda)
    before = pointer_jump_double_k.launches
    out = pointer_jump_double_k(p, n_jumps=k, use_kernel=True)
    torch.cuda.synchronize()
    assert pointer_jump_double_k.launches - before == k
    assert torch.equal(out, pointer_jump_double_ref(p, k))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", [1, 2, 5])
def test_list_rank_kernel(cuda, n, k):
    succ = _lists(n, n, cuda)
    dist = (succ != -1).to(torch.int32)
    before = list_rank_double_k.launches
    s, d = list_rank_double_k(succ, dist, n_steps=k, use_kernel=True)
    torch.cuda.synchronize()
    assert list_rank_double_k.launches - before == k
    rs, rd = list_rank_double_ref(succ, dist, k)
    assert torch.equal(s, rs) and torch.equal(d, rd)


@pytest.mark.parametrize("n,e", [(1, 4), (3000, 9000), (1 << 20, 1 << 22)])
@pytest.mark.parametrize("use_min", [True, False])
def test_hook_edges_kernel(cuda, n, e, use_min):
    g = torch.Generator(device=cuda).manual_seed(n)
    rep, src, dst = (torch.randint(0, n, (size,), generator=g, device=cuda,
                                   dtype=torch.int32) for size in (n, e, e))
    before = hook_edges.launches
    tgt, val = hook_edges(src, dst, rep, use_min, n_nodes=n, use_kernel=True)
    torch.cuda.synchronize()
    assert hook_edges.launches - before == 1
    rt, rv = hook_edges_ref(src, dst, rep, use_min, n)
    assert torch.equal(tgt, rt) and torch.equal(val, rv)


def test_kernel_rejects_int64(cuda):
    p = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        pointer_jump_double_k(p, use_kernel=True)


def test_engine_sync_contract_on_card(cuda):
    chain = torch.clamp(torch.arange(4096, dtype=torch.int32, device=cuda) - 1,
                        min=0)
    for k, want in ((5, 4), (1, 13)):
        out, syncs = compress_full(chain, n_jumps=k, return_syncs=True)
        assert syncs == want
        assert int(out.max()) == 0
    succ = _lists(5000, 7, cuda)
    valid = torch.ones_like(succ, dtype=torch.bool)
    assert torch.equal(*(wyllie_rank(succ, valid, use_kernel=u,
                                     return_syncs=True)[0]
                         for u in (True, False)))


@pytest.mark.parametrize("name,kwargs", [
    ("chain", dict(n=256)), ("grid2d", dict(side=16)),
    ("rmat", dict(scale=8, edge_factor=4)), ("erdos_renyi", dict(n=500)),
    ("pref_attach", dict(n=300))])
def test_gconn_euler_on_card_matches_cpu(cuda, name, kwargs):
    g = getattr(graphs, name)(**kwargs, device=cuda)
    counts = (pointer_jump_double_k.launches, list_rank_double_k.launches,
              hook_edges.launches)
    r = rooted_spanning_tree(g, 3, "gconn_euler")
    torch.cuda.synchronize()
    pj, lr, he = (a - b for a, b in zip(
        (pointer_jump_double_k.launches, list_rank_double_k.launches,
         hook_edges.launches), counts))
    assert (pj, lr, he) == (5 * r.compress_syncs, 5 * r.rank_syncs,
                            r.steps + 1)
    c = rooted_spanning_tree(g.to("cpu"), 3, "gconn_euler", device="cpu")
    for field in ("parent", "rep", "forest_mask"):
        assert torch.equal(getattr(r, field).cpu(), getattr(c, field))
    assert (r.steps, r.compress_syncs, r.rank_syncs) == (
        c.steps, c.compress_syncs, c.rank_syncs)
    assert validate_rst(g, r.parent, 3)["all_ok"]
    tn, tc = tour_numbering(r.parent), tour_numbering(c.parent)
    for field in ("pre", "size", "last", "comp"):
        assert torch.equal(getattr(tn, field).cpu(), getattr(tc, field))


@pytest.mark.parametrize("n,e", [(1, 1), (3000, 9001), (1 << 20, (1 << 22) + 3)])
@pytest.mark.parametrize("level", [0, 3])
def test_frontier_relax_kernel(cuda, n, e, level):
    g = torch.Generator(device=cuda).manual_seed(n + level)
    dist = torch.randint(0, 5, (n,), generator=g, device=cuda,
                         dtype=torch.int32)
    dist[torch.rand(n, generator=g, device=cuda) < 0.5] = INF32
    src, dst = (torch.randint(0, n, (e,), generator=g, device=cuda,
                              dtype=torch.int32) for _ in range(2))
    before = frontier_relax.launches
    mask = frontier_relax(dist, src, dst, level, use_kernel=True)
    torch.cuda.synchronize()
    assert frontier_relax.launches - before == 1
    assert mask.dtype == torch.bool
    assert torch.equal(mask, frontier_relax_ref(dist, src, dst, level))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", [0, 1, 5])
def test_pointer_jump_chain_kernel(cuda, n, k):
    p = _forest(n, n + 1, cuda)
    before = pointer_jump_k.launches
    out = pointer_jump_k(p, n_jumps=k, use_kernel=True)
    torch.cuda.synchronize()
    assert pointer_jump_k.launches - before == 1
    assert torch.equal(out, pointer_jump_ref(p, k))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", [0, 1, 5])
def test_list_rank_chain_kernel(cuda, n, k):
    succ = _lists(n, n + 2, cuda)
    dist = torch.randint(0, 5, (n,), device=cuda, dtype=torch.int32)
    before = list_rank_k.launches
    s, d = list_rank_k(succ, dist, n_steps=k, use_kernel=True)
    torch.cuda.synchronize()
    assert list_rank_k.launches - before == 1
    rs, rd = list_rank_steps_ref(succ, dist, k)
    assert torch.equal(s, rs) and torch.equal(d, rd)


@pytest.mark.parametrize("name,kwargs", [
    ("grid2d", dict(side=16)), ("rmat", dict(scale=8, edge_factor=4))])
def test_bfs_on_card_matches_cpu(cuda, name, kwargs):
    g = getattr(graphs, name)(**kwargs, device=cuda)
    before = frontier_relax.launches
    r = rooted_spanning_tree(g, 3, "bfs")
    torch.cuda.synchronize()
    assert frontier_relax.launches - before == r.steps + 1
    c = rooted_spanning_tree(g.to("cpu"), 3, "bfs", device="cpu")
    assert torch.equal(r.parent.cpu(), c.parent)
    assert torch.equal(r.dist.cpu(), c.dist)
    assert r.steps == c.steps
    assert validate_rst(g, r.parent, 3)["all_ok"]


@pytest.mark.parametrize("name,kwargs", [
    ("grid2d", dict(side=16)), ("rmat", dict(scale=8, edge_factor=4))])
@pytest.mark.parametrize("alternate_hooking", [False, True])
def test_pr_rst_on_card_matches_cpu(cuda, name, kwargs, alternate_hooking):
    g = getattr(graphs, name)(**kwargs, device=cuda)
    before = pointer_jump_double_k.launches
    r = rooted_spanning_tree(g, 3, "pr_rst",
                             alternate_hooking=alternate_hooking)
    torch.cuda.synchronize()
    assert pointer_jump_double_k.launches - before == 5 * r.compress_syncs
    c = rooted_spanning_tree(g.to("cpu"), 3, "pr_rst", device="cpu",
                             alternate_hooking=alternate_hooking)
    assert torch.equal(r.parent.cpu(), c.parent)
    assert (r.steps, r.compress_syncs) == (c.steps, c.compress_syncs)
    assert validate_rst(g, r.parent, 3)["all_ok"]


@pytest.mark.parametrize("n", [1, 2, 4, 64, 1001, 1 << 20, (1 << 20) + 3])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_table_kernel(cuda, n, dtype, op):
    gen = torch.Generator(device=cuda).manual_seed(n)
    if dtype == torch.int32:
        values = torch.randint(-1000, 1000, (n,), generator=gen,
                               device=cuda, dtype=dtype)
    else:
        values = torch.randn(n, generator=gen, device=cuda)
        values[n // 2] = float("nan")
    levels = max(1, (n - 1).bit_length())
    before = segment_table.launches
    got = segment_table(values, levels=levels, op=op, use_kernel=True)
    torch.cuda.synchronize()
    assert segment_table.launches - before == levels
    want = segment_table_ref(values, levels=levels, op=op)
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan], want[~nan])


def test_segment_table_kernel_rejects_int64(cuda):
    with pytest.raises(ValueError, match="int32 or float32"):
        segment_table(torch.arange(8, device=cuda), levels=3, op="min",
                      use_kernel=True)


BCC_FIELDS = ("articulation", "bridge", "edge_bcc", "pre", "size", "low",
              "high")
BCC_COUNTS = ("n_bcc", "rst_steps", "aux_rounds", "seg_syncs")


@pytest.mark.parametrize("name,kwargs", [
    ("chain", dict(n=256)), ("grid2d", dict(side=16)),
    ("rmat", dict(scale=8, edge_factor=4))])
@pytest.mark.parametrize("flavor", ["gconn_euler", "bfs", "pr_rst"])
def test_biconnectivity_on_card_matches_plain_and_cpu(cuda, name, kwargs,
                                                      flavor):
    g = getattr(graphs, name)(**kwargs, device=cuda)
    before = segment_table.launches
    r = biconnectivity(g, 0, rst_flavor=flavor)
    torch.cuda.synchronize()
    assert segment_table.launches - before == r.seg_syncs
    p = biconnectivity(g, 0, rst_flavor=flavor, use_kernel=False)
    c = biconnectivity(g.to("cpu"), 0, rst_flavor=flavor, device="cpu")
    for f in BCC_FIELDS:
        assert torch.equal(getattr(r, f), getattr(p, f)), f
        assert torch.equal(getattr(r, f).cpu(), getattr(c, f)), f
    for k in BCC_COUNTS:
        assert getattr(r, k) == getattr(p, k) == getattr(c, k), k


@pytest.mark.parametrize("op", ["min", "max"])
def test_subtree_agg_kernel_matches_plain(cuda, op):
    g = graphs.grid2d(32, device=cuda)
    tab = build_tables(tour_numbering(rooted_spanning_tree(g, 5).parent))
    gen = torch.Generator(device=cuda).manual_seed(1)
    payload = torch.randn(g.n_nodes, generator=gen, device=cuda)
    v = torch.randint(-1, g.n_nodes + 1, (4096,), generator=gen, device=cuda,
                      dtype=torch.int32)
    before = segment_table.launches
    got = queries.subtree_agg(tab, v, payload, op)
    torch.cuda.synchronize()
    assert segment_table.launches - before == (g.n_nodes - 1).bit_length()
    assert torch.equal(got, queries.subtree_agg(tab, v, payload, op,
                                                use_kernel=False))
