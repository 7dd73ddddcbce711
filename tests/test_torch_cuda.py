"""The port on the card: each CUDA kernel against its plain version, and the
GConn + Euler slice on the card against the same call on the CPU.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one. The file imports no JAX, so it also runs on a machine that has
only PyTorch: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerance: bit-equal (every output is int32 or bool).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (compress_full, rooted_spanning_tree,
                              tour_numbering, validate_rst, wyllie_rank)
from repro_torch.data import graphs
from repro_torch.kernels.hook_edges.ops import hook_edges
from repro_torch.kernels.hook_edges.ref import hook_edges_ref
from repro_torch.kernels.list_rank.ops import list_rank_double_k
from repro_torch.kernels.list_rank.ref import list_rank_double_ref
from repro_torch.kernels.pointer_jump.ops import pointer_jump_double_k
from repro_torch.kernels.pointer_jump.ref import pointer_jump_double_ref

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
