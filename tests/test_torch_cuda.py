"""The port on the card: each CUDA kernel against its plain version (the
two cooperative doubling kernels, one launch a call, and segment_table,
two launches a call, also against their stepwise designs; the two chain
kernels, one cooperative launch a call, and embed_bag also against their
previous designs; the doubling
kernels with their fused convergence flags; the BFS level kernel with its
flag; embed_bag's backward behind the kernel against autograd through its
plain version), and the three RST flavors, biconnectivity, the tree
queries, DIEN serving, DIEN training, the streaming layer (a stream of
each kind, the padded live graph, ``apply_batch``'s input left unchanged),
one GNN train step per architecture and ``reorder_by_rst`` on the card against the same call on the CPU and with
``use_kernel=False``; and each LM's smoke config in float32 (forward,
three decode steps with no host sync, one train step) on the card against
the CPU.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one. The file imports no JAX, so it also runs on a machine that has
only PyTorch: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerance: bit-equal (every output is int32 or bool, or a float32 min/max
table, where a NaN must sit where the plain version has one), except
embed_bag and DIEN, whose float sums run in another order in the kernel:
1e-6 (float32) and 2e-2 (bf16), abs and rel, the reference's own
(``tests/test_kernels.py``); embed_bag is bit-equal to its previous kernel.
embed_bag's gradients are sums over bags or features taken in other orders
on each side: the same tolerances, relative to the sum of each gradient's
terms' magnitudes. DIEN training's gradients, moments and changes are
also held to each leaf's own scale (``TRAIN_SCALED_TOL``); the GNNs to
1e-5 and 1e-4 of each gradient's scale (``GNN_TOL``). The training loop's
watchdog must time a step's work on the card, not its launches.
"""
import ctypes
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import (biconnectivity, build_tables, compress_full,
                              queries, rooted_spanning_tree, tour_numbering,
                              validate_rst, wyllie_rank)
from repro_torch.configs import get_arch
from repro_torch.data import graphs
from repro_torch.kernels.embed_bag.ops import embed_bag, embed_bag_previous
from repro_torch.kernels.embed_bag.ref import embed_bag_ref
from repro_torch.core.compress import _table_levels
from repro_torch.kernels.frontier_relax.ops import (bfs_level,
                                                    bfs_level_buffer,
                                                    frontier_relax)
from repro_torch.kernels.frontier_relax.ref import (INF32, bfs_level_ref,
                                                    frontier_relax_ref)
from repro_torch.kernels.hook_edges.ops import hook_edges
from repro_torch.kernels.hook_edges.ref import hook_edges_ref
from repro_torch.kernels.hops import hop_schedule
from repro_torch.kernels import build
from repro_torch.kernels.list_rank import ops as list_rank_ops
from repro_torch.kernels.list_rank.ops import (list_rank_chain_previous,
                                               list_rank_double_k,
                                               list_rank_double_stepwise,
                                               list_rank_k)
from repro_torch.kernels.list_rank.ref import (list_rank_double_ref,
                                               list_rank_steps_ref)
from repro_torch.kernels.pointer_jump import ops as pointer_jump_ops
from repro_torch.kernels.pointer_jump.ops import (pointer_jump_chain_previous,
                                                  pointer_jump_double_k,
                                                  pointer_jump_double_stepwise,
                                                  pointer_jump_k)
from repro_torch.kernels.pointer_jump.ref import (pointer_jump_double_ref,
                                                  pointer_jump_ref)
from repro_torch.kernels.segment_table.ops import (launches_per_call,
                                                   segment_table,
                                                   segment_table_stepwise)
from repro_torch.kernels.segment_table.ref import segment_table_ref
from repro_torch.data import gnn_batch
from repro_torch.launch import train as train_launch
from repro_torch.launch.train import SMOKE_SHAPES, synthetic_batches
from repro_torch.models import gnn as gnn_models
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw_init
from repro_torch.train.fault import FaultTolerantLoop, StepTimeout
from repro_torch.train.step import build_cell, lm_train_cell

pytestmark = pytest.mark.cuda

SIZES = [1, 100, 3000, 1 << 20]
# The cooperative kernels run a grid-stride loop of 4 entries a thread a
# pass over blocks of 1024 co-resident threads (at most 132 SMs x 2048 on
# an H100, 1,081,344 entries a pass): one size above a pass, and
# grid2d(4096)'s n.
ABOVE_ONE_WAVE = 3 * (1 << 21) + 7
COOP_SIZES = SIZES + [ABOVE_ONE_WAVE, 1 << 24]

# Kernel against plain DIEN training, relative to each leaf's own scale:
# chip_smoke.py's DIEN_TRAIN_SCALED_TOL (float32 measured at most 9.7e-7
# there, TF32 matmuls at least 2.7e-4).
TRAIN_SCALED_TOL = 1e-5


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


def _table(kind, n, seed, device):
    """A parent table: a relabelled random forest, its roots (converged,
    so the flag is False), or a random permutation (disjoint cycles)."""
    if kind == "cycles":
        perm = np.random.default_rng(seed).permutation(n).astype(np.int32)
        return torch.from_numpy(perm).to(device)
    p = _forest(n, seed, device)
    return compress_full(p, use_kernel=False) if kind == "roots" else p


@pytest.mark.parametrize("n", COOP_SIZES)
@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("kind", ["forest", "roots", "cycles"])
def test_pointer_jump_kernel(cuda, n, k, kind):
    """One cooperative launch a call, bit-equal to the plain version and to
    the stepwise design, the fused flag included."""
    p = _table(kind, n, n + k, cuda)
    before = pointer_jump_double_k.launches
    out, changed = pointer_jump_double_k(p, n_jumps=k, use_kernel=True,
                                         return_changed=True)
    torch.cuda.synchronize()
    assert pointer_jump_double_k.launches - before == 1
    want = pointer_jump_double_ref(p, k)
    assert torch.equal(out, want)
    assert changed.dtype == torch.bool and changed.shape == ()
    assert bool(changed) == bool(torch.any(want != p))
    step_out, step_changed = pointer_jump_double_stepwise(
        p, n_jumps=k, return_changed=True)
    assert torch.equal(out, step_out) and bool(changed) == bool(step_changed)
    assert torch.equal(p, _table(kind, n, n + k, cuda))   # input unchanged


@pytest.mark.parametrize("n", COOP_SIZES)
@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("kind", ["lists", "pairs"])
def test_list_rank_kernel(cuda, n, k, kind):
    """One cooperative launch a call, bit-equal to the plain version and to
    the stepwise design, the fused "any list open" flag included ("pairs":
    lists of at most two entries, all closed after one step)."""
    if kind == "pairs":
        ids = torch.arange(n, dtype=torch.int32, device=cuda)
        succ = torch.where((ids % 2 == 0) & (ids + 1 < n), ids + 1, -1)
    else:
        succ = _lists(n, n, cuda)
    dist = (succ != -1).to(torch.int32)
    before = list_rank_double_k.launches
    s, d, still_open = list_rank_double_k(succ, dist, n_steps=k,
                                          use_kernel=True, return_open=True)
    torch.cuda.synchronize()
    assert list_rank_double_k.launches - before == 1
    rs, rd = list_rank_double_ref(succ, dist, k)
    assert torch.equal(s, rs) and torch.equal(d, rd)
    assert still_open.dtype == torch.bool and still_open.shape == ()
    assert bool(still_open) == bool(torch.any(rs != -1))
    if kind == "pairs":
        assert not bool(still_open)
    ss, sd, step_open = list_rank_double_stepwise(succ, dist, n_steps=k,
                                                  return_open=True)
    assert torch.equal(s, ss) and torch.equal(d, sd)
    assert bool(still_open) == bool(step_open)


def test_doubling_kernels_span_more_than_one_wave(cuda):
    """ABOVE_ONE_WAVE really takes a thread more than one pass of 4."""
    dev = torch.device("cuda", torch.cuda.current_device())
    for name, symbol in (("pointer_jump", "pointer_jump_double_blocks"),
                         ("list_rank", "list_rank_double_blocks")):
        blocks = build.cooperative_blocks(name, symbol, dev, 1 << 30)
        assert 0 < blocks * 1024 * 4 < ABOVE_ONE_WAVE


def test_doubling_kernels_launch_nothing_when_empty(cuda):
    """n == 0 or k == 0: no launch, the input back, "unchanged"."""
    before = (pointer_jump_double_k.launches, list_rank_double_k.launches)
    for n, k in ((0, 5), (7, 0)):
        p = _forest(n, 3, cuda)
        out, changed = pointer_jump_double_k(p, n_jumps=k, use_kernel=True,
                                             return_changed=True)
        assert torch.equal(out, p) and not bool(changed)
        succ = _lists(n, 3, cuda)
        dist = (succ != -1).to(torch.int32)
        s, d, still_open = list_rank_double_k(succ, dist, n_steps=k,
                                              use_kernel=True,
                                              return_open=True)
        assert torch.equal(s, succ) and torch.equal(d, dist)
        assert bool(still_open) == bool(torch.any(succ != -1))
    assert (pointer_jump_double_k.launches,
            list_rank_double_k.launches) == before


@pytest.mark.parametrize("k", [-1, -5])
def test_doubling_kernels_negative_count_returns_input(cuda, k):
    """A count < 0 runs no step, as the reference's ``range(k)``: the
    kernel and stepwise entries return copies of the input (pointer_jump's
    flag False, list_rank's ``any(succ != -1)``) and launch nothing;
    ``compress_full`` returns the table after one check."""
    p = _forest(5000, 3, cuda)
    succ = _lists(5000, 3, cuda)
    dist = (succ != -1).to(torch.int32)
    counters = (pointer_jump_double_k, pointer_jump_double_stepwise,
                list_rank_double_k, list_rank_double_stepwise)
    before = [c.launches for c in counters]
    for entry in (lambda q: pointer_jump_double_k(q, n_jumps=k,
                                                  use_kernel=True,
                                                  return_changed=True),
                  lambda q: pointer_jump_double_stepwise(
                      q, n_jumps=k, return_changed=True)):
        out, changed = entry(p)
        assert torch.equal(out, p) and out.data_ptr() != p.data_ptr()
        assert not bool(changed)
    for entry in (lambda: list_rank_double_k(succ, dist, n_steps=k,
                                             use_kernel=True,
                                             return_open=True),
                  lambda: list_rank_double_stepwise(succ, dist, n_steps=k,
                                                    return_open=True)):
        s, d, still_open = entry()
        assert torch.equal(s, succ) and torch.equal(d, dist)
        assert bool(still_open)
    out, syncs = compress_full(p, n_jumps=k, return_syncs=True)
    torch.cuda.synchronize()
    assert torch.equal(out, p) and syncs == 1
    assert [c.launches for c in counters] == before


def test_refused_cooperative_launch_raises(cuda):
    """A grid one block larger than the co-resident count is refused by the
    runtime; the wrapper raises and nothing runs in its place."""
    p = _forest(1 << 20, 5, cuda)
    blocks = build.cooperative_blocks("pointer_jump",
                                      "pointer_jump_double_blocks", p.device,
                                      1 << 30)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pointer_jump_ops._launch_double(p, 5, blocks + 1)
    succ = _lists(1 << 20, 5, cuda)
    blocks = build.cooperative_blocks("list_rank", "list_rank_double_blocks",
                                      succ.device, 1 << 30)
    with pytest.raises(RuntimeError, match="CUDA error"):
        list_rank_ops._launch_double(succ, succ, 5, blocks + 1)
    torch.cuda.synchronize()
    # The card is still usable.
    assert torch.equal(pointer_jump_double_k(p, use_kernel=True),
                       pointer_jump_double_ref(p, 5))


def test_engine_reads_the_fused_flags_on_card(cuda, monkeypatch):
    """compress_full runs no torch.any on a CUDA table, wyllie_rank only its
    first check on the input; the syncs and values stay the plain path's."""
    calls = []
    real_any = torch.any

    def counting_any(*args, **kwargs):
        calls.append(args[0].device)
        return real_any(*args, **kwargs)

    chain = torch.clamp(torch.arange(4096, dtype=torch.int32, device=cuda)
                        - 1, min=0)
    succ = _lists(5000, 7, cuda)
    valid = torch.ones_like(succ, dtype=torch.bool)
    want_c = compress_full(chain, return_syncs=True, use_kernel=False)
    want_w = wyllie_rank(succ, valid, return_syncs=True, use_kernel=False)
    monkeypatch.setattr(torch, "any", counting_any)
    got_c = compress_full(chain, return_syncs=True)
    assert calls == []
    got_w = wyllie_rank(succ, valid, return_syncs=True)
    assert len(calls) == 1
    monkeypatch.undo()
    assert torch.equal(got_c[0], want_c[0]) and got_c[1] == want_c[1] == 4
    assert torch.equal(got_w[0], want_w[0]) and got_w[1] == want_w[1]


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
    assert (pj, lr, he) == (r.compress_syncs, r.rank_syncs, r.steps + 1)
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


# The chain kernels' counts: k <= 0 (one copy pass), single hops, the
# default 5 (3 gathers in 2 passes), 6 (4 in 2) and 31 (five squarings).
CHAIN_KS = [0, 1, 5, -1, 2, 6, 31]


@functools.lru_cache(maxsize=None)
def _chain_input(kind, n):
    """A parent table on the CPU, made once per (kind, n): a relabelled
    random forest, a random function (cycles with trees into them), or one
    list over every element (p[i] = i - 1, p[0] = 0)."""
    if kind == "forest":
        return _forest(n, n + 1, "cpu")
    if kind == "function":
        rng = np.random.default_rng(n + 2)
        return torch.from_numpy(rng.integers(0, n, n).astype(np.int32))
    return torch.clamp(torch.arange(n, dtype=torch.int32) - 1, min=0)


@functools.lru_cache(maxsize=None)
def _chain_lists(kind, n, wrap):
    """(succ, dist) on the CPU: the forest or the random function with
    roots and 2 % of the entries ending their lists, open lists (2 % cuts),
    or one list over every element; dist in [0, 5), or with ``wrap`` in
    [2^31 - 16, 2^31), so that two of them wrap to a negative sum."""
    rng = np.random.default_rng(n + 3)
    ids = torch.arange(n, dtype=torch.int32)
    if kind == "lists":
        succ = _lists(n, n + 2, "cpu")
    elif kind == "chain":
        succ = torch.where(ids + 1 < n, ids + 1, -1)
    else:
        p = _chain_input(kind, n)
        succ = torch.where((p == ids) | torch.from_numpy(rng.random(n) < 0.02),
                           -1, p)
    lo, hi = (2**31 - 16, 2**31) if wrap else (0, 5)
    return succ, torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32))


@pytest.mark.parametrize("n", COOP_SIZES)
@pytest.mark.parametrize("k", CHAIN_KS)
@pytest.mark.parametrize("kind", ["forest", "function", "chain"])
def test_pointer_jump_chain_kernel(cuda, n, k, kind):
    """One cooperative launch a call, bit-equal to the plain version and to
    the previous design; the input unchanged, and a copy for k <= 0."""
    p = _chain_input(kind, n).to(cuda)
    before = pointer_jump_k.launches
    out = pointer_jump_k(p, n_jumps=k, use_kernel=True)
    torch.cuda.synchronize()
    assert pointer_jump_k.launches - before == 1
    assert torch.equal(out, pointer_jump_ref(p, k))
    assert torch.equal(out, pointer_jump_chain_previous(p, n_jumps=k))
    assert torch.equal(p.cpu(), _chain_input(kind, n))
    assert out.data_ptr() != p.data_ptr()


@pytest.mark.parametrize("n", COOP_SIZES)
@pytest.mark.parametrize("k", CHAIN_KS)
@pytest.mark.parametrize("kind", ["forest", "function", "lists", "chain"])
@pytest.mark.parametrize("wrap", [False, True], ids=["small", "wrap"])
def test_list_rank_chain_kernel(cuda, n, k, kind, wrap):
    """One cooperative launch a call, bit-equal to the plain version and to
    the previous design (int32 sums wrap alike); the inputs unchanged, and
    copies for k <= 0."""
    succ_cpu, dist_cpu = _chain_lists(kind, n, wrap)
    succ, dist = succ_cpu.to(cuda), dist_cpu.to(cuda)
    before = list_rank_k.launches
    s, d = list_rank_k(succ, dist, n_steps=k, use_kernel=True)
    torch.cuda.synchronize()
    assert list_rank_k.launches - before == 1
    rs, rd = list_rank_steps_ref(succ, dist, k)
    assert torch.equal(s, rs) and torch.equal(d, rd)
    ps, pd = list_rank_chain_previous(succ, dist, n_steps=k)
    assert torch.equal(s, ps) and torch.equal(d, pd)
    assert torch.equal(succ.cpu(), succ_cpu) and torch.equal(dist.cpu(),
                                                             dist_cpu)
    assert s.data_ptr() != succ.data_ptr() and d.data_ptr() != dist.data_ptr()


def test_chain_kernels_span_more_than_one_wave(cuda):
    """The chain kernels' co-resident grids: ABOVE_ONE_WAVE takes a thread
    more than one pass of 4."""
    dev = torch.device("cuda", torch.cuda.current_device())
    for name, symbol in (("pointer_jump", "pointer_jump_chain_blocks"),
                         ("list_rank", "list_rank_chain_blocks")):
        blocks = build.cooperative_blocks(name, symbol, dev, 1 << 30)
        assert 0 < blocks * 1024 * 4 < ABOVE_ONE_WAVE


def test_chain_kernels_launch_nothing_when_empty(cuda):
    p = torch.empty(0, dtype=torch.int32, device=cuda)
    before = (pointer_jump_k.launches, list_rank_k.launches)
    assert pointer_jump_k(p, use_kernel=True).numel() == 0
    assert all(t.numel() == 0 for t in list_rank_k(p, p, use_kernel=True))
    assert (pointer_jump_k.launches, list_rank_k.launches) == before


def test_refused_chain_launch_raises(cuda):
    """A grid one block larger than the co-resident count is refused, and a
    plan that reads a table before it is written is rejected; the wrapper
    raises and nothing runs in its place."""
    p = _forest(1 << 20, 5, cuda)
    blocks = build.cooperative_blocks("pointer_jump",
                                      "pointer_jump_chain_blocks", p.device,
                                      1 << 30)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pointer_jump_ops._launch_chain(p, hop_schedule(5), blocks + 1)
    succ = _lists(1 << 20, 5, cuda)
    blocks = build.cooperative_blocks("list_rank", "list_rank_chain_blocks",
                                      succ.device, 1 << 30)
    with pytest.raises(RuntimeError, match="CUDA error"):
        list_rank_ops._launch_chain(succ, succ,
                                    hop_schedule(5, pack_input=True),
                                    blocks + 1)
    bad = (ctypes.c_int32 * 3)(2, 0, 1)   # pass 1 reads table 1
    out = torch.empty_like(p)
    fn = build.function("pointer_jump", "pointer_jump_chain",
                        pointer_jump_ops._ARGTYPES["pointer_jump_chain"])
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check("pointer_jump", fn(
            p.data_ptr(), out.data_ptr(), out.data_ptr(),
            ctypes.addressof(bad), 3, p.numel(), 0, p.device.index,
            torch.cuda.current_stream(p.device).cuda_stream))
    torch.cuda.synchronize()
    assert torch.equal(pointer_jump_k(p, use_kernel=True),
                       pointer_jump_ref(p, 5))


def _bfs_state(n, e, level, seed, device):
    """A random mid-BFS state: dist in [0, level] or INF32, parent, and
    random half-edges."""
    g = torch.Generator(device=device).manual_seed(seed)
    dist = torch.randint(0, level + 1, (n,), generator=g, device=device,
                         dtype=torch.int32)
    dist[torch.rand(n, generator=g, device=device) < 0.5] = INF32
    parent = torch.randint(-1, n, (n,), generator=g, device=device,
                           dtype=torch.int32)
    src, dst = (torch.randint(0, n, (e,), generator=g, device=device,
                              dtype=torch.int32) for _ in range(2))
    return dist, parent, src, dst


def _level_against_ref(dist, parent, src, dst, level):
    """One bfs_level call (one launch counted) against bfs_level_ref on
    copies of the same state: dist, parent and the flag bit-equal."""
    want_d, want_p = dist.clone(), parent.clone()
    want = bfs_level_ref(want_d, want_p, src, dst, level)
    cand = bfs_level_buffer(dist.numel(), dist.device)
    before = bfs_level.launches
    got = bfs_level(dist, parent, cand, src, dst, level, use_kernel=True)
    torch.cuda.synchronize()
    assert bfs_level.launches - before == 1
    assert got == want
    assert torch.equal(dist, want_d) and torch.equal(parent, want_p)
    return got


@pytest.mark.parametrize("n,e", [(1, 1), (2, 0), (3000, 9001),
                                 (1 << 20, (1 << 22) + 3)])
@pytest.mark.parametrize("level", [0, 3])
def test_bfs_level_kernel(cuda, n, e, level):
    dist, parent, src, dst = _bfs_state(n, e, level, n + e + level, cuda)
    _level_against_ref(dist, parent, src, dst, level)


@pytest.mark.parametrize("leaves", [10_000, 1 << 20])
def test_bfs_level_kernel_hub_takes_every_proposal(cuda, leaves):
    """Every leaf on the frontier, the hub (vertex 0) undiscovered: one
    level aims ``leaves`` proposals at one address; the hub gets the
    smallest leaf, and the next level (nothing left) reports no change."""
    n = leaves + 1
    leaf = torch.randperm(leaves, device=cuda).to(torch.int32) + 1
    hub = torch.zeros_like(leaf)
    src, dst = torch.cat([leaf, hub]), torch.cat([hub, leaf])
    dist = torch.full((n,), 4, dtype=torch.int32, device=cuda)
    dist[0] = INF32
    parent = torch.arange(n, dtype=torch.int32, device=cuda)
    assert _level_against_ref(dist, parent, src, dst, 4)
    assert int(parent[0]) == 1 and int(dist[0]) == 5
    assert not _level_against_ref(dist, parent, src, dst, 5)


def test_bfs_level_kernel_keeps_its_buffer_across_levels(cuda):
    """One buffer for a whole BFS, as bfs_rst passes it: level by level the
    same states as the plain version, the last flag False."""
    g = graphs.rmat(12, edge_factor=8, device=cuda)
    n = g.n_nodes
    states = []
    for use_kernel in (True, False):
        dist = torch.full((n,), INF32, dtype=torch.int32, device=cuda)
        dist[0] = 0
        parent = torch.full((n,), -1, dtype=torch.int32, device=cuda)
        parent[0] = 0
        cand = bfs_level_buffer(n, cuda)
        flags, level = [True], 0
        while flags[-1]:
            flags.append(bfs_level(dist, parent, cand, g.src, g.dst, level,
                                   use_kernel=use_kernel))
            level += 1
        states.append((dist, parent, flags))
    (kd, kp, kf), (pd, pp, pf) = states
    assert torch.equal(kd, pd) and torch.equal(kp, pp) and kf == pf


@pytest.mark.parametrize("name,kwargs", [
    ("grid2d", dict(side=16)), ("rmat", dict(scale=8, edge_factor=4))])
def test_bfs_on_card_matches_cpu(cuda, name, kwargs):
    g = getattr(graphs, name)(**kwargs, device=cuda)
    before = (frontier_relax.launches, bfs_level.launches)
    r = rooted_spanning_tree(g, 3, "bfs")
    torch.cuda.synchronize()
    assert bfs_level.launches - before[1] == r.steps + 1
    assert frontier_relax.launches == before[0]
    c = rooted_spanning_tree(g.to("cpu"), 3, "bfs", device="cpu")
    assert torch.equal(r.parent.cpu(), c.parent)
    assert torch.equal(r.dist.cpu(), c.dist)
    assert r.steps == c.steps
    assert validate_rst(g, r.parent, 3)["all_ok"]


def test_bfs_on_card_at_full_size(cuda):
    """grid2d(4096) and rmat(20, 16) from root 0: parent, dist and steps
    bit-equal to the plain path on the card; rmat's also to the port's CPU
    run, the grid's to its closed form (the CPU run would take hours):
    dist = row + col, and the smallest proposer is the vertex above, else
    the one to the left."""
    side = 4096
    grid = graphs.grid2d(side, device=cuda)
    r = rooted_spanning_tree(grid, 0, "bfs")
    p = rooted_spanning_tree(grid, 0, "bfs", use_kernel=False)
    assert torch.equal(r.parent, p.parent) and torch.equal(r.dist, p.dist)
    assert r.steps == p.steps == 2 * (side - 1)
    v = torch.arange(side * side, dtype=torch.int32, device=cuda)
    row, col = v // side, v % side
    assert torch.equal(r.dist, row + col)
    want = torch.where(row > 0, v - side, v - 1)
    want[0] = 0
    assert torch.equal(r.parent, want)
    del grid, r, p, v, row, col, want
    rmat = graphs.rmat(20, edge_factor=16, device=cuda)
    r = rooted_spanning_tree(rmat, 0, "bfs")
    p = rooted_spanning_tree(rmat, 0, "bfs", use_kernel=False)
    c = rooted_spanning_tree(rmat.to("cpu"), 0, "bfs", device="cpu")
    for want in (p, c):
        assert torch.equal(r.parent.cpu(), want.parent.cpu())
        assert torch.equal(r.dist.cpu(), want.dist.cpu())
        assert r.steps == want.steps


@pytest.mark.parametrize("name,kwargs", [
    ("grid2d", dict(side=16)), ("rmat", dict(scale=8, edge_factor=4))])
@pytest.mark.parametrize("alternate_hooking", [False, True])
def test_pr_rst_on_card_matches_cpu(cuda, name, kwargs, alternate_hooking):
    g = getattr(graphs, name)(**kwargs, device=cuda)
    before = pointer_jump_double_k.launches
    r = rooted_spanning_tree(g, 3, "pr_rst",
                             alternate_hooking=alternate_hooking)
    torch.cuda.synchronize()
    assert pointer_jump_double_k.launches - before == r.compress_syncs
    c = rooted_spanning_tree(g.to("cpu"), 3, "pr_rst", device="cpu",
                             alternate_hooking=alternate_hooking)
    assert torch.equal(r.parent.cpu(), c.parent)
    assert (r.steps, r.compress_syncs) == (c.steps, c.compress_syncs)
    assert validate_rst(g, r.parent, 3)["all_ok"]


def _same_table(got, want):
    """Bit-equal, NaN for NaN (a NaN's payload aside)."""
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got[~nan], want[~nan])


def _table_values(n, dtype, seed, device):
    """int32 over the whole range, or float32 with a NaN in the middle and
    NaN, ±0.0 and ±inf scattered in (the op's identity among them)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             device=device, dtype=dtype)
    values = torch.randn(n, generator=gen, device=device)
    special = torch.tensor([float("nan"), 0.0, -0.0, float("inf"),
                            -float("inf")], device=device)
    pick = torch.randint(0, 5, (n,), generator=gen, device=device)
    rare = torch.rand(n, generator=gen, device=device) < 0.3 / max(n, 1) ** 0.5
    values = torch.where(rare, special[pick], values)
    values[n // 2] = float("nan")
    return values


# Sizes below, at and past 2^12, odd and even sizes (a row 16-byte aligned
# or not), ragged tiles of 2^13 outputs, and the paths' n.
SEG_SIZES = [1, 2, 3, 4, 64, 1001, 4095, 4096, 4097, 1 << 20, (1 << 20) + 1,
             (1 << 20) + 3, 1 << 24]


@pytest.mark.parametrize("n", SEG_SIZES)
@pytest.mark.parametrize("levels", [0, 1, 12, 13, 14, "full"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_table_kernel(cuda, n, levels, dtype, op):
    """Bit-equal to the plain version and to the stepwise design, at
    levels around the tile's 13 (11 below 2^13 x 264 values); the launches
    are the plan's: 1 up to the tile's levels, 2 above."""
    if levels == "full":
        levels = max(1, (n - 1).bit_length())
    values = _table_values(n, dtype, n + levels, cuda)
    before = segment_table.launches
    got = segment_table(values, levels=levels, op=op, use_kernel=True)
    torch.cuda.synchronize()
    per_call = launches_per_call(n, levels)
    assert segment_table.launches - before == per_call
    assert (per_call == 1 if levels <= 11
            else per_call == 2 if levels >= 14 else per_call in (1, 2))
    _same_table(got, segment_table_ref(values, levels=levels, op=op))
    _same_table(got, segment_table_stepwise(values, levels=levels, op=op))


def test_segment_table_kernel_float_specials(cuda):
    """A ±0.0 tie gives -0.0 for min and +0.0 for max, ±inf and NaN
    propagate, as in the plain version on the card and on the CPU (where
    ``segment_table_ref`` orders the zeros as the reference does): small
    hand-made inputs around the identity."""
    nan, inf = float("nan"), float("inf")
    for vals in ([0.0, -0.0, 0.0, -0.0], [-0.0, 0.0] * 3, [inf, -inf, inf],
                 [nan, 1.0, -inf, inf, -0.0, 0.0, nan],
                 [-inf] * 5 + [inf] * 4):
        values = torch.tensor(vals, device=cuda)
        for op in ("min", "max"):
            levels = max(1, (len(vals) - 1).bit_length())
            got = segment_table(values, levels=levels, op=op,
                                use_kernel=True)
            _same_table(got, segment_table_ref(values, levels=levels, op=op))
            _same_table(got.cpu(), segment_table_ref(values.cpu(),
                                                     levels=levels, op=op))
            _same_table(got, segment_table_stepwise(values, levels=levels,
                                                    op=op))


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
    levels = _table_levels(g.n_nodes)
    assert r.seg_syncs == 2 * levels
    assert segment_table.launches - before == (
        r.seg_syncs // levels * launches_per_call(g.n_nodes, levels))
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
    assert segment_table.launches - before == launches_per_call(
        g.n_nodes, (g.n_nodes - 1).bit_length())
    assert torch.equal(got, queries.subtree_agg(tab, v, payload, op,
                                                use_kernel=False))


# The hot counts of the kernel's paths: 4 and 8 specialised (dien-smoke,
# dien), the rest in rounds of 8 (one round, a round and one more, a
# partial last round); the widths: scalar (1, 7), 8-byte (18), 16-byte
# (128 float32), and a row of 75 chunks.
EMBED_HOTS = [1, 3, 4, 8, 9, 16, 33]
EMBED_DIMS = [1, 7, 18, 128, 300]
EMBED_SHAPES = ([(4, 3, 20, 18), (33, 8, 100, 128), (37, 1, 10, 300),
                 (1, 16, 512, 18), (262144, 8, 100000, 18)]
                + [(37, hot, 100, d) for hot in EMBED_HOTS
                   for d in EMBED_DIMS])


@pytest.mark.parametrize("b,hot,v,d", EMBED_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("row_offset", [0, 1])
@pytest.mark.parametrize("idx_offset", [0, 1])
def test_embed_bag_kernel(cuda, b, hot, v, d, dtype, tol, mean, weighted,
                          row_offset, idx_offset):
    """row_offset 1 starts the table one element into its storage, so only
    scalar loads are aligned (the kernel's V = 1 path); idx_offset 1 does
    the same to idx and the weights (no 16-byte index loads). Bit-equal to
    the previous kernel, and within the tolerance of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(b * d + hot)
    idx = torch.empty(b * hot + idx_offset, dtype=torch.int32,
                      device=cuda)[idx_offset:].view(b, hot)
    idx.copy_(torch.randint(0, v, (b, hot), generator=gen, device=cuda,
                            dtype=torch.int32))
    w = None
    if weighted:
        w = torch.empty(b * hot + idx_offset, device=cuda)[idx_offset:]
        w = w.view(b, hot).copy_(torch.rand((b, hot), generator=gen,
                                            device=cuda))
    table = torch.empty(v * d + row_offset, dtype=dtype,
                        device=cuda)[row_offset:].view(v, d)
    table.copy_(torch.randn((v, d), generator=gen, device=cuda))
    before = embed_bag.launches
    got = embed_bag(idx, table, w, mean=mean, use_kernel=True)
    torch.cuda.synchronize()
    assert embed_bag.launches - before == 1
    want = embed_bag_ref(idx, w, table, mean=mean)
    assert got.dtype == dtype and got.shape == (b, d)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    previous = embed_bag_previous(idx, table, w, mean=mean)
    assert torch.equal(got.view(bits), previous.view(bits))


def test_embed_bag_kernel_rejects_int64_and_cpu_tables(cuda):
    table = torch.randn(10, 18, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        embed_bag(torch.zeros(4, 2, dtype=torch.int64, device=cuda), table,
                  use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        embed_bag(torch.zeros(4, 2, dtype=torch.int32, device=cuda),
                  table.cpu(), use_kernel=True)


def test_embed_bag_kernel_negative_ids_count_from_the_end(cuda):
    """An id in [-V, 0) is the row V + id, as in ``table[idx]``."""
    table = torch.randn(30, 18, device=cuda)
    idx = torch.tensor([[-1, 0, 29], [-30, 5, -7]], dtype=torch.int32,
                       device=cuda)
    got = embed_bag(idx, table, use_kernel=True)
    torch.testing.assert_close(got, embed_bag_ref(idx, None, table),
                               rtol=1e-6, atol=1e-6)


_OUT_OF_RANGE = """
import sys, torch
from repro_torch.kernels.embed_bag.ops import embed_bag, embed_bag_previous
path, (bad, hot, pos) = sys.argv[1], map(int, sys.argv[2:])
table = torch.randn(30, 18, device="cuda")
idx = torch.zeros(64, hot, dtype=torch.int32, device="cuda")
idx[37, pos] = bad
try:
    if path == "previous":
        embed_bag_previous(idx, table)
    else:
        embed_bag(idx, table, use_kernel=path == "kernel")
    torch.cuda.synchronize()
except (RuntimeError, IndexError) as e:
    print("raised:", type(e).__name__, e)
    sys.exit(0)
sys.exit(1)
"""


@pytest.mark.parametrize("bad", [30, 1 << 30, -31])
@pytest.mark.parametrize("path,hot,pos", [
    ("kernel", 8, 5), ("plain", 8, 5), ("previous", 8, 5),
    ("kernel", 8, 0), ("kernel", 8, 7), ("kernel", 9, 0), ("kernel", 9, 8)])
def test_embed_bag_out_of_range_id_raises_on_the_card(cuda, path, bad, hot,
                                                      pos):
    """An id outside [-V, V) raises on the card, through the kernel (it
    traps) as through the plain ``table[idx]`` (a device-side assert) and
    the previous kernel, at the first and the last index of a bag, on the
    specialised path (hot 8) and the runtime one (hot 9). Each loses the
    CUDA context, so each runs in a process of its own."""
    import os
    import pathlib
    import subprocess
    import sys
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", _OUT_OF_RANGE, path,
                          str(bad), str(hot), str(pos)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and "raised:" in run.stdout, (
        run.stdout + run.stderr)


def test_dien_serve_p99_kernel_matches_plain_and_cpu(cuda):
    """The full config at serve_p99: one embed_bag launch a call, the same
    scores with ``use_kernel=False``, and on the first rows the port's CPU
    run within 1e-6 (cuBLAS and MKL sum in other orders; chip_smoke.py
    measured one ulp of a 0.5 score, 6e-8)."""
    spec = get_arch("dien")
    step, params, _ = build_cell(spec, "serve_p99")
    plain, _, _ = build_cell(spec, "serve_p99", use_kernel=False)
    _, batch = next(synthetic_batches(spec, spec.shapes["serve_p99"],
                                      spec.make_config(), seed=1))
    before = embed_bag.launches
    got = step(params, batch)
    torch.cuda.synchronize()
    assert embed_bag.launches - before == 1
    assert got.shape == (512,) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, plain(params, batch), rtol=1e-6,
                               atol=1e-6)
    cpu_step, _, _ = build_cell(spec, "serve_p99", device="cpu")
    params.to("cpu")
    want = cpu_step(params, {k: v[:64].cpu() for k, v in batch.items()})
    torch.testing.assert_close(got[:64].cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,hot,v,d", EMBED_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_embed_bag_backward_on_the_card(cuda, b, hot, v, d, dtype, tol, mean,
                                        weighted):
    """``d_table`` and ``d_w`` through the kernel's forward (one launch)
    and ``embed_bag_backward``, against autograd through ``embed_bag_ref``
    on float32 copies of the same values. Each gradient element is a sum
    (d_table: over the bags that name a row; d_w: over the D features)
    taken in another order on each side, and in bf16 ours adds in bf16: so
    each is held to ``tol`` relative to the sum of its terms' magnitudes,
    |got − want| <= tol · (1 + Σ|term|)."""
    gen = torch.Generator(device=cuda).manual_seed(b * d + hot + 7)
    idx = torch.randint(0, v, (b, hot), generator=gen, device=cuda,
                        dtype=torch.int32)
    w = (torch.rand((b, hot), generator=gen, device=cuda).requires_grad_()
         if weighted else None)
    table = torch.randn((v, d), generator=gen, device=cuda).to(dtype)
    table.requires_grad_()
    g = torch.randn((b, d), generator=gen, device=cuda).to(dtype)
    wrt = [table, w] if weighted else [table]
    before = embed_bag.launches
    out = embed_bag(idx, table, w, mean=mean, use_kernel=True)
    got = torch.autograd.grad(out, wrt, g)
    torch.cuda.synchronize()
    assert embed_bag.launches - before == 1
    t32 = table.detach().float().requires_grad_()
    w32 = w.detach().clone().requires_grad_() if weighted else None
    want = torch.autograd.grad(embed_bag_ref(idx, w32, t32, mean=mean),
                               [t32, w32] if weighted else [t32], g.float())
    wv = w.detach() if weighted else torch.ones((b, hot), device=cuda)
    s = wv.sum(-1, keepdim=True).clamp_min(1e-9) if mean else 1.0
    g_abs = g.float().abs()
    terms = ((wv / s).abs()[..., None] * g_abs[:, None, :]).reshape(-1, d)
    t_scale = torch.zeros((v, d), device=cuda).index_add_(
        0, idx.reshape(-1).long(), terms)
    assert got[0].dtype == dtype and got[0].shape == (v, d)
    assert bool(((got[0].float() - want[0]).abs()
                 <= tol * (1 + t_scale)).all())
    if weighted:
        rows = t32.detach()[idx].abs()
        w_scale = torch.einsum("bd,bhd->bh", g_abs, rows) / s
        if mean:
            w_scale = w_scale + torch.einsum(
                "bd,bd->b", g_abs, out.detach().float().abs())[:, None] / s
        assert got[1].dtype == torch.float32 and got[1].shape == (b, hot)
        assert bool(((got[1] - want[1]).abs() <= tol * (1 + w_scale)).all())


def _scaled_ratio(got, want, floor=0.0):
    """(max |got - want| - floor) over max |want|, for a whole tensor."""
    scale = float(want.double().abs().max())
    assert scale > 0
    return (float((got.double() - want.double()).abs().max()) - floor) / scale


def test_dien_smoke_training_kernel_matches_plain(cuda):
    """Three steps of the smoke config's train cell on the card: one
    embed_bag launch a step, and loss, grad_norm, parameters and moments
    within 1e-6 of the plain twin's (the same forward; the backward's
    scatter-adds sum in an order the card does not fix). Most leaves lie
    wholly below 1e-6, so grad_norm, m, v and each parameter's change over
    the steps are also held to their own scale, as chip_smoke.py's phase
    5h holds them: max |got - want| <= TRAIN_SCALED_TOL * max |want|, plus
    two float32 ulps of the leaf's largest entry for the change (a
    difference of two rounded parameters)."""
    spec = dataclasses.replace(get_arch("dien"),
                               shapes={"smoke": SMOKE_SHAPES["recsys"]})
    step, state, _ = build_cell(spec, "smoke", smoke=True)
    plain, plain_state, _ = build_cell(spec, "smoke", smoke=True,
                                       use_kernel=False)
    initial = {k: p.detach().clone()
               for k, p in state["params"].named_parameters()}
    batches = synthetic_batches(spec, spec.shapes["smoke"],
                                spec.make_smoke_config(), seed=2)
    for _ in range(3):
        _, batch = next(batches)
        before = embed_bag.launches
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        assert embed_bag.launches - before == 1
        plain_state, want = plain(plain_state, batch)
        assert embed_bag.launches - before == 1
        for k in ("loss", "grad_norm"):
            assert bool(torch.isfinite(metrics[k]))
            torch.testing.assert_close(metrics[k], want[k], rtol=1e-6,
                                       atol=1e-6)
        assert _scaled_ratio(metrics["grad_norm"],
                             want["grad_norm"]) <= TRAIN_SCALED_TOL
    assert int(state["opt"]["step"]) == 3
    named = dict(plain_state["params"].named_parameters())
    ulps = 2 * torch.finfo(torch.float32).eps
    for k, p in state["params"].named_parameters():
        assert p.is_cuda
        torch.testing.assert_close(p, named[k], rtol=1e-6, atol=1e-6)
        floor = ulps * float(initial[k].abs().max())
        ratio = _scaled_ratio(p.detach() - initial[k],
                              named[k].detach() - initial[k], floor)
        assert ratio <= TRAIN_SCALED_TOL, (k, ratio)
        for part in ("m", "v"):
            torch.testing.assert_close(state["opt"][part][k],
                                       plain_state["opt"][part][k],
                                       rtol=1e-6, atol=1e-6)
            ratio = _scaled_ratio(state["opt"][part][k],
                                  plain_state["opt"][part][k])
            assert ratio <= TRAIN_SCALED_TOL, (part, k, ratio)


# ---- the streaming layer -------------------------------------------------------

DYN_STATE = ("parent", "rep", "pool_src", "pool_dst", "pool_valid",
             "tree_mask", "dirty")
DYN_STATS = ("cuts", "links", "rounds", "overflow", "pending",
             "deletes_found")
DYN_BCC = ("pre", "rep", "low", "high", "articulation", "bridge", "edge_bcc")
DYN_BCC_COUNTS = ("n_bcc", "aux_rounds", "seg_syncs", "dirty_count")


def _stream_run(g, stream, batch, use_kernel):
    """Replay a stream with an incremental tour and BCC refresh after every
    batch; per batch the state, stats, numbering and BCC."""
    from repro_torch import dynamic
    from repro_torch.data import streams
    s_ = streams.STREAMS[stream](g.to("cpu"), batch=batch, seed=0,
                                 n_batches=6)
    s = dynamic.init_state(s_, device=g.device, use_kernel=use_kernel)
    tn = bcc = None
    out = []
    for b in s_.batches:
        s, stats = dynamic.replay_batch(s, b, use_kernel=use_kernel)
        tn, s2 = dynamic.refresh_tour(s, tn, use_kernel=use_kernel)
        bcc = dynamic.refresh_bcc(s2, bcc, tour=tn, use_kernel=use_kernel)
        out.append((s, stats, tn, bcc))
        s = s2
    return out


@pytest.mark.parametrize("stream", ["sliding_window", "insert_heavy",
                                    "churn"])
@pytest.mark.parametrize("name,kwargs", [
    ("grid2d", dict(side=24)), ("rmat", dict(scale=9, edge_factor=4))])
def test_stream_on_card_matches_plain_and_cpu(cuda, name, kwargs, stream):
    g = getattr(graphs, name)(**kwargs, device=cuda)
    kernels = (pointer_jump_double_k, list_rank_double_k, hook_edges,
               segment_table)
    before = [k.launches for k in kernels]
    got = _stream_run(g, stream, 16, None)
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in zip(kernels, before))
    want = _stream_run(g, stream, 16, False)
    cpu = _stream_run(g.to("cpu"), stream, 16, None)
    for (s, st, tn, b), (ps, pst, ptn, pb), (cs, cst, ctn, cb) in zip(
            got, want, cpu):
        for f in DYN_STATE:
            assert torch.equal(getattr(s, f), getattr(ps, f)), f
            assert torch.equal(getattr(s, f).cpu(), getattr(cs, f)), f
        for k in DYN_STATS:
            assert int(st[k]) == int(pst[k]) == int(cst[k]), k
        for f in ("pre", "size", "last", "comp"):
            assert torch.equal(getattr(tn, f), getattr(ptn, f)), f
            assert torch.equal(getattr(tn, f).cpu(), getattr(ctn, f)), f
        for f in DYN_BCC:
            assert torch.equal(getattr(b, f), getattr(pb, f)), f
            assert torch.equal(getattr(b, f).cpu(), getattr(cb, f)), f
        for k in DYN_BCC_COUNTS:
            assert getattr(b, k) == getattr(pb, k) == getattr(cb, k), k


def test_apply_batch_on_card_leaves_its_input_unchanged(cuda):
    from repro_torch import dynamic
    from repro_torch.data import streams
    g = graphs.rmat(10, edge_factor=4, device="cpu")
    s_ = streams.churn(g, batch=64, n_batches=3)
    s = dynamic.init_state(s_, device=cuda)
    s, _ = dynamic.replay_batch(s, s_.batches[0])
    before = {f: getattr(s, f).clone() for f in DYN_STATE}
    s2, _ = dynamic.replay_batch(s, s_.batches[1])
    torch.cuda.synchronize()
    for f in DYN_STATE:
        assert torch.equal(getattr(s, f), before[f]), f
    assert not torch.equal(s2.pool_src, s.pool_src)


def test_padded_live_graph_on_card(cuda, monkeypatch):
    """A padded live graph through connected_components and
    rooted_spanning_tree on the card: equal to the plain path and the CPU,
    and hook_edges never receives an id outside [0, n)."""
    from repro_torch import dynamic
    from repro_torch.core import connected_components, connectivity
    from repro_torch.data import streams
    g = graphs.rmat(10, edge_factor=4, device="cpu")
    s_ = streams.sliding_window(g, batch=256, n_batches=5)
    s = dynamic.init_state(s_, dynamic.stream_capacity(s_, 100), device=cuda)
    for b in s_.batches:
        s, _ = dynamic.replay_batch(s, b)
    lg = dynamic.live_graph(s)
    n = lg.n_nodes
    assert lg.padded and bool((lg.src == n).any())
    seen = []
    real = connectivity.hook_edges

    def hook(src, dst, rep, use_min, **kw):
        seen.append(int(torch.maximum(src.max(), dst.max())))
        return real(src, dst, rep, use_min, **kw)
    monkeypatch.setattr(connectivity, "hook_edges", hook)
    before = hook_edges.launches
    got = connected_components(lg)
    assert hook_edges.launches > before
    want = connected_components(lg, use_kernel=False)
    cpu = connected_components(lg.to("cpu"))
    for a, b, c in zip(got[:2], want[:2], cpu[:2]):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    assert got[2] == want[2] == cpu[2]
    root = int(s.rep[0])
    r = rooted_spanning_tree(lg, root)
    p = rooted_spanning_tree(lg, root, use_kernel=False)
    c = rooted_spanning_tree(lg.to("cpu"), root, device="cpu")
    assert torch.equal(r.parent, p.parent)
    assert torch.equal(r.parent.cpu(), c.parent)
    assert seen and max(seen) < n
    assert validate_rst(lg, r.parent, root, connected=False)["all_ok"]


# ---- self-healing on the card ------------------------------------------------

HEAL_REPORT = ("acyclic", "roots_fixed", "rep_consistent", "tree_cover_ok",
               "tree_slots_ok", "spanning_ok", "counts_ok", "forest_ok",
               "tour_fresh", "bcc_fresh", "healthy", "violating",
               "comp_violating", "sever", "stale", "bad_slots",
               "n_violating")


def _steady_on(g, use_kernel):
    """A churn steady state (8 batches of 32, seed 0) with a full tour and
    BCC, on ``g``'s device."""
    from repro_torch import dynamic
    from repro_torch.data import streams
    s_ = streams.churn(g.to("cpu"), batch=32, n_batches=8, seed=0)
    s = dynamic.init_state(s_, device=g.device, use_kernel=use_kernel)
    for b in s_.batches:
        s, _ = dynamic.replay_batch(s, b, use_kernel=use_kernel)
    tn, s = dynamic.refresh_tour(s, None, use_kernel=use_kernel)
    return s, tn, dynamic.refresh_bcc(s, None, tour=tn,
                                      use_kernel=use_kernel)


def _same_heal(a, b, on_cpu=False):
    """Two (state, tn, bcc) triples hold the same values."""
    def same(x, y):
        return torch.equal(x.cpu() if on_cpu else x, y)
    (s, tn, bcc), (s2, tn2, bcc2) = a, b
    for f in DYN_STATE:
        assert same(getattr(s, f), getattr(s2, f)), f
    assert s.version == s2.version
    for f in ("pre", "size", "last", "comp", "parent"):
        assert same(getattr(tn, f), getattr(tn2, f)), f
    for f in DYN_BCC:
        assert same(getattr(bcc, f), getattr(bcc2, f)), f
    for k in DYN_BCC_COUNTS:
        assert getattr(bcc, k) == getattr(bcc2, k), k


@pytest.mark.parametrize("injector", ["parent_bitflip", "parent_cycle",
                                      "rep_corrupt", "tree_mask_desync",
                                      "pool_desync", "stale_bcc"])
@pytest.mark.parametrize("name,kwargs", [
    ("grid2d", dict(side=24)), ("rmat", dict(scale=9, edge_factor=4))])
def test_audit_and_recover_on_card_match_plain_and_cpu(cuda, name, kwargs,
                                                       injector):
    """Inject, audit and recover with the kernels, against
    ``use_kernel=False`` on the card and the same calls on the CPU: every
    report field, the healed state, tour and BCC, and ``info``; the
    pre-state unchanged; only the four kernels of the path launch."""
    from repro_torch import dynamic
    g = getattr(graphs, name)(**kwargs, device=cuda)
    state, tn, bcc = _steady_on(g, None)
    cpu = _steady_on(g.to("cpu"), None)
    _same_heal((state, tn, bcc), cpu, on_cpu=True)
    bad, bad_bcc, desc = dynamic.inject(injector, state, bcc, seed=4)
    bad_c, bad_bcc_c, desc_c = dynamic.inject(injector, *cpu[::2], seed=4)
    assert desc == desc_c
    snap = {f: getattr(bad, f).clone() for f in DYN_STATE}
    counted = (pointer_jump_double_k, list_rank_double_k, hook_edges,
               segment_table)
    others = (frontier_relax, bfs_level, pointer_jump_k, list_rank_k,
              embed_bag)
    torch.cuda.synchronize()
    before = [k.launches for k in counted + others]
    rep = dynamic.audit_forest(bad, tn, bad_bcc)
    out = dynamic.recover(bad, tn, bad_bcc)
    torch.cuda.synchronize()
    after = [k.launches for k in counted + others]
    assert after[0] > before[0]
    assert after[len(counted):] == before[len(counted):]
    rep_p = dynamic.audit_forest(bad, tn, bad_bcc, use_kernel=False)
    out_p = dynamic.recover(bad, tn, bad_bcc, use_kernel=False)
    rep_c = dynamic.audit_forest(bad_c, cpu[1], bad_bcc_c)
    out_c = dynamic.recover(bad_c, cpu[1], bad_bcc_c)
    for f in HEAL_REPORT:
        assert torch.equal(getattr(rep, f), getattr(rep_p, f)), f
        assert torch.equal(getattr(rep, f).cpu(), getattr(rep_c, f)), f
    assert rep.syncs == rep_p.syncs == rep_c.syncs
    assert not bool(rep.healthy)
    _same_heal((out[0], out[1], out[2]), (out_p[0], out_p[1], out_p[2]))
    _same_heal((out[0], out[1], out[2]), (out_c[0], out_c[1], out_c[2]),
               on_cpu=True)
    assert out[4] == out_p[4] == out_c[4]
    assert bool(dynamic.audit_forest(*out[:3]).healthy)
    for f, t in snap.items():
        assert torch.equal(getattr(bad, f), t), f


def test_audit_of_a_cyclic_table_runs_to_its_bound_on_card(cuda):
    """A parent cycle keeps the bounded compression open: 64 convergence
    checks, one cooperative launch each."""
    from repro_torch import dynamic
    from repro_torch.dynamic.audit import AUDIT_MAX_SYNCS
    g = graphs.grid2d(24, device=cuda)
    state, _, _ = _steady_on(g, None)
    bad, _, _ = dynamic.inject("parent_cycle", state, None, seed=2)
    torch.cuda.synchronize()
    before = pointer_jump_double_k.launches
    report = dynamic.audit_forest(bad)
    torch.cuda.synchronize()
    assert report.syncs == AUDIT_MAX_SYNCS
    assert pointer_jump_double_k.launches - before == AUDIT_MAX_SYNCS
    assert not bool(report.acyclic)


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """A state saved from the card comes back on the card, bit-equal, its
    host ints as ints; a state saved on the CPU restores onto the card."""
    from repro_torch.train import checkpoint as ckpt
    g = graphs.grid2d(16, device=cuda)
    state, tn, bcc = _steady_on(g, None)
    ckpt.save(tmp_path / "a", {"forest": state, "tour": tn, "bcc": bcc},
              step=1)
    like = {"forest": dataclasses.replace(state, version=0), "tour": tn,
            "bcc": bcc}
    tree, _ = ckpt.restore(tmp_path / "a", like)
    assert tree["forest"].parent.is_cuda and tree["bcc"].edge_bcc.is_cuda
    assert tree["forest"].version == state.version
    _same_heal((tree["forest"], tree["tour"], tree["bcc"]),
               (state, tn, bcc))
    cpu = _steady_on(g.to("cpu"), None)
    ckpt.save(tmp_path / "b", {"forest": cpu[0]}, step=2)
    tree, _ = ckpt.restore(tmp_path / "b", {"forest": state})
    assert tree["forest"].rep.is_cuda
    for f in DYN_STATE:
        assert torch.equal(getattr(tree["forest"], f), getattr(state, f)), f


def test_resilient_loop_kill_resume_on_card(cuda, tmp_path):
    """Chaos, audits and checkpoints on the card: a run killed after batch
    8 and resumed is bit-identical to the uninterrupted run, and both to the
    same loop on the CPU."""
    from repro_torch.data import streams
    from repro_torch.launch.resilient import ResilientStreamLoop
    g = graphs.grid2d(16, device="cpu")
    s_ = streams.churn(g, batch=32, n_batches=12, seed=2)
    batches = list(s_.batches)
    cfg = dict(tour_mode="incremental", bcc_mode="incremental",
               tour_every=4, audit_every=4, chaos=("parent_cycle",
                                                   "pool_desync",
                                                   "stale_bcc"),
               chaos_every=3, chaos_seed=9, sanitize=True)
    a = ResilientStreamLoop.from_stream(s_, device=cuda, **cfg)
    a.run(batches)
    b1 = ResilientStreamLoop.from_stream(s_, device=cuda,
                                         ckpt_dir=tmp_path, ckpt_every=4,
                                         **cfg)
    b1.run(batches[:8])
    b2 = ResilientStreamLoop.from_stream(s_, device=cuda,
                                         ckpt_dir=tmp_path, ckpt_every=4,
                                         **cfg)
    assert b2.resume() == 8
    b2.run(batches)
    c = ResilientStreamLoop.from_stream(s_, device="cpu", **cfg)
    c.run(batches)
    assert b2.injected == [x for x in a.injected if x[0] >= 8]
    assert a.injected == c.injected and a.recoveries == c.recoveries
    _same_heal((b2.state, b2.tn, b2.bcc), (a.state, a.tn, a.bcc))
    _same_heal((a.state, a.tn, a.bcc), (c.state, c.tn, c.bcc), on_cpu=True)
    assert a.state.parent.is_cuda and b2.state.parent.is_cuda


def _fleet_run(g, kind, lanes, use_kernel, device, tmp=None):
    """A ``lanes``-tenant fleet over 4 ticks with refreshes every 2 (tour
    and BCC incremental, tables), lane by lane beside its sequential twin
    (one ``replay_batch`` a tenant); returns both sides' per-tick records."""
    from repro_torch import dynamic
    from repro_torch.core.queries import build_tables as single_tables
    from repro_torch.data import streams
    from repro_torch.dynamic import fleet as tf
    ss = [streams.churn(g.to("cpu"), batch=32, n_batches=4, seed=t)
          for t in range(lanes)]
    cap = max(dynamic.stream_capacity(s) for s in ss)
    fleet = tf.fleet_empty(lanes, g.n_nodes, cap, device=device)
    twins = [dynamic.init_state(s, cap, device=device,
                                use_kernel=use_kernel) for s in ss]
    for t, s in enumerate(twins):
        fleet.set_tenant(t, s)
    out = []
    tn = bcc = None
    tns = [None] * lanes
    bccs = [None] * lanes
    for i in range(4):
        block = tuple(np.stack([getattr(s.batches[i], f) for s in ss])
                      for f in ("ins_u", "ins_v", "del_u", "del_v"))
        fleet, stats = tf.apply_batches(fleet, *block, use_kernel=use_kernel)
        seq = []
        for t, s in enumerate(ss):
            twins[t], st = dynamic.replay_batch(twins[t], s.batches[i],
                                                use_kernel=use_kernel)
            seq.append(st)
        rec = {"fleet": fleet, "stats": stats, "twins": list(twins),
               "seq": seq}
        if i % 2 == 1:
            tn, fleet = tf.refresh_tours(fleet, tn, use_kernel=use_kernel)
            bcc = tf.refresh_bccs(fleet, bcc, tour=tn, use_kernel=use_kernel)
            tables = tf.build_fleet_tables(tn)
            for t in range(lanes):
                tns[t], twins[t] = dynamic.refresh_tour(
                    twins[t], tns[t], use_kernel=use_kernel)
                bccs[t] = dynamic.refresh_bcc(twins[t], bccs[t],
                                              tour=tns[t],
                                              use_kernel=use_kernel)
            rec.update(tn=tn, bcc=bcc, tables=tables, tns=list(tns),
                       bccs=list(bccs),
                       twin_tables=[single_tables(x) for x in tns])
        out.append(rec)
    return out


@pytest.mark.parametrize("name,kwargs", [
    ("grid2d", dict(side=24)), ("rmat", dict(scale=9, edge_factor=4))])
def test_fleet_on_card_matches_sequential_twins_and_plain(cuda, name,
                                                          kwargs):
    """A 3-lane fleet on the kernel path: every lane bit-equal to its
    sequential twin (state, version, stats; the stacked tour, BCC and
    tables against the twins' refreshes), and the whole run to the fleet
    with ``use_kernel=False``; the four kernels of the path launched."""
    from repro_torch.dynamic.fleet import fleet_sync_cost, tenant_slice
    g = getattr(graphs, name)(**kwargs, device=cuda)
    kernels = (pointer_jump_double_k, list_rank_double_k, hook_edges,
               segment_table)
    before = [k.launches for k in kernels]
    got = _fleet_run(g, "churn", 3, None, cuda)
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in zip(kernels, before))
    plain = _fleet_run(g, "churn", 3, False, cuda)
    for rec, prec in zip(got, plain):
        fleet, pfleet = rec["fleet"], prec["fleet"]
        assert fleet_sync_cost(rec["stats"]) == \
            int(rec["stats"]["rounds"].max()) + 1
        for f in DYN_STATE:
            assert torch.equal(getattr(fleet, f), getattr(pfleet, f)), f
        for k in DYN_STATS:
            assert torch.equal(rec["stats"][k], prec["stats"][k]), k
        for t, twin in enumerate(rec["twins"]):
            lane = fleet.tenant(t)
            for f in DYN_STATE:
                assert torch.equal(getattr(lane, f), getattr(twin, f)), f
            assert lane.version == twin.version
            for k in DYN_STATS:
                assert int(rec["stats"][k][t]) == int(rec["seq"][t][k]), k
        if "tn" not in rec:
            continue
        for t in range(3):
            for f in ("pre", "size", "last", "comp", "parent"):
                assert torch.equal(getattr(rec["tn"], f)[t],
                                   getattr(rec["tns"][t], f)), f
            lane = tenant_slice(rec["bcc"], t)
            for f in DYN_BCC:
                assert torch.equal(getattr(lane, f),
                                   getattr(rec["bccs"][t], f)), f
            for k in DYN_BCC_COUNTS:
                assert int(getattr(lane, k)) == \
                    int(getattr(rec["bccs"][t], k)), k
            tab = tenant_slice(rec["tables"], t)
            for f in ("pre", "last", "comp", "parent", "depth", "up"):
                assert torch.equal(getattr(tab, f),
                                   getattr(rec["twin_tables"][t], f)), f
            assert int(tab.build_syncs) == rec["twin_tables"][t].build_syncs
        for f in DYN_BCC:
            assert torch.equal(getattr(rec["bcc"], f),
                               getattr(prec["bcc"], f)), f


def test_bcc_batch_on_card_matches_separate_calls(cuda):
    """The union ``bcc_batch`` on the kernel path against B separate
    ``biconnectivity`` calls and against its plain path."""
    from repro_torch.core import Graph, bcc_batch
    b, side = 4, 16
    g = graphs.grid2d(side, device="cpu")
    rng = np.random.default_rng(0)
    src, dst = [], []
    for _ in range(b):
        perm = torch.from_numpy(rng.permutation(side * side).astype(np.int32))
        src.append(perm[g.src.long()])
        dst.append(perm[g.dst.long()])
    src, dst = torch.stack(src).to(cuda), torch.stack(dst).to(cuda)
    roots = torch.tensor([0, 5, 17, 255], dtype=torch.int32)
    fields = ("articulation", "bridge", "edge_bcc", "pre", "size", "low",
              "high")
    for flavor in ("gconn_euler", "bfs", "pr_rst"):
        got = bcc_batch(src, dst, roots, n_nodes=side * side,
                        rst_flavor=flavor, device=cuda)
        plain = bcc_batch(src, dst, roots, n_nodes=side * side,
                          rst_flavor=flavor, use_kernel=False, device=cuda)
        for f in fields + ("n_bcc", "rst_steps", "aux_rounds", "seg_syncs"):
            assert torch.equal(getattr(got, f), getattr(plain, f)), f
        for i in range(b):
            one = biconnectivity(Graph(side * side, src[i], dst[i]),
                                 int(roots[i]), rst_flavor=flavor,
                                 device=cuda)
            for f in fields:
                assert torch.equal(getattr(got, f)[i], getattr(one, f)), f
            for f in ("n_bcc", "rst_steps", "aux_rounds", "seg_syncs"):
                assert int(getattr(got, f)[i]) == int(getattr(one, f)), f


# ---------------------------------------------------------------------------
# The GNNs, the RST reorder and the training loop's watchdog (the port's
# GNN slice): float sums in another order on the card (the scatter-adds'
# atomics, cuBLAS), so 1e-5 abs and rel and each gradient within 1e-4 of
# its own largest value; GAT's a_dst gradients are 0 in exact arithmetic
# and rounding on both devices, held below 1e-8.

GNN_TOL = 1e-5
GNN_SCALED_TOL = 1e-4


def _gnn_step_on(arch, device):
    spec = get_arch(arch)
    cfg = spec.make_smoke_config()
    spec = train_launch.smoke_spec(spec, cfg)
    step_fn, state, _ = build_cell(spec, "smoke", smoke=True, device=device)
    _, batch = next(synthetic_batches(spec, spec.shapes["smoke"], cfg,
                                      device=device))
    return step_fn, state, batch


@pytest.mark.parametrize("arch", ["gat-cora", "schnet", "dimenet",
                                  "meshgraphnet"])
def test_gnn_train_step_on_card_matches_cpu(cuda, arch):
    """One smoke train step from the same parameters: loss, every
    gradient (through the step's AdamW moments: m = 0.1 g at step 1) and
    the new state."""
    step_cpu, state_cpu, batch_cpu = _gnn_step_on(arch, "cpu")
    step_gpu, state_gpu, batch_gpu = _gnn_step_on(arch, cuda)
    params = {k: p.detach() for k, p in state_cpu["params"].named_parameters()}
    state_gpu = {"params": gnn_models.GNNParams.from_named(
        {k: p.to(cuda) for k, p in params.items()}).requires_grad_(),
        "opt": adamw_init({k: p.to(cuda) for k, p in params.items()})}
    for k, t in batch_cpu["graph"].items():
        assert torch.equal(batch_gpu["graph"][k].cpu(), t), k
    new_cpu, m_cpu = step_cpu(state_cpu, batch_cpu)
    new_gpu, m_gpu = step_gpu(state_gpu, batch_gpu)
    torch.testing.assert_close(m_gpu["loss"].cpu(), m_cpu["loss"],
                               rtol=GNN_TOL, atol=GNN_TOL)
    for k, want in new_cpu["opt"]["m"].items():
        got = new_gpu["opt"]["m"][k].cpu()
        if k.endswith("a_dst"):
            assert want.abs().max() < 1e-8 and got.abs().max() < 1e-8
            continue
        torch.testing.assert_close(got, want, rtol=GNN_TOL, atol=GNN_TOL)
        assert (got - want).abs().max() <= GNN_SCALED_TOL * want.abs().max()
    for k, p in new_gpu["params"].named_parameters():
        assert p.is_cuda and p.requires_grad
        torch.testing.assert_close(p.detach().cpu(), dict(
            new_cpu["params"].named_parameters())[k].detach(),
            rtol=GNN_TOL, atol=GNN_TOL)


@pytest.mark.parametrize("name,make", [
    ("rmat(12, 8)", lambda: graphs.rmat(12, edge_factor=8, device="cpu")),
    ("grid2d(64)", lambda: graphs.grid2d(64, device="cpu"))])
def test_reorder_by_rst_on_card_matches_cpu(cuda, name, make):
    g = make()
    src, dst = g.src.numpy(), g.dst.numpy()
    want = gnn_batch.reorder_by_rst(src, dst, g.n_nodes, device="cpu")
    got = gnn_batch.reorder_by_rst(src, dst, g.n_nodes)
    plain = gnn_batch.reorder_by_rst(src, dst, g.n_nodes, use_kernel=False)
    assert got.is_cuda
    assert torch.equal(got.cpu(), want) and torch.equal(plain.cpu(), want)


def test_watchdog_times_out_on_device_work(cuda, tmp_path):
    """The step's work is a sleep on the card, queued and returned at once:
    the watchdog waits for it, times it and raises StepTimeout."""
    def sleepy(state, batch):
        torch.cuda._sleep(2_000_000_000)            # about a second
        return state, {"x": state["x"] + 1}

    loop = FaultTolerantLoop(step_fn=sleepy,
                             state={"x": torch.zeros((), device=cuda)},
                             data_iter=iter([(0, {}), (1, {})]),
                             ckpt_dir=tmp_path, step_timeout_s=0.2,
                             max_retries=0)
    with pytest.raises(StepTimeout):
        loop.run(1)


LM_IDS = ("llama3.2-1b", "qwen3-1.7b", "minicpm-2b", "moonshot-v1-16b-a3b",
          "dbrx-132b")
LM_TOL = 1e-5


def _scaled(got, want) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("arch", LM_IDS)
def test_lm_on_card_matches_cpu(cuda, arch):
    """The smoke config in float32 (TF32 off) from the same weights: the
    forward's logits, three decode steps (the cache written in place on the
    card, no host sync a step: sync debug mode "error"), and one train
    step's loss, grad_norm and m (0.1 g), each within 1e-5 of its scale."""
    assert not torch.backends.cuda.matmul.allow_tf32
    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.make_smoke_config(), dtype=torch.float32)
    cpu = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    gpu = tfm.LMParams.from_named({k: p.to(cuda) for k, p in
                                   cpu.named_parameters()})
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    with torch.inference_mode():
        want = tfm.forward(cfg, cpu, toks)
        got = tfm.forward(cfg, gpu, toks.to(cuda))
        assert _scaled(got, want) <= LM_TOL
        c_cpu = tfm.init_kv_cache(cfg, 2, 8, device="cpu")
        c_gpu = tfm.init_kv_cache(cfg, 2, 8, device=cuda)
        k_buf = c_gpu["k"]
        t_gpu = toks.to(cuda)
        for i in range(3):
            want, c_cpu = tfm.decode_step(cfg, cpu, toks[:, i], c_cpu)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got, c_gpu = tfm.decode_step(cfg, gpu, t_gpu[:, i], c_gpu)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert _scaled(got, want) <= LM_TOL, i
        assert c_gpu["k"] is k_buf and c_gpu["len"] == 3
        assert _scaled(c_gpu["v"], c_cpu["v"]) <= LM_TOL

    cells = {}
    for dev in ("cpu", cuda):
        step_fn, _, _ = lm_train_cell(cfg, batch=2, seq=24,
                                      device=torch.device(dev))
        params = tfm.LMParams.from_named(
            {k: p.to(dev) for k, p in cpu.named_parameters()}).requires_grad_()
        state = {"params": params,
                 "opt": adamw_init(dict(params.named_parameters()))}
        batch = {"tokens": toks.to(dev), "targets": toks.roll(1, 1).to(dev)}
        cells[str(dev)] = step_fn(state, batch)
    (new_c, m_c), (new_g, m_g) = cells["cpu"], cells[str(cuda)]
    for k in ("loss", "grad_norm"):
        assert _scaled(m_g[k], m_c[k]) <= LM_TOL, k
    for k, want in new_c["opt"]["m"].items():
        assert _scaled(new_g["opt"]["m"][k], want) <= LM_TOL, k
