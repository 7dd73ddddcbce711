"""The port's multi-rank code against ``repro`` on the CPU:
``core/distributed.py``, ``models/transformer.py::moe_block_shard_map`` and
the DTensor block order of ``distributed/sharding.py``.

``distributed_cc_spanning_forest`` runs at one rank in this process (a
world-1 gloo group, destroyed after each test) and at 8 gloo ranks, on an
(8,) mesh and on the (2, 4) ``("data", "model")`` host mesh over
``"data"``. The algorithm takes global minima, so the shard count changes
nothing: ``rep``, ``forest_mask`` and ``rounds`` are held bit-equal to the
reference's run on a 1-device mesh, on the reference test's grid2d(20) and
rmat(9, 4, seed=2), on two components beside isolated vertices, and on a
graph whose edge count needs ``(0, 0)`` padding. Every graph is padded to a
multiple of 8 half-edges on both sides.

The 8 ranks are processes started once per module (``tests/torch_ranks.py``,
rendezvous through a ``FileStore`` under ``tmp_path``: no TCP port). Beside
them one subprocess runs the reference with 512 host devices (JAX fixes
the device count when it starts): its ``moe_block_shard_map`` at (2, 4),
and JAX's block of every card under the specs checked, at (2, 4) and
(2, 16, 16).

MoE: moonshot's smoke config in float32 with ``act_batch_axes=("data",)``,
``moe_expert_axis="model"`` and ``act_seq_axis`` ``"model"`` or None; the
output within 1e-5 of its scale of the reference's (the experts' partial
outputs are summed in another order), each rank's routing (expert, slot,
keep) bit-equal to the reference's formula (``local_fn``'s lines of
``repro.models.transformer.moe_block_shard_map``, run in jnp here: the
reference does not return them).
"""
import functools
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import Graph as JGraph
from repro.core.distributed import distributed_cc_spanning_forest as jax_cc
from repro.data.graphs import grid2d, rmat
from repro_torch.core.distributed import distributed_cc_spanning_forest
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_host_mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 8
GRAPHS = ("grid", "rmat", "two_comps", "odd")
#: The block-order specs: (2, 4) ones are those of ``torch_ranks.SPECS``.
SPECS_24 = ((("data", "model"), None), ("model", "data"),
            (None, ("data", "model")), ("data", None))
SPECS_PROD = ((("pod", "data"), "model"), (None, ("pod", "data")),
              (("pod", "data", "model"), None), ("model", None))
BLOCK_SHAPE = (1024, 64)
#: The tensor the ranks distribute (``torch_ranks.FULL_SHAPE``).
FULL_SHAPE = (8, 16)
MOE_SHAPE = (4, 16)                     # (B, S) of the MoE tokens
MOE_TOL = 1e-5


def _padded(src, dst, n):
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    pad = -src.size % WORLD
    z = np.zeros(pad, np.int32)
    return np.concatenate([src, z]), np.concatenate([dst, z]), n


@functools.cache
def graph(name: str):
    """(src, dst, n) of a test graph, padded to a multiple of WORLD."""
    if name == "grid":
        g = grid2d(20)
    elif name == "rmat":
        g = rmat(9, 4, seed=2)
    elif name == "two_comps":
        # A path 0-9 and a cycle 15-25; 10-14 and 26-39 isolated.
        e = [(i, i + 1) for i in range(9)]
        e += [(i, i + 1) for i in range(15, 25)] + [(25, 15)]
        g = JGraph.from_numpy_undirected(40, np.array(e))
    else:
        # 13 undirected edges (26 half-edges: 6 pads): a star with two
        # chords, and a triangle; 12-16 isolated.
        e = [(0, i) for i in range(1, 9)]
        e += [(9, 10), (10, 11), (11, 9), (3, 5), (4, 6)]
        g = JGraph.from_numpy_undirected(17, np.array(e))
    src, dst, n = _padded(g.src, g.dst, g.n_nodes)
    if name == "odd":
        assert (src.size - np.asarray(g.src).size) == 6
    return src, dst, n


@functools.cache
def reference(name: str):
    """The reference's (rep, forest, rounds) on a 1-device mesh."""
    src, dst, n = graph(name)
    mesh = jax.make_mesh((1,), ("data",))
    rep, forest, rounds = jax_cc(mesh, "data")(
        jnp.asarray(src), jnp.asarray(dst), n_nodes=n)
    return np.asarray(rep), np.asarray(forest), int(rounds)


def moe_inputs() -> dict:
    rng = np.random.default_rng(3)
    b, s = MOE_SHAPE
    d, e, f = 64, 8, 48                     # moonshot's smoke widths

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(
            np.float32)
    return {"moe/x": rng.standard_normal((b, s, d)).astype(np.float32),
            "moe/router": normal((d, e), d),
            "moe/w_gate": normal((e, d, f), d),
            "moe/w_up": normal((e, d, f), d),
            "moe/w_down": normal((e, f, d), f)}


_JAX_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.models import transformer as jt

job, out, specs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
data = np.load(job)
devs = np.array(jax.devices())
mesh = Mesh(devs[:8].reshape(2, 4), ("data", "model"))
res = {}
args = [jnp.asarray(data[f"moe/{k}"])
        for k in ("x", "router", "w_gate", "w_up", "w_down")]
for seq in ("model", None):
    cfg = dataclasses.replace(
        get_arch("moonshot-v1-16b-a3b").make_smoke_config(),
        dtype=jnp.float32, act_batch_axes=("data",), act_seq_axis=seq,
        moe_expert_axis="model")
    fn = jax.jit(lambda *a, cfg=cfg: jt.moe_block_shard_map(*a, cfg, mesh))
    res[f"moe/{seq}"] = np.asarray(fn(*args))
for label, (shape, names, shape_specs, gshape) in specs.items():
    m = Mesh(devs[:int(np.prod(shape))].reshape(shape), tuple(names))
    for i, spec in enumerate(shape_specs):
        spec = [tuple(e) if isinstance(e, list) else e for e in spec]
        idx = NamedSharding(m, P(*spec)).devices_indices_map(tuple(gshape))
        starts = np.zeros(tuple(shape) + (len(gshape),), np.int64)
        for coord in np.ndindex(*shape):
            starts[coord] = [sl.start or 0 for sl in idx[m.devices[coord]]]
        res[f"block/{label}/{i}"] = starts
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 8 ranks' results and the reference subprocess's, both started
    together and awaited."""
    tmp = tmp_path_factory.mktemp("ranks")
    job = {**moe_inputs()}
    for name in GRAPHS:
        src, dst, n = graph(name)
        job[f"g/{name}/src"], job[f"g/{name}/dst"] = src, dst
        job[f"g/{name}/n"] = np.array(n)
    np.savez(tmp / "job.npz", **job)
    specs = {"24": ((2, 4), ("data", "model"), SPECS_24, FULL_SHAPE),
             "prod": ((2, 16, 16), ("pod", "data", "model"), SPECS_PROD,
                      BLOCK_SHAPE)}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "job.npz"),
         str(tmp / "ref.npz"), json.dumps(specs)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_ranks.py"), str(r),
         str(WORLD), str(tmp / "store"), str(tmp / "job.npz"), str(tmp)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    errs = []
    for p in [ref, *procs]:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, "\n".join(errs)
    return ([dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
            dict(np.load(tmp / "ref.npz")))


@pytest.fixture
def world_one():
    """A world-1 gloo group in this process, destroyed after the test."""
    mesh = make_host_mesh(device_type="cpu")
    yield mesh
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Distributed connectivity
# ---------------------------------------------------------------------------

def assert_same(got, want, what):
    rep, forest, rounds = got
    wrep, wforest, wrounds = want
    assert np.array_equal(np.asarray(rep), wrep), f"{what}: rep"
    assert np.array_equal(np.asarray(forest), wforest), f"{what}: forest"
    assert int(rounds) == wrounds, f"{what}: rounds {rounds} != {wrounds}"


@pytest.mark.parametrize("name", GRAPHS)
def test_cc_one_rank(world_one, name):
    src, dst, n = graph(name)
    rep, forest, rounds, syncs = distributed_cc_spanning_forest(world_one)(
        torch.from_numpy(src), torch.from_numpy(dst), n_nodes=n,
        return_syncs=True)
    assert rep.dtype == torch.int32 and forest.dtype == torch.bool
    assert isinstance(rounds, int) and syncs >= rounds + 1
    want = reference(name)
    assert_same((rep.numpy(), forest.numpy(), rounds), want, name)
    n_comp = int((want[0] == np.arange(n)).sum())
    assert int(want[1].sum()) == n - n_comp
    if name == "two_comps":
        assert n_comp == 2 + 5 + 14


@pytest.mark.parametrize("mesh", ("line", "grid"))
@pytest.mark.parametrize("name", GRAPHS)
def test_cc_eight_ranks(runs, mesh, name):
    ranks, _ = runs
    want = reference(name)
    for r, res in enumerate(ranks):
        got = tuple(res[f"cc/{mesh}/{name}/{k}"]
                    for k in ("rep", "forest", "rounds"))
        assert_same(got, want, f"{mesh} rank {r} {name}")


def test_cc_refuses_unpadded_edges():
    with fake_world(WORLD):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
        run = distributed_cc_spanning_forest(mesh)
        e = torch.zeros(10, dtype=torch.int32)
        with pytest.raises(AssertionError,
                           match="edge count 10 must divide mesh axis "
                                 "data=8; pad with self-loop edges"):
            run(e, e, n_nodes=3)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# Expert-parallel MoE
# ---------------------------------------------------------------------------

def reference_local_route(x, router_w, cfg, ridx, e_per):
    """``local_fn``'s routing lines of the reference's
    ``moe_block_shard_map`` on a flat token table."""
    t = x.shape[0]
    e_total, k = cfg.n_experts, cfg.top_k
    logits = x.astype(jnp.float32) @ router_w.astype(jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    _top_g, top_e = jax.lax.top_k(gates, k)
    local_e = top_e - ridx * e_per
    mine = (local_e >= 0) & (local_e < e_per)
    le_safe = jnp.where(mine, local_e, 0)
    cap = int(max(1, round(t * k / e_total * cfg.capacity_factor)))
    cap = -(-cap // 8) * 8
    onehot = jax.nn.one_hot(le_safe, e_per, dtype=jnp.int32) * mine[..., None]
    flat = onehot.reshape(t * k, e_per)
    pos = jnp.sum(flat * (jnp.cumsum(flat, axis=0) - flat),
                  axis=-1).reshape(t, k)
    return le_safe, pos, mine & (pos < cap), cap


@pytest.mark.parametrize("seq", ("model", None))
def test_moe_block_shard_map(runs, seq):
    import dataclasses
    from repro.configs import get_arch
    ranks, ref = runs
    inputs = moe_inputs()
    x = inputs["moe/x"]
    want = ref[f"moe/{seq}"]
    b, s = MOE_SHAPE
    cfg = dataclasses.replace(
        get_arch("moonshot-v1-16b-a3b").make_smoke_config(),
        dtype=jnp.float32, act_batch_axes=("data",), act_seq_axis=seq,
        moe_expert_axis="model")
    e_per = cfg.n_experts // 4
    got = np.full_like(want, np.nan)
    for r, res in enumerate(ranks):
        di, mi = (int(c) for c in res["coordinate"])
        rows = slice(di * b // 2, (di + 1) * b // 2)
        cols = slice(mi * s // 4, (mi + 1) * s // 4) if seq else slice(None)
        out = res[f"moe/{seq}/out"]
        if seq is None and not np.isnan(got[rows, cols]).any():
            # The model ranks of one data row hold replicas.
            assert np.array_equal(out, got[rows, cols]), f"rank {r}"
        got[rows, cols] = out
        xf = jnp.asarray(x[rows].reshape(-1, x.shape[2]))
        le, pos, keep, cap = reference_local_route(
            xf, jnp.asarray(inputs["moe/router"]), cfg, mi, e_per)
        assert int(res[f"moe/{seq}/cap"]) == cap
        assert np.array_equal(res[f"moe/{seq}/keep"], np.asarray(keep))
        assert np.array_equal(res[f"moe/{seq}/local_e"], np.asarray(le))
        assert np.array_equal(res[f"moe/{seq}/pos"], np.asarray(pos))
    err = np.abs(got - want).max()
    assert err <= MOE_TOL * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# DTensor block order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(SPECS_24)))
def test_block_order_two_by_four(runs, i):
    """Each gloo rank's ``distribute_tensor`` block under the spec's
    placements is JAX's block for that mesh position."""
    ranks, ref = runs
    starts = ref[f"block/24/{i}"]
    full = np.arange(math.prod(FULL_SHAPE)).reshape(FULL_SHAPE)
    counts = [math.prod({"data": 2, "model": 4}[a] for a in
                        ((e,) if isinstance(e, str) else e or ()))
              for e in SPECS_24[i]]
    local = [n // c for n, c in zip(FULL_SHAPE, counts)]
    for res in ranks:
        di, mi = (int(c) for c in res["coordinate"])
        js = starts[di, mi]
        want = full[js[0]:js[0] + local[0], js[1]:js[1] + local[1]]
        assert np.array_equal(res[f"block/{i}"], want)


@pytest.mark.parametrize("i", range(len(SPECS_PROD)))
def test_block_order_production(runs, i):
    """On (2, 16, 16), under a fake group of 512 ranks: DTensor's offset of
    each sampled rank's block (torch's own placement arithmetic) is JAX's,
    and the placements put ``Shard(d)`` on each mesh dim a tensor dim is
    split over, in mesh order."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    _, ref = runs
    starts = ref[f"block/prod/{i}"]
    shape, names = (2, 16, 16), ("pod", "data", "model")
    spec = P(*SPECS_PROD[i])
    dims = {a: d for d, e in enumerate(SPECS_PROD[i]) if e
            for a in ((e,) if isinstance(e, str) else e)}
    for rank in (*range(0, 512, 37), 511):
        with fake_world(math.prod(shape), rank=rank):
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            sh = NamedSharding(mesh, spec)
            assert sh.placements == tuple(
                Shard(dims[a]) if a in dims else Replicate() for a in names)
            local, offset = compute_local_shape_and_global_offset(
                BLOCK_SHAPE, mesh, sh.placements)
            assert tuple(local) == sh.local_shape(BLOCK_SHAPE)
        coord = np.unravel_index(rank, shape)
        assert list(offset) == list(starts[coord]), rank
