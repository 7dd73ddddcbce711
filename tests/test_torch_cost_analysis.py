"""``launch/cost_analysis.py`` against closed forms and against
``repro.launch.hlo_analysis`` on the CPU.

Closed forms: the flops of ``mm``/``addmm``/``bmm``/``baddbmm``/``einsum``
(exact), 0 bytes for views, a row-sharded × replicated DTensor product on
a fake world of 4 counted at one rank's share, the payload of an implicit
all-gather, of ``dist.all_reduce`` and of DTensor's CPU all-to-all
fallback (counted as the all-to-all), the peak of a toy forward/backward
chain whose live set is known, and ``embed_bag`` counted at its kernel's
boundary (all exact).

Against ``repro``: the smoke configs at the smoke shapes of
``tests/test_torch_mesh_cells.py`` (LMs batch 4 × 64 positions, the
GNNs' 64 nodes and 256 edges, DIEN 16 rows; qwen3's decode at batch 4
and 1 against a 16-position cache). The reference is compiled in one
subprocess with 256 host devices on a (1, 1) and a (2, 4) ``("data",
"model")`` mesh (and the production cases below on its (16, 16)) and
read by ``hlo_analysis.analyze``; the port runs ``analyze_cell`` on a
fake world of 1, 8 or 256 with the same mesh. Every comparison is within
1% (``REL``).

GAT, DIEN's train and serve cells: the port's per-card flops equal the
reference's. Everywhere else a departure changes the products, and the
test pins the reference's flops plus its closed form (``ROADMAP.md``,
"Standing departures"). With T = B·S tokens, L layers, V the padded
vocab, n the cards, n_d the data axis, and A the reference's attention
products (two forward, two recomputed under its per-layer remat, four in
the backward, each 2·B·H·S²·Dh a layer):
  * causal key blocks wholly masked are skipped: A_port = k·A, k the
    share of (query, key) blocks kept (36 of 64 here);
  * the loss chunk runs under ``torch.utils.checkpoint``, which replays
    its unembedding in the backward; XLA folds that replay into the
    forward's: one more 2·T·d·V product;
  * SchNet: torch's checkpoint replays an interaction's forward up to the
    last tensor its backward needs, one node product (2·N·d²) more than
    XLA's remat keeps; XLA turns the readout's 1-wide product's gradient
    (2·N·(d/2), a contraction of length 1) into a broadcast multiply, no
    dot. So on one card: port = ref − (1 − k)·A + 2·T·d·V (LM), ref +
    n_int·2·N·d² + N·d (SchNet).
On the (2, 4) mesh the reference splits llama3.2-1b's and qwen3-1.7b's
products over the 8 cards (its (2, 4) count is its (1, 1) count / 8 to
the flop) and minicpm's, moonshot's and dbrx's less evenly. The port
splits every LM's layers evenly: attention by ``transformer.HeadSplit``
(gcd(H, 4) head blocks, the rest of the model axis over query chunks), k
and v by wk's and wv's column blocks, every product on the rank's share
with its gradient whole. So its (2, 4) count is (its (1, 1) count) / 8
plus the work it runs on the rank's rows only (÷ n_d, not ÷ n), and at
or under the reference's (2, 4) count plus that work:
  * the loss: each rank's rows against the whole unembedding, its four
    products (forward, replay, two gradients);
and the router's four products (forward, replay, two gradients) run on
the whole token table on every card (the MoE without an expert axis).
On the production (16, 16) mesh, full widths cut to two layers, the
port's ``train_4k`` step for llama3.2-1b (GQA, one kv head to two model
ranks) and minicpm-2b (36 heads on 16: four head blocks over four query
blocks) counts at or under the reference's, compiled at the same cut.
The decode step runs every product on the rank's rows and its block of
the weight: with the batch over ``data`` (batch 4) each term / 8, the
reference's split; with one request (batch 1, the positions over
``data``) the products / 4 (the row whole, the weights' model blocks)
and the attention / 8 (the heads over ``model``, the positions over
``data``), at or under the reference's. On the (16, 16) mesh at two
layers every long_500k cell and the MoE LMs' decode_32k count at or under
the reference's flops, with its arguments and at or under its temp.
SchNet at smoke (rows
not constrained) gets its aggregates whole on every card from each
scatter: three node products an interaction (w_out's two and its replay)
run whole, and w_out's two gradient products an interaction on a
gradient split over both axes (÷ n).

Collectives: the reference's ``hlo_parsed.collective_bytes`` is recorded
beside its flops. The four GNN smoke cells on (2, 4) take the whole layout
of ``models/gnn.py``'s gathers and scatters, whose collectives are pinned
to the byte in closed form (``gnn_whole``), as is MeshGraphNet's by blocks
(``mgn_blocks``, ``_blocks_cheaper`` patched); each step's collectives are
at or under the reference's. MeshGraphNet's and GAT's ``minibatch_lg``
cells on the (16, 16) mesh at full config (by blocks) count at or under
the reference's collective bytes a card.
"""
import dataclasses
import functools
import json
from collections import defaultdict
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_arch
from repro_torch.kernels.embed_bag.ops import embed_bag
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
REL = 0.01
DIMS = {"1x1": (1, 1), "2x4": (2, 4)}
LM_TRAIN = dict(kind="train", batch=4, seq=64)
GNN_TRAIN = dict(kind="train", n_nodes=64, n_edges=256, d_feat=16,
                 n_graphs=4)
LMS = ("llama3.2-1b", "qwen3-1.7b", "minicpm-2b", "moonshot-v1-16b-a3b",
       "dbrx-132b")
CASES = {**{f"{a}/train": (a, LM_TRAIN) for a in LMS},
         "qwen3-1.7b/decode": ("qwen3-1.7b",
                               dict(kind="decode", batch=4, seq=16)),
         "qwen3-1.7b/decode1": ("qwen3-1.7b",
                                dict(kind="decode", batch=1, seq=16)),
         "gat-cora/train": ("gat-cora", GNN_TRAIN),
         "schnet/train": ("schnet", GNN_TRAIN),
         "meshgraphnet/train": ("meshgraphnet", GNN_TRAIN),
         "dimenet/train": ("dimenet", GNN_TRAIN),
         "dien/train": ("dien", dict(kind="train", batch=16)),
         "dien/serve": ("dien", dict(kind="serve", batch=16))}
#: The reference's (2, 4) count is its (1, 1) count / 8 for these.
EVEN_REFERENCE = ("llama3.2-1b", "qwen3-1.7b")
#: ``train_4k`` on the (16, 16) production mesh at full width, cut to
#: PRODUCTION_LAYERS layers.
PRODUCTION = ("llama3.2-1b", "minicpm-2b")
PRODUCTION_LAYERS = 2
#: The decode cells on the (16, 16) mesh at the same cut: long_500k (one
#: request, the positions over ``data``) of every LM, and the MoE LMs'
#: decode_32k (the batch over ``data``, the positions over ``model``).
PRODUCTION_DECODE = tuple((a, "long_500k") for a in LMS) + (
    ("moonshot-v1-16b-a3b", "decode_32k"), ("dbrx-132b", "decode_32k"))
#: GNN cells on the (16, 16) mesh at their full configs (no cut), whose
#: collectives the port holds to the reference's.
PRODUCTION_GNN = (("meshgraphnet", "minibatch_lg"),
                  ("gat-cora", "minibatch_lg"))
GNNS = ("gat-cora", "schnet", "dimenet", "meshgraphnet")

_JAX_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import dataclasses
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import get_arch
from repro.launch.hlo_analysis import analyze
from repro.launch.mesh import make_production_mesh
from repro.train.step import build_cell

cases, production, decode, layers, gnn, out = (
    json.loads(sys.argv[1]), json.loads(sys.argv[2]),
    json.loads(sys.argv[3]), int(sys.argv[4]), json.loads(sys.argv[5]),
    sys.argv[6])
res = {}
for mesh_name, dims in (("1x1", (1, 1)), ("2x4", (2, 4))):
    devs = np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims)
    mesh = Mesh(devs, ("data", "model"))
    for label, (arch, shape) in cases.items():
        spec = dataclasses.replace(get_arch(arch), shapes={"smoke": shape})
        step_fn, state, inputs = build_cell(spec, "smoke", mesh, smoke=True)
        with getattr(jax, "set_mesh", lambda m: m)(mesh):
            compiled = jax.jit(step_fn).lower(state, inputs).compile()
        cost = analyze(compiled.as_text())
        res[f"{label}@{mesh_name}"] = cost.flops
        res[f"{label}@{mesh_name}/coll"] = cost.collective_bytes
        res[f"{label}@{mesh_name}/temp"] = \
            compiled.memory_analysis().temp_size_in_bytes
mesh = make_production_mesh()
for arch, shape in gnn:
    step_fn, state, inputs = build_cell(get_arch(arch), shape, mesh)
    with getattr(jax, "set_mesh", lambda m: m)(mesh):
        compiled = jax.jit(step_fn).lower(state, inputs).compile()
    res[f"{arch}/{shape}@16x16/coll"] = analyze(
        compiled.as_text()).collective_bytes
for arch, shape in [(a, "train_4k") for a in production] + decode:
    base = get_arch(arch)
    cfg = dataclasses.replace(base.make_config(), n_layers=layers)
    spec = dataclasses.replace(base, make_config=lambda cfg=cfg: cfg)
    step_fn, state, inputs = build_cell(spec, shape, mesh)
    with getattr(jax, "set_mesh", lambda m: m)(mesh):
        compiled = jax.jit(step_fn).lower(state, inputs).compile()
    res[f"{arch}/{shape}@16x16"] = analyze(compiled.as_text()).flops
    mem = compiled.memory_analysis()
    res[f"{arch}/{shape}@16x16/temp"] = mem.temp_size_in_bytes
    res[f"{arch}/{shape}@16x16/args"] = mem.argument_size_in_bytes
with open(out, "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{"<case>@<mesh>": the reference's per-card flops, and under
    "<case>@<mesh>/temp" its temp bytes and "<case>@<mesh>/coll" its
    collective bytes (``hlo_parsed.collective_bytes``)}, compiled in a
    subprocess started first; the port's analyses run meanwhile."""
    tmp = tmp_path_factory.mktemp("hlo")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, json.dumps(CASES),
         json.dumps(PRODUCTION), json.dumps(PRODUCTION_DECODE),
         str(PRODUCTION_LAYERS), json.dumps(PRODUCTION_GNN),
         str(tmp / "ref.json")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    for label in CASES:          # the port's side while the reference runs
        for mesh_name in DIMS:
            port_flops(label, mesh_name)
    for arch in PRODUCTION:
        port_production(arch)
    for arch, shape in PRODUCTION_DECODE:
        port_production(arch, shape)
    for arch, shape in PRODUCTION_GNN:
        port_gnn_production_cell(arch, shape)
    for arch in GNNS:
        gnn_collectives(arch)
    gnn_collectives("meshgraphnet", blocks=True)
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    return json.loads((tmp / "ref.json").read_text())


@functools.cache
def port_cell(label: str, mesh_name: str) -> dict:
    arch, shape = CASES[label]
    dims = DIMS[mesh_name]
    n = dims[0] * dims[1]
    spec = dataclasses.replace(get_arch(arch), shapes={"smoke": shape})
    with fake_world(n):
        mesh = DeviceMesh("cpu", torch.arange(n).reshape(dims),
                          mesh_dim_names=("data", "model"))
        return ca.analyze_cell(spec, "smoke", mesh, smoke=True)


def port_flops(label: str, mesh_name: str) -> float:
    return port_cell(label, mesh_name)["cost"].flops


@functools.cache
def port_production_cell(arch: str, shape: str = "train_4k") -> dict:
    """The port's analysis of ``arch``'s ``shape`` step on the production
    (16, 16) mesh (a fake world of 256) at full width, cut to
    PRODUCTION_LAYERS layers."""
    base = get_arch(arch)
    cfg = dataclasses.replace(base.make_config(), n_layers=PRODUCTION_LAYERS)
    spec = dataclasses.replace(base, make_config=lambda: cfg)
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        return ca.analyze_cell(spec, shape, mesh)


def port_production(arch: str, shape: str = "train_4k") -> float:
    return port_production_cell(arch, shape)["cost"].flops


@functools.cache
def port_gnn_production_cell(arch: str, shape: str) -> dict:
    """The port's analysis of a GNN cell on the (16, 16) mesh at its full
    config."""
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        return ca.analyze_cell(get_arch(arch), shape, mesh)


@functools.cache
def gnn_collectives(arch: str, blocks: bool = False) -> tuple:
    """(the collective bytes by kind that ``models/gnn.py``'s gathers and
    scatters issue, the step's collective bytes) of ``arch``'s smoke train
    step on the (2, 4) mesh; with ``blocks`` every gather and scatter by
    blocks (``_blocks_cheaper`` patched)."""
    from repro_torch.models import gnn as tg
    kinds = {"_all_gather": "all-gather", "_reduce_scatter": "reduce-scatter",
             "_all_reduce": "all-reduce"}
    own = defaultdict(float)
    saved = {name: getattr(tg, name) for name in (*kinds, "_blocks_cheaper")}

    def recorded(name):
        def run(t, group, *args):
            if group is not None:
                own[kinds[name]] += ca.tensor_bytes(t)
            return saved[name](t, group, *args)
        return run
    for name in kinds:
        setattr(tg, name, recorded(name))
    if blocks:
        tg._blocks_cheaper = lambda sp, n, k: True
    try:
        spec = dataclasses.replace(get_arch(arch), shapes={"smoke": GNN_TRAIN})
        with fake_world(8):
            mesh = DeviceMesh("cpu", torch.arange(8).reshape(DIMS["2x4"]),
                              mesh_dim_names=("data", "model"))
            cost = ca.analyze_cell(spec, "smoke", mesh, smoke=True)["cost"]
    finally:
        for name, fn in saved.items():
            setattr(tg, name, fn)
    return dict(own), cost.collective_bytes


def near(got: float, want: float) -> bool:
    return abs(got - want) <= REL * abs(want)


# ---------------------------------------------------------------------------
# Closed forms
# ---------------------------------------------------------------------------

def _counted(fn, *args):
    with ca.counting() as mode:
        fn(*args)
    return mode.cost


def meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("op,args,want", [
    ("mm", ((8, 16), (16, 4)), 2 * 8 * 16 * 4),
    ("addmm", ((4,), (8, 16), (16, 4)), 2 * 8 * 16 * 4),
    ("bmm", ((3, 8, 16), (3, 16, 4)), 2 * 3 * 8 * 16 * 4),
    ("baddbmm", ((3, 8, 4), (3, 8, 16), (3, 16, 4)), 2 * 3 * 8 * 16 * 4),
    ("einsum", ("bhqd,bhkd->bhqk", (2, 3, 8, 16), (2, 3, 5, 16)),
     2 * 2 * 3 * 8 * 5 * 16),
    ("matmul", ((5, 8, 16), (16, 4)), 2 * 5 * 8 * 16 * 4),
    ("mv", ((8, 16), (16,)), 2 * 8 * 16),
])
def test_product_flops(op, args, want):
    ts = [a if isinstance(a, str) else meta(*a) for a in args]
    assert _counted(getattr(torch, op), *ts).flops == want


def test_views_move_no_bytes():
    x = meta(4, 8, 16)

    def views(x):
        x.view(32, 16).t().expand(2, 16, 32).detach()
        x.split(2)
        x.reshape(4, 128)
        torch.empty_like(x)
        x.as_strided((4, 4), (16, 1))
        x.permute(2, 0, 1).unsqueeze(0)[0, 1:]
    cost = _counted(views, x)
    assert cost.bytes_accessed == 0 and cost.flops == 0
    # A data-moving op counts its operand and its result.
    assert _counted(torch.neg, x).bytes_accessed == 2 * 4 * 8 * 16 * 4
    assert _counted(lambda t: t.contiguous(), x.transpose(0, 1)
                    ).bytes_accessed == 2 * 4 * 8 * 16 * 4


@pytest.fixture
def world4():
    with fake_world(4):
        yield DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("x",))
    assert not dist.is_initialized()


def dt(mesh, local_shape, global_shape, placements, **kw):
    return DTensor.from_local(
        torch.empty(local_shape, device="meta", **kw), mesh, placements,
        run_check=False, shape=global_shape,
        stride=torch.empty(global_shape, device="meta").stride())


def test_sharded_product_counts_one_rank(world4):
    """A row-sharded A (64 rows over 4 ranks) times a replicated B: one
    rank's 16 rows, a quarter of the global product, no collective."""
    a = dt(world4, (16, 32), (64, 32), (Shard(0),))
    b = dt(world4, (32, 8), (32, 8), (Replicate(),))
    cost = _counted(torch.mm, a, b)
    assert cost.flops == 2 * 16 * 32 * 8 == (2 * 64 * 32 * 8) / 4
    assert cost.collective_bytes == 0


def test_collective_payloads(world4):
    """An implicit all-gather (a sharded contraction made replicated), an
    explicit all-reduce, and DTensor's CPU all-to-all fallback (a shard
    moved to another dim: all-gather + chunk on gloo) counted as the
    all-to-all a CUDA mesh runs, each with its operand's bytes."""
    a = dt(world4, (16, 32), (64, 32), (Shard(0),))
    cost = _counted(lambda t: t.redistribute(world4, (Replicate(),)), a)
    assert dict(cost.per_collective) == {"all-gather": 16 * 32 * 4}
    x = meta(10)
    cost = _counted(dist.all_reduce, x)
    assert dict(cost.per_collective) == {"all-reduce": 40}
    cost = _counted(lambda t: t.redistribute(world4, (Shard(1),)), a)
    assert dict(cost.per_collective) == {"all-to-all": 16 * 32 * 4}
    assert cost.collective_bytes == 16 * 32 * 4


def test_temp_of_a_chain():
    """x (1 MiB, an argument) → y = 2x → z = 3y, y dropped → w = exp(z)
    (saved for the backward), z dropped → the sum, then its gradient: the
    live set peaks in the backward at w, dL/dz and dL/dy (3 MiB) beside
    the 4-byte loss and its 4-byte gradient."""
    mib = 1 << 20
    x = torch.empty(mib // 4, device="meta", requires_grad=True)
    with ca.counting() as mode:
        args = mode.arguments(x)
        y = x * 2
        z = y * 3
        del y
        w = z.exp()
        del z
        g, = torch.autograd.grad(w.sum(), x)
    assert args == mib
    assert mode.peak == 3 * mib + 8
    del w, g
    assert mode.live == 0            # every storage the chain made is gone


def test_sharding_propagation_counts_nothing(world4, monkeypatch):
    """softplus and its gradient on a row-split ``meta`` DTensor (64 rows
    over 4 ranks). DTensor infers the placements of softplus's backward by
    running its decomposition on ``meta`` tensors of the global shape,
    outside any fake mode; none of that is counted: the peak, bytes,
    flops and collectives are those of the same ops on the rank's 16
    rows, no counted op makes a 64-row tensor, and the propagator's entry
    points are put back after."""
    made = []
    allocated = ca.CostMode._allocated

    def recording(self, out):
        made.extend(tuple(t.shape) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
        allocated(self, out)
    monkeypatch.setattr(ca.CostMode, "_allocated", recording)
    prop = DTensor._op_dispatcher.sharding_propagator
    entries = dict(vars(prop))

    def counted(x):
        with ca.counting() as mode:
            mode.arguments(x)
            y = torch.nn.functional.softplus(x)
            torch.autograd.grad(y, x, torch.ones_like(y))
        return (mode.peak, mode.cost.bytes_accessed, mode.cost.flops,
                mode.cost.collective_bytes)
    sharded = counted(dt(world4, (16, 64), (64, 64), (Shard(0),)
                         ).requires_grad_())
    assert made and set(made) == {(16, 64)}
    assert vars(prop) == entries
    assert sharded == counted(meta(16, 64).requires_grad_())
    assert sharded[0] == 3 * 16 * 64 * 4     # y, the ones, the gradient


def test_collective_wrapper_counts_as_its_input():
    """The functional collectives' autograd wrapper of a result
    (``_c10d_functional._wrap_tensor_autograd``) holds its input's
    storage on the card but makes a new one on ``meta``: counted as the
    input's, which stays live until the wrapper and its views are gone."""
    mib = 1 << 20
    wrap = torch.ops._c10d_functional._wrap_tensor_autograd
    with ca.counting() as mode:
        x = torch.ones(mib // 4, device="meta")
        w = wrap(x)
        v = w[:8]
        assert mode.live == mode.peak == mib
        del x, w
        assert mode.live == mib
        del v
        assert mode.live == 0


def test_embed_bag_counts_as_its_kernel():
    """On ``meta`` the wrapper runs its plain version; under the analysis
    that counts as the kernel's launch: indices, weights, table and result
    bytes, no intermediate op, no flops."""
    b, hot, v, d = 32, 8, 100, 18
    idx = torch.empty((b, hot), dtype=torch.int32, device="meta")
    w = meta(b, hot)
    table = meta(v, d)
    cost = _counted(lambda: embed_bag(idx, table, w, mean=True))
    assert cost.flops == 0
    assert cost.bytes_accessed == 4 * (b * hot + b * hot + v * d + b * d)
    plain = _counted(lambda: embed_bag(idx, table, w, mean=True,
                                       use_kernel=False))
    assert plain.bytes_accessed > cost.bytes_accessed


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["gat-cora/train", "meshgraphnet/train",
                                   "dien/train", "dien/serve"])
def test_per_card_flops_match_reference(reference, label):
    for mesh_name in DIMS:
        want = reference[f"{label}@{mesh_name}"]
        assert near(port_flops(label, mesh_name), want), (mesh_name, want)


def _lm(label):
    arch, shape = CASES[label]
    cfg = get_arch(arch).make_smoke_config()
    return cfg, shape["batch"], shape["seq"]


def _kept_share(cfg, seq: int) -> float:
    """The share of (query, key) blocks ``chunked_attention`` computes."""
    n_q, n_kv = max(seq // cfg.q_chunk, 1), max(seq // cfg.kv_chunk, 1)
    qc, kvc = seq // n_q, seq // n_kv
    kept = sum(1 for i in range(n_q) for j in range(n_kv)
               if j * kvc <= i * qc + qc - 1)
    return kept / (n_q * n_kv)


def _lm_terms(label):
    """(A, k, loss product) of an LM train case: the reference's attention
    products, the kept share, one 2·T·d·V product."""
    cfg, b, s = _lm(label)
    attn = 8 * cfg.n_layers * 2 * b * cfg.n_heads * s * s * cfg.d_head
    return attn, _kept_share(cfg, s), 2 * b * s * cfg.d_model * \
        cfg.vocab_padded


def lm_math(label) -> float:
    """port − reference on one card (skipped blocks, the loss replay)."""
    attn, k, loss = _lm_terms(label)
    return -(1 - k) * attn + loss


def lm_partition(label, n_data: int = 2, n: int = 8) -> float:
    """The port's per-card flops beyond an even split over n cards: the
    loss's four products (forward, replay, two gradients) on the rank's
    rows against the whole unembedding (÷ n_d, not ÷ n), and an MoE's
    router's four on the whole token table."""
    cfg, b, s = _lm(label)
    _attn, _k, loss = _lm_terms(label)
    out = 4 * loss * (1 / n_data - 1 / n)
    if cfg.is_moe:
        out += 4 * cfg.n_layers * 2 * b * s * cfg.d_model * cfg.n_experts \
            * (1 - 1 / n)
    return out


@pytest.mark.parametrize("label", [f"{a}/train" for a in LMS])
def test_lm_train_flops_one_card(reference, label):
    want = reference[f"{label}@1x1"] + lm_math(label)
    assert near(port_flops(label, "1x1"), want), want


@pytest.mark.parametrize("label", [f"{a}/train" for a in LMS])
def test_lm_train_flops_per_card(reference, label):
    """Each LM's step splits evenly over the 8 cards but for
    ``lm_partition``'s terms; where the reference splits less evenly, the
    port counts at or under the reference plus those terms."""
    one = reference[f"{label}@1x1"]
    split = reference[f"{label}@2x4"]
    got = port_flops(label, "2x4")
    want = (one + lm_math(label)) / 8 + lm_partition(label)
    assert near(got, want), (want, split)
    if label.split("/")[0] in EVEN_REFERENCE:
        assert split == one / 8
    else:
        assert split > one / 8          # the reference splits less evenly
        assert got <= split + lm_math(label) / 8 + lm_partition(label)


@pytest.mark.parametrize("arch", PRODUCTION)
def test_production_mesh_train_flops(reference, arch):
    """Per card on the (16, 16) mesh, where the model axis divides neither
    head count of llama3.2-1b (8 kv heads) nor minicpm-2b's 36 heads: the
    port's step at or under the reference's."""
    want = reference[f"{arch}/train_4k@16x16"]
    assert port_production(arch) <= want, (port_production(arch), want)


def decode_terms(label) -> dict:
    """The products of one decode step of an LM case on one card, by
    name."""
    cfg, b, s = _lm(label)
    d, L, dh = cfg.d_model, cfg.n_layers, cfg.d_head
    return {"q, k, v": L * 2 * b * d * (cfg.n_heads + 2 * cfg.n_kv_heads)
            * dh,
            "wo": L * 2 * b * cfg.n_heads * dh * d,
            "attention": L * 2 * (2 * b * cfg.n_heads * dh * s),
            "mlp": L * 3 * (2 * b * d * cfg.d_ff),
            "unembed": 2 * b * d * cfg.vocab_padded}


def test_decode_flops(reference):
    """Batch 4 on (2, 4): the batch over ``data`` (two rows a rank), the
    positions over ``model`` (4 of 16 a rank). Every product runs on the
    rank's rows and its column (or row) block of the weight, and the
    attention on its rows and positions: each term / 8, the reference's
    split."""
    label = "qwen3-1.7b/decode"
    one = reference[f"{label}@1x1"]
    terms = decode_terms(label)
    assert near(port_flops(label, "1x1"), one)
    assert near(sum(terms.values()), one)
    split = reference[f"{label}@2x4"]
    assert split == one / 8
    assert near(port_flops(label, "2x4"),
                sum(t / 8 for t in terms.values()))


def test_decode_flops_one_request(reference):
    """Batch 1 on (2, 4): the positions over ``data`` (8 of 16 a rank),
    the 4 heads over ``model`` (one a rank, against its kv head in the
    rank's block). The products run on the rank's column (or row) block,
    the one row whole (/ 4), the attention on its head and positions
    (/ 8); at or under the reference's count."""
    label = "qwen3-1.7b/decode1"
    one = reference[f"{label}@1x1"]
    terms = decode_terms(label)
    assert near(port_flops(label, "1x1"), one)
    assert near(sum(terms.values()), one)
    want = sum(t / (8 if name == "attention" else 4)
               for name, t in terms.items())
    got = port_flops(label, "2x4")
    assert near(got, want)
    assert got <= reference[f"{label}@2x4"]


@pytest.mark.parametrize("arch,shape", PRODUCTION_DECODE)
def test_production_mesh_decode_flops(reference, arch, shape):
    """Per card on the (16, 16) mesh: the decode step's flops at or under
    the reference's (long_500k: the heads over ``model`` against each
    rank's cache block; the MoE's router and experts on the rank's
    share), its arguments the reference's (less its int32 ``len``) and
    its temp at or under the reference's."""
    key = f"{arch}/{shape}@16x16"
    got = port_production_cell(arch, shape)
    assert got["cost"].flops <= reference[key], (got["cost"].flops,
                                                 reference[key])
    mem = got["memory_analysis"]
    assert mem["argument_size_in_bytes"] == reference[f"{key}/args"] - 4
    assert mem["temp_size_in_bytes"] <= reference[f"{key}/temp"]


def test_schnet_flops(reference):
    label = "schnet/train"
    cfg = get_arch("schnet").make_smoke_config()
    n, d, inter = GNN_TRAIN["n_nodes"], cfg.d_hidden, cfg.n_interactions
    node = 2 * n * d * d
    math = inter * node + 2 * n * (d // 2)
    one = reference[f"{label}@1x1"]
    assert near(port_flops(label, "1x1"), one + math)
    split = reference[f"{label}@2x4"]
    assert split == one / 2                 # rows over data, model idle
    rows = 3 * inter * node * (1 - 1 / 2) - 2 * inter * node * (1 / 2 - 1 / 8)
    assert near(port_flops(label, "2x4"), split + math / 2 + rows)


def test_schnet_temp_at_or_under_reference(reference):
    """SchNet's smoke train step on the (2, 4) mesh: the rows' split
    halves the step's tables on each card, and the count holds no tensor
    of DTensor's sharding propagation (softplus's backward is propagated
    through its decomposition at the global shape), so its temp is at or
    under the reference's."""
    got = port_cell("schnet/train", "2x4")["memory_analysis"]
    assert 0 < got["temp_size_in_bytes"] <= reference["schnet/train@2x4/temp"]


def test_memory_analysis_keys():
    """Every cell's memory analysis: the reference's keys, the arguments
    each storage once, the decode cache written in place (aliased)."""
    res = port_cell("qwen3-1.7b/decode", "2x4")["memory_analysis"]
    assert set(res) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "alias_size_in_bytes", "temp_size_in_bytes"}
    cfg, b, s = _lm("qwen3-1.7b/decode")
    cache = 2 * cfg.n_layers * b * cfg.n_kv_heads * s * cfg.d_head * 2
    assert res["alias_size_in_bytes"] == cache // 8
    for label in ("dien/train", "llama3.2-1b/train"):
        res = port_cell(label, "2x4")["memory_analysis"]
        assert res["alias_size_in_bytes"] == 0     # AdamW returns new state
        assert 0 < res["output_size_in_bytes"] <= res["argument_size_in_bytes"]
        assert res["temp_size_in_bytes"] >= res["output_size_in_bytes"]


# ---------------------------------------------------------------------------
# The GNN cells' collectives
# ---------------------------------------------------------------------------

def gnn_whole(arch: str, n_d: int = 2) -> dict:
    """The bytes by kind of ``models/gnn.py``'s collectives in ``arch``'s
    smoke train step on a mesh with a data axis of ``n_d``, every gather
    and scatter whole and the rows not constrained (smoke): a gather from a
    table split over data all-gathers its N / n_d rows a rank (the gathers
    of one call share it) and reduce-scatters its whole gradient table; a
    gather from a replicated table all-reduces its gradient; a scatter
    all-reduces its whole table. Checkpointed code runs forward twice
    (the replay); the first layer reads the node features' split rows, a
    later one the replicated aggregate.
      * GAT (L = 2 layers, H heads): layer 1 gathers [e_src | e_dst] and h
        ([N, 2H] and [N, H·D]) from split tables; the maxes and
        denominators ([N, H]) and the aggregate are scattered a layer; the
        softmax's two gathers and layer 2's three read replicated tables;
      * SchNet (I interactions): the positions (3 wide, no gradient) once,
        each interaction's x[src] and its scatter forward twice, the atom
        embedding's gradient [n_atom_types, d], the per-graph sum;
      * DimeNet (B blocks, T = 4E triplets): the positions, h[src] and
        h[dst] (one table), the edge directions and radial bases once a
        step (no gradient); each block's m_kj gathered and its aggregate
        [E, d] scattered forward twice, its two chunk norms (3 column sums)
        in the forward, the block's replay and the chunk's, and its two
        weights' gradients; the per-node and per-graph energies;
      * MeshGraphNet (L layers): the positions once, each layer's h[src]
        and h[dst] (one table) and its scatter forward twice."""
    cfg = get_arch(arch).make_smoke_config()
    n, e, graphs = (GNN_TRAIN[k] for k in ("n_nodes", "n_edges", "n_graphs"))
    rows, edges = n // n_d, e // n_d
    if arch == "gat-cora":
        h, w1 = cfg.n_heads, cfg.n_heads * cfg.d_hidden
        wl = cfg.n_heads * cfg.n_classes
        ag, rs = rows * (2 * h + w1), n * (2 * h + w1)
        ar = n * ((4 * h + w1) + (4 * h + wl) + (2 * h + wl))
    elif arch == "schnet":
        d, i = cfg.d_hidden, cfg.n_interactions
        ag, rs = rows * (3 + 2 * i * d), i * n * d
        ar = 2 * i * n * d + cfg.n_atom_types * d + graphs
    elif arch == "dimenet":
        d, b = cfg.d_hidden, cfg.n_blocks
        sbf = cfg.n_spherical * cfg.n_radial
        ag = (rows * (3 + d) + edges * (3 + cfg.n_radial)
              + 2 * b * edges * d)
        rs = n * d + b * e * d
        ar = (2 * b * e * d + 3 * 2 * 3 * b
              + b * (sbf * cfg.n_bilinear + d * cfg.n_bilinear * d)
              + n + graphs + cfg.n_atom_types * d)
    else:
        d, layers = cfg.d_hidden, cfg.n_layers
        ag, rs, ar = rows * (3 + 2 * layers * d), layers * n * d, \
            2 * layers * n * d
    return {"all-gather": 4 * ag, "reduce-scatter": 4 * rs,
            "all-reduce": 4 * ar}


def mgn_blocks(n_d: int = 2, m: int = 4) -> dict:
    """The bytes by kind of ``models/gnn.py``'s collectives in
    MeshGraphNet's smoke step on an (n_d, m) mesh, every gather and scatter
    by blocks: each data rank's E / n_d index rows cut into m pieces of q
    rows, each rank's node block N / n_d rows.
      * a gather of tables w wide (the positions [3 | 3], no gradient;
        h[src] and h[dst], [d | d]): each index's piece all-gathered over
        data (q int32), the pieces' rows [n_d·q, w] reduce-scattered over
        data and the rank's [q, w] all-gathered over model; its gradient
        [q, w] all-gathered over data and the node block [N / n_d, d]
        all-reduced over model;
      * a scatter (d wide): its index's piece and the values' [q, d]
        all-gathered over data, the node block all-reduced over model; its
        gradient [n_d·q, d] reduce-scattered over data and [q, d]
        all-gathered over model.
    Each layer runs forward twice (its replay)."""
    cfg = get_arch("meshgraphnet").make_smoke_config()
    d, layers = cfg.d_hidden, cfg.n_layers
    n, e = GNN_TRAIN["n_nodes"], GNN_TRAIN["n_edges"]
    q = -(-(e // n_d) // m)
    ag = 2 * q + 6 * q + layers * (2 * (3 * q + 3 * q * d) + 3 * q * d)
    rs = n_d * q * 6 + layers * (2 * n_d * q * 2 * d + n_d * q * d)
    ar = 3 * layers * (n // n_d) * d
    return {"all-gather": 4 * ag, "reduce-scatter": 4 * rs,
            "all-reduce": 4 * ar}


@pytest.mark.parametrize("arch", GNNS)
def test_gnn_smoke_collectives(reference, arch):
    """The GNN smoke cells on the (2, 4) mesh take the whole layout (at 64
    nodes and 256 edges the whole table moves fewer rows than the blocks,
    ``gnn._blocks_cheaper``): ``models/gnn.py``'s collectives are
    ``gnn_whole``'s to the byte, and the step's collectives (with
    DTensor's: the parameters' gradients, the loss) at or under the
    reference's. At one rank nothing is exchanged."""
    own, total = gnn_collectives(arch)
    assert own == gnn_whole(arch)
    assert total <= reference[f"{arch}/train@2x4/coll"], total
    assert port_cell(f"{arch}/train", "1x1")["cost"].collective_bytes == 0
    assert reference[f"{arch}/train@1x1/coll"] == 0


def test_mgn_blocks_collectives(reference):
    """MeshGraphNet's smoke step on the (2, 4) mesh with every gather and
    scatter by blocks: ``models/gnn.py``'s collectives are ``mgn_blocks``'
    to the byte, and the step's at or under the reference's (which splits
    its gathers and scatters the same way)."""
    own, total = gnn_collectives("meshgraphnet", blocks=True)
    assert own == mgn_blocks()
    assert total <= reference["meshgraphnet/train@2x4/coll"], total


@pytest.mark.parametrize("arch,shape", PRODUCTION_GNN)
def test_production_gnn_collectives(reference, arch, shape):
    """MeshGraphNet's and GAT's ``minibatch_lg`` cells on the (16, 16) mesh
    at their full configs: the port's collective bytes a card (its gathers
    and scatters by blocks) at or under the reference's."""
    got = port_gnn_production_cell(arch, shape)["cost"]
    want = reference[f"{arch}/{shape}@16x16/coll"]
    assert 0 < got.collective_bytes <= want, (got.collective_bytes, want)
