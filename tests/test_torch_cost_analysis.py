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
against a 16-position cache). The reference is compiled in one
subprocess with 8 host devices on a (1, 1) and a (2, 4) ``("data",
"model")`` mesh and read by ``hlo_analysis.analyze``; the port runs
``analyze_cell`` on a fake world of 1 or 8 with the same mesh. Every
comparison is within 1% (``REL``).

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
On the (2, 4) mesh the reference splits every LM product over the 8
cards (llama3.2-1b and qwen3-1.7b: its (2, 4) count is its (1, 1) count /
8 to the flop; minicpm, moonshot and dbrx split theirs less evenly,
so the port is held to their (1, 1) count / 8 there). The port runs on
the rank's rows only (÷ n_d, not ÷ n):
  * the loss: each rank's rows against the whole unembedding, its four
    products (forward, replay, two gradients);
  * attention, where the model axis divides neither head count (llama,
    qwen3, minicpm, dbrx smoke: 2 or 6 kv heads on 4): heads whole on
    every model rank;
  * the products that read a gradient DTensor leaves as a partial sum over
    the model axis (the reference reduces it first): dense, wo's two
    gradient products in every layer and w_down's in every layer but the
    last; MoE, wo's in every layer but the last (its weight gradient in
    every layer where heads are whole);
and the router's four products (forward, replay, two gradients) run on
the whole token table on every card (the MoE without an expert axis).
The decode step (no activation constraint, as in the reference) leaves
the residual a partial sum over the model axis after the first
attention's output product: gate and up in every layer, q, k, v after the
first, and the unembedding run on the rank's rows. SchNet at smoke (rows
not constrained) gets its aggregates whole on every card from each
scatter: three node products an interaction (w_out's two and its replay)
run whole, and w_out's two gradient products an interaction on a
gradient split over both axes (÷ n).
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import get_arch
from repro_torch.kernels.embed_bag.ops import embed_bag
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.dryrun import fake_world

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
         "gat-cora/train": ("gat-cora", GNN_TRAIN),
         "schnet/train": ("schnet", GNN_TRAIN),
         "dien/train": ("dien", dict(kind="train", batch=16)),
         "dien/serve": ("dien", dict(kind="serve", batch=16))}
#: The reference's (2, 4) count is its (1, 1) count / 8 for these.
EVEN_REFERENCE = ("llama3.2-1b", "qwen3-1.7b")

_JAX_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import get_arch
from repro.launch.hlo_analysis import analyze
from repro.train.step import build_cell

cases, out = json.loads(sys.argv[1]), sys.argv[2]
res = {}
for mesh_name, dims in (("1x1", (1, 1)), ("2x4", (2, 4))):
    devs = np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims)
    mesh = Mesh(devs, ("data", "model"))
    for label, (arch, shape) in cases.items():
        spec = dataclasses.replace(get_arch(arch), shapes={"smoke": shape})
        step_fn, state, inputs = build_cell(spec, "smoke", mesh, smoke=True)
        with getattr(jax, "set_mesh", lambda m: m)(mesh):
            compiled = jax.jit(step_fn).lower(state, inputs).compile()
        res[f"{label}@{mesh_name}"] = analyze(compiled.as_text()).flops
with open(out, "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{"<case>@<mesh>": the reference's per-card flops}, compiled in a
    subprocess started first; the port's analyses run meanwhile."""
    tmp = tmp_path_factory.mktemp("hlo")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, json.dumps(CASES),
         str(tmp / "ref.json")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    for label in CASES:          # the port's side while the reference runs
        for mesh_name in DIMS:
            port_flops(label, mesh_name)
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

@pytest.mark.parametrize("label", ["gat-cora/train", "dien/train",
                                   "dien/serve"])
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
    """The port's per-card flops beyond an even split over n cards."""
    cfg, b, s = _lm(label)
    attn, k, loss = _lm_terms(label)
    t, d, L = b * s, cfg.d_model, cfg.n_layers
    share = 1 / n_data - 1 / n
    n_model = n // n_data
    whole_heads = bool(cfg.n_kv_heads % n_model or cfg.n_heads % n_model)
    out = 4 * loss * share                              # the loss
    if whole_heads:
        out += k * attn * share                         # attention
    wo = 2 * t * cfg.n_heads * cfg.d_head * d
    if cfg.is_moe:
        out += ((L - 1) + (L if whole_heads else L - 1)) * wo * share
        out += 4 * L * 2 * t * d * cfg.n_experts * (1 - 1 / n)   # router
    else:
        out += 2 * L * wo * share
        out += 2 * (L - 1) * 2 * t * cfg.d_ff * d * share         # w_down
    return out


@pytest.mark.parametrize("label", [f"{a}/train" for a in LMS])
def test_lm_train_flops_one_card(reference, label):
    want = reference[f"{label}@1x1"] + lm_math(label)
    assert near(port_flops(label, "1x1"), want), want


@pytest.mark.parametrize("label", [f"{a}/train" for a in LMS])
def test_lm_train_flops_per_card(reference, label):
    one = reference[f"{label}@1x1"]
    split = reference[f"{label}@2x4"]
    if label.split("/")[0] in EVEN_REFERENCE:
        assert split == one / 8
    else:
        assert split > one / 8          # the reference splits less evenly
    want = (one + lm_math(label)) / 8 + lm_partition(label)
    assert near(port_flops(label, "2x4"), want), (want, split)


def test_decode_flops(reference):
    label = "qwen3-1.7b/decode"
    one = reference[f"{label}@1x1"]
    assert near(port_flops(label, "1x1"), one)
    cfg, b, _s = _lm(label)
    d, L = cfg.d_model, cfg.n_layers
    partial = (L * 2 * (2 * b * d * cfg.d_ff)
               + (L - 1) * 2 * b * d * (cfg.n_heads + 2 * cfg.n_kv_heads)
               * cfg.d_head
               + 2 * b * d * cfg.vocab_padded)
    split = reference[f"{label}@2x4"]
    assert split == one / 8
    assert near(port_flops(label, "2x4"), split + partial * (1 / 2 - 1 / 8))


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
