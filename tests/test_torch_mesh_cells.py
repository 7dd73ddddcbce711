"""The sharded cells of ``train/step.py`` (``build_cell(..., mesh)``: the
state and inputs as DTensors placed by ``distributed/sharding.py``) against
``repro`` on the CPU.

Eight gloo ranks on the (2, 4) ``("data", "model")`` host mesh are started
once for the module (``tests/torch_mesh_ranks.py``, rendezvous through a
``FileStore`` under ``tmp_path``: no TCP port). Each runs one step of
every case on the same starting state, drawn here from the reference
(``params_from_reference`` weights under the port's names), and on the
first synthetic batch, which both packages draw bit-equal:
  * qwen3-1.7b's smoke train cell, the reference test's step
    (``tests/test_distributed.py``), in float32 from step 1999 with
    mid-training moments (``test_torch_lm_cells.moments``);
  * moonshot's, with ``act_batch_axes``, ``act_seq_axis`` and
    ``moe_expert_axis`` set: the MoE runs ``moe_block_shard_map``, whose
    capacity is counted per data shard. A 1-device reference routes all
    tokens as one shard, so the reference's step is taken per data shard
    (its ``lm_loss`` and gradient on each half of the batch under its
    ``shard_map``, averaged, then its AdamW), which is the reference's
    step at (2, 4): GSPMD does not change the math. Each rank's routing of
    each MoE layer is held bit-equal to the reference's ``local_fn``
    formula on the same token table;
  * moonshot's prefill with its batch and expert axes set, against the
    reference's prefill cell on each data shard;
  * the four GNN smoke train cells with their rows constrained over
    ``data`` (``constrain=True``; the reference's constraints do not
    change its math, so its smoke cell is the reference), GAT with random
    attention vectors (``test_torch_gnn._train_params``), from step 5000;
  * DIEN's smoke train cell with its tables' rows split over ``model``
    (the ``embed_bag`` kernel's plain version on the rank's rows), from
    step 250;
  * qwen3's decode cell, three steps from an empty cache, its batch over
    ``data`` and positions over ``model`` (batch 4), or its positions over
    ``data`` (batch 1), against the reference's ``decode_step``.
Every rank's loss and grad norm must be the same; rank 0 gathers the new
parameters, m and v whole.

In this process, at one rank (a world-1 gloo group): each family's mesh
cell equals its no-mesh cell, and the placement helpers hold their
contracts (a constraint handed a plain tensor raises; on ``meta`` the
state comes back as ``Sharded`` pairs).

Tolerances, float32: the LM loss, grad norm, parameters, m and v within
1e-5 of each leaf's scale and the logits likewise; the GNNs' loss and
grad norm within 1e-5, parameters, m and v within 1e-5 absolute and
relative, m and v also within 1e-4 of each leaf's scale, and the
parameters' change within ``test_torch_gnn.DELTA_RTOL`` (1e-3) of its
scale plus two ulps of the leaf (Adam divides each gradient entry by its
own root mean square, so an entry far below its leaf's largest carries
its rounding into a full-size step); DIEN's as the GNNs'. Sharded contractions sum in other orders, so no float is held
bit-equal; the MoE routing is.
"""
import dataclasses
import functools
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

from repro.configs import get_arch as jax_get_arch
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.launch.train import synthetic_batches as jax_batches
from repro.models import dien as jd
from repro.models import transformer as jt
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.schedule import cosine_schedule as jax_cosine
from repro.train import step as jax_step
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as shr
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import smoke_spec, synthetic_batches
from repro_torch.models import gnn as tg
from repro_torch.models import transformer as tt
from repro_torch.train.step import build_cell
from test_torch_distributed import reference_local_route
from test_torch_gnn import DELTA_RTOL, _train_params, named
from test_torch_lm_cells import moments
from test_torch_transformer import (assert_close, flat_reference_tree,
                                    reference_params, scaled_err)
from test_torch_transformer import one_torch_thread  # noqa: F401 (autouse)
from torch_mesh_ranks import (DECODE_LEN, DECODE_STEPS, FIELDS, GNN_ARCHS,
                              LM_SHAPE, PREFILL_FIELDS)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 8
N_DATA = 2
LM_START = 1999
GNN_START = 5000
DIEN_START = 250
LM_TOL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
SCALED = 1e-4
DIEN_SHAPE = dict(kind="train", batch=16)


def jax_lm_config(arch: str, **fields):
    return dataclasses.replace(jax_get_arch(arch).make_smoke_config(),
                               dtype=jnp.float32, **fields)


def ambient(mesh):
    """The reference's ambient mesh for its bare ``PartitionSpec``
    constraints (``jax.set_mesh``, or the mesh itself on older JAX)."""
    return getattr(jax, "set_mesh", lambda m: m)(mesh)


# ---------------------------------------------------------------------------
# The job: each case's starting state
# ---------------------------------------------------------------------------

def lm_start(arch: str):
    """(params, m, v) under the port's names: the reference's float32
    weights and mid-training moments."""
    flat = flat_reference_tree(reference_params(arch, "float32"))
    params = {k: np.asarray(v, np.float32) for k, v in flat.items()}
    mv = moments(sorted((k, v.shape) for k, v in params.items()))
    return params, {k: a for k, (a, _) in mv.items()}, \
        {k: b for k, (_, b) in mv.items()}


@functools.cache
def gnn_start(arch: str) -> dict:
    return named(_train_params(arch, jax_get_arch(arch).make_smoke_config()))


@functools.cache
def dien_start() -> dict:
    cfg = jax_get_arch("dien").make_smoke_config()
    return named(jd.dien_init(cfg, jax.random.key(0)))


def decode_tokens() -> np.ndarray:
    return np.random.default_rng(4).integers(0, 256, (DECODE_STEPS, 4)
                                             ).astype(np.int32)


def prefill_tokens() -> np.ndarray:
    return np.random.default_rng(5).integers(
        0, 256, (LM_SHAPE["batch"], LM_SHAPE["seq"])).astype(np.int32)


def job() -> dict:
    out = {"prefill/tokens": prefill_tokens(),
           "decode/tokens": decode_tokens()}
    for case, (arch, _) in FIELDS.items():
        p, m, v = lm_start(arch)
        out.update({f"{case}/p/{k}": a for k, a in p.items()})
        out.update({f"{case}/m/{k}": a for k, a in m.items()})
        out.update({f"{case}/v/{k}": a for k, a in v.items()})
        out[f"{case}/start"] = np.array(LM_START)
    for arch in GNN_ARCHS:
        out.update({f"gnn/{arch}/p/{k}": a
                    for k, a in gnn_start(arch).items()})
        out[f"gnn/{arch}/start"] = np.array(GNN_START)
    out.update({f"dien/p/{k}": a for k, a in dien_start().items()})
    out["dien/start"] = np.array(DIEN_START)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 8 ranks' results, rank by rank."""
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    np.savez(tmp / "job.npz", **job())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"), str(r),
         str(WORLD), str(tmp / "store"), str(tmp / "job.npz"), str(tmp)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, "\n".join(errs)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# The reference's steps
# ---------------------------------------------------------------------------

def _tree(flat: dict) -> dict:
    """A flat LM dict under the port's names as the reference's tree."""
    out = {"layers": {}}
    for k, v in flat.items():
        if k.startswith("layers."):
            out["layers"][k.removeprefix("layers.")] = jnp.asarray(v)
        else:
            out[k] = jnp.asarray(v)
    return out


def _lm_batch(arch: str, jc):
    spec = jax_get_arch(arch)
    _, batch = next(jax_batches(spec, LM_SHAPE, jc))
    return batch


@functools.cache
def reference_lm_step(case: str):
    """The reference's step of ``case``: (loss, grad norm, {part: leaves}).
    With the expert axis set, per data shard (see the module's
    docstring)."""
    arch, fields = FIELDS[case]
    jc = jax_lm_config(arch, **fields)
    p, m, v = lm_start(arch)
    params = _tree(p)
    opt = jax_adamw_init(params)
    opt["m"], opt["v"] = _tree(m), _tree(v)
    opt["step"] = jnp.int32(LM_START)
    batch = _lm_batch(arch, jc)
    if not fields.get("moe_expert_axis"):
        step_fn, _, _ = jax_step.lm_train_cell(
            jc, jax_host_mesh(), batch=LM_SHAPE["batch"],
            seq=LM_SHAPE["seq"], fsdp=jax_get_arch(arch).fsdp)
        state, metrics = jax.jit(step_fn)({"params": params, "opt": opt},
                                          batch)
        new_params, new_opt = state["params"], state["opt"]
        loss, gn = metrics["loss"], metrics["grad_norm"]
    else:
        mesh = jax_host_mesh()
        jt.set_lm_mesh(mesh)
        rows = LM_SHAPE["batch"] // N_DATA

        def loss_fn(pp, tok, tgt):
            return jt.lm_loss(jc, pp, tok, tgt)
        with ambient(mesh):
            grad_fn = jax.jit(jax.value_and_grad(loss_fn))
            parts = [grad_fn(params, batch["tokens"][i * rows:(i + 1) * rows],
                             batch["targets"][i * rows:(i + 1) * rows])
                     for i in range(N_DATA)]
        jt.set_lm_mesh(None)
        loss = sum(l for l, _ in parts) / N_DATA
        grads = jax.tree.map(lambda *g: sum(g) / N_DATA,
                             *[g for _, g in parts])
        lr = jax_cosine(opt["step"], peak_lr=3e-4, warmup=2000,
                        total=120_000)
        new_params, new_opt, gn = jax_adamw_update(grads, opt, lr,
                                                   compute_dtype=jc.dtype)
    leaves = {"p": flat_reference_tree(new_params),
              "m": flat_reference_tree(new_opt["m"]),
              "v": flat_reference_tree(new_opt["v"])}
    return float(loss), float(gn), leaves


@functools.cache
def reference_prefill() -> np.ndarray:
    """The reference's prefill cell on each data shard's rows."""
    arch = "moonshot-v1-16b-a3b"
    jc = jax_lm_config(arch, **PREFILL_FIELDS)
    mesh = jax_host_mesh()
    rows = LM_SHAPE["batch"] // N_DATA
    step_fn, _, _ = jax_step.lm_prefill_cell(
        jc, mesh, batch=rows, seq=LM_SHAPE["seq"],
        fsdp=jax_get_arch(arch).fsdp)
    params = _tree(lm_start(arch)[0])
    toks = prefill_tokens()
    with ambient(mesh):
        fn = jax.jit(step_fn)
        out = [np.asarray(fn(params, {"tokens": jnp.asarray(
            toks[i * rows:(i + 1) * rows])})) for i in range(N_DATA)]
    jt.set_lm_mesh(None)
    return np.concatenate(out)


@functools.cache
def reference_decode(batch: int) -> list:
    jc = jax_lm_config("qwen3-1.7b")
    params = _tree(lm_start("qwen3-1.7b")[0])
    cache = jt.init_kv_cache(jc, batch, DECODE_LEN)
    step = jax.jit(functools.partial(jt.decode_step, jc))
    out = []
    for tok in decode_tokens()[:, :batch]:
        logits, cache = step(params, jnp.asarray(tok), cache)
        out.append(np.asarray(logits))
    return out


def _named_tree(tree) -> dict:
    return {k: np.asarray(v) for k, v in named(tree).items()}


@functools.cache
def reference_cell_step(case: str):
    """The reference's smoke train cell (GNN or DIEN): one step from the
    case's start."""
    if case == "dien":
        base = jax_get_arch("dien")
        spec = dataclasses.replace(base, shapes={"smoke": DIEN_SHAPE})
        params0, start = dien_start(), DIEN_START
        cfg = spec.make_smoke_config()
        tree = jd.dien_init(cfg, jax.random.key(0))
    else:
        arch = case.removeprefix("gnn/")
        base = jax_get_arch(arch)
        cfg = base.make_smoke_config()
        shape = smoke_spec(get_arch(arch), get_arch(arch).make_smoke_config()
                           ).shapes["smoke"]
        spec = dataclasses.replace(base, shapes={"smoke": shape})
        params0, start = gnn_start(arch), GNN_START
        tree = _train_params(arch, cfg)
    step_fn, _, _ = jax_step.build_cell(spec, "smoke", jax_host_mesh(),
                                        smoke=True)
    opt = jax_adamw_init(tree)
    opt["step"] = jnp.int32(start)
    _, batch = next(jax_batches(spec, spec.shapes["smoke"], cfg))
    state, metrics = jax.jit(step_fn)({"params": tree, "opt": opt}, batch)
    leaves = {"p": _named_tree(state["params"]),
              "m": _named_tree(state["opt"]["m"]),
              "v": _named_tree(state["opt"]["v"])}
    return (float(metrics["loss"]), float(metrics["grad_norm"]), leaves,
            params0)


# ---------------------------------------------------------------------------
# Eight ranks
# ---------------------------------------------------------------------------

def _same_on_every_rank(ranks, key):
    vals = [r[key] for r in ranks]
    assert all(np.array_equal(v, vals[0]) for v in vals), (key, vals)
    return float(vals[0])


@pytest.mark.parametrize("case", list(FIELDS))
def test_lm_train_step_eight_ranks(ranks, case):
    loss, gn, want = reference_lm_step(case)
    assert_close(np.float64(_same_on_every_rank(ranks, f"{case}/loss")),
                 np.float64(loss), LM_TOL, f"{case} loss")
    assert_close(np.float64(_same_on_every_rank(ranks, f"{case}/gn")),
                 np.float64(gn), LM_TOL, f"{case} grad norm")
    assert int(ranks[0][f"{case}/step"]) == LM_START + 1
    for part, leaves in want.items():
        assert {k[len(f"{case}/{part}/"):] for k in ranks[0]
                if k.startswith(f"{case}/{part}/")} == set(leaves)
        for k, w in leaves.items():
            assert_close(ranks[0][f"{case}/{part}/{k}"], w, LM_TOL,
                         f"{case} {part} {k}")


def test_moe_routing_eight_ranks(ranks):
    """Each rank's routing of both MoE layers, bit-equal to the
    reference's ``local_fn`` formula on the rank's token table."""
    jc = jax_lm_config(*FIELDS["moonshot"][:1], **FIELDS["moonshot"][1])
    router = lm_start("moonshot-v1-16b-a3b")[0]["layers.router"]
    kept = 0
    for r, res in enumerate(ranks):
        for layer in range(jc.n_layers):
            tag = f"moonshot/route/{layer}"
            ridx = int(res[f"{tag}/ridx"])
            assert ridx == int(res["coordinate"][1])
            x = res[f"{tag}/x"]
            assert x.shape == (LM_SHAPE["batch"] // N_DATA * LM_SHAPE["seq"],
                               jc.d_model)
            le, pos, keep, cap = reference_local_route(
                jnp.asarray(x), jnp.asarray(router[layer]), jc, ridx,
                jc.n_experts // (WORLD // N_DATA))
            assert int(res[f"{tag}/cap"]) == cap
            for name, want in (("keep", keep), ("local_e", le),
                               ("pos", pos)):
                assert np.array_equal(res[f"{tag}/{name}"],
                                      np.asarray(want)), (r, layer, name)
            kept += int(np.asarray(keep).sum())
    assert kept > 0


def test_moonshot_prefill_eight_ranks(ranks):
    want = reference_prefill()
    for r, res in enumerate(ranks):
        assert_close(res["moonshot_prefill/logits"], want, LM_TOL,
                     f"prefill logits rank {r}")


def _close_to_scale(got, want, rtol, what, floor=0.0):
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(want, np.float64)).max())
    scale = float(np.abs(want).max())
    assert err <= rtol * scale + floor, f"{what}: {err:.3e} vs {scale:.3e}"


def _hold_cell(ranks, case):
    loss, gn, want, params0 = reference_cell_step(case)
    np.testing.assert_allclose(_same_on_every_rank(ranks, f"{case}/loss"),
                               loss, **TOL)
    np.testing.assert_allclose(_same_on_every_rank(ranks, f"{case}/gn"),
                               gn, **TOL)
    res = ranks[0]
    for k, w in want["p"].items():
        got = res[f"{case}/p/{k}"]
        np.testing.assert_allclose(got, w, **TOL, err_msg=k)
        p0 = np.asarray(params0[k], np.float64)
        _close_to_scale(got - p0, w - p0, DELTA_RTOL,
                        f"{case} change of {k}",
                        floor=2 * float(np.spacing(np.float32(
                            np.abs(p0).max()))))
    for part in ("m", "v"):
        for k, w in want[part].items():
            got = res[f"{case}/{part}/{k}"]
            np.testing.assert_allclose(got, w, **TOL, err_msg=f"{part} {k}")
            _close_to_scale(got, w, SCALED, f"{case} {part} {k}")


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_train_step_eight_ranks(ranks, arch):
    _hold_cell(ranks, f"gnn/{arch}")


def test_dien_train_step_eight_ranks(ranks):
    _hold_cell(ranks, "dien")


@pytest.mark.parametrize("batch", (4, 1))
def test_decode_eight_ranks(ranks, batch):
    want = reference_decode(batch)
    for r, res in enumerate(ranks):
        assert int(res[f"decode/{batch}/len"]) == DECODE_STEPS
        for i, w in enumerate(want):
            assert_close(res[f"decode/{batch}/{i}"], w, LM_TOL,
                         f"decode batch {batch} step {i} rank {r}")


# ---------------------------------------------------------------------------
# One rank, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def world_one():
    """A world-1 gloo group in this process, destroyed after the test."""
    mesh = make_host_mesh(device_type="cpu")
    yield mesh
    dist.destroy_process_group()


def _one_step(spec, cfg, mesh):
    step_fn, state, _ = build_cell(spec, "smoke", mesh, smoke=True,
                                   device="cpu")
    state["opt"]["step"] = torch.tensor(3000, dtype=torch.int32)
    _, batch = next(synthetic_batches(spec, spec.shapes["smoke"], cfg,
                                      device="cpu"))
    state, metrics = step_fn(state, batch)

    def whole(t):
        return (t.full_tensor() if shr.is_dtensor(t) else t).detach()
    return metrics, {k: whole(p) for k, p in
                     state["params"].named_parameters()}


WORLD_ONE = ("qwen3-1.7b", "moonshot-v1-16b-a3b", "schnet", "dien")


@pytest.mark.parametrize("arch", WORLD_ONE)
def test_world_one_mesh_cell_equals_no_mesh(world_one, arch):
    """At one rank every block is the whole tensor: the mesh cell's step
    gives the no-mesh cell's loss, grad norm and parameters (moonshot with
    its three mesh fields set, the expert-parallel path)."""
    base = get_arch(arch)
    cfg = base.make_smoke_config()
    if base.family == "lm":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    spec = smoke_spec(base, cfg)
    plain = dataclasses.replace(spec, make_smoke_config=lambda: cfg)
    fields = FIELDS["moonshot"][1] if base.family == "lm" \
        and cfg.is_moe else {}
    mcfg = dataclasses.replace(cfg, **fields)
    meshed = dataclasses.replace(spec, make_smoke_config=lambda: mcfg)
    want, wp = _one_step(plain, cfg, None)
    got, gp = _one_step(meshed, mcfg, world_one)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)
    assert set(gp) == set(wp)
    for k, w in wp.items():
        torch.testing.assert_close(gp[k], w, rtol=1e-6, atol=1e-6,
                                   msg=k)


HELPERS = {
    "_constrain_act": dict(act_batch_axes=("data",)),
    "_constrain_moe_tokens": dict(act_seq_axis="model"),
    "_constrain_moe_buckets": dict(moe_expert_axis="model"),
    "_gather_moe_weight": dict(moe_expert_axis="model"),
}


@pytest.mark.parametrize("helper", HELPERS)
def test_constraint_on_a_plain_tensor_raises(world_one, helper):
    """An axis field set and a plain tensor: the helper raises; with the
    field unset it returns the tensor; on a DTensor it places it."""
    cfg = get_arch("moonshot-v1-16b-a3b").make_smoke_config()
    fn = getattr(tt, helper)
    x = torch.zeros((4, 8, 8))
    assert fn(cfg, x) is x
    with_fields = dataclasses.replace(cfg, **HELPERS[helper])
    with pytest.raises(TypeError, match="DTensor"):
        fn(with_fields, x)
    from torch.distributed.tensor import distribute_tensor
    d = distribute_tensor(x, world_one, shr.NamedSharding(
        world_one, shr.P()).placements)
    y = fn(with_fields, d if helper != "_constrain_moe_tokens"
           else d.reshape(32, 8))
    assert shr.is_dtensor(y) and any(p.is_shard() for p in y.placements)


def test_gnn_rows_on_a_plain_tensor_raise():
    tg.set_gnn_data_axes(("data",))
    try:
        with pytest.raises(TypeError, match="DTensor"):
            tg._constrain_rows(torch.zeros(4, 2))
    finally:
        tg.set_gnn_data_axes(())
    x = torch.zeros(4, 2)
    assert tg._constrain_rows(x) is x


@pytest.mark.parametrize("arch,shape", [("qwen3-1.7b", "train_4k"),
                                        ("dien", "train_batch"),
                                        ("gat-cora", "ogb_products")])
def test_meta_mesh_cell_gives_sharded_pairs(arch, shape):
    """On ``meta`` over the (16, 16) mesh (a fake group): every state leaf
    and input is a ``Sharded`` pair whose block divides; AdamW's moments
    and master copy are placed as their parameter, its step replicated."""
    from repro_torch.launch.mesh import make_production_mesh
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        _, state, inputs = build_cell(get_arch(arch), shape, mesh,
                                      device="meta")
        params, opt = state["params"], state["opt"]
        assert params and all(isinstance(v, shr.Sharded)
                              for v in params.values())
        for part in ("m", "v", "master"):
            assert {k: v.sharding for k, v in opt[part].items()} == \
                {k: v.sharding for k, v in params.items()}
        assert opt["step"].sharding.spec == shr.P()
        for v in inputs.values():
            for leaf in (v.values() if isinstance(v, dict) else (v,)):
                assert isinstance(leaf, shr.Sharded)
                leaf.sharding.local_shape(tuple(leaf.tensor.shape))
    assert not dist.is_initialized()


def test_dimenet_triplet_chunks_over_a_data_split(world_one, monkeypatch):
    """DimeNet's triplet chunks on a mesh: each chunk's triplets are split
    over the data axes (``gnn._chunk_rows``), so a chunk count the data
    split does not divide runs. At one rank the two-chunk mesh step equals
    the two-chunk step with no mesh."""
    monkeypatch.setattr(tg, "_pick_chunks", lambda t, _target: 2)
    base = get_arch("dimenet")
    cfg = base.make_smoke_config()
    spec = smoke_spec(base, cfg)
    want, wp = _one_step(spec, cfg, None)
    got, gp = _one_step(spec, cfg, world_one)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)
    for k, w in wp.items():
        torch.testing.assert_close(gp[k], w, rtol=1e-6, atol=1e-6, msg=k)


def test_dimenet_chunk_count_not_divided_by_the_data_axis(monkeypatch):
    """Two triplet chunks over a data axis of 4 (a (4, 2) mesh on a fake
    world of 8, on ``meta``): the step runs (DTensor alone cannot view the
    split triplet ids as 2 chunks), each chunk's triplets split 4 ways."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.cost_analysis import analyze_cell
    monkeypatch.setattr(tg, "_pick_chunks", lambda t, _target: 2)
    base = get_arch("dimenet")
    spec = smoke_spec(base, base.make_smoke_config())
    with fake_world(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                          mesh_dim_names=("data", "model"))
        got = analyze_cell(spec, "smoke", mesh, smoke=True)
    assert got["cost"].flops > 0
    assert got["cost"].per_collective["all-gather"] > 0
    assert not dist.is_initialized()
