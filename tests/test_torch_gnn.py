"""The four GNNs and their train cell in the port against the JAX package on
the CPU.

The same numpy inputs (the reference's ``synthetic_batches``, which the
port draws bit-equal, ``tests/test_torch_gnn_batch.py``) and the same
parameters (the reference's init, carried over with
``params_from_reference``) go through ``repro`` and ``repro_torch`` at the
smoke configs: each model's output, loss and every gradient against the
reference's jitted ``value_and_grad``, and three steps of the train cell
(parameters, m and v) against the reference's cell.

Graphs: ``SMOKE_SHAPES["gnn"]`` (64 nodes, 256 edges), the same with 255
edges (one sentinel row ``src == dst == 64``, which every scatter must drop
and every gather mask; not for DimeNet, whose reference triplet builder
fails on sentinels), and with 101 edges (the tree's edges cut: nodes with
no incoming edge, whose aggregate is 0, at ELU's and ReLU's kink). At init
GAT's attention vectors are zero, so every score sits at
``leaky_relu``'s tie at 0.

Tolerances: 1e-5 abs and rel (float32 sums in other orders: matmuls, the
scatter-adds, the global norm over leaves in pytree order against
``named_parameters`` order), and each gradient, m and v also within 1e-4
of its own largest value (most leaves lie far below 1e-5). GAT's
``a_dst`` gradients are 0 in exact arithmetic (a constant per softmax
group) and rounding on both sides: they are held below 1e-8 instead. The
parameters' change over three steps is held to 1e-3 of its own scale plus
two float32 ulps of the leaf's largest entry (see the train-cell test).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.mesh import make_host_mesh
from repro.launch.train import SMOKE_SHAPES as JAX_SMOKE_SHAPES
from repro.launch.train import synthetic_batches as jax_batches
from repro.models import gnn as jg
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.train import step as jax_step
from repro_torch.configs import get_arch
from repro_torch.launch.train import smoke_spec, synthetic_batches
from repro_torch.models import gnn as tg
from repro_torch.optim import adamw_init
from repro_torch.train.step import build_cell, gnn_loss

ARCHS = ("gat-cora", "schnet", "dimenet", "meshgraphnet")
TOL = dict(rtol=1e-5, atol=1e-5)
SCALED_RTOL = 1e-4
DELTA_RTOL = 1e-3
ZERO_GRADS = {"layers.0.a_dst", "layers.1.a_dst"}
# (n_nodes, n_edges): the smoke shape, one sentinel row, a cut tree.
GRAPHS = {"smoke": (64, 256), "sentinel": (64, 255), "cut": (64, 101)}
CASES = [(a, gname) for a in ARCHS for gname in GRAPHS
         if not (a == "dimenet" and gname == "sentinel")]


def named(tree, prefix: str = "") -> dict:
    """A reference tree's leaves under the port's ``named_parameters``
    names (the path of keys and indices)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in named(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in named(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _shape(arch, gname):
    cfg = jax_get_arch(arch).make_smoke_config()
    n, e = GRAPHS[gname]
    shape = dict(JAX_SMOKE_SHAPES["gnn"], n_nodes=n, n_edges=e)
    shape["d_feat"] = getattr(cfg, "d_in",
                              getattr(cfg, "d_in_node", shape["d_feat"]))
    return shape


def _jax_graph(shape, gb):
    return jg.GraphBatch(
        n_nodes=shape["n_nodes"], node_feat=gb["node_feat"], src=gb["src"],
        dst=gb["dst"], positions=gb.get("positions"),
        graph_id=gb["graph_id"], n_graphs=shape["n_graphs"],
        trip_in=gb.get("trip_in"), trip_out=gb.get("trip_out"))


@functools.cache
def _reference(arch, gname):
    """(params, output, loss, grads) of the reference on its first smoke
    batch, as numpy."""
    spec = jax_get_arch(arch)
    cfg = spec.make_smoke_config()
    shape = _shape(arch, gname)
    _, batch = next(jax_batches(dataclasses.replace(spec, shapes={"s": shape}),
                                shape, cfg))
    params = jax_step.gnn_make_init(arch, cfg)(cfg, jax.random.key(0))
    g = _jax_graph(shape, batch["graph"])
    fwd = {"gat-cora": jg.gat_forward, "schnet": jg.schnet_forward,
           "dimenet": jg.dimenet_forward, "meshgraphnet": jg.mgn_forward}[arch]
    out = jax.jit(lambda p: fwd(cfg, p, g))(params)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_step._gnn_forward_and_loss(arch, cfg, p, g,
                                                 batch["labels"])))(params)
    return (jax.tree.map(np.asarray, params), np.asarray(out), float(loss),
            named(jax.tree.map(np.asarray, grads)))


def _port(arch, gname, params_np):
    spec = get_arch(arch)
    cfg = spec.make_smoke_config()
    shape = _shape(arch, gname)
    _, batch = next(synthetic_batches(spec, shape, cfg, device="cpu"))
    params = tg.params_from_reference(arch, params_np, device="cpu")
    g = tg.GraphBatch(n_nodes=shape["n_nodes"], n_graphs=shape["n_graphs"],
                      **batch["graph"])
    return cfg, params, g, batch["labels"]


def close_to_scale(got, want, rtol, what, floor=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale > 0, f"{what}: the reference is all zero"
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale + floor, (
        f"{what}: max |diff| {err:.3e} against {rtol} * {scale:.3e} "
        f"+ {floor:.3e}")


def assert_grads(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        assert g.shape == w.shape, k
        if k in ZERO_GRADS:
            assert np.abs(w).max() < 1e-8 and np.abs(g).max() < 1e-8, k
            continue
        np.testing.assert_allclose(g, w, **TOL, err_msg=k)
        close_to_scale(g, w, SCALED_RTOL, k)


@pytest.mark.parametrize("arch,gname", CASES)
def test_forward_loss_and_gradients_match_jax(arch, gname):
    params_np, out_ref, loss_ref, grads_ref = _reference(arch, gname)
    cfg, params, g, labels = _port(arch, gname, params_np)
    with torch.no_grad():
        out = tg.FORWARD[arch](cfg, params, g)
    np.testing.assert_allclose(out.numpy(), out_ref, **TOL)
    params.requires_grad_()
    names, leaves = zip(*params.named_parameters())
    loss = gnn_loss(arch, cfg, params, g, labels)
    np.testing.assert_allclose(loss.item(), loss_ref, **TOL)
    assert_grads(dict(zip(names, torch.autograd.grad(loss, leaves))),
                 grads_ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_the_reference_tree(arch):
    params_np = _reference(arch, "smoke")[0]
    params = tg.params_from_reference(arch, params_np, device="cpu")
    want = named(params_np)
    assert sorted(k for k, _ in params.named_parameters()) == sorted(want)
    back = params.to_reference()
    assert jax.tree.structure(back) == jax.tree.structure(params_np)
    for k, v in named(back).items():
        np.testing.assert_array_equal(v, want[k])
    again = tg.GNNParams.from_named(dict(params.named_parameters()))
    assert jax.tree.structure(again.to_reference()) == \
        jax.tree.structure(params_np)
    assert not any(p.requires_grad for p in again.parameters())
    with pytest.raises(ValueError, match="parameter tree keys"):
        tg.params_from_reference("schnet" if arch != "schnet" else "gat-cora",
                                 params_np, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_shapes(arch):
    cfg = get_arch(arch).make_config()
    jcfg = jax_get_arch(arch).make_config()
    want = named(jax.tree.map(
        lambda s: np.empty(s.shape, s.dtype),
        jax.eval_shape(functools.partial(jax_step.gnn_make_init(arch, jcfg),
                                         jcfg), jax.random.key(0))))
    gen = torch.Generator().manual_seed(0)
    got = dict(tg.INIT[arch](cfg, generator=gen,
                             device="meta").named_parameters())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and got[k].dtype == \
            torch.float32, k
    params = tg.INIT[arch](get_arch(arch).make_smoke_config(),
                           generator=gen, device="cpu")
    assert all(torch.isfinite(p).all() for p in params.parameters())


def test_segment_softmax_and_scatter_sum_match_jax():
    """Sentinels (index == n) dropped, ties in the max, an empty segment;
    values and gradients."""
    rng = np.random.default_rng(3)
    n, e, h = 9, 40, 3
    index = rng.integers(0, n + 1, e).astype(np.int32)
    index[index == 4] = 5                           # segment 4 empty
    scores = rng.standard_normal((e, h)).astype(np.float32)
    scores[1] = scores[0]                           # a tie in a segment
    index[1] = index[0]
    cot = rng.standard_normal((e, h)).astype(np.float32)
    cot_n = rng.standard_normal((n, h)).astype(np.float32)

    def ref(s):
        a = jg.segment_softmax(s, jnp.asarray(index), n)
        return jnp.sum(a * cot) + jnp.sum(jg.scatter_sum(a, jnp.asarray(
            index), n) * cot_n)

    want_val, want_grad = jax.value_and_grad(ref)(jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_()
    idx = torch.from_numpy(index)
    a = tg.segment_softmax(s, idx, n)
    val = (a * torch.from_numpy(cot)).sum() + (
        tg.scatter_sum(a, idx, n) * torch.from_numpy(cot_n)).sum()
    (grad,) = torch.autograd.grad(val, s)
    np.testing.assert_allclose(val.item(), float(want_val), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), **TOL)
    np.testing.assert_array_equal(
        a.detach().numpy()[index == n], 0)


def test_pick_chunks_and_the_bf16_carry_rule():
    for t in (1, 7, 1024, 4 * 169984, 12_345_678, 16_777_216, 247_000_000):
        for target in (1, 5, 256, tg.TRIPLET_CHUNK):
            assert tg._pick_chunks(t, target) == jg._pick_chunks(t, target)
    f32 = torch.float32
    assert tg._carry_dtype((1 << 22) - 1, f32) == f32
    assert tg._carry_dtype(1 << 22, f32) == torch.bfloat16
    assert tg._carry_dtype(61_859_840, f32) == torch.bfloat16
    assert tg._carry_dtype(169_984, f32) == f32


@pytest.mark.parametrize("target", [256, 100])
def test_dimenet_chunked_triplets_match_jax(monkeypatch, target):
    """The multi-chunk loop (4 chunks of 256, or 8 of 128 where 100 is
    asked: the largest count <= 10 that divides 1024) against the
    reference's scan with its chunk target patched to the same value:
    outputs and gradients."""
    params_np = _reference("dimenet", "smoke")[0]
    real = jg._pick_chunks
    monkeypatch.setattr(jg, "_pick_chunks", lambda t, _: real(t, target))
    spec = jax_get_arch("dimenet")
    jcfg = spec.make_smoke_config()
    shape = _shape("dimenet", "smoke")
    _, batch = next(jax_batches(dataclasses.replace(spec, shapes={"s": shape}),
                                shape, jcfg))
    jgraph = _jax_graph(shape, batch["graph"])
    params_j = jax.tree.map(jnp.asarray, params_np)
    loss_ref, grads_ref = jax.value_and_grad(
        lambda p: jax_step._gnn_forward_and_loss(
            "dimenet", jcfg, p, jgraph, batch["labels"]))(params_j)

    cfg, params, g, labels = _port("dimenet", "smoke", params_np)
    assert tg._pick_chunks(g.trip_in.shape[0], target) > 1
    real_blocks = tg._dimenet_blocks
    monkeypatch.setattr(tg, "_dimenet_blocks",
                        functools.partial(real_blocks, chunk_target=target))
    params.requires_grad_()
    names, leaves = zip(*params.named_parameters())
    loss = gnn_loss("dimenet", cfg, params, g, labels)
    np.testing.assert_allclose(loss.item(), float(loss_ref), **TOL)
    assert_grads(dict(zip(names, torch.autograd.grad(loss, leaves))),
                 named(jax.tree.map(np.asarray, grads_ref)))
    # The chunk-wide norm makes the chunking visible in the output.
    with torch.no_grad():
        single = tg.dimenet_forward(cfg, params, g)
    monkeypatch.setattr(tg, "_dimenet_blocks", real_blocks)
    with torch.no_grad():
        assert not torch.equal(single, tg.dimenet_forward(cfg, params, g))


def test_dimenet_bf16_carry_runs_in_bf16(monkeypatch):
    """With the carry rule forced to bfloat16 (as from 2^22 edges), the
    blocks carry bf16 and the energies stay within bf16 rounding of the
    float32 carry."""
    params_np = _reference("dimenet", "smoke")[0]
    cfg, params, g, _ = _port("dimenet", "smoke", params_np)
    with torch.no_grad():
        want = tg.dimenet_forward(cfg, params, g)
        seen = []
        real = tg._carry_dtype

        def forced(e, dtype):
            seen.append(e)
            return torch.bfloat16
        monkeypatch.setattr(tg, "_carry_dtype", forced)
        got = tg.dimenet_forward(cfg, params, g)
    assert seen == [256] and real(256, torch.float32) == torch.float32
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-2,
                               atol=5e-2)
    assert not torch.equal(got, want)


def _train_params(arch, cfg):
    """The reference's init, but GAT's attention vectors drawn from
    N(0, 0.5^2): at their zero init every score sits on leaky_relu's kink,
    where ``a_dst``'s gradient is 0 in exact arithmetic and each side's
    rounding noise, which Adam's normalized step turns into moves of a
    random sign; the forward test covers the zero init."""
    params = jax_step.gnn_make_init(arch, cfg)(cfg, jax.random.key(0))
    if arch == "gat-cora":
        rng = np.random.default_rng(7)
        for lp in params["layers"]:
            for k in ("a_src", "a_dst"):
                lp[k] = jnp.asarray(0.5 * rng.standard_normal(lp[k].shape),
                                    jnp.float32)
    return params


@functools.cache
def _reference_steps(arch, start):
    spec = jax_get_arch(arch)
    cfg = spec.make_smoke_config()
    shape = _shape(arch, "smoke")
    spec = dataclasses.replace(spec, shapes={"smoke": shape})
    step_fn, _, _ = jax_step.build_cell(spec, "smoke", make_host_mesh(),
                                        smoke=True)
    params = _train_params(arch, cfg)
    opt = jax_adamw_init(params)
    opt["step"] = jnp.int32(start)
    state = {"params": params, "opt": opt}
    step = jax.jit(step_fn)
    losses = []
    for _, batch in zip(range(3), jax_batches(spec, shape, cfg)):
        state, metrics = step(state, batch[1])
        losses.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    to_np = functools.partial(jax.tree.map, np.asarray)
    return (to_np(params), losses, named(to_np(state["params"])),
            named(to_np(state["opt"]["m"])), named(to_np(state["opt"]["v"])),
            int(state["opt"]["step"]))


@pytest.mark.parametrize("start", [0, 5000])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_three_steps_match_jax(arch, start):
    """From step 0 (lr 0, so the first step must not move the parameters;
    then lr 1e-5 and 2e-5) and from step 5,000 (cosine, lr 5.6e-4), three
    steps of the smoke cell: loss and grad_norm each step, then
    parameters, m and v. The parameters' change is held to DELTA_RTOL of
    its own scale: Adam divides each gradient entry by its own root mean
    square, so an entry far below its leaf's largest carries its rounding
    (up to 1e-3 of itself where a float32 sum cancels) into a step of full
    size; a wrong lr, beta, bias correction or weight decay moves the
    change by a percent or more."""
    params0, losses, p_ref, m_ref, v_ref, step_ref = _reference_steps(
        arch, start)
    spec = get_arch(arch)
    cfg = spec.make_smoke_config()
    spec = smoke_spec(spec, cfg)
    step_fn, state, _ = build_cell(spec, "smoke", smoke=True, device="cpu")
    params = tg.params_from_reference(arch, params0,
                                      device="cpu").requires_grad_()
    opt = adamw_init(dict(params.named_parameters()))
    opt["step"] = torch.tensor(start, dtype=torch.int32)
    assert sorted(k for k, _ in state["params"].named_parameters()) == \
        sorted(opt["m"])
    state = {"params": params, "opt": opt}
    init = named(params0)
    batches = synthetic_batches(spec, spec.shapes["smoke"], cfg,
                                device="cpu")
    for i, ((_, batch), (loss, gn)) in enumerate(zip(batches, losses)):
        state, metrics = step_fn(state, batch)
        np.testing.assert_allclose(metrics["loss"].item(), loss, **TOL)
        np.testing.assert_allclose(metrics["grad_norm"].item(), gn, **TOL)
        if start == 0 and i == 0:
            for k, p in state["params"].named_parameters():
                np.testing.assert_array_equal(p.detach().numpy(), init[k],
                                              err_msg=k)
    assert int(state["opt"]["step"]) == step_ref
    for k, p in state["params"].named_parameters():
        assert p.requires_grad
        p = p.detach().numpy()
        np.testing.assert_allclose(p, p_ref[k], **TOL, err_msg=k)
        ulps = 2 * np.spacing(np.float32(np.abs(init[k]).max()))
        close_to_scale(p - init[k], p_ref[k] - init[k], DELTA_RTOL,
                       f"{k} change", floor=float(ulps))
    for got, want, what in ((state["opt"]["m"], m_ref, "m"),
                            (state["opt"]["v"], v_ref, "v")):
        for k, w in want.items():
            g = got[k].numpy()
            np.testing.assert_allclose(g, w, **TOL, err_msg=f"{what} {k}")
            close_to_scale(g, w, SCALED_RTOL, f"{what} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_build_cell_ogb_products_is_meta(arch):
    """The shape that does not fit one card: state and inputs on meta,
    the reference's input widths (GAT's d_in and MGN's d_in_node from
    d_feat = 100)."""
    step_fn, state, inputs = build_cell(get_arch(arch), "ogb_products",
                                        device="cpu")
    leaves = [*state["params"].parameters(), *state["opt"]["m"].values(),
              *state["opt"]["v"].values(), *state["opt"]["master"].values(),
              *inputs["graph"].values(), inputs["labels"]]
    assert all(t.device.type == "meta" for t in leaves)
    g = inputs["graph"]
    assert tuple(g["src"].shape) == (61_859_840,)
    if arch == "dimenet":
        assert tuple(g["trip_in"].shape) == (4 * 61_859_840,)
    if arch == "gat-cora":
        assert tuple(state["params"]["layers"][0]["w"].shape) == (100, 8, 8)
        assert tuple(g["node_feat"].shape) == (2_449_408, 100)
    if arch == "meshgraphnet":
        assert tuple(state["params"]["enc_node"][0][0].shape) == (100, 128)
