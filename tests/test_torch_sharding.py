"""``distributed/sharding.py`` and ``launch/mesh.py`` in the port against
``repro.distributed.sharding`` on the CPU.

Every rule's spec tree is held equal to the reference's, for every arch's
full and smoke config, on both production meshes and a (2, 4) mesh (the
reference's as ``jax.sharding.AbstractMesh``: the rules read the axis
names and sizes only; the port's are DeviceMeshes over a fake process
group of as many ranks, ``launch.dryrun.fake_world``). Parameter trees are
compared under the port's names against the reference's tree paths joined
with "." (``layers.wq``, ``mlp.0.0``); abstract inputs in spec, shape and
dtype. The port's KV cache is ``[L, B,
Hkv, S, Dh]`` where the reference's is ``[L, B, S, Hkv, Dh]``: its specs
and shapes are compared with those two entries swapped. Each leaf's
``local_shape`` is held to JAX's ``shard_shape`` and to each dim divided
by its axes' product; where that does not divide (smoke widths on a
16-wide axis), both sides refuse.
"""
import contextlib
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JMesh
from jax.sharding import NamedSharding as JNamed

from repro.configs import get_arch as jax_get_arch
from repro.distributed import sharding as jshr
from repro.models import dien as jdien
from repro.models import transformer as jt
from repro.train.step import gnn_make_init as jax_gnn_init
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.distributed import sharding as shr
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import gnn as tgnn
from repro_torch.models import transformer as tt
from repro_torch.models.dien import dien_init

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
_TORCH_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
                 torch.int32: jnp.int32, torch.bool: jnp.bool_}


@contextlib.contextmanager
def meshes(name):
    """(the port's DeviceMesh under a fake group, the reference's
    AbstractMesh) of one of MESHES."""
    shape, names = MESHES[name]
    with fake_world(math.prod(shape)):
        if "pod" in names or shape == (16, 16):
            tmesh = make_production_mesh(multi_pod="pod" in names,
                                         device_type="cpu")
        else:
            tmesh = make_host_mesh(*shape, device_type="cpu")
        yield tmesh, JMesh(shape, names)


@pytest.fixture
def pair(mesh_name):
    with meshes(mesh_name) as both:
        yield both


def path_name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def ref_flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {path_name(p): v for p, v in leaves}


def check_local(spec, shape, jmesh, tmesh, what):
    """The port's local_shape against JAX's shard_shape (both refuse a
    dim that does not divide)."""
    tsh = shr.NamedSharding(tmesh, spec)
    jsh = JNamed(jmesh, jax.sharding.PartitionSpec(*spec))
    try:
        want = jsh.shard_shape(tuple(shape))
    except ValueError:
        with pytest.raises(ValueError, match="does not divide"):
            tsh.local_shape(tuple(shape))
        return
    got = tsh.local_shape(tuple(shape))
    assert got == tuple(want), what
    sizes = dict(zip(tmesh.mesh_dim_names, tmesh.shape))
    for n, g, d in zip(shape, got, range(len(shape))):
        assert g == n // int(np.prod([sizes[a] for a in spec.axes(d)]))


def check_abstract(got: dict, want: dict, jmesh, tmesh, swap=()):
    assert set(got) == set(want)
    for k, s in got.items():
        w = want[k]
        spec, shape = tuple(w.sharding.spec), tuple(w.shape)
        if k in swap:
            spec = spec[:2] + (spec[3], spec[2]) + spec[4:]
            shape = shape[:2] + (shape[3], shape[2]) + shape[4:]
        assert isinstance(s, shr.Sharded), k
        assert s.tensor.device.type == "meta"
        assert s.sharding.spec == spec, (k, s.sharding.spec, spec)
        assert tuple(s.tensor.shape) == shape, k
        assert _TORCH_DTYPES[s.tensor.dtype] == w.dtype, k
        check_local(s.sharding.spec, shape, jmesh, tmesh, k)


@functools.cache
def ref_params(arch: str, smoke: bool):
    spec = jax_get_arch(arch)
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    key = jax.random.key(0)
    if spec.family == "lm":
        return jax.eval_shape(functools.partial(jt.init_params, cfg), key)
    if spec.family == "gnn":
        return jax.eval_shape(functools.partial(
            jax_gnn_init(arch, cfg), cfg), key)
    return jax.eval_shape(functools.partial(jdien.dien_init, cfg), key)


def port_params(arch: str, smoke: bool):
    spec = get_arch(arch)
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    if spec.family == "lm":
        return tt.init_params(cfg, generator=None, device="meta")
    if spec.family == "gnn":
        return tgnn.INIT[arch](cfg, generator=None, device="meta")
    return dien_init(cfg, generator=None, device="meta")


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("smoke", (False, True), ids=("full", "smoke"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs(arch, smoke, mesh_name, pair):
    tmesh, jmesh = pair
    spec, jspec = get_arch(arch), jax_get_arch(arch)
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    jcfg = jspec.make_smoke_config() if smoke else jspec.make_config()
    params = port_params(arch, smoke)
    shapes = {k: tuple(v.shape) for k, v in params.named_parameters()}
    rshapes = {k: tuple(v.shape) for k, v in
               ref_flat(ref_params(arch, smoke)).items()}
    assert shapes == rshapes
    if spec.family == "lm":
        got = shr.lm_param_specs(cfg, tmesh, fsdp=spec.fsdp)
        want = jshr.lm_param_specs(jcfg, jmesh, fsdp=jspec.fsdp)
        assert set(got) == set(want) and set(got["layers"]) == \
            set(want["layers"])
        flat = shr.flat_specs(got)
        assert flat == {k: tuple(v) for k, v in ref_flat(want).items()}
        assert set(flat) == set(shapes)
        trees = [flat]
    elif spec.family == "gnn":
        flat = shr.gnn_param_specs(params)
        want = ref_flat(jshr.gnn_param_specs(ref_params(arch, smoke)))
        assert flat == {k: tuple(v) for k, v in want.items()}
        assert shr.gnn_param_specs(dict(params.named_parameters())) == flat
        trees = [flat]
    else:
        trees = []
        for rep in (False, True):
            flat = shr.dien_param_specs(params, replicate_tables=rep)
            want = ref_flat(jshr.dien_param_specs(ref_params(arch, smoke),
                                                  replicate_tables=rep))
            assert flat == {k: tuple(v) for k, v in want.items()}
            trees.append(flat)
    for flat in trees:
        for k, s in flat.items():
            assert isinstance(s, shr.P)
            check_local(s, shapes[k], jmesh, tmesh, k)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs(arch, mesh_name, pair):
    tmesh, jmesh = pair
    spec = get_arch(arch)
    for smoke in (False, True):
        cfg = spec.make_smoke_config() if smoke else spec.make_config()
        jcfg = (jax_get_arch(arch).make_smoke_config() if smoke
                else jax_get_arch(arch).make_config())
        for name, shape in spec.shapes.items():
            if spec.family == "lm":
                b, s = shape["batch"], shape["seq"]
                check_abstract(shr.lm_input_specs(tmesh, b, s),
                               jshr.lm_input_specs(jmesh, b, s), jmesh,
                               tmesh)
                cache, tok = shr.lm_cache_specs(cfg, tmesh, b, s)
                jcache, jtok = jshr.lm_cache_specs(jcfg, jmesh, b, s)
                check_abstract(cache, jcache, jmesh, tmesh, swap=("k", "v"))
                check_abstract(tok, jtok, jmesh, tmesh)
            elif spec.family == "gnn":
                for pos in (False, True):
                    for atoms in (False, True):
                        kw = dict(n_nodes=shape["n_nodes"],
                                  n_edges=shape["n_edges"],
                                  d_feat=shape["d_feat"], positions=pos,
                                  atom_types=atoms,
                                  n_graphs=shape["n_graphs"],
                                  n_triplets=4 * shape["n_edges"] * pos)
                        check_abstract(shr.gnn_input_specs(tmesh, **kw),
                                       jshr.gnn_input_specs(jmesh, **kw),
                                       jmesh, tmesh)
            elif shape["kind"] == "retrieval":
                n = shape["n_candidates"]
                check_abstract(shr.dien_retrieval_specs(tmesh, cfg, n),
                               jshr.dien_retrieval_specs(jmesh, jcfg, n),
                               jmesh, tmesh)
            else:
                check_abstract(
                    shr.dien_input_specs(tmesh, cfg, shape["batch"]),
                    jshr.dien_input_specs(jmesh, jcfg, shape["batch"]),
                    jmesh, tmesh)


@pytest.mark.parametrize("mesh_name", ["2x16x16"])
def test_lm_cache_specs_both_branches(mesh_name, pair):
    tmesh, _ = pair
    cfg = get_arch("llama3.2-1b").make_config()
    (kv, tok) = shr.lm_cache_specs(cfg, tmesh, 128, 32768)
    assert kv["k"].sharding.spec == shr.P(None, ("pod", "data"), None,
                                          "model", None)
    assert tok["token"].sharding.spec == shr.P(("pod", "data"))
    (kv, tok) = shr.lm_cache_specs(cfg, tmesh, 1, 524288)
    assert kv["k"].sharding.spec == shr.P(None, None, None,
                                          ("pod", "data"), None)
    assert tok["token"].sharding.spec == shr.P(None)


@pytest.mark.parametrize("mesh_name", ["2x16x16"])
def test_spec_and_placements(mesh_name, pair):
    from torch.distributed.tensor import Replicate, Shard
    mesh, _ = pair
    assert shr.P(("data",), None) == ("data", None)
    assert shr.P(("pod", "data"), None) == (("pod", "data"), None)
    assert shr.P() == () and shr.P(None, None) != shr.P()
    assert shr.data_axes(mesh) == ("pod", "data")
    sh = shr.ns(mesh, ("pod", "data"), "model")
    assert sh.placements == (Shard(0), Shard(0), Shard(1))
    assert sh.local_shape((64, 32)) == (2, 2)
    assert shr.ns(mesh, None, "data").placements == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(NotImplementedError, match="mesh order"):
        shr.ns(mesh, ("data", "pod"))
    with pytest.raises(ValueError, match="no mesh axis"):
        shr.ns(mesh, "rows")
    with pytest.raises(ValueError, match="used twice"):
        shr.ns(mesh, "data", "data")
    with pytest.raises(ValueError, match="does not divide"):
        sh.local_shape((48, 32))


def test_meshes():
    with pytest.raises(RuntimeError, match="none is initialized"):
        make_production_mesh()
    for multi_pod, world, shape, names in (
            (False, 256, (16, 16), ("data", "model")),
            (True, 512, (2, 16, 16), ("pod", "data", "model"))):
        with fake_world(world):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            assert tuple(mesh.shape) == shape
            assert mesh.mesh_dim_names == names
            with pytest.raises(RuntimeError, match="ranks"):
                make_production_mesh(multi_pod=not multi_pod,
                                     device_type="cpu")
        assert not dist.is_initialized()
    with fake_world(8):
        mesh = make_host_mesh(2, 16, device_type="cpu")
        assert tuple(mesh.shape) == (2, 4)
        assert shr.data_axes(mesh) == ("data",)
        mesh = make_host_mesh(16, 1, device_type="cpu")
        assert tuple(mesh.shape) == (8, 1)
    try:
        mesh = make_host_mesh(4, 4, device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
