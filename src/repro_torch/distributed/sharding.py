"""Sharding rules per architecture family.

The port of ``repro.distributed.sharding``. Axes: ``data`` = DP/FSDP (+
sequence parallel for long-context decode), ``model`` = TP (heads / d_ff /
vocab) + EP (experts), ``pod`` = cross-pod pure data parallelism.

A rule returns the reference's spec tree, keyed by the port's names:
``lm_param_specs`` the reference's nested tree over ``LMParams``' keys
(``layers`` holds the ``ParameterDict``'s), ``gnn_param_specs`` and
``dien_param_specs`` one entry per ``named_parameters()`` name
(``inter.0.filter.1.0``, ``gru1.wz``, ``mlp.0.0``). The reference's
abstract inputs (``jax.ShapeDtypeStruct`` with a sharding) are ``Sharded``
pairs: a tensor on ``meta`` and its ``NamedSharding``.

``P`` is the port's ``PartitionSpec``: one entry per tensor dim, ``None``
(replicated), an axis name, or a tuple of names (the dim split over their
product, the first name outermost); a one-name tuple is stored as the
name, as JAX stores it. ``NamedSharding(mesh, spec).placements`` gives the
DTensor placements (one ``Shard(d)`` or ``Replicate()`` per mesh dim) and
``local_shape`` each card's block. A dim split over several mesh dims
takes DTensor's default order, mesh dim by mesh dim, which is JAX's
row-major order when the tuple lists its axes in mesh order; another order
is refused.

The trees differ from the reference's in one place: the port's KV cache is
laid out ``[L, B, Hkv, S, Dh]`` (``models.transformer.init_kv_cache``), so
``lm_cache_specs`` gives the reference's specs with its S and Hkv entries
swapped.

Real tensors are placed as DTensors (the counterpart of the reference's
``train/step.py::_abstract``): ``place`` puts a tensor under its spec,
``place_tree`` a tree of named tensors under a spec tree, and
``opt_specs`` is the reference's ``_opt_specs``. Every rank holds the same
full tensor (the same seed, the same batch), so each keeps its own block
and nothing is scattered (``distribute_tensor(..., src_data_rank=None)``).
A ``meta`` tensor becomes a ``Sharded`` pair instead. ``local`` and
``from_local`` cross between a DTensor and this rank's block inside a
sharded function, with the gradient placements that make its backward
right.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary


class P(tuple):
    """A partition spec: ``P(None, "data")``, ``P(("pod", "data"), None)``."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                if not all(isinstance(a, str) for a in e):
                    raise TypeError(f"spec entry {e!r}: axis names only")
                e = e[0] if len(e) == 1 else (e or None)
            elif e is not None and not isinstance(e, str):
                raise TypeError(f"spec entry {e!r}: None, a name or a tuple")
            norm.append(e)
        return super().__new__(cls, norm)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"

    def axes(self, dim: int) -> tuple:
        """The mesh axes tensor dim ``dim`` is split over (outermost
        first)."""
        e = self[dim] if dim < len(self) else None
        return () if e is None else (e,) if isinstance(e, str) else e


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh's named axes."""
    mesh: Any
    spec: P

    def __post_init__(self):
        sizes = mesh_axes(self.mesh)
        seen = []
        for d in range(len(self.spec)):
            axes = self.spec.axes(d)
            for a in axes:
                if a not in sizes:
                    raise ValueError(f"{self.spec}: no mesh axis {a!r} in "
                                     f"{tuple(sizes)}")
            seen.extend(axes)
            order = [self.mesh.mesh_dim_names.index(a) for a in axes]
            if order != sorted(order):
                raise NotImplementedError(
                    f"{self.spec}: dim {d} lists its axes out of mesh order, "
                    "which DTensor's default placement order cannot give")
        if len(seen) != len(set(seen)):
            raise ValueError(f"{self.spec}: a mesh axis is used twice")

    def local_shape(self, global_shape) -> tuple:
        """One card's block: each dim divided by its axes' product, which
        must divide it (as JAX requires)."""
        sizes = mesh_axes(self.mesh)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"{self.spec} has more entries than "
                             f"{len(global_shape)} dims")
        counts = [math.prod(sizes[a] for a in self.spec.axes(d))
                  for d in range(len(global_shape))]
        for n, c in zip(global_shape, counts):
            if n % c:
                raise ValueError(f"{self.spec}: dim of {n} does not divide "
                                 f"into {c} blocks (shape "
                                 f"{tuple(global_shape)})")
        return tuple(n // c for n, c in zip(global_shape, counts))

    @property
    def placements(self) -> tuple:
        """The DTensor placements, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        dim_of = {a: d for d in range(len(self.spec))
                  for a in self.spec.axes(d)}
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in self.mesh.mesh_dim_names)


class Sharded(NamedTuple):
    """An abstract input: a ``meta`` tensor and its sharding."""
    tensor: torch.Tensor
    sharding: NamedSharding


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (the same full tensor on every rank) under ``sharding``: a
    DTensor holding this rank's block, or on ``meta`` a ``Sharded`` pair.
    A DTensor is redistributed; a host int, and a replicated 0-d tensor
    (AdamW's step: every rank holds the same scalar), are left as they
    are."""
    if not isinstance(t, torch.Tensor):
        return t
    if is_dtensor(t):
        return t.redistribute(sharding.mesh, sharding.placements)
    if t.device.type == "meta":
        sharding.local_shape(tuple(t.shape))        # the blocks must divide
        return Sharded(t, sharding)
    if t.dim() == 0 and not any(sharding.spec):
        return t
    sharding.local_shape(tuple(t.shape))            # the blocks must divide
    mesh, pl = sharding.mesh, sharding.placements
    block = t.detach()
    for d in range(block.dim()):
        n = math.prod(mesh.size(i) for i, p in enumerate(pl)
                      if p.is_shard(d))
        size = block.shape[d] // n
        block = block.narrow(d, block_offset(mesh, pl, d, size), size)
    return from_local(block.contiguous(), mesh, pl).requires_grad_(
        t.requires_grad)


def place_tree(tree, specs, mesh):
    """A tree of tensors (dicts, parameter modules by their
    ``named_parameters()`` names) placed by a spec tree of the same keys:
    each leaf under ``NamedSharding(mesh, spec)``, or as given where the
    spec is already a ``Sharded`` pair. A module comes back as its class's
    ``from_named`` of the placed tensors (trainable as it was), or on
    ``meta`` as a dict of ``Sharded`` pairs."""
    if isinstance(tree, torch.nn.Module):
        named = dict(tree.named_parameters())
        placed = place_tree(named, specs, mesh)
        if any(isinstance(v, Sharded) for v in placed.values()):
            return placed
        out = type(tree).from_named(placed)
        for name, p in out.named_parameters():
            p.requires_grad_(named[name].requires_grad)
        return out
    if isinstance(tree, dict):
        missing = set(tree) - set(specs)
        if missing:
            raise KeyError(f"no sharding rule for {sorted(missing)}")
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(specs, Sharded):
        return place(tree, specs.sharding)
    return place(tree, NamedSharding(mesh, specs))


def replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value as a plain tensor (the same on every
    rank: a collective); a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def gather_tree(tree):
    """``tree`` with every DTensor gathered whole (a collective: every
    rank calls it), a module rebuilt by its class's ``from_named`` with
    its parameters' ``requires_grad``; other leaves as they are."""
    if isinstance(tree, torch.nn.Module):
        named = dict(tree.named_parameters())
        out = type(tree).from_named(gather_tree(named))
        for name, p in out.named_parameters():
            p.requires_grad_(named[name].requires_grad)
        return out
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if is_dtensor(tree):
        return replicated(tree).detach()
    return tree


def opt_specs(param_specs) -> dict:
    """AdamW's state: moments and master copy placed as the parameters,
    the step replicated (the reference's ``_opt_specs``)."""
    return {"m": param_specs, "v": param_specs, "master": param_specs,
            "step": P()}


def local(x, placements, *, partial: tuple = ()) -> torch.Tensor:
    """This rank's block of DTensor ``x`` redistributed to ``placements``.
    The block's gradient comes back ``Partial`` on the mesh dims of
    ``partial`` where ``x`` is replicated: there each rank used the same
    copy on its own share of the work, and the gradient is their sum."""
    from torch.distributed.tensor import Partial
    x = x.redistribute(x.device_mesh, tuple(placements))
    grad = tuple(Partial() if i in partial and p.is_replicate() else p
                 for i, p in enumerate(x.placements))
    return x.to_local(grad_placements=grad)


def from_local(t: torch.Tensor, mesh, placements):
    """A DTensor from this rank's block ``t`` (blocks divide evenly)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, tuple(placements), run_check=False)


def block_offset(mesh, placements, dim: int, local_size: int) -> int:
    """Where this rank's block of tensor dim ``dim`` starts, for blocks of
    ``local_size``: the mesh dims that split it, outermost first."""
    idx = 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx * local_size


def sharded_dims(placements) -> tuple:
    """The mesh dims on which a placement splits a tensor."""
    return tuple(i for i, p in enumerate(placements) if p.is_shard())


#: Each mesh's groups over several of its dims, made once a mesh.
_GROUPS = WeakIdKeyDictionary()


def group_over(mesh, dims: tuple):
    """The process group over mesh dims ``dims`` (indices in mesh order)
    that holds this rank: one dim's own group, or for several dims one
    group over all of them (``("pod", "data")`` is one collective, not one
    per dim), its ranks in the order of ``flat_coordinate``; None when the
    dims hold one rank. The groups of several dims are made the first time
    any is asked for, every rank calling ``dist.new_group`` for each in the
    same order; their ranks come from the mesh's own dim groups (a mesh
    lays its ranks out with one stride a dim)."""
    size = math.prod(mesh.size(i) for i in dims)
    if size == 1:
        return None
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    made = _GROUPS.setdefault(mesh, {})
    if dims not in made:
        import itertools

        import torch.distributed as dist
        me = dist.get_rank()
        stride = []
        for i in range(mesh.ndim):
            ranks = (dist.get_process_group_ranks(mesh.get_group(i))
                     if mesh.size(i) > 1 else [me])
            stride.append(ranks[1] - ranks[0] if len(ranks) > 1 else 0)
        base = me - sum(mesh.get_local_rank(i) * stride[i]
                        for i in range(mesh.ndim))
        rest = [i for i in range(mesh.ndim) if i not in dims]
        for fixed in itertools.product(*(range(mesh.size(i)) for i in rest)):
            at = base + sum(c * stride[i] for c, i in zip(fixed, rest))
            row = [at + sum(c * stride[i] for c, i in zip(coord, dims))
                   for coord in itertools.product(
                       *(range(mesh.size(i)) for i in dims))]
            if row != sorted(row):
                raise ValueError(f"mesh dims {dims} do not hold their ranks "
                                 f"in order: {row}")
            group = dist.new_group(row)
            if me in row:
                made[dims] = group
    return made[dims]


def reduced(g, placements: tuple):
    """DTensor ``g`` (a gradient: its block is reduced in place) placed as
    ``placements``, its partial sums over several mesh dims that
    ``placements`` replicates reduced in one all-reduce over those dims
    together (``group_over``), where DTensor runs one per dim."""
    from torch.distributed.tensor import Replicate
    mesh = g.device_mesh
    dims = tuple(i for i, p in enumerate(g.placements)
                 if p.is_partial("sum") and placements[i].is_replicate())
    group = group_over(mesh, dims) if len(dims) > 1 else None
    if group is not None:
        import torch.distributed as dist
        t = g.to_local()
        dist.all_reduce(t, group=group)
        g = from_local(t, mesh, tuple(Replicate() if i in dims else p
                                      for i, p in enumerate(g.placements)))
    return g if tuple(g.placements) == tuple(placements) else g.redistribute(
        mesh, placements)


def flat_coordinate(mesh, dims: tuple) -> int:
    """This rank's coordinate over mesh dims ``dims`` flattened, the
    outermost first (its block's number, as ``block_offset`` counts)."""
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def data_axes(mesh) -> tuple[str, ...]:
    """Batch axes: ('pod', 'data') on the multi-pod mesh, else ('data',)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def ns(mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def abstract(mesh, shape, dtype, *spec) -> Sharded:
    return Sharded(torch.empty(shape, dtype=dtype, device="meta"),
                   ns(mesh, *spec))


def _n_data(mesh) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def lm_param_specs(cfg, mesh, *, fsdp: bool) -> dict:
    """Spec tree matching ``transformer.init_params``: ``embed``,
    ``layers`` (``LMParams.layers``' keys), ``ln_out``, ``unembed`` unless
    tied."""
    dp = "data" if fsdp else None
    layer = {
        "wq": P(None, dp, "model"),
        "wk": P(None, dp, "model"),
        "wv": P(None, dp, "model"),
        "wo": P(None, "model", dp),
        "ln_attn": P(None, None),
        "ln_mlp": P(None, None),
    }
    if cfg.qk_norm:
        layer["q_norm"] = P(None, None)
        layer["k_norm"] = P(None, None)
    if cfg.is_moe:
        layer["router"] = P(None, None, None)
        layer["w_gate"] = P(None, "model", dp, None)
        layer["w_up"] = P(None, "model", dp, None)
        layer["w_down"] = P(None, "model", None, dp)
    else:
        layer["w_gate"] = P(None, dp, "model")
        layer["w_up"] = P(None, dp, "model")
        layer["w_down"] = P(None, "model", dp)
    specs = {"embed": P("model", dp), "layers": layer, "ln_out": P(None)}
    if not cfg.tie_embeddings:
        specs["unembed"] = P(dp, "model")
    return specs


def flat_specs(tree: dict, prefix: str = "") -> dict:
    """A nested spec tree under ``named_parameters()``-style names
    (``layers.wq``)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_specs(v, name + "."))
        else:
            out[name] = v
    return out


def lm_input_specs(mesh, batch: int, seq: int) -> dict:
    da = data_axes(mesh)
    return {"tokens": abstract(mesh, (batch, seq), torch.int32, da, None),
            "targets": abstract(mesh, (batch, seq), torch.int32, da, None)}


def lm_cache_specs(cfg, mesh, batch: int, seq: int):
    """KV-cache shardings: batch over data when batch ≥ |data|, the
    sequence over ``model``; otherwise sequence parallelism (long_500k: one
    request, the sequence over the data axes). The port's cache is
    ``[L, B, Hkv, S, Dh]``; ``len`` is the reference's int32 scalar."""
    da = data_axes(mesh)
    if batch >= _n_data(mesh):
        spec = (None, da, None, "model", None)
    else:
        spec = (None, None, None, da, None)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.d_head)
    return {
        "k": abstract(mesh, shape, cfg.dtype, *spec),
        "v": abstract(mesh, shape, cfg.dtype, *spec),
        "len": abstract(mesh, (), torch.int32),
    }, {
        "token": abstract(mesh, (batch,), torch.int32,
                           da if batch >= _n_data(mesh) else None),
    }


# ---------------------------------------------------------------------------
# GNN family — nodes/edges sharded over data, params replicated
# ---------------------------------------------------------------------------

def _names(params) -> list[str]:
    if isinstance(params, torch.nn.Module):
        return [k for k, _ in params.named_parameters()]
    return list(params)


def gnn_param_specs(params) -> dict:
    """``P()`` for every parameter (a module or a dict of named
    tensors)."""
    return {k: P() for k in _names(params)}


def gnn_input_specs(mesh, *, n_nodes: int, n_edges: int, d_feat: int,
                    positions: bool = False, atom_types: bool = False,
                    n_graphs: int = 1, n_triplets: int = 0) -> dict:
    da = data_axes(mesh)
    if atom_types:
        nf = abstract(mesh, (n_nodes,), torch.int32, da)
    else:
        nf = abstract(mesh, (n_nodes, d_feat), torch.float32, da, None)
    out = {
        "node_feat": nf,
        "src": abstract(mesh, (n_edges,), torch.int32, da),
        "dst": abstract(mesh, (n_edges,), torch.int32, da),
        "graph_id": abstract(mesh, (n_nodes,), torch.int32, da),
    }
    if positions:
        out["positions"] = abstract(mesh, (n_nodes, 3), torch.float32, da,
                                     None)
    if n_triplets:
        out["trip_in"] = abstract(mesh, (n_triplets,), torch.int32, da)
        out["trip_out"] = abstract(mesh, (n_triplets,), torch.int32, da)
    return out


# ---------------------------------------------------------------------------
# RecSys family — table rows over model, batch over data
# ---------------------------------------------------------------------------

DIEN_TABLES = ("item_table", "cate_table", "user_table")


def dien_param_specs(params, *, replicate_tables: bool = False) -> dict:
    """Tables row-shard over ``model`` for training; serving replicates
    them (the reference's policy: its assigned tables are ~72 MB)."""
    specs = {k: P() for k in _names(params)}
    if not replicate_tables:
        for k in DIEN_TABLES:
            specs[k] = P("model", None)
    return specs


def dien_input_specs(mesh, cfg, batch: int) -> dict:
    da = data_axes(mesh)
    t = cfg.seq_len
    return {
        "hist_items": abstract(mesh, (batch, t), torch.int32, da, None),
        "hist_cates": abstract(mesh, (batch, t), torch.int32, da, None),
        "hist_mask": abstract(mesh, (batch, t), torch.bool, da, None),
        "target_item": abstract(mesh, (batch,), torch.int32, da),
        "target_cate": abstract(mesh, (batch,), torch.int32, da),
        "user_feats": abstract(mesh, (batch, cfg.user_hot), torch.int32,
                                da, None),
        "label": abstract(mesh, (batch,), torch.int32, da),
    }


def dien_retrieval_specs(mesh, cfg, n_candidates: int) -> dict:
    da = data_axes(mesh)
    t = cfg.seq_len
    return {
        "hist_items": abstract(mesh, (1, t), torch.int32, None, None),
        "hist_cates": abstract(mesh, (1, t), torch.int32, None, None),
        "hist_mask": abstract(mesh, (1, t), torch.bool, None, None),
        "user_feats": abstract(mesh, (1, cfg.user_hot), torch.int32, None,
                                None),
        "cand_items": abstract(mesh, (n_candidates,), torch.int32, da),
        "cand_cates": abstract(mesh, (n_candidates,), torch.int32, da),
    }
