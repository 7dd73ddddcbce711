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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch


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
