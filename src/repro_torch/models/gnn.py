"""GNN architectures: GAT, SchNet, DimeNet, MeshGraphNet.

The port of ``repro.models.gnn``. Message passing is gathers over an
explicit edge index and scatter-adds into nodes (``index_add``,
``scatter_reduce``): the reference's XLA gather/scatter, not a TPU kernel.
All shapes are fixed: graphs are padded to (N, E[, T]) with sentinel
indices ``src == dst == N``, which every scatter drops and every gather
masks, as the reference's ``mode="drop"`` and clipped gathers do.

Kernel regimes per the taxonomy:
  GAT           SDDMM edge scores → segment-softmax → weighted scatter-sum
  SchNet        RBF edge filters (cfconv) → scatter-sum
  DimeNet       triplet gather (k→j→i) with angular×radial basis → bilinear
  MeshGraphNet  edge+node MLPs, encode-process-decode, sum aggregation

Each model's parameters are a ``GNNParams`` module under the reference's
names and layout (``x @ w + b``, MGN's layers stacked on a leading L axis),
so ``params_from_reference`` transposes nothing. The memory design is the
reference's: ``jax.checkpoint`` is ``torch.utils.checkpoint`` at the same
places, ``lax.scan`` over stacked layers is a loop, DimeNet streams its
triplets in chunks and carries its edge states in bfloat16 from 2^22
edges.

Over a device mesh (a sharded cell of ``train.step.build_cell``) the
graph's tensors are DTensors split over the data axes by rows (nodes,
edges, triplets) and the parameters are replicated. The dense steps are
DTensor ops. A gather ``x[index]`` (``_rows``) takes the replicated ``x``
and this rank's block of the index; a scatter into nodes (``scatter_sum``,
the softmax's max) adds this rank's rows into all of them and the partial
results are summed over the ranks (the max reduced), then placed back on
the rows by ``_constrain_rows`` at the reference's sites when
``set_gnn_data_axes`` is set, else replicated. DimeNet's triplet chunks
gather and scatter on this rank's tensors, with one gather of the edge
states and one reduction of the aggregate a block (``_mesh_triplets``).
The softmax's
max passes its gradient (zero in exact arithmetic: a softmax does not
depend on the shift it subtracts) to each rank's own largest score.

Ties: ``jnp.maximum`` and ``jnp.clip`` pass half the gradient to each side
of a tie and ``torch.clamp`` passes all of it to the input, so a clip of a
value that may be differentiated is ``minimum(maximum(...))`` here; the
activations are written as the reference's ``where``s (``leaky_relu`` at
0, where GAT's zero-initialized attention puts every score at step 0).
"""
from __future__ import annotations

import contextvars
import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.graph import resolve_device
from repro_torch.distributed import sharding as shr

#: DimeNet's triplet chunk: the reference's ``_pick_chunks(t, 4_194_304)``.
TRIPLET_CHUNK = 4_194_304
#: From this many edges DimeNet carries its edge states in bfloat16.
BF16_CARRY_EDGES = 1 << 22


# ---------------------------------------------------------------------------
# Batched graph container (fixed shapes; pad with src == dst == n_nodes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GraphBatch:
    n_nodes: int                             # includes padding
    node_feat: torch.Tensor                  # [N, F] float or [N] int (atoms)
    src: torch.Tensor                        # [E] int32
    dst: torch.Tensor                        # [E] int32
    positions: torch.Tensor | None = None    # [N, 3]
    graph_id: torch.Tensor | None = None     # [N] int32 (molecule batching)
    n_graphs: int = 1
    trip_in: torch.Tensor | None = None      # [T] edge id (k→j)
    trip_out: torch.Tensor | None = None     # [T] edge id (j→i)


# Mesh axes for activation sharding constraints (set by the step factory
# for full-scale cells; unset → no constraints, e.g. smoke cells).
_GNN_DATA_AXES: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "gnn_data_axes", default=())


def set_gnn_data_axes(axes: tuple) -> None:
    _GNN_DATA_AXES.set(tuple(axes))


def _constrain_rows(x: torch.Tensor) -> torch.Tensor:
    """Shard the leading (node/edge/triplet) dim over the data axes; a
    plain tensor raises while the axes are set."""
    axes = _GNN_DATA_AXES.get()
    if not axes:
        return x
    if not shr.is_dtensor(x):
        raise TypeError(f"_constrain_rows: the rows are placed over {axes}, "
                        "so the tensor must be a DTensor; got a plain one")
    mesh = x.device_mesh
    spec = shr.P(axes, *([None] * (x.dim() - 1)))
    return x.redistribute(mesh, shr.NamedSharding(mesh, spec).placements)


def _row_placements(index, ndim: int) -> tuple:
    """The placements of a tensor of ``ndim`` dims whose rows are
    ``index``'s: its split of dim 0, replicated elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if p.is_shard(0) else Replicate()
                 for p in index.placements)


def _summed(out: torch.Tensor, index, reduce: str = "sum"):
    """This rank's scatter ``out`` (of its rows of ``index``) as the sum
    (or max) over the ranks that split the rows: constrained to the rows,
    or replicated."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = index.device_mesh
    split = shr.sharded_dims(index.placements)
    out = shr.from_local(out, mesh, tuple(
        Partial(reduce) if i in split else Replicate()
        for i in range(mesh.ndim)))
    if _GNN_DATA_AXES.get() and reduce == "sum":
        return _constrain_rows(out)
    return out.redistribute(mesh, (Replicate(),) * mesh.ndim)


def _index_add(n: int, index: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """``zeros(n, ...).index_add(0, index, values)`` (every index in
    [0, n))."""
    return values.new_zeros((n,) + values.shape[1:]).index_add(0, index,
                                                               values)


def scatter_sum(values: torch.Tensor, index: torch.Tensor,
                n: int) -> torch.Tensor:
    """Σ of ``values`` rows into ``n`` rows by ``index``; an index ≥ n
    (padding) goes to a drop row that is cut off, as ``mode="drop"``."""
    if shr.is_dtensor(index):
        vl = shr.local(values, _row_placements(index, values.dim()))
        return _summed(scatter_sum(vl, shr.local(index, index.placements), n),
                       index)
    idx = torch.where(index < n, index, n).long()
    out = values.new_zeros((n + 1,) + values.shape[1:])
    return out.index_add(0, idx, values)[:n]


def _clip_index(index: torch.Tensor, n: int) -> torch.Tensor:
    """An index clipped into [0, n), for a gather (no gradient)."""
    return torch.clamp(index, 0, n - 1).long()


def _rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` for a differentiated ``x``: its backward is
    ``index_add`` (one atomic add a row), where ``x[index]``'s sorts the
    index and walks each repeated row in one warp, which serializes a hub
    (rmat's thousands of edges out of one node) or a padding row. On a
    mesh: the replicated ``x`` at this rank's block of the index (``x``'s
    gradient is a partial sum over the ranks that split the index)."""
    if not shr.is_dtensor(index):
        return x.index_select(0, index)
    xl = _whole(x, shr.sharded_dims(index.placements))
    out = xl.index_select(0, shr.local(index, index.placements))
    return shr.from_local(out, index.device_mesh,
                          _row_placements(index, out.dim()))


def _max(x: torch.Tensor, floor: float) -> torch.Tensor:
    """``jnp.maximum(x, floor)``: half the gradient to each side of a tie."""
    return torch.maximum(x, x.new_tensor(floor))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient at the ends."""
    return torch.minimum(_max(x, lo), x.new_tensor(hi))


def _segment_max(scores: torch.Tensor, index: torch.Tensor, n: int):
    """The per-node max of ``scores`` [E, H] over ``index`` (an index ≥ n
    dropped), -1e30 where a node has no edge: [n, H]."""
    if shr.is_dtensor(index):
        sl = shr.local(scores, _row_placements(index, scores.dim()))
        return _summed(_segment_max(sl, shr.local(index, index.placements),
                                    n), index, "max")
    idx = torch.where(index < n, index, n).long()
    mx = torch.full((n + 1,) + scores.shape[1:], -1e30, dtype=scores.dtype,
                    device=scores.device)
    return mx.scatter_reduce(0, idx[:, None].expand_as(scores), scores,
                             "amax")[:n]


def segment_softmax(scores: torch.Tensor, index: torch.Tensor, n: int):
    """Softmax over incoming edges per node. scores: [E, H]."""
    mx = _segment_max(scores, index, n)
    safe = _clip_index(index, n)
    ex = torch.exp(scores - _rows(mx, safe))
    ex = torch.where((index < n)[:, None], ex, 0)
    den = scatter_sum(ex, index, n)
    return ex / _max(_rows(den, safe), 1e-16)


def _const(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A small constant ``t`` beside ``like``: replicated on its mesh when
    ``like`` is a DTensor."""
    if not shr.is_dtensor(like):
        return t
    from torch.distributed.tensor import Replicate
    mesh = like.device_mesh
    return shr.from_local(t, mesh, (Replicate(),) * mesh.ndim)


def _silu(x):
    return x * torch.sigmoid(x)


def _leaky_relu(x, slope: float = 0.2):
    """``jax.nn.leaky_relu``: slope 1 at 0 (torch's has ``slope`` there)."""
    return torch.where(x >= 0, x, slope * x)


def _elu(x):
    """``jax.nn.elu``."""
    return torch.where(x > 0, x, torch.expm1(torch.where(x > 0, 0.0, x)))


def _ssp(x):
    """Shifted softplus (SchNet activation)."""
    return torch.nn.functional.softplus(x) - float(np.log(2.0))


def _mlp(params, x: torch.Tensor, act=torch.relu,
         final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` per ``(w, b)`` layer, ``act`` between them (and after
    the last with ``final_act``)."""
    params = list(params)
    for i, (w, b) in enumerate(params):
        x = x @ w + b
        if i + 1 < len(params) or final_act:
            x = act(x)
    return x


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def _remat(fn, *args):
    """``jax.checkpoint``: keep ``fn``'s inputs, recompute its insides in
    the backward."""
    return checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Parameters: a module over the reference's tree
# ---------------------------------------------------------------------------

class _Dict(nn.Module):
    """A dict of the tree: its keys as attributes."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            _set(self, k, v)

    def __getitem__(self, name: str):
        return getattr(self, name)


class GNNParams(_Dict):
    """A GNN's parameters under the reference's names: a dict is a
    submodule whose attributes are its keys, a list (an MLP, GAT's layers,
    DimeNet's blocks) an ``nn.ModuleList``, and a ``(w, b)`` pair an
    ``nn.ParameterList``. ``params[name]`` reads one entry, as the
    reference's dict does. Built frozen; ``requires_grad_()`` makes them
    trainable. ``named_parameters()`` names them ``inter.0.filter.1.0``
    (the path of keys and indices); ``from_named`` inverts it and
    ``to_reference`` gives the reference's tree back."""

    @classmethod
    def from_named(cls, named: dict) -> "GNNParams":
        """Frozen parameters from tensors under ``named_parameters()``'s
        names: paths of digits are lists, and a list of tensors a
        ``(w, b)`` pair."""
        root: dict = {}
        for name, t in named.items():
            *path, last = name.split(".")
            node = root
            for key in path:
                node = node.setdefault(key, {})
            node[last] = t
        return cls(_as_tree(root))

    def to_reference(self) -> dict:
        """The reference's parameter tree, numpy leaves (bf16 as
        float32)."""
        return _to_tree(self)


def _module(v):
    if isinstance(v, dict):
        return _Dict(v)
    if isinstance(v, tuple):
        return nn.ParameterList(nn.Parameter(t, requires_grad=False)
                                for t in v)
    return nn.ModuleList(_module(x) for x in v)


def _set(mod: nn.Module, key: str, v) -> None:
    if isinstance(v, torch.Tensor):
        setattr(mod, key, nn.Parameter(v, requires_grad=False))
    else:
        setattr(mod, key, _module(v))


def _as_tree(node):
    """A nested dict of path keys as the reference's tree: digit keys make
    a list, or a tuple where its items are tensors."""
    if isinstance(node, torch.Tensor):
        return node
    if all(k.isdigit() for k in node):
        items = [_as_tree(node[str(i)]) for i in range(len(node))]
        if all(isinstance(x, torch.Tensor) for x in items):
            return tuple(items)
        return items
    return {k: _as_tree(v) for k, v in node.items()}


def _to_tree(mod):
    if isinstance(mod, torch.Tensor):
        t = mod.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(mod, nn.ParameterList):
        return tuple(_to_tree(p) for p in mod)
    if isinstance(mod, nn.ModuleList):
        return [_to_tree(m) for m in mod]
    return {k: _to_tree(v) for k, v in
            (*mod._parameters.items(), *mod._modules.items())}


#: The top-level keys of each architecture's parameter tree.
_TOP_KEYS = {"gat-cora": {"layers"},
             "schnet": {"embed", "inter", "readout"},
             "dimenet": {"embed", "rbf_proj", "edge_init", "blocks", "out"},
             "meshgraphnet": {"enc_node", "enc_edge", "layers", "dec"}}


def params_from_reference(arch_id: str, tree: dict, *,
                          device: str | torch.device | None = None
                          ) -> GNNParams:
    """The reference's parameter tree for ``arch_id`` (``gat_init``,
    ``schnet_init``, ``dimenet_init`` or ``mgn_init``; numpy leaves: dicts,
    lists of blocks or layers, ``(w, b)`` tuples, MGN's stacked layers) as
    the port's parameters on ``device``."""
    if set(tree) != _TOP_KEYS[arch_id]:
        raise ValueError(f"{arch_id}: parameter tree keys {sorted(tree)}, "
                         f"expected {sorted(_TOP_KEYS[arch_id])}")
    dev = resolve_device(device)

    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(convert(v) for v in x)
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(dev,
                                                             torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    return GNNParams(convert(tree))


class _Init:
    """Draws from ``generator`` on ``device`` (no generator on ``meta``)."""

    def __init__(self, generator, device, dtype):
        self.gen, self.dev, self.dtype = generator, device, dtype

    def normal(self, shape, scale):
        x = torch.randn(shape, generator=self.gen, device=self.dev)
        return (x * scale).to(self.dtype)

    def zeros(self, shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.dev)

    def mlp(self, dims):
        """The reference's ``_init_mlp``: N(0, 1/fan_in) weights, zero
        biases."""
        return [(self.normal((a, b), a ** -0.5), self.zeros(b))
                for a, b in zip(dims[:-1], dims[1:])]


def _initializer(cfg, generator, device) -> _Init:
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        raise ValueError("a generator is needed outside the meta device")
    return _Init(generator, dev, cfg.dtype)


# ---------------------------------------------------------------------------
# GAT  [arXiv:1710.10903] — n_layers=2, d_hidden=8, n_heads=8, attn agg
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    dtype: torch.dtype = torch.float32


def gat_init(cfg: GATConfig, *, generator: torch.Generator | None,
             device: str | torch.device | None = None) -> GNNParams:
    """Random parameters with the reference's distributions, drawn from
    ``generator`` (on ``device``; None on ``meta``)."""
    init = _initializer(cfg, generator, device)
    layers = []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        heads = cfg.n_heads
        d_out = cfg.d_hidden if i + 1 < cfg.n_layers else cfg.n_classes
        layers.append({"w": init.normal((d_in, heads, d_out), d_in ** -0.5),
                       "a_src": init.zeros((heads, d_out)),
                       "a_dst": init.zeros((heads, d_out))})
        d_in = heads * d_out
    return GNNParams({"layers": layers})


def gat_forward(cfg: GATConfig, params: GNNParams,
                g: GraphBatch) -> torch.Tensor:
    """Per-node logits [N, n_classes]."""
    n = g.n_nodes
    x = g.node_feat.to(cfg.dtype)
    src_safe = _clip_index(g.src, n)
    dst_safe = _clip_index(g.dst, n)
    dst_ok = (g.dst < n)[:, None, None]
    layers = params["layers"]
    for i, lp in enumerate(layers):
        h = _constrain_rows(torch.einsum("nf,fhd->nhd", x, lp["w"]))
        e_src = torch.sum(h * lp["a_src"], -1)                # [N, H]
        e_dst = torch.sum(h * lp["a_dst"], -1)
        scores = _leaky_relu(_rows(e_src, src_safe)
                             + _rows(e_dst, dst_safe))          # [E, H]
        alpha = segment_softmax(scores, g.dst, n)             # [E, H]
        msg = _constrain_rows(_rows(h, src_safe) * alpha[..., None])
        agg = scatter_sum(torch.where(dst_ok, msg, 0), g.dst, n)
        x = agg.mean(1) if i + 1 == len(layers) else _elu(agg.reshape(n, -1))
    return x


# ---------------------------------------------------------------------------
# SchNet  [arXiv:1706.08566] — 3 interactions, d=64, rbf=300, cutoff=10
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_atom_types: int = 100
    dtype: torch.dtype = torch.float32


def schnet_init(cfg: SchNetConfig, *, generator: torch.Generator | None,
                device: str | torch.device | None = None) -> GNNParams:
    init = _initializer(cfg, generator, device)
    d = cfg.d_hidden
    inter = [{"filter": init.mlp([cfg.n_rbf, d, d]),
              "w_in": init.mlp([d, d]),
              "w_out": init.mlp([d, d, d])}
             for _ in range(cfg.n_interactions)]
    return GNNParams({"embed": init.normal((cfg.n_atom_types, d), 0.1),
                      "inter": inter,
                      "readout": init.mlp([d, d // 2, 1])})


def _atom_embed(params, node_feat):
    """Embedding rows of the atom types, clipped into the table."""
    table = params["embed"]
    return _rows(table, _clip_index(node_feat.to(torch.int32),
                                    table.shape[0]))


def schnet_forward(cfg: SchNetConfig, params: GNNParams,
                   g: GraphBatch) -> torch.Tensor:
    """Per-graph energy [n_graphs]."""
    n = g.n_nodes
    h = _atom_embed(params, g.node_feat)
    src_safe = _clip_index(g.src, n)
    dst_safe = _clip_index(g.dst, n)
    d_ij = _norm(_rows(g.positions, dst_safe) - _rows(g.positions, src_safe)
                 + 1e-9)
    dst_ok = (g.dst < n)[:, None]

    # The RBF expansion (E × n_rbf: 74 GB float32 at ogb_products) is
    # recomputed inside each checkpointed interaction, not stashed.
    def edge_filter(lp_filter):
        centers = _const(torch.linspace(0.0, cfg.cutoff, cfg.n_rbf,
                                        device=d_ij.device), d_ij)
        gamma = cfg.n_rbf / cfg.cutoff
        rbf = torch.exp(-gamma * (d_ij[:, None] - centers) ** 2).to(cfg.dtype)
        env = 0.5 * (torch.cos(math.pi * _clip(d_ij / cfg.cutoff, 0.0, 1.0))
                     + 1.0)
        w = _mlp(lp_filter, rbf, act=_ssp, final_act=True)
        return _constrain_rows(w * env[:, None].to(cfg.dtype))

    for lp in params["inter"]:
        def interaction(h, lp=lp):
            w = edge_filter(lp["filter"])
            x = _mlp(lp["w_in"], h)
            msg = _constrain_rows(_rows(x, src_safe) * w)
            agg = scatter_sum(torch.where(dst_ok, msg, 0), g.dst, n)
            return h + _mlp(lp["w_out"], agg, act=_ssp)

        h = _remat(interaction, h)

    atom_e = _mlp(params["readout"], h, act=_ssp)[:, 0]      # [N]
    gid = g.graph_id if g.graph_id is not None else _const(torch.zeros(
        n, dtype=torch.int32, device=h.device), h)
    return scatter_sum(atom_e, gid, g.n_graphs)


# ---------------------------------------------------------------------------
# DimeNet  [arXiv:2003.03123] — 6 blocks, d=128, bilinear=8, sph=7, rad=6
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_atom_types: int = 100
    dtype: torch.dtype = torch.float32


def dimenet_init(cfg: DimeNetConfig, *, generator: torch.Generator | None,
                 device: str | torch.device | None = None) -> GNNParams:
    init = _initializer(cfg, generator, device)
    d = cfg.d_hidden
    blocks = [{"w_sbf": init.normal((cfg.n_spherical * cfg.n_radial,
                                     cfg.n_bilinear), 0.1),
               "bilinear": init.normal((d, cfg.n_bilinear, d),
                                       (d ** -0.5) * 0.1),
               "w_kj": init.mlp([d, d]),
               "w_ji": init.mlp([d, d]),
               "update": init.mlp([d, d, d])}
              for _ in range(cfg.n_blocks)]
    return GNNParams({"embed": init.normal((cfg.n_atom_types, d), 0.1),
                      "rbf_proj": init.mlp([cfg.n_radial, d]),
                      "edge_init": init.mlp([3 * d, d]),
                      "blocks": blocks,
                      "out": init.mlp([d, d // 2, 1])})


def dimenet_forward(cfg: DimeNetConfig, params: GNNParams,
                    g: GraphBatch) -> torch.Tensor:
    """Per-graph energy via directional message passing on edges, with the
    reference's Bessel-radial × Chebyshev-angular basis (n_radial ×
    n_spherical features)."""
    n = g.n_nodes
    src_safe = _clip_index(g.src, n)
    dst_safe = _clip_index(g.dst, n)
    vec = _rows(g.positions, dst_safe) - _rows(g.positions, src_safe)
    d_ij = _norm(vec + 1e-9)

    # Radial basis: sin(kπ d / c) / d  (Bessel j0 harmonics).
    kk = _const(torch.arange(1, cfg.n_radial + 1, dtype=torch.float32,
                             device=vec.device), vec)
    rbf = (torch.sin(kk * math.pi * (d_ij / cfg.cutoff)[:, None])
           / _max(d_ij, 1e-6)[:, None]).to(cfg.dtype)

    h = _atom_embed(params, g.node_feat)
    rbf_d = _mlp(params["rbf_proj"], rbf)
    m = _constrain_rows(_mlp(
        params["edge_init"],
        torch.cat([_rows(h, src_safe), _rows(h, dst_safe), rbf_d], -1),
        act=_silu, final_act=True))                         # [E, d]
    return _dimenet_blocks(cfg, params, g, m, rbf, vec, n)


def _pick_chunks(t: int, target: int) -> int:
    """Largest chunk count ≤ t/target that divides t."""
    n = max(1, t // target)
    while t % n:
        n -= 1
    return n


def _chunk_rows(idx: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """``idx`` [t] as [n_chunks, t / n_chunks], chunk i its i-th run. A
    DTensor split along t comes back split along each chunk instead:
    gathered whole, viewed, and each rank keeps its block of every chunk
    (DTensor cannot view a split dim as more chunks than its blocks
    divide)."""
    tc = idx.shape[0] // n_chunks
    if n_chunks == 1 or not shr.is_dtensor(idx) or not any(
            p.is_shard(0) for p in idx.placements):
        return idx.reshape(n_chunks, tc)
    from torch.distributed.tensor import Replicate, Shard
    mesh = idx.device_mesh
    whole = idx.redistribute(mesh, (Replicate(),) * mesh.ndim)
    return whole.reshape(n_chunks, tc).redistribute(mesh, tuple(
        Shard(1) if p.is_shard(0) else p for p in idx.placements))


def _carry_dtype(e: int, dtype: torch.dtype) -> torch.dtype:
    """The inter-block carry's dtype: bfloat16 from ``BF16_CARRY_EDGES``
    edges (halves the per-block stash; block math stays in ``dtype``)."""
    return torch.bfloat16 if e >= BF16_CARRY_EDGES else dtype


def _dimenet_blocks(cfg, params, g, m, rbf, vec, n, *,
                    chunk_target: int = TRIPLET_CHUNK):
    """Interaction blocks with the triplets streamed in chunks of about
    ``chunk_target`` (basis, gather, bilinear and scatter a chunk, each
    under checkpoint), accumulating into the per-edge aggregate. On a mesh
    the block's collectives run once a block (``_mesh_triplets``)."""
    e, d = m.shape
    t = g.trip_in.shape[0]
    n_chunks = _pick_chunks(t, chunk_target)
    if shr.is_dtensor(g.trip_in):
        aggregate = _mesh_triplets(cfg, g, vec, rbf, e, n_chunks)
    else:
        aggregate = _plain_triplets(cfg, g, vec, rbf, e, d, t, n_chunks)
    carry_dtype = _carry_dtype(e, m.dtype)

    def one_block(m_c, bp):
        m = m_c.to(cfg.dtype)
        m_kj = _constrain_rows(_mlp(bp["w_kj"], m))       # [E, d]
        agg = aggregate(m_kj, bp)
        m = m + _mlp(bp["update"], _mlp(bp["w_ji"], m) + agg, act=_silu)
        return _constrain_rows(m.to(carry_dtype))

    m = m.to(carry_dtype)
    for bp in params["blocks"]:
        m = _remat(one_block, m, bp)
    m = m.to(cfg.dtype)
    edge_e = _mlp(params["out"], m, act=_silu)[:, 0]
    node_e = scatter_sum(torch.where(g.dst < n, edge_e, 0), g.dst, n)
    gid = g.graph_id if g.graph_id is not None else _const(torch.zeros(
        n, dtype=torch.int32, device=m.device), m)
    return scatter_sum(node_e, gid, g.n_graphs)


def _plain_triplets(cfg, g, vec, rbf, e, d, t, n_chunks):
    """The block's triplet aggregate on plain tensors: ``aggregate(m_kj,
    bp)``, each chunk's scatter into its own [E, d] table, the tables
    summed."""
    tc = t // n_chunks
    ti_all = _chunk_rows(g.trip_in, n_chunks)
    to_all = _chunk_rows(g.trip_out, n_chunks)
    sph_k = torch.arange(cfg.n_spherical, device=vec.device)

    def triplet_chunk(m_kj, w_sbf, bilinear, ti_raw, to_raw):
        ti = _clip_index(ti_raw, e)
        to = _clip_index(to_raw, e)
        valid = (ti_raw < e) & (to_raw < e)
        v_in = -_rows(vec, ti)                            # j→k direction
        v_out = _rows(vec, to)
        # The reference's ``jnp.linalg.norm(x, -1)`` passes -1 as ``ord``
        # with no axis: the matrix norm of the whole chunk (the least
        # column sum of |x|, padding rows included), one scalar per chunk.
        cos_a = torch.sum(v_in * v_out, -1) / _max(
            torch.linalg.matrix_norm(v_in + 1e-9, ord=-1)
            * torch.linalg.matrix_norm(v_out + 1e-9, ord=-1), 1e-9)
        angles = torch.arccos(_clip(cos_a, -1.0, 1.0))
        # Chebyshev angular basis T_l(cos α) × radial basis of the in-edge.
        sph = torch.cos(angles[:, None] * sph_k)
        sbf = (sph[:, :, None] * _rows(rbf, ti).float()[:, None, :]
               ).reshape(tc, -1).to(cfg.dtype)
        basis = sbf @ w_sbf                               # [tc, n_bilinear]
        # Padded triplets are masked to 0; the reference gathers and
        # scatter-adds them at edge e - 1, which on the card is one row
        # taking every padded triplet's atomics (three quarters of
        # minibatch_lg's). Here they gather and add their 0 at rows spread
        # over [0, e): the same sums.
        spread = torch.remainder(torch.arange(tc, device=ti.device), e)
        ti_m = torch.where(valid, ti, spread)
        to_m = torch.where(valid, to, spread)
        # The reference's einsum("td,dbe,tb->te"), as one GEMM over (b, d).
        nb = basis.shape[1]
        outer = (basis[:, :, None]
                 * _rows(m_kj, ti_m)[:, None, :]).reshape(tc, -1)
        tmsg = outer @ bilinear.transpose(0, 1).reshape(nb * d, d)
        tmsg = torch.where(valid[:, None], tmsg, 0)
        return _constrain_rows(_index_add(e, to_m, tmsg))

    def aggregate(m_kj, bp):
        agg = None                  # the first chunk's sum starts it
        for idx in range(n_chunks):
            part = _remat(triplet_chunk, m_kj, bp["w_sbf"], bp["bilinear"],
                          ti_all[idx], to_all[idx])
            agg = part if agg is None else agg + part
        return agg

    return aggregate


class _GatherRows(torch.autograd.Function):
    """``x.index_select(0, index)`` whose backward adds the gradient into
    one zero table in place (``index_select``'s adds it into a copy of
    the zeros: two [E, d] tables where one will do)."""

    @staticmethod
    def forward(ctx, x, index):
        ctx.save_for_backward(index)
        ctx.x_shape = x.shape
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        index, = ctx.saved_tensors
        return grad.new_zeros(ctx.x_shape).index_add_(0, index, grad), None


def _whole(x, split: tuple):
    """A DTensor whole on this rank (an all-gather; its gradient comes
    back as the ranks' partial sums over ``split``, reduced once); a
    plain tensor as it is."""
    if not shr.is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return shr.local(x, (Replicate(),) * x.device_mesh.ndim, partial=split)


def _chunk_norm(x: torch.Tensor, mesh, split: tuple) -> torch.Tensor:
    """``matrix_norm(x, ord=-1)`` of a chunk whose rows are split over the
    mesh dims ``split``, from this rank's rows ``x``: the column sums of
    |x| summed over those ranks, the least of them."""
    cols = torch.linalg.vector_norm(x, 1, dim=0)
    if split:
        from torch.distributed.tensor import Partial, Replicate
        cols = shr.from_local(cols, mesh, tuple(
            Partial() if i in split else Replicate()
            for i in range(mesh.ndim)))
        cols = cols.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local()
    return cols.amin()


def _mesh_triplets(cfg, g, vec, rbf, e, n_chunks):
    """The block's triplet aggregate on a mesh: ``aggregate(m_kj, bp)``
    with the triplet ids' rows split over the data axes.

    Every collective runs once a block, not once a chunk: ``m_kj`` is
    gathered whole and the rows of all the rank's triplets taken from it
    at once (its gradient is added into one [E, d] table and
    reduce-scattered once); the chunks scatter into one [E, d] accumulator
    of this rank's partial sums, reduce-scattered once onto the rows; the
    block's weights are taken whole once (their gradients all-reduced
    once). Edge directions and radial bases are gathered once a step (no
    gradient). The chunk's angle keeps the reference's norm of the whole
    chunk: a sum over the ranks of 3 column sums. The gathered ``m_kj`` is
    freed once its rows are taken: the block holds the rank's rows (T / n_d
    of them) and one [E, d] table at a time, forward and backward."""
    ti_all = _chunk_rows(g.trip_in, n_chunks)        # [n_chunks, tc]
    to_all = _chunk_rows(g.trip_out, n_chunks)
    mesh, pl = ti_all.device_mesh, ti_all.placements
    if any(p.is_shard(0) for p in pl):
        raise ValueError(f"triplet chunks split across chunks: {pl}")
    split = shr.sharded_dims(pl)
    ti_raw, to_raw = shr.local(ti_all, pl), shr.local(to_all, pl)
    tc = ti_raw.shape[1]
    ti, to = _clip_index(ti_raw, e), _clip_index(to_raw, e)
    valid = (ti_raw < e) & (to_raw < e)
    start = shr.block_offset(mesh, pl, 1, tc)
    spread = torch.remainder(torch.arange(start, start + tc,
                                          device=ti.device), e)
    ti_m = torch.where(valid, ti, spread)
    to_m = torch.where(valid, to, spread)
    vec_w, rbf_w = _whole(vec, split), _whole(rbf, split)
    sph_k = torch.arange(cfg.n_spherical, device=ti.device)

    def chunk_msg(rows, w_sbf, wr, i):
        v_in = -vec_w.index_select(0, ti[i])               # j→k direction
        v_out = vec_w.index_select(0, to[i])
        cos_a = torch.sum(v_in * v_out, -1) / _max(
            _chunk_norm(v_in + 1e-9, mesh, split)
            * _chunk_norm(v_out + 1e-9, mesh, split), 1e-9)
        angles = torch.arccos(_clip(cos_a, -1.0, 1.0))
        sph = torch.cos(angles[:, None] * sph_k)
        sbf = (sph[:, :, None] * rbf_w.index_select(0, ti[i]).float()[
            :, None, :]).reshape(tc, -1).to(cfg.dtype)
        basis = sbf @ w_sbf                               # [tc, n_bilinear]
        outer = (basis[:, :, None] * rows[:, None, :]).reshape(tc, -1)
        return torch.where(valid[i][:, None], outer @ wr, 0)

    def aggregate(m_kj, bp):
        d = m_kj.shape[1]
        mkj = _whole(m_kj, split)                         # [E, d]
        rows = _GatherRows.apply(mkj, ti_m.reshape(-1)).view(n_chunks, tc, d)
        del mkj
        w_sbf = _whole(bp["w_sbf"], split)
        bilinear = _whole(bp["bilinear"], split)
        wr = bilinear.transpose(0, 1).reshape(-1, d)      # [(b, d), d]
        acc = rows.new_zeros((e, d))
        for i, rows_i in enumerate(rows.unbind(0)):
            acc.index_add_(0, to_m[i], _remat(chunk_msg, rows_i, w_sbf, wr,
                                              i))
        return _summed(acc, ti_all)

    return aggregate


# ---------------------------------------------------------------------------
# MeshGraphNet  [arXiv:2010.03409] — 15 layers, d=128, sum agg, 2-layer MLPs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MGNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_in_node: int = 8
    d_in_edge: int = 4
    d_out: int = 3
    dtype: torch.dtype = torch.float32


def _ln(x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6)


def mgn_init(cfg: MGNConfig, *, generator: torch.Generator | None,
             device: str | torch.device | None = None) -> GNNParams:
    """The processor's identical layers stacked on a leading L axis, as
    the reference's scannable tree."""
    init = _initializer(cfg, generator, device)
    d = cfg.d_hidden
    dims_node = [2 * d] + [d] * cfg.mlp_layers
    dims_edge = [3 * d] + [d] * cfg.mlp_layers
    layers = [{"edge_mlp": init.mlp(dims_edge),
               "node_mlp": init.mlp(dims_node)}
              for _ in range(cfg.n_layers)]
    stacked = {k: [tuple(torch.stack([lay[k][i][j] for lay in layers])
                         for j in range(2))
                   for i in range(len(layers[0][k]))]
               for k in ("edge_mlp", "node_mlp")}
    return GNNParams({"enc_node": init.mlp([cfg.d_in_node, d, d]),
                      "enc_edge": init.mlp([cfg.d_in_edge, d, d]),
                      "layers": stacked,
                      "dec": init.mlp([d, d, cfg.d_out])})


def mgn_forward(cfg: MGNConfig, params: GNNParams,
                g: GraphBatch) -> torch.Tensor:
    """Per-node output [N, d_out]. The processor layers run one after the
    other, each under checkpoint (O(1)-in-depth stash)."""
    n = g.n_nodes
    src_safe = _clip_index(g.src, n)
    dst_safe = _clip_index(g.dst, n)
    h = _mlp(params["enc_node"], g.node_feat.to(cfg.dtype))
    if g.positions is not None:
        rel = _rows(g.positions, dst_safe) - _rows(g.positions, src_safe)
        dist = _norm(rel + 1e-9, keepdim=True)
        ef = torch.cat([rel, dist], -1).to(cfg.dtype)
    else:
        ef = _const(torch.zeros((g.src.shape[0], cfg.d_in_edge),
                                dtype=cfg.dtype, device=h.device), h)
    he = _mlp(params["enc_edge"], ef)
    dst_ok = (g.dst < n)[:, None]

    def one_layer(h, he, edge_mlp, node_mlp):
        e_in = torch.cat([he, _rows(h, src_safe), _rows(h, dst_safe)], -1)
        he = _constrain_rows(he + _ln(_mlp(edge_mlp, e_in)))
        agg = scatter_sum(torch.where(dst_ok, he, 0), g.dst, n)
        n_in = torch.cat([h, agg], -1)
        h = _constrain_rows(h + _ln(_mlp(node_mlp, n_in)))
        return h, he

    stacked = params["layers"]
    for i in range(cfg.n_layers):
        edge_mlp = [(w[i], b[i]) for w, b in stacked["edge_mlp"]]
        node_mlp = [(w[i], b[i]) for w, b in stacked["node_mlp"]]
        h, he = _remat(one_layer, h, he, edge_mlp, node_mlp)
    return _mlp(params["dec"], h)


# ---------------------------------------------------------------------------
# Dispatch by architecture
# ---------------------------------------------------------------------------

INIT = {"gat-cora": gat_init, "schnet": schnet_init,
        "dimenet": dimenet_init, "meshgraphnet": mgn_init}
FORWARD = {"gat-cora": gat_forward, "schnet": schnet_forward,
           "dimenet": dimenet_forward, "meshgraphnet": mgn_forward}
