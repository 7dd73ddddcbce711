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
edges, triplets), the same on each rank of ``model``, and the parameters
are replicated. The dense steps are DTensor ops; the gathers
(``_gather_rows``) and scatters (``scatter_sum``, the softmax's max) run
explicit collectives on each rank's blocks, whole or by blocks as the
shapes make cheaper (see "Gathers and scatters over a mesh" below), and
the gathers that read their tables at one point share each collective. A
scatter's result stays on the rows by blocks; whole, it is placed back on
the rows when ``set_gnn_data_axes`` is set, else replicated. DimeNet's
triplet chunks gather the edge states and reduce the aggregate once a
block (``_mesh_triplets``). The softmax's max passes its gradient (zero
in exact arithmetic: a softmax does not depend on the shift it subtracts)
to each rank's own largest score.

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
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint
from torch.utils.weak import WeakIdKeyDictionary

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


def _index_add(n: int, index: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """``zeros(n, ...).index_add(0, index, values)`` (every index in
    [0, n))."""
    return values.new_zeros((n,) + values.shape[1:]).index_add(0, index,
                                                               values)


def _scatter_local(values: torch.Tensor, index: torch.Tensor, n: int,
                   reduce: str = "sum") -> torch.Tensor:
    """The sum (or max, -1e30 where no row lands) of ``values`` rows into
    ``n`` rows by ``index``; an index ≥ n (padding) goes to a drop row
    that is cut off, as ``mode="drop"``."""
    idx = torch.where(index < n, index, n).long()
    if reduce == "sum":
        out = values.new_zeros((n + 1,) + values.shape[1:])
        return out.index_add(0, idx, values)[:n]
    out = torch.full((n + 1,) + values.shape[1:], -1e30, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, _expand_rows(idx, values), values,
                              "amax")[:n]


def scatter_sum(values: torch.Tensor, index: torch.Tensor,
                n: int) -> torch.Tensor:
    """Σ of ``values`` rows into ``n`` rows by ``index``; an index ≥ n
    (padding) goes to a drop row that is cut off, as ``mode="drop"``. On
    a mesh, ``_mesh_scatter``."""
    if shr.is_dtensor(index):
        return _mesh_scatter(values, index, n, "sum")
    return _scatter_local(values, index, n)


def _clip_index(index: torch.Tensor, n: int) -> torch.Tensor:
    """An index clipped into [0, n), for a gather (no gradient)."""
    return torch.clamp(index, 0, n - 1).long()


def _rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` for a differentiated ``x``: its backward is
    ``index_add`` (one atomic add a row), where ``x[index]``'s sorts the
    index and walks each repeated row in one warp, which serializes a hub
    (rmat's thousands of edges out of one node) or a padding row. On a
    mesh, ``_gather_rows``."""
    return _gather_rows((x, index))[0]


# ---------------------------------------------------------------------------
# Gathers and scatters over a mesh
# ---------------------------------------------------------------------------
#
# A graph's index (``src``, ``dst``, the triplets' edge ids) has its rows
# split over the data axes D (n_d blocks) and the same on every rank of
# the other mesh dims M (``model``: m ranks). A table split over D as the
# index's rows is read and written in one of two layouts, chosen per call
# from the shapes (``_by_blocks``):
#   * whole: the table all-gathered over D and each rank's own index rows
#     taken from it, the gradients added into one whole table and
#     reduce-scattered over D once; a scatter adds the rank's rows into a
#     whole table, reduce-scattered over D (all-reduced when the rows are
#     not constrained).
#   * by blocks, the decomposition of the reference's partitioner (its
#     HLO: edge blocks over ``model``, node blocks over D): each D rank's
#     index rows are cut into m pieces (the last padded), and rank
#     (dc, mc) takes piece mc of every D rank's rows (int32 gathered over
#     D, ``_block_plan``). A gather takes rows from the rank's own node
#     block only
#     (zeros elsewhere); one reduce-scatter over D leaves each rank its
#     own piece summed and one all-gather over M assembles its D rank's
#     rows, the layout ``_constrain_rows`` places (the reference
#     all-reduces over D, then permutes: the same sum, landing where its
#     permute takes it). A scatter takes the pieces' values (an all-gather
#     over D), adds them into the rank's node block, and one all-reduce
#     over M sums the block. Each side's backward is the other's forward;
#     the gathers of one call share each collective.
# Each collective runs over one group: several data axes (``("pod",
# "data")``) are flattened into one (``sharding.group_over``).

@dataclasses.dataclass(frozen=True)
class _Split:
    """How an index's rows lie on its mesh: split over mesh dims ``d``
    (``n_d`` blocks, this rank's ``dc``), the same on each rank of the
    others (``m`` ranks, this rank's ``mc``), with the group over each
    (None for one rank)."""
    mesh: object
    d: tuple
    n_d: int
    m: int
    dc: int
    mc: int
    d_group: object
    m_group: object

    def rows(self) -> tuple:
        """The placements of a tensor whose rows are split as the
        index's."""
        from torch.distributed.tensor import Replicate, Shard
        return tuple(Shard(0) if i in self.d else Replicate()
                     for i in range(self.mesh.ndim))


def _split_of(index) -> _Split:
    mesh = index.device_mesh
    d = shr.sharded_dims(index.placements)
    rest = tuple(i for i in range(mesh.ndim) if i not in d)
    return _Split(mesh, d, math.prod(mesh.size(i) for i in d),
                  math.prod(mesh.size(i) for i in rest),
                  shr.flat_coordinate(mesh, d),
                  shr.flat_coordinate(mesh, rest),
                  shr.group_over(mesh, d), shr.group_over(mesh, rest))


def _piece(sp: _Split, k_loc: int) -> int:
    """The rows of one of the m pieces of a D rank's k_loc index rows (the
    last padded)."""
    return -(-k_loc // sp.m)


def _blocks_cheaper(sp: _Split, n: int, k: int) -> bool:
    """Whether k index rows (over all D ranks) against a table of n rows
    move fewer rows a card by blocks than whole, counted as the dry run
    counts them (each collective's operand) over a gather and its gradient
    (a scatter and its gradient move the same). With pieces of q rows: by
    blocks n_d·q reduce-scattered over D, q all-gathered over M and again
    over D, n/n_d all-reduced over M; whole, n/n_d all-gathered over D and
    n reduce-scattered."""
    return _piece(sp, k // sp.n_d) * (sp.n_d + 2) < n


def _by_blocks(sp: _Split, n: int, k: int) -> bool:
    """Whether a gather from (or a scatter into) a table of n rows by k
    index rows goes by blocks: more than one rank, and cheaper
    (``_blocks_cheaper``)."""
    return (sp.n_d * sp.m > 1 and n % sp.n_d == 0
            and _blocks_cheaper(sp, n, k))


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """[q, ...] → [n·q, ...]: the group's blocks in rank order."""
    if group is None:
        return t
    out = t.new_empty((n * t.shape[0],) + t.shape[1:])
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def _reduce_scatter(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """[n·q, ...] summed over the group, rank r keeping block r."""
    if group is None:
        return t
    out = t.new_empty((t.shape[0] // n,) + t.shape[1:])
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


def _all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` summed (or its max taken) over the group, in place."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
    return t


def _expand_rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row ``mask`` [k] broadcast to ``like`` [k, ...]."""
    return mask.view((-1,) + (1,) * (like.dim() - 1)).expand_as(like)


class _Plan(NamedTuple):
    """A rank's rows of a gather or scatter by blocks (``_block_plan``)."""
    lidx: torch.Tensor      # [n_d·q] int32: each row's row in the block
    ok: torch.Tensor        # [n_d·q] whether the node block holds it
    k_loc: int              # the D rank's index rows (m·q less padding)


def _block_plan(sp: _Split, il: torch.Tensor, n: int) -> _Plan:
    """This rank's rows of a gather or scatter by blocks against a table of
    n rows, from ``il``, its D rank's index rows: piece ``mc`` of every D
    rank's rows (padded with n to m equal pieces; an all-gather over D),
    each with its row in this rank's node block and whether the block
    holds it (an index ≥ n is held by none). A row not held points at a
    row spread over the block, so that no one row takes their adds."""
    k_loc = il.shape[0]
    pad = sp.m * _piece(sp, k_loc) - k_loc
    if pad:
        il = torch.cat([il, il.new_full((pad,), n)])
    piece = il.reshape(sp.m, -1)[sp.mc].to(torch.int32)
    b = _all_gather(piece, sp.d_group, sp.n_d).long()
    n_loc = n // sp.n_d
    local = b - sp.dc * n_loc
    ok = (local >= 0) & (local < n_loc)
    spread = torch.remainder(torch.arange(b.shape[0], device=b.device),
                             n_loc)
    return _Plan(torch.where(ok, local, spread).int(), ok, k_loc)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows after it up to ``rows``."""
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


#: Each index DTensor's ``_Split`` and rows on this rank (a view), made
#: once and dropped with it. Block plans are not kept here: a batch's own
#: index (``g.dst``) outlives the step's graph, and a plan lives as long
#: as the graph that saves it.
_SPLITS = WeakIdKeyDictionary()


def _index_split(index) -> tuple:
    """(``_Split``, this rank's rows) of an index DTensor."""
    got = _SPLITS.get(index)
    if got is None:
        got = (_split_of(index), shr.local(index, index.placements))
        _SPLITS[index] = got
    return got


def _pack(ts, lead: int) -> torch.Tensor:
    """Tensors whose rows split into ``lead`` equal runs as one [lead, Σ]
    buffer: run r of each, one after the other."""
    if len(ts) == 1:
        return ts[0].reshape(lead, -1)
    return torch.cat([t.reshape(lead, -1) for t in ts], 1)


def _unpack(buf: torch.Tensor, lead: int, shapes) -> list:
    """``_pack``'s inverse: a tensor of each of ``shapes`` from ``buf``."""
    sizes = [math.prod(s) // lead for s in shapes]
    return [p.reshape(s) for p, s in
            zip(buf.reshape(lead, -1).split(sizes, 1), shapes)]


def _columns(widths) -> list:
    """The first column of each of tables of ``widths`` side by side."""
    return [sum(widths[:j]) for j in range(len(widths))]


class _GatherBlocks(torch.autograd.Function):
    """``tables[j][index]`` by blocks for each ``(j, plan)`` of ``pairs``
    (the tables [n_loc, w_j] of one dtype): the rows the rank's
    node block holds, zeros elsewhere; one reduce-scatter over D, one
    all-gather over M. Backward: one all-gather over D of the pieces'
    gradients, each added into its table's node block, one all-reduce over
    M of all the tables side by side."""

    @staticmethod
    def forward(ctx, sp, pairs, *tables):
        ctx.sp, ctx.n_loc = sp, tables[0].shape[0]
        ctx.widths = [t.shape[1] for t in tables]
        ctx.which = [(j, plan.k_loc) for j, plan in pairs]
        ctx.save_for_backward(*(t for _j, plan in pairs
                                for t in (plan.lidx, plan.ok)))
        parts = []
        for j, plan in pairs:
            part = tables[j].index_select(0, plan.lidx)
            parts.append(part.masked_fill_(_expand_rows(~plan.ok, part), 0))
        mine = _reduce_scatter(_pack(parts, sp.n_d), sp.d_group, sp.n_d)
        every = _all_gather(mine, sp.m_group, sp.m)            # [m, Σ]
        return tuple(o[:plan.k_loc] for o, (_j, plan) in zip(_unpack(
            every, sp.m, [(sp.m * plan.lidx.shape[0] // sp.n_d,
                           ctx.widths[j]) for j, plan in pairs]), pairs))

    @staticmethod
    def backward(ctx, *grads):
        sp, widths = ctx.sp, ctx.widths
        saved = ctx.saved_tensors
        pairs = [(j, _Plan(saved[2 * i], saved[2 * i + 1], k_loc))
                 for i, (j, k_loc) in enumerate(ctx.which)]
        mine = torch.cat([
            _pad_rows(g, sp.m * plan.lidx.shape[0] // sp.n_d).reshape(
                sp.m, -1)[sp.mc] for g, (_j, plan) in zip(grads, pairs)])
        every = _all_gather(mine[None], sp.d_group, sp.n_d)    # [n_d, Σ]
        parts = _unpack(every, sp.n_d, [(plan.lidx.shape[0], widths[j])
                                        for j, plan in pairs])
        cols = _columns(widths)
        buf = every.new_zeros((ctx.n_loc, sum(widths)))
        for part, (j, plan) in zip(parts, pairs):
            buf[:, cols[j]:cols[j] + widths[j]].index_add_(
                0, plan.lidx,
                part.masked_fill_(_expand_rows(~plan.ok, part), 0))
        _all_reduce(buf, sp.m_group)
        return (None, None,
                *(buf[:, a:a + w] for a, w in zip(cols, widths)))


class _GatherWhole(torch.autograd.Function):
    """``tables[j][index]`` whole for each ``(j, index)`` of ``pairs``
    (the tables [n_loc, w_j] of one dtype, side by side): one all-gather
    over D, each rank's own index rows taken from it. Backward: every
    gradient added into one whole table (each table's columns),
    reduce-scattered over D once."""

    @staticmethod
    def forward(ctx, sp, pairs, *tables):
        ctx.sp, ctx.which = sp, [j for j, _idx in pairs]
        ctx.widths = [t.shape[1] for t in tables]
        ctx.save_for_backward(*(idx for _j, idx in pairs))
        side = tables[0] if len(tables) == 1 else torch.cat(tables, 1)
        whole = _all_gather(side, sp.d_group, sp.n_d)
        cols = _columns(ctx.widths)
        ctx.n = whole.shape[0]
        return tuple(whole[:, cols[j]:cols[j] + ctx.widths[j]].index_select(
            0, idx) for j, idx in pairs)

    @staticmethod
    def backward(ctx, *grads):
        sp, widths = ctx.sp, ctx.widths
        cols = _columns(widths)
        buf = grads[0].new_zeros((ctx.n, sum(widths)))
        for g, j, idx in zip(grads, ctx.which, ctx.saved_tensors):
            buf[:, cols[j]:cols[j] + widths[j]].index_add_(0, idx, g)
        mine = _reduce_scatter(buf, sp.d_group, sp.n_d)
        return (None, None,
                *(mine[:, a:a + w] for a, w in zip(cols, widths)))


def _take(sp: _Split, items) -> list:
    """The rank's rows ``x[index]`` [k_loc, ...] of each ``(x, il, plan)``
    of ``items``: ``x`` a DTensor table, ``il`` the rank's index rows,
    ``plan`` its block plan (``_block_plan``) or None to go whole. A table
    replicated on the mesh is read on the rank (its gradient summed over
    D); any other is placed as the index's rows. The tables that go one
    way share one collective a side (by dtype and rows). At one rank each
    pair is read on its own, as with no mesh, so the step is the no-mesh
    step bit for bit."""
    out = [None] * len(items)
    calls: dict = {}
    for i, (x, il, plan) in enumerate(items):
        if all(p.is_replicate() for p in x.placements):
            out[i] = _replicated(x, sp).index_select(0, il)
            continue
        if sp.n_d * sp.m == 1:     # each read on its own, as with no mesh
            out[i] = shr.local(x, sp.rows()).index_select(0, il)
            continue
        key = (plan is not None, x.dtype, x.shape[0])
        tables, pairs, slots = calls.setdefault(key, ([], [], []))
        if not any(t is x for t in tables):
            tables.append(x)
        j = next(j for j, t in enumerate(tables) if t is x)
        pairs.append((j, plan if plan is not None else il))
        slots.append(i)
    for (blocks, _dtype, _n), (tables, pairs, slots) in calls.items():
        local = [shr.local(x, sp.rows()) for x in tables]
        flat = [t.reshape(t.shape[0], -1) for t in local]
        got = (_GatherBlocks if blocks else _GatherWhole).apply(sp, pairs,
                                                                *flat)
        for i, g, (j, _p) in zip(slots, got, pairs):
            out[i] = g.reshape((-1,) + local[j].shape[1:])
    return out


def _gather_rows(*pairs) -> list:
    """``x[index]`` for each ``(x, index)`` of ``pairs``, tables read at the
    same point. Plain tensors: ``index_select``. On a mesh (every index a
    DTensor split over the same data axes D) each goes whole or by blocks
    (``_by_blocks`` on its table's and index's rows; a table replicated on
    the mesh is read on the rank), and the pairs that go one way share
    their collectives: one a side for all of them."""
    if not shr.is_dtensor(pairs[0][1]):
        return [x.index_select(0, index) for x, index in pairs]
    items = []
    for x, index in pairs:
        sp, il = _index_split(index)
        n, k = x.shape[0], index.shape[0]
        blocks = _by_blocks(sp, n, k) and not all(p.is_replicate()
                                                  for p in x.placements)
        items.append((x, il, _block_plan(sp, il, n) if blocks else None))
    out = _take(sp, items)
    return [shr.from_local(o, sp.mesh, sp.rows()) for o in out]


class _ToBlocks(torch.autograd.Function):
    """Rows split as an index's [k_loc, ...] → the rank's rows of a scatter
    by blocks [n_d·k_loc/m, ...]: piece ``mc`` of every D rank's rows, one
    all-gather over D. Backward: one reduce-scatter over D of their
    gradients, one all-gather over M."""

    @staticmethod
    def forward(ctx, sp, t):
        ctx.sp, ctx.shape = sp, t.shape
        piece = _pad_rows(t, sp.m * _piece(sp, t.shape[0])).reshape(
            sp.m, -1)[sp.mc]
        return _all_gather(piece[None], sp.d_group, sp.n_d).reshape(
            (-1,) + t.shape[1:])

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp
        mine = _reduce_scatter(g.reshape(sp.n_d, -1), sp.d_group, sp.n_d)
        every = _all_gather(mine, sp.m_group, sp.m)
        return None, every.reshape((-1,) + ctx.shape[1:])[:ctx.shape[0]]


class _Reduce(torch.autograd.Function):
    """Each rank's partial rows summed (``op`` "sum") or their max taken
    over ``group``. The result feeds the same computation on every rank of
    the group, so the gradient passes through (a max's to each rank's own
    largest entries)."""

    @staticmethod
    def forward(ctx, t, group, op):
        return _all_reduce(t.clone(), group, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceScatter(torch.autograd.Function):
    """Each rank's partial table [n, ...] summed over ``group``, rank r
    keeping its rows' block r; the backward all-gathers the gradient."""

    @staticmethod
    def forward(ctx, t, group, n):
        ctx.group, ctx.n = group, n
        return _reduce_scatter(t, group, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.n), None, None


def _reduce_whole(sp: _Split, out: torch.Tensor, reduce: str):
    """A whole-table scatter's partial result ``out`` [n, ...] on each rank
    as a DTensor: a sum reduce-scattered onto the rows over D when the rows
    are constrained (and n splits evenly), else all-reduced over D,
    replicated."""
    from torch.distributed.tensor import Replicate
    if (reduce == "sum" and _GNN_DATA_AXES.get()
            and out.shape[0] % sp.n_d == 0):
        if sp.d_group is not None:
            out = _ReduceScatter.apply(out, sp.d_group, sp.n_d)
        return shr.from_local(out, sp.mesh, sp.rows())
    if sp.d_group is not None:
        out = _Reduce.apply(out, sp.d_group, reduce)
    return shr.from_local(out, sp.mesh, (Replicate(),) * sp.mesh.ndim)


def _scatter_blocks(sp: _Split, values: torch.Tensor, plan: tuple, n: int,
                    reduce: str):
    """A scatter by blocks of the rank's rows ``values`` (split as the
    index's) into a table of n rows split over D: the pieces' values
    (``_ToBlocks``) added (or their max taken, -1e30 where none lands)
    into the rank's node block, one all-reduce over M. A DTensor placed as
    the index's rows."""
    lidx, ok, _k = plan
    vb = _ToBlocks.apply(sp, values)
    shape = (n // sp.n_d,) + vb.shape[1:]
    if reduce == "sum":
        out = vb.new_zeros(shape).index_add(
            0, lidx, torch.where(_expand_rows(ok, vb), vb, 0))
    else:
        out = torch.full(shape, -1e30, dtype=vb.dtype, device=vb.device
                         ).scatter_reduce(
            0, _expand_rows(lidx.long(), vb),
            torch.where(_expand_rows(ok, vb), vb, -1e30), "amax")
    if sp.m_group is not None:
        out = _Reduce.apply(out, sp.m_group, reduce)
    return shr.from_local(out, sp.mesh, sp.rows())


def _mesh_scatter(values: torch.Tensor, index, n: int, reduce: str):
    """``scatter_sum`` (or ``_segment_max``) on a mesh: by blocks or whole
    (``_by_blocks``), the whole table's result as ``_reduce_whole`` places
    it."""
    sp, il = _index_split(index)
    vl = shr.local(values, sp.rows())
    if _by_blocks(sp, n, index.shape[0]):
        return _scatter_blocks(sp, vl, _block_plan(sp, il, n), n, reduce)
    return _reduce_whole(sp, _scatter_local(vl, il, n, reduce), reduce)


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
        return _mesh_scatter(scores, index, n, "max")
    return _scatter_local(scores, index, n, "max")


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
        scores = _leaky_relu(torch.add(*_gather_rows(
            (e_src, src_safe), (e_dst, dst_safe))))           # [E, H]
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
    d_ij = _norm(torch.sub(*_gather_rows((g.positions, dst_safe),
                                         (g.positions, src_safe))) + 1e-9)
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
    vec = torch.sub(*_gather_rows((g.positions, dst_safe),
                                  (g.positions, src_safe)))
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
        torch.cat([*_gather_rows((h, src_safe), (h, dst_safe)), rbf_d], -1),
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


class _SummedGrad(torch.autograd.Function):
    """A table replicated on the mesh that each rank reads for its own
    share of the work: the forward passes it through, the backward sums
    its gradient over ``group`` (one all-reduce, over the data axes
    together)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


def _replicated(x, sp: _Split) -> torch.Tensor:
    """DTensor ``x``, replicated on the mesh, whole on this rank; its
    gradient is summed over D (``_SummedGrad``)."""
    from torch.distributed.tensor import Replicate
    t = shr.local(x, (Replicate(),) * sp.mesh.ndim)
    return t if sp.d_group is None else _SummedGrad.apply(t, sp.d_group)


def _chunk_norm(x: torch.Tensor, sp: _Split) -> torch.Tensor:
    """``matrix_norm(x, ord=-1)`` of a chunk whose rows are split over D,
    from this rank's rows ``x`` (no gradient): the column sums of |x|
    summed over D, the least of them."""
    return _all_reduce(torch.linalg.vector_norm(x, 1, dim=0), sp.d_group
                       ).amin()


def _mesh_triplets(cfg, g, vec, rbf, e, n_chunks):
    """The block's triplet aggregate on a mesh: ``aggregate(m_kj, bp)``
    with the triplet ids' rows split over the data axes D.

    Every collective runs once a block, not once a chunk, whole or by
    blocks as ``_by_blocks`` picks from (E, T): the rows of all the rank's
    triplets are gathered from ``m_kj`` at once (``_take``), and the
    chunks' messages reduced once: whole, each chunk adds into one [E, d]
    accumulator of the rank's partial sums, reduce-scattered once onto the
    rows; by blocks, the chunks' messages [T / n_d, d] are scattered into
    the rank's node block (``_scatter_blocks``). The block's weights are
    taken whole once (their gradients all-reduced once). Edge directions
    and radial bases are gathered once a step (no gradient). The chunk's
    angle keeps the reference's norm of the whole chunk: a sum over D of 3
    column sums."""
    ti_all = _chunk_rows(g.trip_in, n_chunks)        # [n_chunks, tc]
    to_all = _chunk_rows(g.trip_out, n_chunks)
    pl = ti_all.placements
    if any(p.is_shard(0) for p in pl):
        raise ValueError(f"triplet chunks split across chunks: {pl}")
    sp = _split_of(ti_all)
    ti_raw, to_raw = shr.local(ti_all, pl), shr.local(to_all, pl)
    tc = ti_raw.shape[1]
    # int32 ids: the closure holds them for the step.
    ti, to = _clip_index(ti_raw, e).int(), _clip_index(to_raw, e).int()
    valid = (ti_raw < e) & (to_raw < e)
    start = shr.block_offset(sp.mesh, pl, 1, tc)
    spread = torch.remainder(torch.arange(start, start + tc,
                                          device=ti.device,
                                          dtype=torch.int32), e)
    ti_m = torch.where(valid, ti, spread)
    to_m = torch.where(valid, to, spread)
    blocks = _by_blocks(sp, e, sp.n_d * ti_m.numel())
    vec_w = _all_gather(shr.local(vec, sp.rows()), sp.d_group, sp.n_d)
    rbf_w = _all_gather(shr.local(rbf, sp.rows()), sp.d_group, sp.n_d)
    sph_k = torch.arange(cfg.n_spherical, device=ti.device)

    def chunk_msg(rows, w_sbf, wr, i):
        v_in = -vec_w.index_select(0, ti[i])               # j→k direction
        v_out = vec_w.index_select(0, to[i])
        cos_a = torch.sum(v_in * v_out, -1) / _max(
            _chunk_norm(v_in + 1e-9, sp) * _chunk_norm(v_out + 1e-9, sp),
            1e-9)
        angles = torch.arccos(_clip(cos_a, -1.0, 1.0))
        sph = torch.cos(angles[:, None] * sph_k)
        sbf = (sph[:, :, None] * rbf_w.index_select(0, ti[i]).float()[
            :, None, :]).reshape(tc, -1).to(cfg.dtype)
        basis = sbf @ w_sbf                               # [tc, n_bilinear]
        outer = (basis[:, :, None] * rows[:, None, :]).reshape(tc, -1)
        return torch.where(valid[i][:, None], outer @ wr, 0)

    def aggregate(m_kj, bp):
        d = m_kj.shape[1]
        plan = _block_plan(sp, ti_m.reshape(-1), e) if blocks else None
        rows, = _take(sp, [(m_kj, ti_m.reshape(-1), plan)])
        rows = rows.view(n_chunks, tc, d)
        w_sbf = _replicated(bp["w_sbf"], sp)
        wr = _replicated(bp["bilinear"], sp).transpose(0, 1).reshape(-1, d)
        if blocks:
            msgs = rows.new_empty(rows.shape)
            for i, rows_i in enumerate(rows.unbind(0)):
                msgs[i] = _remat(chunk_msg, rows_i, w_sbf, wr, i)
            return _scatter_blocks(sp, msgs.view(-1, d),
                                   _block_plan(sp, to_m.reshape(-1), e), e,
                                   "sum")
        acc = rows.new_zeros((e, d))
        for i, rows_i in enumerate(rows.unbind(0)):
            acc.index_add_(0, to_m[i], _remat(chunk_msg, rows_i, w_sbf, wr,
                                              i))
        return _reduce_whole(sp, acc, "sum")

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
        rel = torch.sub(*_gather_rows((g.positions, dst_safe),
                                      (g.positions, src_safe)))
        ef = torch.cat([rel, _norm(rel + 1e-9, keepdim=True)], -1).to(
            cfg.dtype)
    else:
        ef = _const(torch.zeros((g.src.shape[0], cfg.d_in_edge),
                                dtype=cfg.dtype, device=h.device), h)
    he = _mlp(params["enc_edge"], ef)
    dst_ok = (g.dst < n)[:, None]

    def one_layer(h, he, edge_mlp, node_mlp):
        e_in = torch.cat([he, *_gather_rows((h, src_safe), (h, dst_safe))],
                         -1)
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
