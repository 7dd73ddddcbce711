"""Multi-tenant forest fleet: T session graphs in one process (DESIGN.md §13).

The port of ``repro.dynamic.fleet``. ``serve_stream`` drives one
``DynamicForest``; a fleet serves many independent session graphs at once.

  * ``ForestFleet`` stacks T tenant forests array-of-structs: one
    ``parent[T, n]`` (etc.) per field, one shared (n, capacity) schema, in
    the tenant-local layout of the reference (each lane holds its
    tenant's own ids and the sentinel n). ``version`` and ``active`` are
    host arrays, as the single forest's version is a host int.
  * The reference vmaps its single-tenant ``while_loop``s over the tenant
    axis. Here every fleet call runs the single-tenant code once over the
    **disjoint union** of its lanes (``ForestFleet.as_forest``): T·n
    vertices, lane t's vertex v at t·n + v and its pool slot c at t·C + c,
    one union sentinel T·n. Lanes share no vertex, so a converged lane is
    a fixed point of every loop, and each lane's result is the one a call
    of its own gives. The loops then run until every lane converges, at
    one host read a round for all: ``apply_batches`` pays
    ``max_t(rounds_t) + 1`` reads a tick, against ``Σ_t(rounds_t + 1)``
    for T separate calls (``fleet_sync_cost``; the §13 headline
    ``benchmarks/table8_fleet.py`` measures). The offsets, the sentinel
    and the per-lane counts live only inside the fleet functions and the
    ``lanes=`` arguments of the code they call; every lane count is the
    lane's own, as the reference's vmapped carries keep it.
  * ``refresh_tours`` / ``refresh_bccs`` / ``build_fleet_tables`` refresh
    the §9/§10/§12 caches over the union the same way and hand back
    stacked, tenant-local results; ``FleetQuerySession`` serves per-tenant
    reads over the stacked tables with the per-tenant staleness policies
    of §12.
  * ``FleetDispatcher`` (host-side) coalesces each tick's incoming events
    by tenant into the ``(T, B)`` block, sentinel-padding slots with no
    traffic; batch units are atomic (never split or merged), so a tenant's
    applied-batch sequence is exactly its offered sequence. The block
    goes to the device as one copy.
  * ``FleetManager`` (host-side) admits sessions to slots and evicts the
    least-recently-used when over capacity, checkpointing the evicted
    forest through ``train.checkpoint``; re-admission restores it (and its
    stream cursor) bit-identically.
  * ``FleetSchema`` / ``FleetBucket`` / ``BucketedFleet`` (§15) route
    tenants by shape into sub-fleets that tick independently.

``launch.serve_fleet`` wires all of it behind the ``ServeConfig`` +
``FleetConfig`` CLI. Everything runs on the device of the fleet's tensors:
the card unless ``fleet_empty`` (or the bucket) is given another.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import pathlib
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import queries as q
from repro_torch.core.compress import DEFAULT_JUMPS, _table_levels
from repro_torch.core.euler import TourNumbering, tour_numbering
from repro_torch.core.graph import resolve_device
from repro_torch.core.queries import QueryTables, _build_tables, build_tables
from repro_torch.data.streams import StreamBatch
from repro_torch.dynamic.bcc import (DynamicBCC, _refresh_full,
                                     _refresh_incremental)
from repro_torch.dynamic.forest import (DynamicForest, _count, apply_batch,
                                        edge_slots, forest_empty)
from repro_torch.dynamic.queries import POLICIES, StaleQueryError
from repro_torch.dynamic.tour import _merge_dirty
from repro_torch.dynamic.view import CadencePolicy
from repro_torch.train import checkpoint as ckpt


def tenant_slice(tree, t: int):
    """Lane ``t`` of a stacked dataclass (``TourNumbering``,
    ``DynamicBCC``, ``QueryTables``): every tensor field with a leading
    tenant axis sliced (views), every other field as it is."""
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name)[t]
        for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), torch.Tensor)})


def _set_lane(stacked, t: int, lane):
    """A copy of ``stacked`` with lane ``t`` of every tensor field set to
    ``lane``'s field (a tensor or a host int). The other lanes, and the
    tensors ``stacked`` shares with its callers, are left as they were."""
    out = {}
    for f in dataclasses.fields(stacked):
        full = getattr(stacked, f.name)
        if isinstance(full, torch.Tensor):
            full = full.clone()
            full[t] = getattr(lane, f.name)
            out[f.name] = full
    return dataclasses.replace(stacked, **out)


# -- the disjoint union: offsets and the sentinel ----------------------------

def _lane_offsets(lanes: int, size: int, device) -> torch.Tensor:
    """int32[lanes, 1]: lane t's first id in a union of lanes of ``size``."""
    return torch.arange(lanes, dtype=torch.int32, device=device)[:, None] \
        * size


def _union_ids(x: torch.Tensor, n: int) -> torch.Tensor:
    """Flat union ids of tenant-local ids ``x`` [T, k]. Every local id
    outside [0, n), n itself (the tenant's sentinel, which in the union is
    tenant t+1's vertex 0) included, becomes the union sentinel T·n
    *before* the offset is added, so no edge or event can cross lanes."""
    lanes = x.shape[0]
    x = x.to(torch.int32)
    ok = (x >= 0) & (x < n)
    return torch.where(ok, x + _lane_offsets(lanes, n, x.device),
                       lanes * n).reshape(-1)


def _local_ids(x: torch.Tensor, lanes: int, n: int) -> torch.Tensor:
    """[T, k] tenant-local ids of flat union ids ``x``; the union sentinel
    T·n becomes each tenant's n."""
    x = x.view(lanes, -1)
    return torch.where(x < lanes * n, x - _lane_offsets(lanes, n, x.device),
                       n)


def _union_halves(x: torch.Tensor, base: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """A [T, 2C] per-half-edge array in the union pool graph's layout
    (every lane's forward slots, then every lane's reverse slots), plus
    ``base`` [T, 1] on entries >= 0 when given."""
    c = x.shape[1] // 2
    if base is not None:
        x = torch.where(x >= 0, x + base, x)
    return torch.cat([x[:, :c].reshape(-1), x[:, c:].reshape(-1)])


def _lane_halves(x: torch.Tensor, lanes: int,
                 base: torch.Tensor | None = None) -> torch.Tensor:
    """The inverse of ``_union_halves``: [T, 2C] from the union layout."""
    half = x.numel() // 2
    out = torch.cat([x[:half].view(lanes, -1), x[half:].view(lanes, -1)], 1)
    if base is not None:
        out = torch.where(out >= 0, out - base, out)
    return out


def _tour_union(tn: TourNumbering) -> TourNumbering:
    """A stacked numbering [T, n] as the union's (lane t's plus t·n)."""
    lanes, n = tn.pre.shape
    off = _lane_offsets(lanes, n, tn.pre.device)
    return TourNumbering(pre=(tn.pre + off).reshape(-1),
                         size=tn.size.reshape(-1),
                         last=(tn.last + off).reshape(-1),
                         comp=(tn.comp + off).reshape(-1),
                         parent=(tn.parent + off).reshape(-1))


def _tour_local(tn: TourNumbering, lanes: int) -> TourNumbering:
    n = tn.pre.numel() // lanes
    off = _lane_offsets(lanes, n, tn.pre.device)
    return TourNumbering(pre=tn.pre.view(lanes, n) - off,
                         size=tn.size.view(lanes, n),
                         last=tn.last.view(lanes, n) - off,
                         comp=tn.comp.view(lanes, n) - off,
                         parent=tn.parent.view(lanes, n) - off)


def _bcc_union(b: DynamicBCC) -> DynamicBCC:
    """A stacked ``DynamicBCC`` as the union's: vertex ids and preorder
    values (``pre``, ``rep``, ``low``, ``high``, ``edge_bcc``) shifted by
    the lane's offset, the pool snapshots onto the union sentinel."""
    lanes, n = b.parent.shape
    off = _lane_offsets(lanes, n, b.parent.device)
    return DynamicBCC(
        n_nodes=lanes * n, parent=_union_ids(b.parent, n),
        pool_src=_union_ids(b.pool_src, n), pool_dst=_union_ids(b.pool_dst, n),
        pool_valid=b.pool_valid.reshape(-1),
        tree_mask=b.tree_mask.reshape(-1),
        pre=(b.pre + off).reshape(-1), rep=(b.rep + off).reshape(-1),
        low=(b.low + off).reshape(-1), high=(b.high + off).reshape(-1),
        articulation=b.articulation.reshape(-1),
        bridge=_union_halves(b.bridge), edge_bcc=_union_halves(b.edge_bcc, off),
        n_bcc=b.n_bcc, aux_rounds=b.aux_rounds, seg_syncs=b.seg_syncs,
        dirty_count=b.dirty_count)


def _bcc_local(b: DynamicBCC, lanes: int) -> DynamicBCC:
    n = b.n_nodes // lanes
    off = _lane_offsets(lanes, n, b.parent.device)
    return DynamicBCC(
        n_nodes=n, parent=_local_ids(b.parent, lanes, n),
        pool_src=_local_ids(b.pool_src, lanes, n),
        pool_dst=_local_ids(b.pool_dst, lanes, n),
        pool_valid=b.pool_valid.view(lanes, -1),
        tree_mask=b.tree_mask.view(lanes, -1),
        pre=b.pre.view(lanes, n) - off, rep=b.rep.view(lanes, n) - off,
        low=b.low.view(lanes, n) - off, high=b.high.view(lanes, n) - off,
        articulation=b.articulation.view(lanes, n),
        bridge=_lane_halves(b.bridge, lanes),
        edge_bcc=_lane_halves(b.edge_bcc, lanes, off),
        n_bcc=b.n_bcc, aux_rounds=b.aux_rounds, seg_syncs=b.seg_syncs,
        dirty_count=b.dirty_count)


# -- the fleet container -----------------------------------------------------

_LEAVES = ("parent", "rep", "pool_src", "pool_dst", "pool_valid",
           "tree_mask", "dirty")


@dataclasses.dataclass(frozen=True)
class ForestFleet:
    """T tenant forests, array-of-structs, one shared capacity schema.

    Every tensor is the single-tenant ``DynamicForest`` field with a
    leading tenant axis (``parent[T, n]``, ``pool_src[T, C]``, ...), in
    contiguous memory of its own; ``version`` (int64[T]) and ``active``
    (bool[T], occupied slots) are host numpy arrays. An inactive slot
    holds an edgeless forest; fleet updates still run over it (sentinel
    events on an empty forest are no-ops), keeping every call fixed-shape.

    ``set_tenant`` and ``clear_tenant`` write their lane in place, so
    fleets derived from one another (``apply_batches`` returns new
    tensors; ``refresh_tours`` shares all but ``dirty``) see such writes
    together.
    """

    n_nodes: int
    parent: torch.Tensor
    rep: torch.Tensor
    pool_src: torch.Tensor
    pool_dst: torch.Tensor
    pool_valid: torch.Tensor
    tree_mask: torch.Tensor
    dirty: torch.Tensor
    version: np.ndarray
    active: np.ndarray

    @property
    def n_slots(self) -> int:
        return self.parent.shape[0]

    @property
    def capacity(self) -> int:
        return self.pool_src.shape[1]

    @property
    def device(self) -> torch.device:
        return self.parent.device

    # -- the union and single-tenant views -----------------------------------

    def as_forest(self) -> DynamicForest:
        """The fleet as one ``DynamicForest``: the disjoint union of its
        lanes (T·n vertices, lane t's vertex v at t·n + v, its pool slot c
        at t·C + c, the union sentinel T·n on padding), the carrier every
        fleet call runs. Its ``version`` is 0: the lanes' stay here."""
        n = self.n_nodes
        return DynamicForest(
            n_nodes=self.n_slots * n, parent=_union_ids(self.parent, n),
            rep=_union_ids(self.rep, n),
            pool_src=_union_ids(self.pool_src, n),
            pool_dst=_union_ids(self.pool_dst, n),
            pool_valid=self.pool_valid.reshape(-1),
            tree_mask=self.tree_mask.reshape(-1),
            dirty=self.dirty.reshape(-1), version=0)

    def with_forest(self, forest: DynamicForest,
                    version: np.ndarray | None = None) -> "ForestFleet":
        """Split a union ``DynamicForest`` back into lanes, keeping the
        activity mask (and the versions, unless ``version`` is given)."""
        lanes, n = self.n_slots, self.n_nodes
        return ForestFleet(
            n_nodes=n, parent=_local_ids(forest.parent, lanes, n),
            rep=_local_ids(forest.rep, lanes, n),
            pool_src=_local_ids(forest.pool_src, lanes, n),
            pool_dst=_local_ids(forest.pool_dst, lanes, n),
            pool_valid=forest.pool_valid.view(lanes, -1),
            tree_mask=forest.tree_mask.view(lanes, -1),
            dirty=forest.dirty.view(lanes, -1),
            version=self.version if version is None else version,
            active=self.active)

    def tenant(self, t: int) -> DynamicForest:
        """Tenant ``t``'s forest as a standalone ``DynamicForest`` (views
        of its lane)."""
        return DynamicForest(n_nodes=self.n_nodes, version=int(
            self.version[t]), **{f: getattr(self, f)[t] for f in _LEAVES})

    def set_tenant(self, t: int, forest: DynamicForest) -> "ForestFleet":
        """Install ``forest`` in slot ``t`` (marks it active), in place."""
        if forest.n_nodes != self.n_nodes:
            raise ValueError(f"tenant n_nodes {forest.n_nodes} != fleet "
                             f"{self.n_nodes}")
        if forest.capacity != self.capacity:
            raise ValueError(f"tenant capacity {forest.capacity} != fleet "
                             f"schema {self.capacity} (one shared "
                             "capacity per fleet)")
        for f in _LEAVES:
            getattr(self, f)[t].copy_(getattr(forest, f))
        self.version[t] = forest.version
        self.active[t] = True
        return self

    def clear_tenant(self, t: int) -> "ForestFleet":
        """Reset slot ``t`` to an edgeless forest (marks it inactive)."""
        self.set_tenant(t, forest_empty(self.n_nodes, self.capacity,
                                        device=self.device))
        self.active[t] = False
        return self


def fleet_empty(n_slots: int, n_nodes: int, capacity: int, *,
                device: str | torch.device | None = None) -> ForestFleet:
    """A fleet of T inactive, edgeless slots, each lane its own memory, on
    ``device`` (the card unless the caller names another)."""
    dev = resolve_device(device)
    verts = torch.arange(n_nodes, dtype=torch.int32, device=dev)
    sent = torch.full((n_slots, capacity), n_nodes, dtype=torch.int32,
                      device=dev)
    off = torch.zeros((n_slots, capacity), dtype=torch.bool, device=dev)
    return ForestFleet(
        n_nodes=n_nodes, parent=verts.repeat(n_slots, 1),
        rep=verts.repeat(n_slots, 1), pool_src=sent, pool_dst=sent.clone(),
        pool_valid=off, tree_mask=off.clone(),
        dirty=torch.zeros((n_slots, n_nodes), dtype=torch.bool, device=dev),
        version=np.zeros(n_slots, np.int64),
        active=np.zeros(n_slots, np.bool_))


# -- the write path over the union --------------------------------------------

def _block(x, device) -> torch.Tensor:
    """An int32 [T, B] event block on ``device`` from an array-like."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.int32))
    return x.to(device, torch.int32)


def apply_batches(fleet: ForestFleet, ins_u, ins_v, del_u, del_v, *,
                  n_jumps: int = DEFAULT_JUMPS,
                  use_kernel: bool | None = None,
                  bucket: str | None = None):
    """Apply one ``(T, B)`` event block: each tenant's batch, all in one
    union call of ``edge_slots`` + ``apply_batch``.

    Args:
      ins_u, ins_v: int32[T, B] per-tenant insertions, tenant-local ids
        (the tenant's ``n_nodes`` sentinel pads inactive slots; any id
        outside [0, n) is inert, never another tenant's vertex).
      del_u, del_v: int32[T, D] per-tenant deletion pairs (``edge_slots``
        resolves them to the tenant's pool slots).
      use_kernel: see ``repro_torch.kernels.kernel_wanted``.

    Returns:
      (fleet', stats): stats maps the ``apply_batch`` counters (plus
      ``deletes_found``) to int32[T] tensors, each lane's own, bit-equal
      to applying its batch alone; ``link_rounds`` is the union loop's
      host count of productive rounds (= ``max(rounds)``). Every slot's
      version is bumped, active or not, as the reference's vmapped
      ``apply_batch`` bumps it.

    Reports the tick's sync bill (``fleet_sync_cost``) to the ambient
    ``obs`` ledger under the ``fleet_apply`` phase (labelled with the
    sub-fleet ``bucket`` when one is ticking, §15).
    """
    lanes, n = fleet.n_slots, fleet.n_nodes
    dev = fleet.device
    ins_u, ins_v, del_u, del_v = (_block(x, dev)
                                  for x in (ins_u, ins_v, del_u, del_v))
    forest = fleet.as_forest()
    dmask, found = edge_slots(forest, _union_ids(del_u, n),
                              _union_ids(del_v, n))
    out, stats = apply_batch(forest, _union_ids(ins_u, n),
                             _union_ids(ins_v, n), dmask, n_jumps=n_jumps,
                             use_kernel=use_kernel, lanes=lanes)
    stats["deletes_found"] = _count(found, lanes)
    fleet = fleet.with_forest(out, version=fleet.version + 1)
    obs.record("fleet_apply", lambda: fleet_sync_cost(stats), bucket=bucket)
    return fleet, stats


def fleet_sync_cost(stats) -> int:
    """Convergence checks one ``apply_batches`` tick paid: the union link
    loop's host reads, ``max_t(rounds_t)`` productive rounds plus the
    final all-lanes check (read from the host count, no device read),
    against ``Σ_t(rounds_t + 1)`` for T sequential calls."""
    return int(stats["link_rounds"]) + 1


# -- cache refreshes over the union (§9 tour, §10 BCC, §12 tables) ------------

def refresh_tours(fleet: ForestFleet, cached: TourNumbering | None = None,
                  *, incremental: bool = True,
                  use_kernel: bool | None = None,
                  bucket: str | None = None):
    """The fleet's ``refresh_tour``: one union numbering.

    ``cached`` is the stacked numbering [T, n] from the previous call
    (lane t of the result is bit-equal to single-tenant ``refresh_tour``
    on tenant t). Returns ``(numbering[T, n], fleet')`` with all dirty
    masks cleared. Reports the refresh's sync bill, the maximum over
    lanes of each lane's own count, to the ambient ``obs`` ledger under
    ``fleet_refresh_tour``.
    """
    lanes, n = fleet.n_slots, fleet.n_nodes
    forest = fleet.as_forest()
    if cached is None or not incremental:
        tn, syncs = tour_numbering(forest.parent, use_kernel=use_kernel,
                                   return_syncs=True, lanes=lanes)
    else:
        tn, syncs = _merge_dirty(forest.parent, forest.rep, forest.dirty,
                                 _tour_union(cached), use_kernel=use_kernel,
                                 return_syncs=True, lanes=lanes)
    obs.record("fleet_refresh_tour", lambda: int(torch.max(syncs)),
               bucket=bucket)
    return _tour_local(tn, lanes), dataclasses.replace(
        fleet, dirty=torch.zeros_like(fleet.dirty))


def refresh_bccs(fleet: ForestFleet, cached: DynamicBCC | None = None, *,
                 tour: TourNumbering, incremental: bool = True,
                 use_kernel: bool | None = None,
                 bucket: str | None = None) -> DynamicBCC:
    """The fleet's ``refresh_bcc``: one union refresh, a stacked
    ``DynamicBCC`` back (counts int32[T], each lane's own).

    Reports the refresh's sync bill (the maximum over lanes of
    ``seg_syncs + aux_rounds``) to the ambient ``obs`` ledger under
    ``fleet_refresh_bcc``.
    """
    lanes = fleet.n_slots
    forest = fleet.as_forest()
    tn = _tour_union(tour)
    if cached is None or not incremental:
        bcc = _refresh_full(forest, tn, use_kernel=use_kernel, lanes=lanes)
    else:
        bcc = _refresh_incremental(forest, tn, _bcc_union(cached),
                                   use_kernel=use_kernel, lanes=lanes)
    bcc = _bcc_local(bcc, lanes)
    obs.record("fleet_refresh_bcc",
               lambda: int(torch.max(bcc.seg_syncs + bcc.aux_rounds)),
               bucket=bucket)
    return bcc


def build_fleet_tables(tn: TourNumbering, *, n_jumps: int = DEFAULT_JUMPS,
                       bucket: str | None = None) -> QueryTables:
    """The §12 ``build_tables`` over the union: one stacked query index
    (``up[T, levels + 1, n]`` at the tenants' own ⌈log2 n⌉ levels;
    ``build_syncs`` int32[T], each lane's own).

    Runs ``_build_tables``, which records nothing, and reports the stacked
    build's sync bill (the maximum over lanes) to the ambient ``obs``
    ledger under ``fleet_tables``.
    """
    lanes, n = tn.pre.shape
    tab = _build_tables(_tour_union(tn), n_jumps=n_jumps,
                        levels=_table_levels(n), lanes=lanes)
    off = _lane_offsets(lanes, n, tn.pre.device)
    up = tab.up.view(-1, lanes, n) - off
    tables = QueryTables(pre=tn.pre, last=tn.last, comp=tn.comp,
                         parent=tn.parent, depth=tab.depth.view(lanes, n),
                         up=up.permute(1, 0, 2).contiguous(),
                         build_syncs=tab.build_syncs)
    obs.record("fleet_tables", lambda: int(torch.max(tables.build_syncs)),
               bucket=bucket)
    return tables


# -- per-tenant read sessions over the stacked tables -------------------------

def _i32(x, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    return t.reshape(1) if t.dim() == 0 else t


@dataclasses.dataclass
class FleetQuerySession:
    """Version-stamped read views over every fleet slot (§12, fleet-wide).

    One stacked ``QueryTables`` (built by ``build_fleet_tables``, all
    tenants in one union build), per-tenant version stamps, and a
    per-tenant staleness policy. Query methods take ``(fleet, t, ...)``;
    the staleness gate is per call and per tenant:

      * ``strict``  — raise ``StaleQueryError``;
      * ``refresh`` — rebuild only tenant t's lane of the stacked tables
        (a single-tenant tour + ``build_tables``), then answer;
      * ``stale``   — serve the frozen lane and count it.
    """

    tables: QueryTables                  # stacked [T, ...]
    bcc: DynamicBCC | None               # stacked, optional
    versions: np.ndarray                 # int64[T] stamped fleet versions
    policies: tuple[str, ...]
    use_kernel: bool | None = None
    n_jumps: int = DEFAULT_JUMPS
    # Per-tenant telemetry (host-side), keyed by stable tenant label, not
    # slot index, so counters survive evict → re-admit rotation even when
    # the tenant lands in another slot. ``labels[slot]`` maps residency to
    # label; the default identity labels are slot-indexed.
    labels: list = None                  # slot → stable tenant id
    stats: dict = None                   # label → Counter of telemetry

    @classmethod
    def from_fleet(cls, fleet: ForestFleet,
                   tn: TourNumbering | None = None,
                   bcc: DynamicBCC | None = None, *,
                   policy: str | Sequence[str] = "strict",
                   use_kernel: bool | None = None,
                   n_jumps: int = DEFAULT_JUMPS,
                   labels: Sequence | None = None) -> "FleetQuerySession":
        t_slots = fleet.n_slots
        if labels is not None and len(labels) != t_slots:
            raise ValueError(f"{len(labels)} labels for {t_slots} slots")
        if isinstance(policy, str):
            policies = (policy,) * t_slots
        else:
            policies = tuple(policy)
        if len(policies) != t_slots:
            raise ValueError(f"{len(policies)} policies for {t_slots} slots")
        for p in policies:
            if p not in POLICIES:
                raise ValueError(f"policy {p!r} not in {POLICIES}")
        if tn is None:
            tn, _ = refresh_tours(fleet, incremental=False,
                                  use_kernel=use_kernel)
        tables = build_fleet_tables(tn, n_jumps=n_jumps)
        sess = cls(tables=tables, bcc=bcc, versions=fleet.version.copy(),
                   policies=policies, use_kernel=use_kernel,
                   n_jumps=n_jumps,
                   labels=(list(labels) if labels is not None
                           else list(range(t_slots))), stats={})
        sess._bump_builds(tables)
        return sess

    # -- stable-label bookkeeping --------------------------------------------

    def _bump(self, label, **deltas) -> None:
        c = self.stats.setdefault(label, collections.Counter())
        for k, v in deltas.items():
            c[k] += int(v)

    def _bump_builds(self, tables: QueryTables) -> None:
        """One build for every slot, its build syncs read in one copy."""
        for s, syncs in enumerate(tables.build_syncs.tolist()):
            self._bump(self.labels[s], builds=1, build_syncs_total=syncs)

    def set_label(self, slot: int, label) -> None:
        """Bind ``slot`` to a stable tenant id. Telemetry for ``label``
        accumulates across rotations: a re-admitted tenant's counters
        continue from where eviction left them."""
        self.labels[slot] = label
        self.stats.setdefault(label, collections.Counter())

    # -- lifecycle -----------------------------------------------------------

    def rebuild_tenant(self, fleet: ForestFleet, t: int) -> None:
        """Re-index one tenant: a single-tenant tour + tables, written
        into lane ``t`` of a copy of the stacked index (other lanes, and
        the caches the session shares with its caller, unchanged)."""
        tn_t, tn_syncs = tour_numbering(fleet.parent[t],
                                        use_kernel=self.use_kernel,
                                        return_syncs=True)
        obs.record("refresh_tour", tn_syncs, tenant=self.labels[t])
        tab_t = build_tables(tn_t, n_jumps=self.n_jumps)
        self.tables = _set_lane(self.tables, t, tab_t)
        if self.bcc is not None:
            bcc_t = _refresh_full(fleet.tenant(t), tn_t,
                                  use_kernel=self.use_kernel)
            self.bcc = _set_lane(self.bcc, t, bcc_t)
        self.versions[t] = fleet.version[t]
        self._bump(self.labels[t], builds=1,
                   build_syncs_total=tab_t.build_syncs)

    def restamp(self, fleet: ForestFleet, tn: TourNumbering,
                bcc: DynamicBCC | None = None) -> None:
        """Adopt freshly refreshed caches for the whole fleet (the cadence
        path: the serving loop refreshed every lane in one union call)."""
        self.tables = build_fleet_tables(tn, n_jumps=self.n_jumps)
        self.bcc = bcc
        self.versions = fleet.version.copy()
        self._bump_builds(self.tables)

    def is_fresh(self, fleet: ForestFleet, t: int) -> bool:
        return int(fleet.version[t]) == int(self.versions[t])

    def ensure(self, fleet: ForestFleet, t: int) -> None:
        if self.is_fresh(fleet, t):
            return
        policy = self.policies[t]
        if policy == "stale":
            self._bump(self.labels[t], stale_served=1)
            return
        if policy == "strict":
            raise StaleQueryError(
                f"tenant {t} at version {int(fleet.version[t])}, session "
                f"slice stamped {int(self.versions[t])}: refresh the "
                "fleet caches first (or use policy='refresh' / 'stale')")
        self._bump(self.labels[t], auto_refreshes=1)
        self.rebuild_tenant(fleet, t)

    # -- per-tenant query ops (gathers over one lane of the stack) -----------

    def _tab(self, t: int) -> QueryTables:
        return tenant_slice(self.tables, t)

    def _ids(self, x) -> torch.Tensor:
        return _i32(x, self.tables.pre.device)

    def connected(self, fleet, t: int, u, v) -> torch.Tensor:
        self.ensure(fleet, t)
        return q.connected(self._tab(t), self._ids(u), self._ids(v))

    def depth(self, fleet, t: int, v) -> torch.Tensor:
        self.ensure(fleet, t)
        return q.depth_of(self._tab(t), self._ids(v))

    def lca(self, fleet, t: int, u, v) -> torch.Tensor:
        self.ensure(fleet, t)
        return q.lca(self._tab(t), self._ids(u), self._ids(v))

    def is_ancestor(self, fleet, t: int, a, x) -> torch.Tensor:
        self.ensure(fleet, t)
        return q.is_ancestor(self._tab(t), self._ids(a), self._ids(x))

    def _bcc_lane(self, t: int) -> DynamicBCC:
        if self.bcc is None:
            raise ValueError("session built without biconnectivity labels "
                             "— pass bcc=refresh_bccs(...) to from_fleet")
        return tenant_slice(self.bcc, t)

    def is_bridge(self, fleet, t: int, u, v) -> torch.Tensor:
        self.ensure(fleet, t)
        b = self._bcc_lane(t)
        cap = b.pool_src.shape[0]
        _hit, flagged = q.edge_membership(
            self._ids(u), self._ids(v), b.pool_src, b.pool_dst,
            b.pool_valid, b.bridge[:cap])
        return flagged

    def is_articulation(self, fleet, t: int, v) -> torch.Tensor:
        self.ensure(fleet, t)
        b = self._bcc_lane(t)
        vq = self._ids(v)
        n = b.articulation.shape[0]
        return ((vq >= 0) & (vq < n)
                & b.articulation[torch.clamp(vq, 0, n - 1).long()])

    # -- telemetry -----------------------------------------------------------

    def sync_stats(self, t=None) -> dict:
        """§12 amortization counters: one tenant's, or fleet totals.

        ``t`` is a stable tenant label; a slot index also resolves (via
        ``labels``) when no tenant carries that exact label.
        """
        keys = ("builds", "build_syncs_total", "stale_served",
                "auto_refreshes")
        if t is None:
            return {k: sum(c[k] for c in self.stats.values())
                    for k in keys}
        if t not in self.stats and isinstance(t, int) \
                and 0 <= t < len(self.labels):
            t = self.labels[t]
        c = self.stats.get(t, collections.Counter())
        return {k: int(c[k]) for k in keys}


# -- host-side dispatch + admission -------------------------------------------

class FleetDispatcher:
    """Coalesces incoming per-tenant batches into ``(T, B)`` tick blocks.

    Host-side. Tenants ``offer`` fixed-shape ``StreamBatch`` units (the §9
    contract: sentinel-padded, one shape per stream); each ``tick`` pops
    at most one unit per resident tenant: units are atomic, never split
    across ticks or merged within one, so every tenant's applied sequence
    equals its offered sequence. Slots with no resident or no queued unit
    get all-sentinel rows: inert under ``apply_batches`` except the
    unconditional version bump, which the admission checkpoint path hides
    (an evicted tenant's clock restarts from its restored stamp). A block
    is built in numpy and goes to ``device`` (the card unless the caller
    names another) as one copy.
    """

    def __init__(self, n_nodes: int, batch: int, *,
                 device: str | torch.device | None = None):
        self.n_nodes = int(n_nodes)
        self.batch = int(batch)
        self.device = resolve_device(device)
        self.queues: dict[Any, collections.deque] = \
            collections.defaultdict(collections.deque)
        self.offered = collections.Counter()
        self.served = collections.Counter()

    def offer(self, tenant, b: StreamBatch) -> None:
        for arr in (b.ins_u, b.ins_v, b.del_u, b.del_v):
            if arr.shape != (self.batch,):
                raise ValueError(
                    f"batch unit shape {arr.shape} != ({self.batch},) — "
                    "the fleet block is fixed-shape; regenerate the "
                    "stream with the fleet's batch size")
        self.queues[tenant].append(b)
        self.offered[tenant] += 1

    def pending(self, tenant=None) -> int:
        if tenant is not None:
            return len(self.queues[tenant])
        return sum(len(d) for d in self.queues.values())

    def tick(self, tenant_at: Sequence[Any]):
        """Build one tick block for the current residency map.

        Args:
          tenant_at: per-slot resident tenant id (``None`` = empty slot).

        Returns:
          ((ins_u, ins_v, del_u, del_v) int32[T, B] tensors on the
           dispatcher's device, served: {tenant: event count} for the
           units dispatched).
        """
        t_slots, n, b = len(tenant_at), self.n_nodes, self.batch
        block = np.full((4, t_slots, b), n, np.int32)
        served: dict[Any, int] = {}
        for s, tenant in enumerate(tenant_at):
            if tenant is None or not self.queues[tenant]:
                continue
            unit = self.queues[tenant].popleft()
            block[:, s] = (unit.ins_u, unit.ins_v, unit.del_u, unit.del_v)
            served[tenant] = int((unit.ins_u < n).sum()
                                 + (unit.del_u < n).sum())
            self.served[tenant] += 1
        return (tuple(torch.from_numpy(block).to(self.device).unbind(0)),
                served)

    def drain(self, tenant_at: Sequence[Any], max_blocks: int = 1):
        """Cross-tick carryover: up to ``max_blocks`` tick blocks in one
        serving tick, so a bursty tenant's queued backlog drains at
        ``max_blocks`` units a tick. Each block is a plain ``tick`` (at
        most one unit per tenant, FIFO, units never split or merged), so
        the applied sequence is exactly the offered sequence.

        Returns a list of ``(block, served)`` pairs; empty when no resident
        tenant has queued units.
        """
        out = []
        for _ in range(max(1, int(max_blocks))):
            if not any(tenant is not None and self.queues[tenant]
                       for tenant in tenant_at):
                break
            out.append(self.tick(tenant_at))
        return out

    def backlog(self) -> dict:
        """{tenant: queued units} for tenants with a non-empty queue (the
        carryover pressure signal, reported per bucket in §15)."""
        return {t: len(q) for t, q in self.queues.items() if q}


class FleetManager:
    """Session admission/eviction against the fleet's slot capacity.

    Host-side bookkeeping around a ``ForestFleet``: which tenant lives in
    which slot, LRU order, and per-tenant stream cursors. When every slot
    is occupied, ``ensure`` evicts a resident through ``train.checkpoint``
    (forest + cursor, atomic publish); re-admission restores it
    bit-identically.

    Victims: idle least-recently-used residents first (evicting a tenant
    with pending dispatcher units round-trips a checkpoint for nothing).
    Pass ``busy`` (tenant → bool) to ``ensure``/``adopt_ready``; when every
    resident is busy the global LRU resident is evicted anyway (liveness
    over thrash-avoidance). Without ``busy``: plain global LRU.

    Async admission (§15): ``prefetch`` starts the checkpoint restore (a
    file read and a decode into host tensors) on a host worker thread
    while the device runs the current tick; ``adopt_ready``, called at a
    tick boundary, installs completed restores (the copy to the device
    happens there). A restore finishing mid-tick is never observed early.
    ``schema`` (optional ``FleetSchema``) is stamped into eviction
    manifests and checked on restore, so a tenant checkpointed under one
    bucket schema cannot be adopted into another.
    """

    def __init__(self, fleet: ForestFleet, ckpt_dir: str | pathlib.Path,
                 *, schema: "FleetSchema | None" = None,
                 executor: concurrent.futures.Executor | None = None):
        self.fleet = fleet
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.schema = schema
        self.slot_of: dict[Any, int] = {}
        self.tenant_at: list[Any] = [None] * fleet.n_slots
        self.last_used = [-1] * fleet.n_slots
        self.clock = 0
        self.cursors = collections.Counter()   # tenant → applied batches
        self.seeds: dict[Any, DynamicForest] = {}  # first-admission state
        self.admissions = 0
        self.evictions = 0
        self.restores = 0
        self.prefetches = 0
        self._executor = executor
        self._prefetch: dict[Any, concurrent.futures.Future] = {}

    def _tenant_dir(self, tenant) -> pathlib.Path:
        return self.ckpt_dir / f"tenant_{tenant}"

    def touch(self, tenant) -> None:
        self.clock += 1
        self.last_used[self.slot_of[tenant]] = self.clock

    def has_checkpoint(self, tenant) -> bool:
        return ckpt.latest_step(self._tenant_dir(tenant)) is not None

    def prefetching(self, tenant) -> bool:
        return tenant in self._prefetch

    def pick_victim(self, busy: Callable[[Any], bool] | None = None):
        """The tenant ``evict`` would choose: idle LRU resident if one
        exists, else the global LRU resident; ``None`` if no residents."""
        residents = [s for s, occ in enumerate(self.tenant_at)
                     if occ is not None]
        if not residents:
            return None
        if busy is not None:
            idle = [s for s in residents if not busy(self.tenant_at[s])]
            if idle:
                residents = idle
        slot = min(residents, key=lambda s: self.last_used[s])
        return self.tenant_at[slot]

    def has_room(self, busy: Callable[[Any], bool] | None = None) -> bool:
        """True when an admission would not evict a busy resident."""
        if any(occ is None for occ in self.tenant_at):
            return True
        victim = self.pick_victim(busy)
        return victim is not None and (busy is None or not busy(victim))

    def _slot_for_admit(self,
                        busy: Callable[[Any], bool] | None = None) -> int:
        free = [s for s, occupant in enumerate(self.tenant_at)
                if occupant is None]
        if free:
            return free[0]
        self.evict(self.pick_victim(busy))
        return [s for s, occ in enumerate(self.tenant_at)
                if occ is None][0]

    def ensure(self, tenant,
               busy: Callable[[Any], bool] | None = None) -> int:
        """Make ``tenant`` resident; returns its slot (evicting the
        preferred victim, idle LRU first, if the fleet is full)."""
        if tenant in self.slot_of:
            self.touch(tenant)
            return self.slot_of[tenant]
        if tenant in self._prefetch:
            # A prefetch is in flight: adopt it synchronously rather than
            # racing a second restore against it.
            forest, cursor = self._prefetch.pop(tenant).result()
            slot = self._slot_for_admit(busy)
            self._install(tenant, slot, forest, cursor=cursor,
                          restored=True)
            return slot
        slot = self._slot_for_admit(busy)
        self._admit(tenant, slot)
        return slot

    def evict(self, tenant) -> None:
        """Checkpoint ``tenant``'s forest + cursor and free its slot."""
        slot = self.slot_of.pop(tenant)
        extra = ({"schema": self.schema.to_dict()}
                 if self.schema is not None else None)
        ckpt.save(self._tenant_dir(tenant),
                  {"forest": self.fleet.tenant(slot)},
                  step=self.clock, data_cursor=int(self.cursors[tenant]),
                  keep=1, extra=extra)
        self.fleet = self.fleet.clear_tenant(slot)
        self.tenant_at[slot] = None
        self.last_used[slot] = -1
        self.evictions += 1

    def _check_manifest(self, tenant, manifest) -> None:
        saved = (manifest.get("extra") or {}).get("schema")
        if saved is None or self.schema is None:
            return
        if saved != self.schema.to_dict():
            raise ValueError(
                f"tenant {tenant!r} checkpoint written under schema "
                f"{saved} cannot be admitted into bucket schema "
                f"{self.schema.to_dict()} — route it to its own bucket")

    def _fresh_forest(self, tenant) -> DynamicForest:
        seed = self.seeds.get(tenant)
        if seed is not None:
            return seed
        return forest_empty(self.fleet.n_nodes, self.fleet.capacity,
                            device=self.fleet.device)

    def _restore(self, tenant):
        """(worker-thread safe) load the tenant's checkpoint → (forest on
        the host, cursor). Host work only: a file read and a decode."""
        fresh = {"forest": forest_empty(self.fleet.n_nodes,
                                        self.fleet.capacity, device="cpu")}
        restored, manifest = ckpt.restore(self._tenant_dir(tenant), fresh)
        self._check_manifest(tenant, manifest)
        return restored["forest"], int(manifest["data_cursor"])

    def _install(self, tenant, slot: int, forest, *, cursor=None,
                 restored: bool = False) -> None:
        if cursor is not None:
            self.cursors[tenant] = int(cursor)
        self.fleet = self.fleet.set_tenant(slot, forest)
        self.slot_of[tenant] = slot
        self.tenant_at[slot] = tenant
        self.admissions += 1
        if restored:
            self.restores += 1
        self.touch(tenant)

    def _admit(self, tenant, slot: int) -> None:
        if self.has_checkpoint(tenant):
            forest, cursor = self._restore(tenant)
            self._install(tenant, slot, forest, cursor=cursor,
                          restored=True)
        else:
            self._install(tenant, slot, self._fresh_forest(tenant))

    # -- async admission (§15) ----------------------------------------------

    def prefetch(self, tenant) -> bool:
        """Start restoring ``tenant`` on the host worker while the current
        tick runs on the device. No fleet state changes here: the restored
        forest becomes visible only when ``adopt_ready`` runs at a tick
        boundary. Returns True if a prefetch was started (or is already in
        flight)."""
        if tenant in self.slot_of:
            return False
        if tenant in self._prefetch:
            return True
        if self._executor is not None:
            fut = self._executor.submit(self._restore, tenant)
        else:
            # No executor: run inline but still defer adoption to the
            # next boundary (the protocol, minus the overlap).
            fut = concurrent.futures.Future()
            try:
                fut.set_result(self._restore(tenant))
            except Exception as e:          # surfaced at adopt time
                fut.set_exception(e)
        self._prefetch[tenant] = fut
        self.prefetches += 1
        return True

    def adopt_ready(self,
                    busy: Callable[[Any], bool] | None = None) -> list:
        """Tick-boundary adoption: install every completed prefetch that
        can take a slot (free, or by evicting the preferred victim).
        Unfinished restores stay in flight; restores that finished mid-tick
        land here, never earlier. Returns the adopted tenants."""
        adopted = []
        for tenant in list(self._prefetch):
            fut = self._prefetch[tenant]
            if not fut.done():
                continue
            del self._prefetch[tenant]
            forest, cursor = fut.result()   # re-raises restore errors
            slot = self._slot_for_admit(busy)
            self._install(tenant, slot, forest, cursor=cursor,
                          restored=True)
            adopted.append(tenant)
        return adopted

    def note_applied(self, served: dict) -> None:
        """Advance stream cursors after a tick (one unit per tenant)."""
        for tenant in served:
            self.cursors[tenant] += 1


# -- shape-bucketed sub-fleets (DESIGN.md §15) --------------------------------

@dataclasses.dataclass(frozen=True)
class FleetSchema:
    """A fleet shape class: every tenant in a bucket shares these.

    ``ForestFleet`` runs all T tenants through one ``(n, capacity)``
    schema, so many small sessions would pay the padding (and the per-tick
    ``max_t(rounds)+1`` sync bill) of the single largest tenant.
    ``BucketedFleet`` routes each tenant to the sub-fleet whose schema it
    fits.
    """

    n_nodes: int
    capacity: int
    batch: int

    @property
    def key(self) -> str:
        return f"n{self.n_nodes}_c{self.capacity}_b{self.batch}"

    @property
    def slot_cost(self) -> int:
        """Device rows one resident slot pins: 3 vertex-length arrays
        (parent, rep, dirty) + 4 capacity-length pool arrays, the memory
        proxy behind equal-budget bucketed-vs-single comparisons
        (table9)."""
        return 3 * self.n_nodes + 4 * self.capacity

    def to_dict(self) -> dict:
        return {"n_nodes": int(self.n_nodes),
                "capacity": int(self.capacity), "batch": int(self.batch)}

    @classmethod
    def from_dict(cls, d: dict) -> "FleetSchema":
        return cls(n_nodes=int(d["n_nodes"]), capacity=int(d["capacity"]),
                   batch=int(d["batch"]))


class FleetBucket:
    """One sub-fleet: a ``ForestFleet`` + dispatcher + manager + caches,
    all under a single ``FleetSchema``, ticking independently.

    Each bucket pays its own per-tick sync bill (max over its lanes + 1)
    with its own ``(T_b, B_b)`` block shape and refresh cadence. ``tick``
    is the whole serving step for the bucket:

      1. tick boundary: adopt prefetched restores that completed during the
         previous tick (``FleetManager.adopt_ready``);
      2. admission: waiting tenants with traffic claim free slots
         (idle-LRU eviction when full); tenants with a checkpoint start an
         async ``prefetch`` instead of blocking the device;
      3. apply: up to ``max_drain`` dispatcher blocks, each one
         ``apply_batches`` labelled with the bucket name;
      4. cadenced refresh: tour/BCC (+ optional query session) on the
         bucket's own ``CadencePolicy``. Any residency change since the
         last refresh forces a full rebuild: a rotated lane's cached
         numbering describes the slot's previous occupant.
    """

    def __init__(self, schema: FleetSchema, n_slots: int,
                 ckpt_dir: str | pathlib.Path, *,
                 cadence: CadencePolicy | None = None,
                 name: str | None = None, use_kernel: bool | None = None,
                 max_drain: int = 1,
                 executor: concurrent.futures.Executor | None = None,
                 device: str | torch.device | None = None):
        self.schema = schema
        self.name = name or schema.key
        self.cadence = cadence or CadencePolicy()
        self.use_kernel = use_kernel
        self.max_drain = max(1, int(max_drain))
        self.manager = FleetManager(
            fleet_empty(n_slots, schema.n_nodes, schema.capacity,
                        device=device),
            pathlib.Path(ckpt_dir) / self.name, schema=schema,
            executor=executor)
        self.dispatcher = FleetDispatcher(schema.n_nodes, schema.batch,
                                          device=device)
        self.tenants: list = []
        self.tn: TourNumbering | None = None
        self.bcc: DynamicBCC | None = None
        self.session: FleetQuerySession | None = None
        self.ticks = 0            # ticks that applied at least one block
        self.blocks = 0
        self.sync_apply = 0
        self.sync_refresh = 0
        self.applied = collections.Counter()   # tenant → applied events
        self.padded_events = 0    # Σ blocks · T_b · B_b (slot-rows fed)
        self.padded_rows = 0      # Σ blocks · T_b · slot_cost (memory·ticks)
        self.max_backlog = 0
        self._lanes_dirty = True  # residency changed since last refresh

    # -- routing -------------------------------------------------------------

    def route(self, tenant, seed: DynamicForest | None = None) -> None:
        """Register ``tenant`` in this bucket. ``seed`` (optional) is the
        forest its first admission installs (a pre-built initial graph
        state, say) instead of an edgeless forest; later admissions
        restore from its eviction checkpoint as usual."""
        if tenant in self.tenants:
            return
        self.tenants.append(tenant)
        if seed is not None:
            if (seed.n_nodes != self.schema.n_nodes
                    or seed.capacity != self.schema.capacity):
                raise ValueError(
                    f"seed forest (n={seed.n_nodes}, "
                    f"capacity={seed.capacity}) does not fit bucket "
                    f"schema {self.schema.key}")
            self.manager.seeds[tenant] = seed

    def offer(self, tenant, unit: StreamBatch) -> None:
        if tenant not in self.tenants:
            raise KeyError(f"tenant {tenant!r} not routed to bucket "
                           f"{self.name}")
        self.dispatcher.offer(tenant, unit)

    def busy(self, tenant) -> bool:
        return self.dispatcher.pending(tenant) > 0

    def pending(self) -> int:
        return self.dispatcher.pending() + len(self.manager._prefetch)

    # -- the serving tick ----------------------------------------------------

    def _admit_waiting(self) -> None:
        mgr = self.manager
        room = sum(1 for occ in mgr.tenant_at
                   if occ is None or not self.busy(occ))
        room -= len(mgr._prefetch)   # in-flight restores will claim room
        for tenant in self.tenants:
            if room <= 0:
                break
            if (not self.busy(tenant) or tenant in mgr.slot_of
                    or mgr.prefetching(tenant)):
                continue
            if mgr.has_checkpoint(tenant):
                mgr.prefetch(tenant)   # lands at the next tick boundary
            else:
                mgr.ensure(tenant, busy=self.busy)
                self._lanes_dirty = True
            room -= 1

    def tick(self, step: int | None = None) -> dict:
        """One serving tick; returns {tenant: applied events}."""
        mgr = self.manager
        if mgr.adopt_ready(busy=self.busy):
            self._lanes_dirty = True
        self._admit_waiting()
        served_total = collections.Counter()
        with obs.span("bucket_tick", step=step, bucket=self.name):
            for block, served in self.dispatcher.drain(
                    mgr.tenant_at, max_blocks=self.max_drain):
                mgr.fleet, stats = apply_batches(
                    mgr.fleet, *block, use_kernel=self.use_kernel,
                    bucket=self.name)
                mgr.note_applied(served)
                self.sync_apply += fleet_sync_cost(stats)
                self.blocks += 1
                self.padded_events += mgr.fleet.n_slots * self.schema.batch
                self.padded_rows += mgr.fleet.n_slots * self.schema.slot_cost
                for tenant, ev in served.items():
                    served_total[tenant] += ev
                    self.applied[tenant] += ev
            if served_total:
                if (self.cadence.tour != "off"
                        and self.cadence.due(self.ticks)):
                    self.refresh(step=step)
                self.ticks += 1
        backlog = self.dispatcher.backlog()
        if backlog:
            self.max_backlog = max(self.max_backlog,
                                   max(backlog.values()))
        return dict(served_total)

    def refresh(self, step: int | None = None) -> None:
        """Cache refresh for the whole bucket (bucket-labelled ledger
        phases + span). Forced callers (end-of-run reporting) call this
        directly, out of cadence."""
        mgr, cad = self.manager, self.cadence
        inc = not self._lanes_dirty
        with obs.span("fleet_refresh", step=step, bucket=self.name), \
                obs.SyncLedger() as led:
            inc_t = cad.tour == "incremental" and self.tn is not None \
                and inc
            self.tn, mgr.fleet = refresh_tours(
                mgr.fleet, self.tn if inc_t else None,
                incremental=inc_t, use_kernel=self.use_kernel,
                bucket=self.name)
            if cad.bcc != "off":
                inc_b = cad.bcc == "incremental" and self.bcc is not None \
                    and inc
                self.bcc = refresh_bccs(
                    mgr.fleet, self.bcc if inc_b else None, tour=self.tn,
                    incremental=inc_b, use_kernel=self.use_kernel,
                    bucket=self.name)
            if cad.queries:
                if self.session is None:
                    self.session = FleetQuerySession.from_fleet(
                        mgr.fleet, self.tn, self.bcc,
                        policy=cad.staleness, use_kernel=self.use_kernel,
                        labels=[t if t is not None else s for s, t
                                in enumerate(mgr.tenant_at)])
                else:
                    for s, tenant in enumerate(mgr.tenant_at):
                        if tenant is not None:
                            self.session.set_label(s, tenant)
                    self.session.restamp(mgr.fleet, self.tn, self.bcc)
        self.sync_refresh += led.total()
        self._lanes_dirty = False

    def slot(self, tenant) -> int:
        """The tenant's resident slot (admitting it if needed)."""
        return self.manager.ensure(tenant, busy=self.busy)


class BucketedFleet:
    """Shape-bucketed sub-fleets behind one serving surface (§15).

    Tenants are routed by ``FleetSchema`` into ``FleetBucket``s; each
    bucket ticks independently with its own block shape, cadence, and
    sync bill. A ``BucketedFleet`` with exactly one bucket is the
    single-schema fleet loop, bit-identically. All buckets share one host
    worker thread for async admission restores. Buckets live on
    ``device`` (the card unless the caller names another).
    """

    def __init__(self, ckpt_dir: str | pathlib.Path, *,
                 use_kernel: bool | None = None, max_drain: int = 1,
                 device: str | torch.device | None = None):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.use_kernel = use_kernel
        self.max_drain = max_drain
        self.device = resolve_device(device)
        self.buckets: dict[str, FleetBucket] = {}
        self._bucket_of: dict[Any, str] = {}
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="fleet-admit")

    def add_bucket(self, schema: FleetSchema, n_slots: int, *,
                   cadence: CadencePolicy | None = None,
                   name: str | None = None,
                   max_drain: int | None = None) -> FleetBucket:
        name = name or schema.key
        if name in self.buckets:
            raise ValueError(f"bucket {name!r} already exists")
        b = FleetBucket(schema, n_slots, self.ckpt_dir, cadence=cadence,
                        name=name, use_kernel=self.use_kernel,
                        max_drain=(self.max_drain if max_drain is None
                                   else max_drain),
                        executor=self._executor, device=self.device)
        self.buckets[name] = b
        return b

    def route(self, tenant, schema: FleetSchema, *,
              seed: DynamicForest | None = None) -> FleetBucket:
        """Bind ``tenant`` to the bucket matching ``schema`` exactly."""
        if tenant in self._bucket_of:
            b = self.buckets[self._bucket_of[tenant]]
            if b.schema != schema:
                raise ValueError(
                    f"tenant {tenant!r} already routed to bucket "
                    f"{b.name} ({b.schema.key}); cannot re-route to "
                    f"{schema.key}")
            return b
        for b in self.buckets.values():
            if b.schema == schema:
                b.route(tenant, seed=seed)
                self._bucket_of[tenant] = b.name
                return b
        raise KeyError(f"no bucket with schema {schema.key} — "
                       f"add_bucket first (have: "
                       f"{', '.join(self.buckets) or 'none'})")

    def bucket_of(self, tenant) -> FleetBucket:
        return self.buckets[self._bucket_of[tenant]]

    def offer(self, tenant, unit: StreamBatch) -> None:
        self.bucket_of(tenant).offer(tenant, unit)

    def pending(self) -> int:
        return sum(b.pending() for b in self.buckets.values())

    def step(self, step: int | None = None) -> dict:
        """One serving tick: every bucket with traffic ticks once."""
        served: dict = {}
        for b in self.buckets.values():
            if b.pending():
                served.update(b.tick(step))
        return served

    def run(self, max_steps: int = 1_000_000) -> int:
        """Drain every queue; returns the number of steps taken."""
        steps = 0
        while self.pending():
            if steps >= max_steps:
                raise RuntimeError(
                    f"BucketedFleet.run did not drain in {max_steps} "
                    "steps — admission livelock?")
            self.step(steps)
            steps += 1
        return steps

    def finalize(self) -> None:
        """Force a final refresh in every bucket that applied work."""
        for b in self.buckets.values():
            if b.blocks:
                b.refresh()

    def tenant_forest(self, tenant) -> DynamicForest:
        """The tenant's current forest (re-admitting it if evicted)."""
        b = self.bucket_of(tenant)
        slot = b.slot(tenant)          # may evict + restore
        return b.manager.fleet.tenant(slot)

    # -- fleet-wide accounting ------------------------------------------------

    def sync_total(self) -> int:
        return sum(b.sync_apply + b.sync_refresh
                   for b in self.buckets.values())

    def applied_events(self) -> int:
        return sum(sum(b.applied.values()) for b in self.buckets.values())

    def padded_rows(self) -> int:
        return sum(b.padded_rows for b in self.buckets.values())

    def padded_events(self) -> int:
        return sum(b.padded_events for b in self.buckets.values())

    def close(self) -> None:
        self._executor.shutdown(wait=True)

    def __enter__(self) -> "BucketedFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
