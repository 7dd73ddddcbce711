"""QuerySession: the read path of the batch-dynamic forest (DESIGN.md §12).

The port of ``repro.dynamic.queries``. ``apply_batch`` is the write path;
a ``QuerySession`` serves reads between writes. It freezes one consistent
view of the forest (the ``core.queries.QueryTables`` index built from a
tour refresh, and optionally the ``DynamicBCC`` labels) and answers query
batches with no further engine sync until the forest moves on.

Every ``apply_batch`` bumps ``DynamicForest.version`` (a host int), the
session stamps the version it was built against, and each query compares
the two without reading the card. ``from_state``/``rebuild`` also compare
caller-provided caches with the live state (``torch.equal`` on the
tensors' own device), so a session is never built over stale intervals.
On a stamp mismatch the ``policy`` decides:

  * ``"strict"``  — raise ``StaleQueryError``;
  * ``"refresh"`` — rebuild from the current state (full tour, tables and
                    BCC recompute, syncs counted in ``build_syncs_total``),
                    then answer;
  * ``"stale"``   — serve the frozen view and count it (``stale_served``).

The session is a host-side mutable object with amortization counters
(``builds``, ``build_syncs_total``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import queries as q
from repro_torch.core.compress import DEFAULT_JUMPS
from repro_torch.core.euler import TourNumbering, tour_numbering
from repro_torch.dynamic.bcc import DynamicBCC, refresh_bcc
from repro_torch.dynamic.forest import DynamicForest

POLICIES = ("strict", "refresh", "stale")


class StaleQueryError(RuntimeError):
    """A query hit a session whose caches no longer match the forest."""


def _i32(x, device: torch.device) -> torch.Tensor:
    """int32 ids on ``device``, at least 1-D."""
    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    return t.reshape(1) if t.dim() == 0 else t


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal tensors, compared where they lie."""
    return a.device == b.device and torch.equal(a, b)


@dataclasses.dataclass
class QuerySession:
    """One consistent, version-stamped read view over a ``DynamicForest``.

    Build with ``from_state`` (reusing the caller's refreshed ``tn`` /
    ``bcc`` caches when there are some: the build then costs only the
    ancestor and depth tables); re-stamp after each refresh with
    ``rebuild``. Every query method takes the current state first, so the
    staleness check is per call, then batched int32 ids.
    """

    tables: q.QueryTables
    tn: TourNumbering
    bcc: DynamicBCC | None
    state_version: int
    policy: str = "strict"
    use_kernel: bool | None = None
    n_jumps: int = DEFAULT_JUMPS
    # amortization / staleness telemetry (host-side counters)
    builds: int = 0
    build_syncs_total: int = 0
    stale_served: int = 0
    auto_refreshes: int = 0

    @classmethod
    def from_state(cls, state: DynamicForest,
                   tn: TourNumbering | None = None,
                   bcc: DynamicBCC | None = None, *,
                   policy: str = "strict", use_kernel: bool | None = None,
                   n_jumps: int = DEFAULT_JUMPS) -> "QuerySession":
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        sess = cls(tables=None, tn=None, bcc=None, state_version=-1,
                   policy=policy, use_kernel=use_kernel, n_jumps=n_jumps)
        sess.rebuild(state, tn=tn, bcc=bcc)
        return sess

    @property
    def device(self) -> torch.device:
        return self.tn.pre.device

    # -- lifecycle ----------------------------------------------------------

    def rebuild(self, state: DynamicForest, *,
                tn: TourNumbering | None = None,
                bcc: DynamicBCC | None = None) -> "QuerySession":
        """(Re)build the index against ``state`` and stamp its version.

        Caller-provided caches are compared with the live state first: a
        ``tn`` whose parent table is not bit-equal to ``state.parent``, or
        a ``bcc`` whose §10 snapshots differ from the live pool, is
        rejected rather than served.
        """
        if tn is not None and not _same(tn.parent, state.parent):
            raise ValueError(
                "stale TourNumbering: tn.parent != state.parent — run "
                "refresh_tour(state, tn) before building a QuerySession")
        if bcc is not None and not (
                _same(bcc.parent, state.parent)
                and _same(bcc.pool_src, state.pool_src)
                and _same(bcc.pool_dst, state.pool_dst)
                and _same(bcc.pool_valid, state.pool_valid)
                and _same(bcc.tree_mask, state.tree_mask)):
            raise ValueError(
                "stale DynamicBCC: its §10 snapshots disagree with the "
                "live forest — run refresh_bcc before building a "
                "QuerySession")
        if tn is None:
            tn = tour_numbering(state.parent, use_kernel=self.use_kernel)
        self.tables = q.build_tables(tn, n_jumps=self.n_jumps)
        self.tn = tn
        self.bcc = bcc
        self.state_version = state.version
        self.builds += 1
        self.build_syncs_total += self.tables.build_syncs
        return self

    def is_fresh(self, state: DynamicForest) -> bool:
        return state.version == self.state_version

    def ensure(self, state: DynamicForest) -> None:
        """Per-query staleness gate: the policy dispatch."""
        if self.is_fresh(state):
            return
        if self.policy == "stale":
            self.stale_served += 1
            return
        if self.policy == "strict":
            raise StaleQueryError(
                f"forest at version {state.version}, session built "
                f"at {self.state_version}: refresh_tour/refresh_bcc and "
                "session.rebuild(...) first (or use policy='refresh' / "
                "'stale')")
        # policy == "refresh": recompute the view from the current state.
        self.auto_refreshes += 1
        bcc = None
        if self.bcc is not None:
            bcc = refresh_bcc(state, None,
                              tour=tour_numbering(
                                  state.parent, use_kernel=self.use_kernel),
                              use_kernel=self.use_kernel)
        self.rebuild(state, bcc=bcc)

    # -- tree queries (tour intervals + doubling tables) ---------------------

    def connected(self, state: DynamicForest, u, v) -> torch.Tensor:
        self.ensure(state)
        return q.connected(self.tables, _i32(u, self.device),
                           _i32(v, self.device))

    def depth(self, state: DynamicForest, v) -> torch.Tensor:
        self.ensure(state)
        return q.depth_of(self.tables, _i32(v, self.device))

    def lca(self, state: DynamicForest, u, v) -> torch.Tensor:
        self.ensure(state)
        return q.lca(self.tables, _i32(u, self.device), _i32(v, self.device))

    def is_ancestor(self, state: DynamicForest, a, x) -> torch.Tensor:
        self.ensure(state)
        return q.is_ancestor(self.tables, _i32(a, self.device),
                             _i32(x, self.device))

    def subtree_agg(self, state: DynamicForest, v, payload,
                    op: str = "add") -> torch.Tensor:
        self.ensure(state)
        return q.subtree_agg(self.tables, _i32(v, self.device),
                             torch.as_tensor(payload, device=self.device),
                             op, use_kernel=self.use_kernel)

    def path_agg(self, state: DynamicForest, u, v, payload,
                 op: str = "add") -> torch.Tensor:
        self.ensure(state)
        return q.path_agg(self.tables, _i32(u, self.device),
                          _i32(v, self.device),
                          torch.as_tensor(payload, device=self.device), op)

    # -- biconnectivity membership (DynamicBCC labels) ------------------------

    def _require_bcc(self) -> DynamicBCC:
        if self.bcc is None:
            raise ValueError(
                "session built without biconnectivity labels — pass "
                "bcc=refresh_bcc(...) to from_state/rebuild to answer "
                "is_bridge / is_articulation")
        return self.bcc

    def is_bridge(self, state: DynamicForest, u, v) -> torch.Tensor:
        """bool[B]: some live (u, v) pool copy is a bridge.

        Matched against the session's snapshot pool (consistent with the
        bridge flags under the ``stale`` policy). A pair with parallel
        copies is never a bridge, and a pair with no live copy answers
        False.
        """
        self.ensure(state)
        bcc = self._require_bcc()
        cap = bcc.pool_src.numel()
        _hit, flagged = q.edge_membership(
            _i32(u, self.device), _i32(v, self.device), bcc.pool_src,
            bcc.pool_dst, bcc.pool_valid, bcc.bridge[:cap])
        return flagged

    def is_articulation(self, state: DynamicForest, v) -> torch.Tensor:
        self.ensure(state)
        bcc = self._require_bcc()
        vq = _i32(v, self.device)
        n = bcc.articulation.numel()
        return ((vq >= 0) & (vq < n)
                & bcc.articulation[torch.clamp(vq, 0, n - 1).long()])

    # -- telemetry ------------------------------------------------------------

    def sync_stats(self) -> dict:
        """Amortization counters for the serving loop."""
        return {"builds": self.builds,
                "build_syncs_total": self.build_syncs_total,
                "stale_served": self.stale_served,
                "auto_refreshes": self.auto_refreshes}
