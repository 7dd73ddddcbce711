"""One refresh surface for the forest's derived caches (DESIGN.md §13).

The port of ``repro.dynamic.view``. The three derived read structures of a
``DynamicForest`` (the Euler-tour numbering, §9; the biconnectivity labels,
§10; the ``QuerySession`` read view, §12) are refreshed behind one entry:

    view = ForestView(CadencePolicy(tour="incremental", bcc="incremental",
                                    every=4))
    state = view.prime(state)            # initial cache build
    ...
    state = view.refresh(state, step=i)  # cadenced: no-op off-cadence
    state = view.refresh(state)          # forced: refresh everything on

``CadencePolicy`` says which caches are maintained (``tour``/``bcc``
modes, ``queries``), how often (``every``), and the query-staleness policy
between refreshes. ``refresh`` takes per-call overrides (``tour=``,
``bcc=``, ``queries=``). The one-shot functions ``refresh_tour_once`` and
``refresh_bcc_once`` hold the logic; ``dynamic.tour.refresh_tour`` and
``dynamic.bcc.refresh_bcc`` are thin wrappers over them.

Each refresh reports its syncs to the port's ``obs`` ledger and runs in an
``obs`` span; a timed refresh waits for the card (``torch.cuda.synchronize``)
before its clock stops, and for nothing on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch import obs
from repro_torch.core.euler import TourNumbering, tour_numbering
from repro_torch.dynamic.bcc import (DynamicBCC, _refresh_full,
                                     _refresh_incremental)
from repro_torch.dynamic.forest import DynamicForest
from repro_torch.dynamic.tour import _clear_dirty, _merge_dirty

_MODES = ("incremental", "full", "off")
_STALENESS = ("strict", "refresh", "stale")


@dataclasses.dataclass(frozen=True)
class CadencePolicy:
    """Which derived caches are maintained, and on what cadence.

    Attributes:
      tour:      tour-numbering mode: ``incremental`` (§9 dirty-scoped
                 merge), ``full`` (ablation), ``off``.
      bcc:       biconnectivity mode (§10), same values.
      queries:   also maintain a ``QuerySession`` at the cadence (§12).
      every:     refresh after every k-th batch (0 disables cadenced
                 refreshes; forced refreshes still work).
      staleness: ``QuerySession`` policy between refreshes.
    """

    tour: str = "incremental"
    bcc: str = "off"
    queries: bool = False
    every: int = 4
    staleness: str = "stale"

    def __post_init__(self):
        if self.tour not in _MODES:
            raise ValueError(f"tour mode {self.tour!r} not in {_MODES}")
        if self.bcc not in _MODES:
            raise ValueError(f"bcc mode {self.bcc!r} not in {_MODES}")
        if self.staleness not in _STALENESS:
            raise ValueError(
                f"staleness {self.staleness!r} not in {_STALENESS}")

    def due(self, step: int | None) -> bool:
        """True when the cadence lands at 0-based batch index ``step``
        (``None`` = forced, always due)."""
        if step is None:
            return True
        return self.every > 0 and (step + 1) % self.every == 0


def _wait(t: torch.Tensor) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def refresh_tour_once(state: DynamicForest,
                      cached: TourNumbering | None = None, *,
                      incremental: bool = True,
                      use_kernel: bool | None = None):
    """One tour refresh (the §9 step).

    ``cached=None`` or ``incremental=False`` recompute from scratch;
    otherwise the dirty-scoped merge, bit-equal either way. Returns
    ``(numbering, state')`` with the dirty mask cleared, and records the
    refresh's engine syncs to the ``obs`` ledger (phase ``refresh_tour``).
    """
    if cached is None or not incremental:
        tn, syncs = tour_numbering(state.parent, use_kernel=use_kernel,
                                   return_syncs=True)
    else:
        tn, syncs = _merge_dirty(state.parent, state.rep, state.dirty,
                                 cached, use_kernel=use_kernel,
                                 return_syncs=True)
    obs.record("refresh_tour", syncs)
    return tn, _clear_dirty(state)


def refresh_bcc_once(state: DynamicForest,
                     cached: DynamicBCC | None = None, *,
                     tour: TourNumbering | None = None,
                     incremental: bool = True,
                     use_kernel: bool | None = None) -> DynamicBCC:
    """One biconnectivity refresh (the §10 step).

    Records the refresh's engine syncs (``seg_syncs + aux_rounds``, the
    table5 accounting) to the ``obs`` ledger (phase ``refresh_bcc``).
    """
    if tour is not None:
        tn = tour
    else:
        tn, tn_syncs = tour_numbering(state.parent, use_kernel=use_kernel,
                                      return_syncs=True)
        obs.record("refresh_tour", tn_syncs)
    if cached is None or not incremental:
        bcc = _refresh_full(state, tn, use_kernel=use_kernel)
    else:
        bcc = _refresh_incremental(state, tn, cached, use_kernel=use_kernel)
    obs.record("refresh_bcc", bcc.seg_syncs + bcc.aux_rounds)
    return bcc


@dataclasses.dataclass
class ForestView:
    """The derived-cache bundle of one forest, refreshed as a unit.

    Owns the tour numbering, the BCC labels and (when the policy asks) the
    ``QuerySession``, plus the refresh latencies (seconds) that serving
    loops report. Host-side and mutable, like the loops that hold it.
    """

    policy: CadencePolicy = dataclasses.field(default_factory=CadencePolicy)
    use_kernel: bool | None = None
    tn: TourNumbering | None = None
    bcc: DynamicBCC | None = None
    session: Any = None                   # dynamic.queries.QuerySession
    tour_lat: list = dataclasses.field(default_factory=list)
    bcc_lat: list = dataclasses.field(default_factory=list)
    _tn_adopted: Any = None               # tn the session was built over

    @property
    def maintains_caches(self) -> bool:
        return self.policy.tour != "off" or self.policy.bcc != "off"

    def prime(self, state: DynamicForest) -> DynamicForest:
        """Initial cache build (a maintained cache exists from step 0).
        BCC-only policies still get a tour numbering (§10 needs one)."""
        if self.maintains_caches:
            state = self.refresh(state, tour=True)
        return state

    def refresh(self, state: DynamicForest, *, step: int | None = None,
                tour: bool | None = None, bcc: bool | None = None,
                queries: bool | None = None) -> DynamicForest:
        """Refresh every cache that is (a) on and (b) due at ``step``.

        ``step=None`` forces the refresh (cadence bypassed). ``tour`` /
        ``bcc`` / ``queries`` override the policy's on/off per call
        (``True`` forces a normally-off cache in the incremental mode,
        ``False`` skips a normally-on one). Returns the state with its
        dirty mask cleared iff the tour refreshed.
        """
        if not self.policy.due(step):
            return state
        do_tour = (self.policy.tour != "off") if tour is None else tour
        do_bcc = (self.policy.bcc != "off") if bcc is None else bcc
        do_q = self.policy.queries if queries is None else queries

        if do_tour:
            with obs.span("refresh_tour", step=step):
                t0 = time.perf_counter()
                mode = self.policy.tour if self.policy.tour != "off" \
                    else "incremental"
                self.tn, state = refresh_tour_once(
                    state, self.tn, incremental=(mode == "incremental"),
                    use_kernel=self.use_kernel)
                _wait(self.tn.pre)
                self.tour_lat.append(time.perf_counter() - t0)
        if do_bcc:
            with obs.span("refresh_bcc", step=step):
                t0 = time.perf_counter()
                mode = self.policy.bcc if self.policy.bcc != "off" \
                    else "incremental"
                self.bcc = refresh_bcc_once(
                    state, self.bcc, tour=self.tn,
                    incremental=(mode == "incremental"),
                    use_kernel=self.use_kernel)
                _wait(self.bcc.edge_bcc)
                self.bcc_lat.append(time.perf_counter() - t0)
        if do_q:
            with obs.span("adopt_session", step=step):
                self.adopt_session(state)
        return state

    # -- query-session adoption (the §12 rebuild) ----------------------------

    def adopt_session(self, state: DynamicForest):
        """(Re)build the ``QuerySession`` over the current caches.

        The dirty check is object identity on ``tn``: a session adopts the
        exact numbering object the view holds, and any tour refresh makes a
        new object and so a re-adoption. Between refreshes the session's
        own staleness policy governs. Falls back to a tour-only session when
        the caches do not match the live state (a caller forcing a session
        before the first cadenced refresh). Counters carry across
        generations, so ``session.sync_stats()`` is cumulative for the run.
        """
        from repro_torch.dynamic.queries import QuerySession

        if self.session is not None and self._tn_adopted is self.tn:
            return self.session
        carry = self.session.sync_stats() if self.session is not None \
            else None
        try:
            sess = QuerySession.from_state(
                state, self.tn, self.bcc, policy=self.policy.staleness,
                use_kernel=self.use_kernel)
        except ValueError:
            sess = QuerySession.from_state(
                state, policy=self.policy.staleness,
                use_kernel=self.use_kernel)
        if carry is not None:
            sess.builds += carry["builds"]
            sess.build_syncs_total += carry["build_syncs_total"]
            sess.stale_served += carry["stale_served"]
            sess.auto_refreshes += carry["auto_refreshes"]
        self.session = sess
        self._tn_adopted = self.tn
        return sess
