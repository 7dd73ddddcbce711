"""O(log n)-sync invariant auditing for the dynamic forest (DESIGN.md §11).

The port of ``repro.dynamic.audit``. ``audit_forest`` checks every
structural invariant a healthy ``DynamicForest`` maintains, on the state's
device, from the same engine primitives the read path uses: one bounded
``compress_full`` (the pointer_jump kernel on the card) plus masked
scatters and reductions, so a full audit costs ⌈log2(depth)/k⌉ + 1
convergence syncs like any other engine phase, and those are its only host
reads:

  * **acyclicity / rooted-ness**: every parent chain must reach a fixed
    point *of the original table* (the ``validate.reaches_root``
    technique: bounded compression, then a re-check against the
    uncompressed table, so even-length cycles cannot fake a root). On a
    cyclic table the compression runs to its bound, ``AUDIT_MAX_SYNCS``;
  * **root fixed-point**: every claimed representative is in range and
    self-parented;
  * **rep-partition consistency**: ``rep == roots_of(parent)``;
  * **tree cover**: every non-root vertex is the child endpoint of exactly
    one live tree slot, and roots of none;
  * **tree-slot sanity**: ``tree_mask ⊆ pool_valid``, tree endpoints in
    range, parent-linked, and in one claimed component;
  * **spanning**: no live pool edge crosses two claimed components;
  * **tree-edge count**: #live tree slots == n − #parent self-loops;
  * **snapshot freshness** (optional): a ``TourNumbering`` must agree with
    the live parent array outside ``state.dirty``; a ``DynamicBCC``'s
    snapshots must agree with the live parent and pool arrays.

The verdicts stay 0-d tensors on the device until a caller reads them
(``bool(report.healthy)``). Every ``mode="drop"`` scatter of the reference
writes into spread drop slots (``dynamic.forest._mark``), and the tree-cover
count adds into n spread slots past the table: on the card, writers that
share one address queue on it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.core.compress import DEFAULT_JUMPS, compress_full
from repro_torch.core.euler import TourNumbering
from repro_torch.core.reroot import _drop_slots
from repro_torch.dynamic.bcc import DynamicBCC
from repro_torch.dynamic.forest import DynamicForest, _mark

#: Sync bound for the audit compression: 64 checks × k doublings covers
#: any real chain (2^320); cycles are the only inputs that hit the bound.
AUDIT_MAX_SYNCS = 64


@dataclasses.dataclass(frozen=True)
class AuditReport:
    """Verdicts and violation masks from one ``audit_forest`` call.

    The verdicts are 0-d bool tensors on the state's device;
    ``bool(report.healthy)`` reads one.

    Attributes:
      n_nodes:        vertex count.
      acyclic:        every chain reaches a true fixed point.
      roots_fixed:    claimed reps are in range and self-parented.
      rep_consistent: rep matches the compressed root everywhere.
      tree_cover_ok:  non-roots covered by exactly one tree slot.
      tree_slots_ok:  no tree bit on dead/unlinked/cross-component slots.
      spanning_ok:    no live pool edge crosses two claimed components.
      counts_ok:      #tree slots == n − #roots.
      forest_ok:      conjunction of the seven structural verdicts.
      tour_fresh:     tour numbering consistent with the live parent (True
                      when no tour was passed).
      bcc_fresh:      BCC snapshots consistent with the live state (True
                      when no cache was passed).
      healthy:        forest_ok & tour_fresh & bcc_fresh.
      violating:      bool[n] per-vertex structural violations.
      comp_violating: bool[n], ``violating`` closed over the claimed AND
                      actual components (the repair scope).
      sever:          bool[n], the minimal cut set for the repair: a vertex
                      whose own parent pointer is broken (out of range, not
                      backed by exactly one live tree slot, or a spurious
                      cycle fixed point).
      stale:          bool[n] snapshot staleness, component-closed (the
                      cache-refresh scope).
      bad_slots:      bool[capacity] pool slots violating tree-slot sanity.
      n_violating:    0-d int32, the vertex count of ``comp_violating``.
      syncs:          int, engine convergence checks spent auditing.
    """

    n_nodes: int
    acyclic: torch.Tensor
    roots_fixed: torch.Tensor
    rep_consistent: torch.Tensor
    tree_cover_ok: torch.Tensor
    tree_slots_ok: torch.Tensor
    spanning_ok: torch.Tensor
    counts_ok: torch.Tensor
    forest_ok: torch.Tensor
    tour_fresh: torch.Tensor
    bcc_fresh: torch.Tensor
    healthy: torch.Tensor
    violating: torch.Tensor
    comp_violating: torch.Tensor
    sever: torch.Tensor
    stale: torch.Tensor
    bad_slots: torch.Tensor
    n_violating: torch.Tensor
    syncs: int

    #: the individually-reportable verdicts, in report order.
    VERDICTS = ("acyclic", "roots_fixed", "rep_consistent",
                "tree_cover_ok", "tree_slots_ok", "spanning_ok",
                "counts_ok", "tour_fresh", "bcc_fresh")

    def violations(self) -> list[str]:
        """Names of the failed verdicts (host reads; empty when healthy)."""
        return [k for k in self.VERDICTS if not bool(getattr(self, k))]

    def summary(self) -> str:
        """One-line human verdict (host reads)."""
        if bool(self.healthy):
            return f"healthy (syncs={self.syncs})"
        return (f"FAULT {'+'.join(self.violations())} "
                f"({int(self.n_violating)} vertices in scope, "
                f"syncs={self.syncs})")


def _close_over_components(mask: torch.Tensor, rep_key: torch.Tensor,
                           hop: torch.Tensor, n: int) -> torch.Tensor:
    """Close a vertex mask over claimed (rep) and actual (hop) components."""
    out = mask
    for key in (rep_key, hop):
        comp_bad = _mark(n, key, mask)
        out = out | comp_bad[key.long()]
    return out


def _audit(state: DynamicForest, tn: TourNumbering | None,
           bcc: DynamicBCC | None, *, n_jumps: int,
           use_kernel: bool | None) -> AuditReport:
    n = state.n_nodes
    dev = state.device
    verts = torch.arange(n, dtype=torch.int32, device=dev)
    p = state.parent
    rep = state.rep

    # ---- acyclicity + rooted-ness (reaches_root technique) ----------------
    in_range = (p >= 0) & (p < n)
    mapped = torch.where(in_range, p, verts)
    hop, syncs = compress_full(mapped, n_jumps=n_jumps,
                               max_syncs=AUDIT_MAX_SYNCS, return_syncs=True,
                               use_kernel=use_kernel)
    reach = mapped[hop.long()] == hop       # true fixed point of the original
    viol = ~reach | ~in_range
    acyclic = torch.all(reach)

    # ---- root fixed-point + rep partition ---------------------------------
    rep_in_range = (rep >= 0) & (rep < n)
    safe_rep = torch.clamp(rep, 0, n - 1)
    root_fixed_v = rep_in_range & (mapped[safe_rep.long()] == safe_rep)
    rep_ok_v = rep_in_range & (rep == hop)
    viol = viol | ~root_fixed_v | ~rep_ok_v
    roots_fixed = torch.all(root_fixed_v)
    rep_consistent = torch.all(rep_ok_v)

    # ---- tree-slot sanity --------------------------------------------------
    u, v = state.pool_src, state.pool_dst
    live, tree = state.pool_valid, state.tree_mask
    ep_ok = (u >= 0) & (u < n) & (v >= 0) & (v < n)
    uc = torch.clamp(u, 0, n - 1).long()
    vc = torch.clamp(v, 0, n - 1).long()
    linked = (mapped[uc] == vc) | (mapped[vc] == uc)
    same_rep = rep[uc] == rep[vc]
    bad_slots = ((tree & ~live)
                 | (tree & live & (~ep_ok | ~linked | ~same_rep))
                 | (live & ~ep_ok))
    tree_slots_ok = ~torch.any(bad_slots)
    # Spanning: a live in-range edge between two claimed components. Its
    # endpoints join the violation set so the repair scope covers (and
    # relinks) both sides; the slot itself is good data.
    cross = live & ep_ok & ~same_rep
    spanning_ok = ~torch.any(cross)
    for ends in (u, v):
        viol = _mark(n, ends, (bad_slots | cross) & ep_ok, viol)

    # ---- tree cover: each non-root the child of exactly one tree slot -----
    slot_tree = tree & live & linked & ep_ok
    child_is_v = mapped[vc] == uc
    child = torch.where(child_is_v, vc, uc)
    count = torch.zeros(2 * n, dtype=torch.int32, device=dev)
    count.index_add_(0, torch.where(slot_tree, child,
                                    _drop_slots(child.numel(), n, dev)),
                     torch.ones_like(child, dtype=torch.int32))
    count = count[:n]
    nonroot = in_range & (p != verts)
    cover_ok_v = torch.where(nonroot, count == 1, count == 0)
    viol = viol | ~cover_ok_v
    tree_cover_ok = torch.all(cover_ok_v)

    # Minimal cut set for the scoped repair: vertices whose own parent
    # pointer is unusable (a redirect breaks the one-tree-slot cover at its
    # child; even-length cycles collapse to spurious self-fixed points).
    sever = ~in_range | ~cover_ok_v | (~reach & (hop == verts))

    # ---- global n − c redundancy ------------------------------------------
    n_tree = torch.sum(tree & live, dtype=torch.int32)
    n_roots = torch.sum(in_range & (p == verts), dtype=torch.int32)
    counts_ok = n_tree == (n - n_roots)

    # ---- snapshot freshness -----------------------------------------------
    stale = torch.zeros(n, dtype=torch.bool, device=dev)
    tour_fresh = torch.ones((), dtype=torch.bool, device=dev)
    if tn is not None:
        tour_stale_v = (tn.parent != mapped) & ~state.dirty
        tour_fresh = ~torch.any(tour_stale_v)
        stale = stale | tour_stale_v
    bcc_fresh = torch.ones((), dtype=torch.bool, device=dev)
    if bcc is not None:
        bcc_stale_v = bcc.parent != p
        slot_mism = ((bcc.pool_src != u) | (bcc.pool_dst != v)
                     | (bcc.pool_valid != live) | (bcc.tree_mask != tree))
        for ends in (bcc.pool_src, bcc.pool_dst, u, v):
            # The sentinel end n of an empty slot is dropped, as in the
            # reference (no pool endpoint is negative).
            bcc_stale_v = _mark(n, ends, slot_mism & (ends < n),
                                bcc_stale_v)
        bcc_fresh = ~torch.any(bcc_stale_v)
        stale = stale | bcc_stale_v

    # ---- closures + verdicts ----------------------------------------------
    rep_key = torch.where(rep_in_range, rep, verts)
    comp_violating = _close_over_components(viol, rep_key, hop, n)
    stale = _close_over_components(stale, rep_key, hop, n)
    forest_ok = (acyclic & roots_fixed & rep_consistent & tree_cover_ok
                 & tree_slots_ok & spanning_ok & counts_ok)
    healthy = forest_ok & tour_fresh & bcc_fresh
    return AuditReport(
        n_nodes=n, acyclic=acyclic, roots_fixed=roots_fixed,
        rep_consistent=rep_consistent, tree_cover_ok=tree_cover_ok,
        tree_slots_ok=tree_slots_ok, spanning_ok=spanning_ok,
        counts_ok=counts_ok, forest_ok=forest_ok, tour_fresh=tour_fresh,
        bcc_fresh=bcc_fresh, healthy=healthy, violating=viol,
        comp_violating=comp_violating, sever=sever, stale=stale,
        bad_slots=bad_slots,
        n_violating=torch.sum(comp_violating, dtype=torch.int32),
        syncs=syncs)


def audit_forest(state: DynamicForest, tn: TourNumbering | None = None,
                 bcc: DynamicBCC | None = None, *,
                 n_jumps: int = DEFAULT_JUMPS,
                 use_kernel: bool | None = None) -> AuditReport:
    """Audit every invariant of ``state`` (and optional caches).

    Args:
      state: the dynamic forest to audit (may be arbitrarily corrupted: no
        check here assumes any invariant holds).
      tn: optional tour numbering to freshness-check against ``state``
        (``state.dirty`` components are exempt: they are known stale until
        the next ``refresh_tour``).
      bcc: optional BCC cache to freshness-check (snapshot equality).
      n_jumps: doubling steps per convergence sync (engine contract).
      use_kernel: see ``repro_torch.kernels.kernel_wanted`` (the bounded
        compression runs the pointer_jump kernel on the card).

    Returns:
      AuditReport; ``report.healthy`` is the single go/no-go bit,
      ``report.comp_violating`` the scope ``recovery.repair_forest``
      rebuilds, ``report.stale`` the scope whose caches must refresh.
      Reports ``report.syncs`` to the ``obs`` ledger (phase ``audit``).
    """
    report = _audit(state, tn, bcc, n_jumps=n_jumps, use_kernel=use_kernel)
    obs.record("audit", report.syncs)
    return report
