"""Graceful degradation and scoped repair for the dynamic forest (DESIGN.md
§11).

The port of ``repro.dynamic.recovery``. The escalation ladder, cheapest
rung first:

  1. **Audit** (``dynamic.audit.audit_forest``): O(log n) syncs; if
     healthy, nothing else runs.
  2. **Scoped repair** (``repair_forest``): a fragment-preserving rebuild
     of the violating components only. Clear the parent pointer at the
     audit's cut set, keep every tree edge that is still a genuine parent
     link, re-derive ``rep`` with one ``compress_scoped`` over the
     violation closure, then drain cross edges with the union-by-size
     ``core.reroot.link_components`` loop ``apply_batch`` uses. Intact
     components pay no doubling work, and the link loop's round count
     scales with the fault count.
  3. **Full rebuild** (``rebuild_forest``): if severing cannot break every
     cycle (``_post_sever_acyclic``) or a second audit still fails,
     re-derive parent / rep / tree_mask from the pool: GConn connectivity
     and Euler-tour rooting, the ``forest_from_graph`` path.

The edge pool is ground truth: repair never invents edges; slots with
out-of-range endpoints are quarantined (invalidated and counted).

``recover`` drives the ladder and then heals the caches (one incremental
``refresh_tour`` / ``refresh_bcc``; a full rebuild invalidates both).

The link loop is a host loop, as ``apply_batch``'s: it reads "any edge
crosses" once a round and stops before a round that would link nothing.
The reference's ``while_loop`` runs that last, unproductive body (its
overlay compression of an identity table, one convergence check) before
its condition fails, so one sync is added for it: ``sync_total``,
``rounds`` and ``links`` equal the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.core.compress import (DEFAULT_JUMPS, compress_full,
                                       compress_scoped)
from repro_torch.core.connectivity import connected_components
from repro_torch.core.euler import euler_tour_root
from repro_torch.core.reroot import link_components
from repro_torch.dynamic.audit import AUDIT_MAX_SYNCS, AuditReport, audit_forest
from repro_torch.dynamic.bcc import refresh_bcc
from repro_torch.dynamic.forest import (DynamicForest, _component_sizes,
                                        _first_true, _mark, live_graph)
from repro_torch.dynamic.tour import refresh_tour

#: Convergence checks of the reference's last link-loop body: its overlay
#: is the identity table, which ``compress_full`` settles in one check.
_IDLE_ROUND_SYNCS = 1


def _quarantine_pool(state: DynamicForest):
    """Invalidate live slots with out-of-range endpoints (no truth there).
    Returns ``((src, dst, valid, tree), n_dropped)``."""
    n = state.n_nodes
    src, dst = state.pool_src, state.pool_dst
    ep_ok = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    drop = state.pool_valid & ~ep_ok
    n_dropped = torch.sum(drop, dtype=torch.int32)
    valid = state.pool_valid & ~drop
    tree = state.tree_mask & ~drop
    src = torch.where(drop, n, src)
    dst = torch.where(drop, n, dst)
    return (src, dst, valid, tree), n_dropped


def _severed(state: DynamicForest, sever: torch.Tensor):
    """The parent table with the cut set (and out-of-range pointers)
    cleared to self-loops; also returns the in-range mask."""
    n = state.n_nodes
    verts = torch.arange(n, dtype=torch.int32, device=state.device)
    in_range = (state.parent >= 0) & (state.parent < n)
    return torch.where(in_range & ~sever, state.parent, verts), in_range


def _repair(state: DynamicForest, sever: torch.Tensor, scope: torch.Tensor,
            *, n_jumps: int, use_kernel: bool | None):
    n = state.n_nodes
    dev = state.device
    levels = max(1, (n - 1).bit_length())

    # Sever the parent pointer at exactly the audit's cut set; everything
    # else keeps its parent, so intact subtrees survive as rooted fragments
    # the link loop below stitches back together.
    p, in_range = _severed(state, sever)

    (pool_src, pool_dst, pool_valid, tree_mask), n_quarantined = \
        _quarantine_pool(state)
    uc = torch.clamp(pool_src, 0, n - 1).long()
    vc = torch.clamp(pool_dst, 0, n - 1).long()

    # A tree bit survives iff the slot is still a genuine parent link under
    # the severed table.
    tree_mask = tree_mask & pool_valid & ((p[uc] == vc) | (p[vc] == uc))

    # Re-derive rep over the violation closure (a union of complete
    # components, so compress_scoped's contract holds). The sync bound is a
    # backstop: callers gate on ``_post_sever_acyclic``.
    comp, rep_syncs = compress_scoped(p, scope, n_jumps=n_jumps,
                                      use_kernel=use_kernel,
                                      return_syncs=True,
                                      max_syncs=AUDIT_MAX_SYNCS)
    rt = torch.where(scope, comp, state.rep)

    # Drain cross edges: the apply_batch link loop (union by size, one
    # winner per moving component, PR-RST path reversal).
    rounds, link_syncs = 0, 0
    links = torch.zeros((), dtype=torch.int32, device=dev)
    while rounds < n:
        ru, rv = rt[uc], rt[vc]
        cand = pool_valid & (ru != rv)
        if not bool(torch.any(cand)):
            link_syncs += _IDLE_ROUND_SYNCS
            break
        size = _component_sizes(rt)
        su, sv = size[ru.long()], size[rv.long()]
        u_moves = (su < sv) | ((su == sv) & (ru > rv))
        start = torch.where(u_moves, uc, vc).to(torch.int32)
        target = torch.where(u_moves, vc, uc).to(torch.int32)
        p, rt, is_winner, s = link_components(
            p, rt, start, target, cand, levels=levels, n_jumps=n_jumps,
            use_kernel=use_kernel, return_syncs=True)
        tree_mask = tree_mask | is_winner
        links = links + torch.sum(is_winner, dtype=torch.int32)
        link_syncs += s
        rounds += 1

    # Every component that absorbed repaired vertices needs a tour refresh.
    comp_touched = _mark(n, rt, scope)
    dirty = state.dirty | comp_touched[rt.long()] | scope

    new_state = DynamicForest(
        n_nodes=n, parent=p, rep=rt, pool_src=pool_src, pool_dst=pool_dst,
        pool_valid=pool_valid, tree_mask=tree_mask, dirty=dirty,
        version=state.version + 1)
    stats = {"rounds": rounds, "links": links,
             "severed": torch.sum(sever & in_range, dtype=torch.int32),
             "repaired": torch.sum(scope, dtype=torch.int32),
             "quarantined_slots": n_quarantined,
             "sync_total": rep_syncs + link_syncs + rounds}
    return new_state, stats


def repair_forest(state: DynamicForest, report: AuditReport, *,
                  n_jumps: int = DEFAULT_JUMPS,
                  use_kernel: bool | None = None):
    """Repair only the audit's violating components from the live pool.

    Args:
      state: the (possibly corrupted) forest; never written into.
      report: the ``audit_forest`` result naming the damage (``sever``, the
        minimal cut set, and ``comp_violating``, the component closure
        whose ``rep`` is re-derived).
      use_kernel: see ``repro_torch.kernels.kernel_wanted`` (the scoped
        compression and the link rounds run the pointer_jump kernel on the
        card).

    Returns:
      (state', stats): ``rounds`` (productive link rounds) and
      ``sync_total`` (scoped compression + overlay compression checks +
      link rounds, the table6 accounting) are host ints; ``links``,
      ``severed`` (parent pointers cut), ``repaired`` (vertices in scope)
      and ``quarantined_slots`` are 0-d int32 tensors. ``sync_total`` is
      recorded to the ``obs`` ledger (phase ``repair``).
    """
    state, stats = _repair(state, report.sever, report.comp_violating,
                           n_jumps=n_jumps, use_kernel=use_kernel)
    obs.record("repair", stats["sync_total"])
    return state, stats


def _post_sever_acyclic(state: DynamicForest, sever: torch.Tensor, *,
                        use_kernel: bool | None = None) -> torch.Tensor:
    """0-d bool: would cutting the audit's sever set leave an acyclic table?

    A cycle whose every link carries a forged tree bit with a consistent
    cover evades the cut set when its length is odd; one bounded
    compression answers whether severing suffices, and if not ``recover``
    escalates straight to the full rebuild.
    """
    p, _ = _severed(state, sever)
    hop = compress_full(p, max_syncs=AUDIT_MAX_SYNCS, use_kernel=use_kernel)
    return torch.all(p[hop.long()] == hop)


def _rebuild(state: DynamicForest, *, use_kernel: bool | None):
    n = state.n_nodes
    cap = state.capacity

    (pool_src, pool_dst, pool_valid, _), n_quarantined = \
        _quarantine_pool(state)
    cleaned = dataclasses.replace(
        state, pool_src=pool_src, pool_dst=pool_dst, pool_valid=pool_valid,
        tree_mask=torch.zeros_like(state.tree_mask))

    rep, forest_mask, cc_rounds = connected_components(
        live_graph(cleaned), use_kernel=use_kernel)

    # Winning half-edges are canonical (e < capacity), so the undirected
    # tree mask is the first half of forest_mask.
    tree_mask = forest_mask[:cap] & pool_valid

    # The forest's half-edges, the first n - 1 set slots of forest_mask
    # (``jnp.nonzero(size=t, fill_value=m2)``, without a host read).
    t = max(n - 1, 1)
    m2 = forest_mask.numel()
    slots = _first_true(forest_mask, t)
    ok = slots < m2
    safe = torch.clamp(slots, 0, max(m2 - 1, 0))
    lg_src = torch.cat([pool_src, pool_dst])
    lg_dst = torch.cat([pool_dst, pool_src])
    fu = torch.where(ok, lg_src[safe], n)
    fv = torch.where(ok, lg_dst[safe], n)
    parent, rank_syncs = euler_tour_root(n, fu, fv, ok, rep,
                                         use_kernel=use_kernel,
                                         return_syncs=True)

    new_state = DynamicForest(
        n_nodes=n, parent=parent, rep=rep, pool_src=pool_src,
        pool_dst=pool_dst, pool_valid=pool_valid, tree_mask=tree_mask,
        dirty=torch.ones(n, dtype=torch.bool, device=state.device),
        version=state.version + 1)
    stats = {"cc_rounds": cc_rounds, "rank_syncs": rank_syncs,
             "quarantined_slots": n_quarantined,
             "sync_total": cc_rounds + rank_syncs}
    return new_state, stats


def rebuild_forest(state: DynamicForest, *, use_kernel: bool | None = None):
    """From-scratch rebuild: re-derive the forest from the live pool.

    GConn connectivity and Euler-tour rooting over the pool (each component
    rooted at its GConn representative), ignoring the existing parent, rep
    and tree_mask. Everything comes back dirty.

    Returns:
      (state', stats): ``cc_rounds``, ``rank_syncs`` and ``sync_total =
      cc_rounds + rank_syncs`` are host ints (``sync_total`` is recorded to
      the ``obs`` ledger, phase ``rebuild``); ``quarantined_slots`` is a 0-d
      int32 tensor.
    """
    state, stats = _rebuild(state, use_kernel=use_kernel)
    obs.record("rebuild", stats["sync_total"])
    return state, stats


def recover(state: DynamicForest, tn=None, bcc=None, *,
            n_jumps: int = DEFAULT_JUMPS, use_kernel: bool | None = None):
    """Audit and, if needed, repair the forest and heal its caches.

    The full ladder: audit → scoped repair → re-audit → full rebuild →
    final audit (raises ``RuntimeError`` if even the rebuild fails it). The
    repair scope lands in ``state.dirty`` (plus any audit-flagged
    staleness), so the tour refresh is incremental and ``refresh_bcc``'s
    snapshot diff picks up the repaired slots. After a full rebuild both
    caches recompute from scratch.

    Args:
      state: the forest to check and repair.
      tn: optional cached ``TourNumbering`` (refreshed and returned).
      bcc: optional cached ``DynamicBCC`` (refreshed and returned).
      use_kernel: see ``repro_torch.kernels.kernel_wanted``; every rung
        takes it.

    Returns:
      (state', tn', bcc', report, info): ``report`` is the initial audit;
      ``info`` is a host dict: ``mode`` in {"clean", "refresh", "scoped",
      "full"}, ``n_violating``, ``audit_syncs``, the stats of the rungs
      that ran (``repair_sync_total``, ``repaired``,
      ``rebuild_sync_total``) and, for any non-clean outcome, the
      escalation ``reason``. Under an ``obs.Tracer`` a non-clean pass emits
      the ``audit_violation`` and ``recovery`` events.
    """
    report = audit_forest(state, tn, bcc, n_jumps=n_jumps,
                          use_kernel=use_kernel)
    info = {"mode": "clean", "n_violating": int(report.n_violating),
            "audit_syncs": report.syncs}
    if bool(report.healthy):
        return state, tn, bcc, report, info

    obs.event("audit_violation", violations=report.violations(),
              n_violating=int(report.n_violating), syncs=report.syncs)
    if not bool(report.forest_ok):
        viable = bool(_post_sever_acyclic(state, report.sever,
                                          use_kernel=use_kernel))
        if viable:
            state, rstats = repair_forest(state, report, n_jumps=n_jumps,
                                          use_kernel=use_kernel)
            info["mode"] = "scoped"
            info["reason"] = "scoped_repair"
            info["repair_sync_total"] = rstats["sync_total"]
            info["repaired"] = int(rstats["repaired"])
        if not viable or not bool(audit_forest(
                state, n_jumps=n_jumps, use_kernel=use_kernel).forest_ok):
            state, bstats = rebuild_forest(state, use_kernel=use_kernel)
            info["mode"] = "full"
            info["reason"] = ("sever_insufficient" if not viable
                              else "reaudit_failed")
            info["rebuild_sync_total"] = bstats["sync_total"]
            tn = None       # nothing cached survives a full rebuild
            bcc = None
            final = audit_forest(state, n_jumps=n_jumps,
                                 use_kernel=use_kernel)
            if not bool(final.forest_ok):
                raise RuntimeError(
                    "unrecoverable: full rebuild still fails the audit: "
                    + final.summary())
    else:
        info["mode"] = "refresh"        # structure fine, caches stale
        info["reason"] = "caches_stale"
    obs.event("recovery", mode=info["mode"], reason=info["reason"],
              n_violating=info["n_violating"])

    # Heal the caches. Staleness beyond the repair scope must also land in
    # the dirty mask so the incremental tour refresh recomputes it.
    if tn is not None or bcc is not None:
        if bool(torch.any(report.stale)):
            state = dataclasses.replace(state,
                                        dirty=state.dirty | report.stale)
    if tn is not None:
        tn, state = refresh_tour(state, tn, use_kernel=use_kernel)
    elif bcc is not None or info["mode"] == "full":
        tn, state = refresh_tour(state, None, use_kernel=use_kernel)
    if bcc is not None or (info["mode"] == "full" and tn is not None):
        bcc = refresh_bcc(state, bcc, tour=tn, use_kernel=use_kernel)
    return state, tn, bcc, report, info
