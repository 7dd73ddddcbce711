"""Batch-dynamic rooted-spanning-forest maintenance (DESIGN.md §9–§13).

The port of ``repro.dynamic``: state and update application (``forest``),
stream replay (``replay``), incremental tour refresh (``tour``),
incremental biconnectivity (``bcc``), the read path (``queries``: a
version-stamped ``QuerySession``), the one refresh surface over them
(``view``: ``ForestView`` and ``CadencePolicy``), and the self-healing
layer (DESIGN.md §11): fault injection (``chaos``), O(log n) invariant
auditing (``audit``) and the scoped-repair/rebuild ladder (``recovery``).
Edge-stream workloads live in ``repro_torch.data.streams``; the serving
loops in ``repro_torch.launch.resilient`` and
``repro_torch.launch.serve_stream``. The fleet is not ported yet.
"""
from repro_torch.dynamic.audit import AuditReport, audit_forest
from repro_torch.dynamic.bcc import DynamicBCC, refresh_bcc
from repro_torch.dynamic.chaos import (INJECTORS, POLLUTERS, inject,
                                       merge_quarantine, pollute_stream,
                                       sanitize_batch)
from repro_torch.dynamic.forest import (DynamicForest, apply_batch,
                                        edge_slots, forest_empty,
                                        forest_from_graph, live_graph)
from repro_torch.dynamic.queries import (POLICIES, QuerySession,
                                         StaleQueryError)
from repro_torch.dynamic.recovery import (rebuild_forest, recover,
                                          repair_forest)
from repro_torch.dynamic.replay import (init_state, replay_batch,
                                        stream_capacity)
from repro_torch.dynamic.tour import refresh_tour
from repro_torch.dynamic.view import (CadencePolicy, ForestView,
                                      refresh_bcc_once, refresh_tour_once)

__all__ = [
    "AuditReport", "CadencePolicy", "DynamicBCC", "DynamicForest",
    "ForestView", "INJECTORS", "POLICIES", "POLLUTERS", "QuerySession",
    "StaleQueryError", "apply_batch", "audit_forest", "edge_slots",
    "forest_empty", "forest_from_graph", "init_state", "inject",
    "live_graph", "merge_quarantine", "pollute_stream", "rebuild_forest",
    "recover", "refresh_bcc", "refresh_bcc_once", "refresh_tour",
    "refresh_tour_once", "repair_forest", "replay_batch", "sanitize_batch",
    "stream_capacity",
]
