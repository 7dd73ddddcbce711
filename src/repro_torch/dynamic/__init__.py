"""Batch-dynamic rooted-spanning-forest maintenance (DESIGN.md §9–§13).

The port of ``repro.dynamic``'s streaming layer: state and update
application (``forest``), stream replay (``replay``), incremental tour
refresh (``tour``), incremental biconnectivity (``bcc``), the read path
(``queries``: a version-stamped ``QuerySession``) and the one refresh
surface over them (``view``: ``ForestView`` and ``CadencePolicy``).
Edge-stream workloads live in ``repro_torch.data.streams``.
"""
from repro_torch.dynamic.bcc import DynamicBCC, refresh_bcc
from repro_torch.dynamic.forest import (DynamicForest, apply_batch,
                                        edge_slots, forest_empty,
                                        forest_from_graph, live_graph)
from repro_torch.dynamic.queries import (POLICIES, QuerySession,
                                         StaleQueryError)
from repro_torch.dynamic.replay import (init_state, replay_batch,
                                        stream_capacity)
from repro_torch.dynamic.tour import refresh_tour
from repro_torch.dynamic.view import (CadencePolicy, ForestView,
                                      refresh_bcc_once, refresh_tour_once)

__all__ = [
    "CadencePolicy", "DynamicBCC", "DynamicForest", "ForestView",
    "POLICIES", "QuerySession", "StaleQueryError", "apply_batch",
    "edge_slots", "forest_empty", "forest_from_graph", "init_state",
    "live_graph", "refresh_bcc", "refresh_bcc_once", "refresh_tour",
    "refresh_tour_once", "replay_batch", "stream_capacity",
]
