"""Core library: the GConn + Euler-tour rooted-spanning-tree path in PyTorch."""
from repro_torch.core.compress import (DEFAULT_JUMPS, compress_full,
                                       compress_scoped, jump_k, rank_to_root,
                                       reduce_to_root, roots_of, wyllie_rank)
from repro_torch.core.connectivity import (connected_components,
                                           count_components,
                                           pointer_jump_full)
from repro_torch.core.euler import (TourNumbering, euler_tour_root,
                                    list_rank_dist_to_end, tour_numbering)
from repro_torch.core.graph import Graph, resolve_device
from repro_torch.core.rst import (METHODS, RSTResult, gconn_euler_rst,
                                  rooted_spanning_tree, tree_depth)
from repro_torch.core.validate import (components_reference, reaches_root,
                                       validate_rst)

__all__ = [
    "DEFAULT_JUMPS", "compress_full", "compress_scoped", "jump_k",
    "rank_to_root", "reduce_to_root", "roots_of", "wyllie_rank",
    "connected_components", "count_components", "pointer_jump_full",
    "TourNumbering", "euler_tour_root", "list_rank_dist_to_end",
    "tour_numbering", "Graph", "resolve_device", "METHODS", "RSTResult",
    "gconn_euler_rst", "rooted_spanning_tree", "tree_depth",
    "components_reference", "reaches_root", "validate_rst",
]
