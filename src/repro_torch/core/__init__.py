"""Core library: the paper's three rooted-spanning-tree strategies in
PyTorch (GConn + Euler tour, BFS, PR-RST), and the consumers on top of them:
biconnectivity, tree queries and tree analytics."""
from repro_torch.core import queries
from repro_torch.core.analytics import depths, subtree_sizes
from repro_torch.core.bcc import (BCCResult, bcc_batch, bcc_from_parent,
                                  bcc_from_tour, biconnectivity)
from repro_torch.core.bfs import bfs_rst
from repro_torch.core.compress import (DEFAULT_JUMPS, compress_full,
                                       compress_scoped, jump_k, rank_to_root,
                                       reduce_to_root, roots_of,
                                       segment_reduce, segment_reduce_scoped,
                                       wyllie_rank)
from repro_torch.core.connectivity import (connected_components,
                                           count_components,
                                           pointer_jump_full)
from repro_torch.core.euler import (TourNumbering, euler_tour_root,
                                    list_rank_dist_to_end, tour_numbering)
from repro_torch.core.graph import (Graph, build_csr, degrees,
                                    resolve_device)
from repro_torch.core.pr_rst import pr_rst
from repro_torch.core.queries import (QueryTables, build_tables, connected,
                                      depth_of, edge_membership,
                                      is_ancestor, lca, path_agg,
                                      subtree_agg)
from repro_torch.core.reroot import (ancestor_tables, link_components,
                                     mark_paths, reverse_and_graft)
from repro_torch.core.rst import (METHODS, RSTResult, gconn_euler_rst,
                                  rooted_spanning_tree, tree_depth)
from repro_torch.core.validate import (bfs_depths_reference,
                                       components_reference, reaches_root,
                                       validate_rst)

__all__ = [
    "queries", "depths", "subtree_sizes", "BCCResult", "bcc_batch",
    "bcc_from_parent", "bcc_from_tour", "biconnectivity", "segment_reduce",
    "segment_reduce_scoped", "QueryTables", "build_tables", "connected",
    "depth_of", "edge_membership", "is_ancestor", "lca", "path_agg",
    "subtree_agg",
    "bfs_rst", "pr_rst", "ancestor_tables", "link_components", "mark_paths",
    "reverse_and_graft",
    "DEFAULT_JUMPS", "compress_full", "compress_scoped", "jump_k",
    "rank_to_root", "reduce_to_root", "roots_of", "wyllie_rank",
    "connected_components", "count_components", "pointer_jump_full",
    "TourNumbering", "euler_tour_root", "list_rank_dist_to_end",
    "tour_numbering", "Graph", "build_csr", "degrees", "resolve_device",
    "METHODS", "RSTResult", "gconn_euler_rst", "rooted_spanning_tree",
    "tree_depth",
    "bfs_depths_reference", "components_reference", "reaches_root",
    "validate_rst",
]
