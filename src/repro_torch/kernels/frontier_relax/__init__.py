"""BFS frontier expansion mask (``ops.frontier_relax``)."""
