"""bfs_rst_p95_ms (ms, host clock): the 95th percentile (nearest rank) of
the wall time of every BFS tree in the window, from its call to its
sync."""
from rstbench import stats


def read(w):
    return stats.percentile([t * 1e3 for t in w["latencies_s"]], 95)
