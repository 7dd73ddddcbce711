"""bfs_rst_ms (ms, host clock): the window's wall time over the BFS trees
completed in it, as rst_ms counts trees. A metric of its own, so that the
BFS cell's wider spread sets its own bound."""
from rstbench import stats


def read(w):
    return stats.per_call_ms(w["window_s"], w["calls"])
