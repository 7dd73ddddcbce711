"""bfs_levels (levels, program counter): RSTResult.steps of the bfs
method, the levels of a tree, averaged over the window's trees."""
from rstbench.metrics import _layer


def read(w):
    return _layer.counter_mean(w, "steps")
