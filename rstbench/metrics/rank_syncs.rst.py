"""rank_syncs.rst (syncs, program counter): RSTResult.rank_syncs, the
Euler tour's list-ranking checks, averaged over the window's trees."""
from rstbench.metrics import _layer


def read(w):
    return _layer.counter_mean(w, "rank_syncs")
