"""bcc_ms (ms, host clock): the window's wall time over the biconnectivity
calls completed in it."""
from rstbench import stats


def read(w):
    return stats.per_call_ms(w["window_s"], w["calls"])
