"""rst_ms (ms, host clock): the window's wall time over the trees completed
in it. A tree is complete when its call has returned and the device has
synchronised."""
from rstbench import stats


def read(w):
    return stats.per_call_ms(w["window_s"], w["calls"])
