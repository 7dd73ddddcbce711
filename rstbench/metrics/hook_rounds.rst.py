"""hook_rounds.rst (rounds, program counter): RSTResult.steps of the
gconn_euler method, the connectivity's hook and compress rounds, averaged
over the window's trees."""
from rstbench.metrics import _layer


def read(w):
    return _layer.counter_mean(w, "steps")
