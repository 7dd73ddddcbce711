"""aux_rounds.bcc (steps, program counter): BCCResult.aux_rounds +
seg_syncs, the BCC core's connectivity rounds on the auxiliary graph and
the levels of its two low/high tables, averaged over the window's
calls."""
from rstbench.metrics import _layer


def read(w):
    return _layer.counter_mean(w, "aux_rounds", "seg_syncs")
