"""euler_ms.rst (ms, program span): the device time of the ``euler.root``
span (the sort, the successors, the Wyllie ranking and the parents) per
traced tree."""
from rstbench.metrics import _spans


def read(w):
    return _spans.device_ms(w, "euler.root")
