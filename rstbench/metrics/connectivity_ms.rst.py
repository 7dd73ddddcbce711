"""connectivity_ms.rst (ms, program span): the device time of the
``connectivity`` span (hooking, the scatters and ``compress_full`` of
every round) per traced tree."""
from rstbench.metrics import _spans


def read(w):
    return _spans.device_ms(w, "connectivity")
