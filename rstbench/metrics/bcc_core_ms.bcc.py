"""bcc_core_ms.bcc (ms, program span): the device time of the ``bcc.core``
span (the low/high tables, aux connectivity and the readout) per traced
``biconnectivity`` call."""
from rstbench.metrics import _spans


def read(w):
    return _spans.device_ms(w, "bcc.core")
