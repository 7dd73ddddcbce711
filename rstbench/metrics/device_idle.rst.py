"""device_idle.rst (%, device trace): the card's idle share while it
builds trees by connectivity and Euler rooting, read from torch.profiler
over the window's first calls."""
from rstbench.metrics import _layer


def read(w):
    return _layer.device_idle(w)
