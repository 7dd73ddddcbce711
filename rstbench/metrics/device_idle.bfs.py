"""device_idle.bfs (%, device trace): the card's idle share while it
builds BFS trees, read from torch.profiler over the window's first
calls."""
from rstbench.metrics import _layer


def read(w):
    return _layer.device_idle(w)
