"""kernel_roofline.bfs (%, device trace): the least bytes of one BFS tree
at the card's peak bandwidth, over the device-busy time of one tree. The
least bytes are any tree's (``_layer.tree_least_bytes``)."""
from rstbench.metrics import _layer

least_bytes = _layer.tree_least_bytes


def read(w):
    return _layer.roofline(w, least_bytes)
