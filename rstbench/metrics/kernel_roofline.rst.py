"""kernel_roofline.rst (%, device trace): the least bytes of one tree at
the card's peak bandwidth, over the device-busy time of one tree
(``_layer.tree_least_bytes``)."""
from rstbench.metrics import _layer

least_bytes = _layer.tree_least_bytes


def read(w):
    return _layer.roofline(w, least_bytes)
