"""kernel_roofline.bcc (%, device trace): the least bytes of one
biconnectivity call at the card's peak bandwidth, over its device-busy
time.

The least bytes: the half-edges' two int32 ends read once (8 B a
half-edge), and every array of BCCResult written once: bridge (bool) and
edge_bcc (int32), 5 B a half-edge; articulation (bool) and pre, size,
low, high (int32), 17 B a vertex."""
from rstbench.metrics import _layer


def least_bytes(n: int, half_edges: int) -> int:
    return 13 * half_edges + 17 * n


def read(w):
    return _layer.roofline(w, least_bytes)
