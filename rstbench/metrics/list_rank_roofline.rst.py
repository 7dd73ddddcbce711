"""list_rank_roofline.rst (%, program span): the ``list_rank_double``
kernel against its own bound. Each pass over an entry reads and writes an
8-byte (succ, dist) pair, 16 B, so the kernel moves 16 B × Σ entries ×
passes of its ``kernel.list_rank_double`` spans (the kernel table's
16N B a pass). That counts the bytes the kernel's passes move, not a
tree's least bytes (``kernel_roofline.rst``), at the card's peak
bandwidth, over the span's device time."""
from rstbench.metrics import _spans

BYTES_PER_ENTRY_PASS = 16


def read(w):
    return _spans.kernel_roofline(w, "kernel.list_rank_double",
                                  BYTES_PER_ENTRY_PASS)
