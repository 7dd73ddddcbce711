"""pointer_jump_roofline.rst (%, program span): the
``pointer_jump_double`` kernel against its own bound. Each pass over an
entry reads one int32 and writes one, 8 B, so the kernel moves 8 B × Σ
entries × passes of its ``kernel.pointer_jump_double`` spans (the kernel
table's 8n B a pass). That counts the bytes the kernel's passes move, not
a tree's least bytes (``kernel_roofline.rst``), at the card's peak
bandwidth, over the span's device time."""
from rstbench.metrics import _spans

BYTES_PER_ENTRY_PASS = 8


def read(w):
    return _spans.kernel_roofline(w, "kernel.pointer_jump_double",
                                  BYTES_PER_ENTRY_PASS)
