"""host_syncs.rst (syncs/tree, program counter): the synchronising CUDA
calls of one gconn_euler rooted_spanning_tree call, as torch's sync debug
mode reports them."""
from rstbench.metrics import _layer


def read(w):
    return _layer.host_syncs(w)
