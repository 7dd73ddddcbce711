"""host_syncs.bcc (syncs/call, program counter): the synchronising CUDA
calls of one biconnectivity call, as torch's sync debug mode reports
them."""
from rstbench.metrics import _layer


def read(w):
    return _layer.host_syncs(w)
