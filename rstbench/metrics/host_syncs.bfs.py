"""host_syncs.bfs (syncs/tree, program counter): the synchronising CUDA
calls of one bfs rooted_spanning_tree call, as torch's sync debug mode
reports them: about one a level."""
from rstbench.metrics import _layer


def read(w):
    return _layer.host_syncs(w)
