"""Per half-edge hook proposals (``ops.hook_edges``)."""
