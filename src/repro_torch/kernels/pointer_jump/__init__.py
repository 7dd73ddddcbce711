"""k-step pointer doubling (``ops.pointer_jump_double_k``)."""
