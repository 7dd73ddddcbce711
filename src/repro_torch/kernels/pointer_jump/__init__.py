"""Pointer jumping: k doubling steps (``ops.pointer_jump_double_k``) and
k + 1 hops against a fixed table (``ops.pointer_jump_k``)."""
