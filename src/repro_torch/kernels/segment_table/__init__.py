"""Doubling sparse table for min/max range queries (``ops.segment_table``)."""
