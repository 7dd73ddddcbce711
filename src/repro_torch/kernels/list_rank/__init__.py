"""k-step Wyllie list ranking (``ops.list_rank_double_k``)."""
