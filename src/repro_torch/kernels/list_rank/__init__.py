"""Wyllie list ranking: k doubling steps (``ops.list_rank_double_k``) and
(k + 1)-hop prefix sums against one snapshot (``ops.list_rank_k``)."""
