"""Embedding bag: fixed-hotness gather and weighted sum or mean
(``ops.embed_bag``)."""
