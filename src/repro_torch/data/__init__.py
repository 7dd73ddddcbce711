"""Data pipelines: the synthetic graph suite (``graphs``)."""
