"""Launch helpers of the port: the synthetic data of ``train``."""
