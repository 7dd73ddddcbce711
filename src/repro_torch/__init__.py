"""PyTorch/CUDA port of the RST library (``repro`` is the JAX reference).

Same subpackages as ``repro``: ``core`` (graph, compression engine,
connectivity, Euler tour, validation, RST entry point), ``data`` (graph
generators) and ``kernels`` (hand-written CUDA kernels for Hopper, each with
its plain PyTorch version). Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
