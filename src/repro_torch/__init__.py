"""PyTorch/CUDA port of the RST library (``repro`` is the JAX reference).

Same subpackages as ``repro``: ``core`` (graph, compression engine,
connectivity, Euler tour, validation, RST entry point, biconnectivity,
queries), ``data`` (graph generators), ``kernels`` (hand-written CUDA
kernels for Hopper, each with its plain PyTorch version), DIEN's
``models``, ``configs``, ``train``, ``optim`` and ``launch``, and ``obs``
(sync ledger, tracing, metrics). Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
