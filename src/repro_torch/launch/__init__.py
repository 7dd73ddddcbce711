"""Launch helpers of the port: the synthetic data of ``train``, the serving
flag schema (``config``), the self-healing stream loop (``resilient``),
the streaming and fleet CLIs (``serve_stream``, ``serve_fleet``) and the
LM serving CLI (``serve``)."""
