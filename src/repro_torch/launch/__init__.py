"""Launch helpers of the port: the synthetic data of ``train``, the serving
flag schema (``config``), the self-healing stream loop (``resilient``) and
the streaming CLI (``serve_stream``)."""
