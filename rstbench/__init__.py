"""The benchmark of ``repro_torch``: rooted spanning trees and
biconnectivity on one NVIDIA H100.

One run is one cell of ``BENCHMARK.json`` (a configuration under a traffic
mix), run once::

    python3 rstbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a configuration is ``configs/<name>.json``
(its generator is ``generators/<generator>.py``), a traffic mix is
``traffic/<name>.json`` (its entry is ``entries/<entry>.py``), and a metric
is ``metrics/<name>.py``. Adding one of them takes new files and new
``BENCHMARK.json`` entries, never an edit. ``reference/`` holds the plain
PyTorch checks that decide ``correct``; it imports nothing of the program.
"""
