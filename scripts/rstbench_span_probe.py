"""Copy the benchmark (``rstbench/``, ``BENCHMARK.json``) of a checkout to
DEST with the program's spans wired into its traced path, and the six
per-layer metrics that read them added to ``BENCHMARK.json``.

    python3 scripts/rstbench_span_probe.py SRC_ROOT DEST
    cd DEST && python3 rstbench/run.py --workload <cell> --seed <n> \\
        --seconds 3 --trace 1

The edit to ``rstbench/bench.py`` is the one a benchmark change would
make: an ``obs.Tracer`` is installed while the profiler runs,
``rstbench.spans.reduce_spans`` of the traced calls goes into the window
as ``spans`` (what ``rstbench/metrics/_spans.py`` reads), and standard
error gets ``PROBE`` lines: device and idle ms a call by span, the idle
gaps by span, device time charged to no span, and the profiled calls'
latencies. DEST's ``src`` is a link to SRC_ROOT's.

At run time, ``PROBE_TRACER=0`` leaves the tracer out (the on-cost's
baseline) and ``PROBE_SYNC_TRACER=1`` counts each call's host syncs with a
tracer installed.
"""
import json
import os
import pathlib
import shutil
import sys

METRICS = [
    ("connectivity_ms.rst", "ms", "lower", "connectivity", "rst_ms"),
    ("euler_ms.rst", "ms", "lower", "Euler tour", "rst_ms"),
    ("bcc_core_ms.bcc", "ms", "lower", "BCC core", "bcc_ms"),
    ("level_gap_us.bfs", "us/level", "lower", "BFS", "bfs_rst_ms"),
    ("list_rank_roofline.rst", "%", "higher", "engine", "rst_ms"),
    ("pointer_jump_roofline.rst", "%", "higher", "engine", "rst_ms")]

# (old, new) edits of rstbench/bench.py; each old text occurs once.
EDITS = [
    ("from rstbench import trace as tracing\n",
     "from rstbench import trace as tracing\n"
     "from rstbench import spans as span_mod\n"
     "import os\n"
     "from repro_torch import obs\n"),
    ("""        profiler = _profiler(cuda)
        profiler.start()
""", """        profiler = _profiler(cuda)
        profiler.start()
        tracer = obs.Tracer()
        if os.environ.get("PROBE_TRACER", "1") == "1":
            tracer.__enter__()
"""),
    ("""                out, k = tracing.count_syncs(lambda: entry.call(root_i))""",
     """                if os.environ.get("PROBE_SYNC_TRACER") == "1":
                    with obs.Tracer():
                        out, k = tracing.count_syncs(lambda: entry.call(root_i))
                else:
                    out, k = tracing.count_syncs(lambda: entry.call(root_i))"""),
    ("""            profiler.stop()
            traced = (profiler, i + 1, end - prof_t0)""",
     """            profiler.stop()
            tracer.__exit__(None, None, None)
            traced = (profiler, i + 1, end - prof_t0)"""),
    ("""        profile = tracing.reduce_events(dev_ev, host_ev, traced[2])""",
     """        profile = tracing.reduce_events(dev_ev, host_ev, traced[2])
        ranges, launches, sdev = span_mod.span_events(traced[0])
        span_table = span_mod.reduce_spans(ranges, launches, sdev,
                                           tracer.records)
        n_att = sum(1 for *_, c in sdev if c in launches)
        print(f"PROBE device ops {len(sdev)}, with a launch {n_att}, "
              f"ranges {len(ranges)}, records {len(tracer.spans())}", file=log)
        kinds = {}
        for e in traced[0].profiler.kineto_results.events():
            kinds[span_mod._kind(e)] = kinds.get(span_mod._kind(e), 0) + 1
        print(f"PROBE kinds {kinds}", file=log)
        calls_ = traced[1]
        busy_ = profile["busy_s"] if profile else 0.0
        for name, v in sorted(span_table.items(), key=lambda kv: -kv[1]["device_s"]):
            print(f"PROBE span {name}: device_ms/call {v['device_s'] * 1e3 / calls_} "
                  f"idle_ms/call {v['idle_s'] * 1e3 / calls_} count {v['count']} "
                  f"args {v['args']}", file=log)
        print(f"PROBE busy_ms/call {busy_ * 1e3 / calls_}", file=log)
        for lab, sec in span_mod.span_gaps(ranges, sdev):
            print(f"PROBE gap {lab}: ms/call {sec * 1e3 / calls_}", file=log)
        # ops charged to no span, by name
        tree = span_mod._Tree(ranges)
        outside = {}
        for nm, s0, e0, c in sdev:
            t = launches.get(c)
            if t is None or tree.innermost(t) < 0:
                outside[nm[:60]] = outside.get(nm[:60], 0) + (e0 - s0) * 1e-9
        for nm, sec in sorted(outside.items(), key=lambda kv: -kv[1])[:8]:
            print(f"PROBE outside {nm}: ms/call {sec * 1e3 / calls_}", file=log)
        lat = sorted(latencies[:calls_])
        print(f"PROBE profiled calls {calls_} median_ms {lat[len(lat)//2] * 1e3} "
              f"all {[round(x * 1e3, 3) for x in latencies[:calls_]]}", file=log)"""),
    ("""              "peak_bytes_per_s": _peak_bandwidth(root, kind)}""",
     """              "peak_bytes_per_s": _peak_bandwidth(root, kind)}
    if traced_spans is not None:
        window["spans"] = traced_spans"""),
    ("""    profile = None
    if traced is not None:""", """    profile = None
    traced_spans = None
    if traced is not None:"""),
    ("""        if profile is not None:
            profile["calls"] = traced[1]""", """        if profile is not None:
            profile["calls"] = traced[1]
        traced_spans = span_table"""),
]


def main(src: pathlib.Path, dest: pathlib.Path) -> None:
    if dest.exists():
        shutil.rmtree(dest)
    dest.mkdir(parents=True)
    shutil.copytree(src / "rstbench", dest / "rstbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(src.resolve() / "src", dest / "src")
    bench = json.loads((src / "BENCHMARK.json").read_text())
    for name, unit, better, layer, moves in METRICS:
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": better,
            "source": "program_span", "layer": layer, "moves": moves})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    path = dest / "rstbench" / "bench.py"
    text = path.read_text()
    for old, new in EDITS:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path.write_text(text)
    print("probe at", dest)


if __name__ == "__main__":
    main(*map(pathlib.Path, sys.argv[1:3]))
