"""One run of one cell: set-up, warm-up, the measured window, the check,
and the result line.

The cell's configuration gives the graph (made on the device from the
seed), its traffic mix the entry and its arguments. One client calls the
entry back to back (a closed loop) from roots drawn uniformly from the
seed, each call timed from its start to the device's synchronisation,
until ``seconds`` have passed. A sample of the calls' outputs, drawn from
the seed, is copied aside and checked against the reference once the
window has closed.

With ``trace`` the window also profiles its first calls (at most
``trace_calls`` calls or ``TRACE_MAX_S`` seconds; the profiler starts
before the window, since its first start takes seconds), then counts the
host syncs of ``sync_calls`` calls; the result line carries the per-layer
metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import json
import pathlib
import random
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from rstbench import catalog, seeds
from rstbench import trace as tracing

BANNED = ("jax", "jaxlib", "flax", "repro")
ROOT_DRAWS = 1 << 20          # roots drawn ahead, reused in turn past that
TRACE_MAX_S = 3.0


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark must never
    load (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _peak_bandwidth(root: pathlib.Path, kind: str) -> float | None:
    peaks = json.loads((root / catalog.PKG / "peaks.json").read_text())
    entry = peaks["devices"].get(kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def _profiler(cuda: bool):
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def run(root: pathlib.Path, workload: str, seed: int, seconds: float,
        trace: bool, *, t_start: float, device=None, log=sys.stderr) -> dict:
    """One run; returns the result line's object. ``device`` None means
    the card, which must be there (the CLI's path); a test passes the CPU.
    """
    bench = catalog.benchmark(root)
    cell = catalog.cell(bench, workload)
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{workload} needs {cell['chips']} CUDA "
                             "device(s); none or too few are visible")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)

    cfg = catalog.config(root, bench, cell["config"])
    tr = catalog.traffic(root, cell["traffic"])
    entry_mod = catalog.entry(root, tr["entry"])

    from repro_torch.core.graph import Graph
    marks = [("imports", time.perf_counter())]
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        marks.append(("device", time.perf_counter()))
    n, src, dst = catalog.generator(root, cfg["generator"]).build(
        cfg["params"], seed, device)
    graph = Graph(n, src, dst)
    sync()
    marks.append(("graph", time.perf_counter()))
    entry = entry_mod.Entry(graph, tr)
    roots = seeds.numpy_rng(seed, seeds.ROOTS).integers(0, n, ROOT_DRAWS)
    warm = seeds.numpy_rng(seed, seeds.WARMUP).integers(
        0, n, tr["warmup_calls"])
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # Warm-up: the cell's own call, which loads (or builds) its kernels.
    for k, r in enumerate(warm):
        out = entry.call(int(r))
        sync()
        marks.append((f"warm-up call {k}", time.perf_counter()))
    slots = [{k: (v.clone() if torch.is_tensor(v) else v)
              for k, v in entry.outputs(out).items()}
             for _ in range(tr["samples"])]
    slot_roots: list[int] = []
    del out
    pick = random.Random(int(seeds.sequence(seed, seeds.SAMPLE)
                             .generate_state(1)[0]))
    profiler = traced = None      # running profiler; (stopped, calls, s)
    sync_left = tr["sync_calls"] if trace and cuda else 0
    host_syncs: list[int] = []
    latencies: list[float] = []
    starts: list[float] = []
    counters: list[dict] = []
    failed = 0

    if trace:
        # Started before the window: its first start takes seconds.
        profiler = _profiler(cuda)
        profiler.start()
    sync()
    t0 = prof_t0 = time.perf_counter()
    setup_s = t0 - t_start
    last = t_start
    for name, t in marks + [("rest", t0)]:
        print(f"set-up {name}: {t - last} s", file=log)
        last = t
    end = t0
    while True:
        i = len(latencies)
        root_i = int(roots[i % ROOT_DRAWS])
        count_now = profiler is None and sync_left > 0
        t = time.perf_counter()
        try:
            if count_now:
                out, k = tracing.count_syncs(lambda: entry.call(root_i))
                host_syncs.append(k)
                sync_left -= 1
            else:
                out = entry.call(root_i)
            sync()
        except RuntimeError as exc:
            print(f"call {i} from root {root_i} failed: {exc!r}", file=log)
            failed += 1
            break
        end = time.perf_counter()
        starts.append(t)
        latencies.append(end - t)
        counters.append(entry.counters(out))
        # Reservoir sample of the calls' outputs, drawn from the seed.
        j = i if i < len(slots) else pick.randrange(i + 1)
        if j < len(slots):
            for k, v in entry.outputs(out).items():
                if torch.is_tensor(v):
                    slots[j][k].copy_(v)
                else:
                    slots[j][k] = v
            if j < len(slot_roots):
                slot_roots[j] = root_i
            else:
                slot_roots.append(root_i)
        del out
        if profiler is not None and (i + 1 >= tr["trace_calls"]
                                     or end - prof_t0 >= TRACE_MAX_S):
            profiler.stop()
            traced = (profiler, i + 1, end - prof_t0)
            profiler = None
            print(f"profiler stopped after call {i} in "
                  f"{time.perf_counter() - end} s", file=log)
        if end - t0 >= seconds and profiler is None and sync_left == 0:
            break
    window_s = end - t0

    found = banned_modules()
    if found:
        print("loaded forbidden modules: " + ", ".join(found), file=log)
        raise SystemExit(3)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    profile = None
    if traced is not None:
        dev_ev, host_ev = tracing.profile_events(traced[0])
        print(f"traced {traced[1]} calls in {traced[2]} s: {len(dev_ev)} "
              f"device and {len(host_ev)} host events", file=log)
        profile = tracing.reduce_events(dev_ev, host_ev, traced[2])
        if profile is not None:
            profile["calls"] = traced[1]
        traced = None

    # The check, after the program's state is gone.
    del entry
    if cuda:
        torch.cuda.empty_cache()
    samples = list(zip(slot_roots, slots))
    counts = entry_mod.check(src, dst, n, samples, tr)
    checks = {name: {"value": counts.get(name), "limit": limit}
              for name, limit in tr["limits"].items()}
    correct = (failed == 0 and len(samples) > 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))

    window = {"cell": workload, "n": n, "half_edges": int(src.numel()), "setup_s": setup_s,
              "window_s": window_s, "calls": len(latencies),
              "latencies_s": latencies, "counters": counters,
              "profile": profile, "host_syncs": host_syncs or None,
              "peak_bytes_per_s": _peak_bandwidth(root, kind)}
    group = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = {}
    for m in group:
        if not catalog.applies(m, workload, bench):
            continue
        value = catalog.metric(root, m["name"]).read(window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev_info = {"platform": "gpu" if cuda else device.type, "kind": kind,
                "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(latencies) + failed,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if trace and profile is not None:
        dev_info["busy_s"] = profile["busy_s"]
        dev_info["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    ms = sorted(t * 1e3 for t in latencies)
    if ms:
        q = [ms[int(f * (len(ms) - 1))] for f in (0, 0.25, 0.5, 0.75, 1)]
        between = sorted(((starts[k + 1] - starts[k] - latencies[k], k)
                          for k in range(len(starts) - 1)), reverse=True)
        print(f"call ms min/q1/median/q3/max {q}; first five "
              f"{[t * 1e3 for t in latencies[:5]]}; longest waits between "
              f"calls (s, after call) {between[:3]}", file=log)
    print(f"{workload}: n={n} half_edges={src.numel()} calls="
          f"{len(latencies)} window_s={window_s} setup_s={setup_s} "
          f"checked={len(samples)} roots={slot_roots}", file=log)
    for name, c in checks.items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=log)
    result["checks"] = checks
    return result
