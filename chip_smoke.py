#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--profile-out FILE]

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit (``nvidia-smi``);
  2. build every CUDA kernel from the repository's sources;
  3. kernels: each kernel against its plain PyTorch version on the card,
     bit-equal, at the main path's sizes, timed with CUDA events;
  4. the engine's sync contract on a 2^24-long chain;
  5. the main path, ``rooted_spanning_tree(g, 0, method="gconn_euler")``
     with the default device and kernels: on ``chain(256)`` and
     ``rmat(6, edge_factor=4)``, rounds 1 and 2 and the same tree as the
     port's run on the CPU, components as the union-find oracle's; then
     on ``grid2d(4096)`` (16.8M
     vertices, road-network regime) and ``rmat(20, edge_factor=16)``
     (kron_g500-logn20 analogue): launch counts set to 0 just before and
     read just after, trees validated, and every output and count held
     bit-equal against the same call with ``use_kernel=False``;
  6. one JSON line listing the kernels, then the result line
     ``{"ok": true, "device": {...}}`` as the last line.

``--profile-out`` also writes a ``torch.profiler`` table of one main-path
run per graph to FILE. Without a CUDA card, or outside the
repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks at 700 W (NVIDIA data sheet): HBM3 bandwidth,
# and the float32 rate outside the tensor cores, against which the
# kernels' int32 operations are counted (the table has no int32 row).
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12

N_JUMPS = 5
TIMED_RUNS = 7
E2E_RUNS = 5


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int = TIMED_RUNS) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after two warm-ups."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: int, ops: int):
    """Least time on the card: the larger of bytes over HBM bandwidth and
    operations over the peak rate, in ms, and which of the two it is."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_line(row: dict) -> dict:
    """A kernel row with its time under the name ``kernel_ms``."""
    return {("kernel_ms" if k == "ms" else k): v for k, v in row.items()}


def max_abs_err(torch, got, want) -> int:
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-out", type=pathlib.Path, default=None)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import (components_reference, compress_full,
                                  connected_components, count_components,
                                  rooted_spanning_tree, validate_rst)
    from repro_torch.core.euler import _tour_successors
    from repro_torch.core.rst import forest_edges
    from repro_torch.data import graphs
    from repro_torch.kernels import build
    from repro_torch.kernels.hook_edges.ops import hook_edges
    from repro_torch.kernels.list_rank.ops import list_rank_double_k
    from repro_torch.kernels.pointer_jump.ops import pointer_jump_double_k

    # 1. The card.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")

    # 2. Build.
    t0 = time.perf_counter()
    reports = build.build()
    build_s = time.perf_counter() - t0
    for name, report in reports.items():
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
        print(f"build {name}: {'; '.join(regs)}")
    emit({"phase": "build", "seconds": round(build_s, 3),
          "built": sorted(reports)})

    # 3. Kernels against their plain versions, at main-path sizes.
    gen = torch.Generator(device=dev).manual_seed(0)
    n_tab = 1 << 24
    ids = torch.arange(n_tab, dtype=torch.int32, device=dev)
    chain = torch.clamp(ids - 1, min=0)
    below = (torch.rand(n_tab, generator=gen, device=dev) * ids).to(torch.int32)
    perm = torch.randperm(n_tab, generator=gen, device=dev).to(torch.int32)
    forest = torch.empty_like(perm)
    forest[perm.long()] = perm[below.long()]      # relabelled random forest
    rows = {}

    err = 0
    for table in (chain, forest):
        err = max(err, max_abs_err(
            torch, pointer_jump_double_k(table, n_jumps=N_JUMPS,
                                         use_kernel=True),
            pointer_jump_double_k(table, n_jumps=N_JUMPS, use_kernel=False)))
    check(err == 0, f"pointer_jump_double differs from plain by {err}")
    pj = {}
    for label, table in (("chain", chain), ("forest", forest)):
        pj[label] = {
            "kernel_ms": cuda_ms(torch, lambda: pointer_jump_double_k(
                table, n_jumps=N_JUMPS, use_kernel=True)),
            "plain_ms": cuda_ms(torch, lambda: pointer_jump_double_k(
                table, n_jumps=N_JUMPS, use_kernel=False)),
            "library_ms_one_step": cuda_ms(torch, lambda: table[table]),
        }
    b_ms, b_by = bound(8 * n_tab, N_JUMPS * n_tab)
    rows["pointer_jump_double"] = dict(
        ms=pj["forest"]["kernel_ms"], plain_ms=pj["forest"]["plain_ms"],
        library_ms=pj["forest"]["library_ms_one_step"], bound_ms=b_ms,
        bound_by=b_by, max_abs_err=err)
    emit({"kernel": "pointer_jump_double", "n": n_tab, "n_jumps": N_JUMPS,
          "input": "relabelled random forest (chain_*: the 2^24 chain)",
          **kernel_line(rows["pointer_jump_double"]), **{
              f"{label}_{k}": v for label in pj for k, v in pj[label].items()}})
    del below, perm, ids

    t0 = time.perf_counter()
    grid = graphs.grid2d(4096, device=dev)
    grid_build_s = time.perf_counter() - t0
    n = grid.n_nodes
    rep, forest_mask, _ = connected_components(grid, use_kernel=False)
    fu, fv, valid = forest_edges(grid, forest_mask)
    comp_root = torch.where(rep == rep[0], 0, rep)
    succ, dvalid = _tour_successors(n, fu, fv, valid, comp_root)
    dist = (dvalid & (succ != -1)).to(torch.int32)
    got = list_rank_double_k(succ, dist, n_steps=N_JUMPS, use_kernel=True)
    want = list_rank_double_k(succ, dist, n_steps=N_JUMPS, use_kernel=False)
    err = max(max_abs_err(torch, got[0], want[0]),
              max_abs_err(torch, got[1], want[1]))
    check(err == 0, f"list_rank_double differs from plain by {err}")
    n_list = succ.numel()
    b_ms, b_by = bound(16 * n_list, 3 * N_JUMPS * n_list)
    rows["list_rank_double"] = dict(
        ms=cuda_ms(torch, lambda: list_rank_double_k(
            succ, dist, n_steps=N_JUMPS, use_kernel=True)),
        plain_ms=cuda_ms(torch, lambda: list_rank_double_k(
            succ, dist, n_steps=N_JUMPS, use_kernel=False)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    emit({"kernel": "list_rank_double", "n": n_list, "n_steps": N_JUMPS,
          "input": "Euler successor list of grid2d(4096)",
          **kernel_line(rows["list_rank_double"])})
    del rep, forest_mask, fu, fv, valid, comp_root, succ, dvalid, dist, got, want

    rand_rep = torch.randint(0, n, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
    err = 0
    for use_min in (True, False):
        got = hook_edges(grid.src, grid.dst, rand_rep, use_min, n_nodes=n,
                         use_kernel=True)
        want = hook_edges(grid.src, grid.dst, rand_rep, use_min, n_nodes=n,
                          use_kernel=False)
        err = max(err, max_abs_err(torch, got[0], want[0]),
                  max_abs_err(torch, got[1], want[1]))
    check(err == 0, f"hook_edges differs from plain by {err}")
    e = grid.n_half_edges
    b_ms, b_by = bound(16 * e + 4 * n, 6 * e)
    rows["hook_edges"] = dict(
        ms=cuda_ms(torch, lambda: hook_edges(grid.src, grid.dst, rand_rep,
                                             True, n_nodes=n,
                                             use_kernel=True)),
        plain_ms=cuda_ms(torch, lambda: hook_edges(grid.src, grid.dst,
                                                   rand_rep, True, n_nodes=n,
                                                   use_kernel=False)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    emit({"kernel": "hook_edges", "n_half_edges": e, "n_nodes": n,
          "input": "grid2d(4096) edges, random rep",
          **kernel_line(rows["hook_edges"])})
    del rand_rep, got, want

    # 4. The engine's sync contract: ⌈log2(d)/k⌉ + 1 checks.
    engine = {"phase": "engine", "chain": n_tab}
    for k, want_syncs in ((5, 6), (1, 25)):
        out, syncs = compress_full(chain, n_jumps=k, return_syncs=True)
        check(syncs == want_syncs and int(out.max()) == 0,
              f"compress_full(chain 2^24, k={k}): syncs={syncs}, "
              f"want {want_syncs}")
        engine[f"syncs_k{k}"] = syncs
    emit(engine)
    del chain, forest, out

    # 5. The main path. First two small graphs: the rounds of the
    # table1/smoke_* rows, and the card's tree against the port's run on
    # the CPU and against the union-find oracle.
    for label, g, want_rounds in (
            ("chain(256)", graphs.chain(256, device=dev), 1),
            ("rmat(6, edge_factor=4)", graphs.rmat(6, edge_factor=4,
                                                   device=dev), 2)):
        r = rooted_spanning_tree(g, 0, method="gconn_euler")
        c = rooted_spanning_tree(g, 0, method="gconn_euler", device="cpu")
        check(r.steps == want_rounds,
              f"{label}: rounds {r.steps}, want {want_rounds}")
        for field in ("parent", "rep", "forest_mask"):
            check(torch.equal(getattr(r, field).cpu(), getattr(c, field)),
                  f"{label}: {field} differs from the run on the CPU")
        check((r.steps, r.compress_syncs, r.rank_syncs)
              == (c.steps, c.compress_syncs, c.rank_syncs),
              f"{label}: counts differ from the run on the CPU")
        oracle = components_reference(g)
        check(np.array_equal(oracle[r.rep.cpu().numpy()], oracle)
              and count_components(r.rep) == len(set(oracle.tolist())),
              f"{label}: components differ from the union-find oracle")
        check(validate_rst(g, r.parent, 0)["all_ok"],
              f"{label}: invalid tree")
    t0 = time.perf_counter()
    rmat = graphs.rmat(20, edge_factor=16, device=dev)
    rmat_build_s = time.perf_counter() - t0
    cases = (("grid2d(4096)", grid, grid_build_s),
             ("rmat(20, edge_factor=16)", rmat, rmat_build_s))

    counters = (pointer_jump_double_k, list_rank_double_k, hook_edges)

    def counts():
        return [c.launches for c in counters]

    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    results, deltas = [], []
    for _, g, _ in cases:
        before = counts()
        results.append(rooted_spanning_tree(g, 0, method="gconn_euler"))
        torch.cuda.synchronize()
        deltas.append([a - b for a, b in zip(counts(), before)])
    launches = dict(zip(("pointer_jump_double", "list_rank_double",
                         "hook_edges"), counts()))
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")

    for (label, g, build_s), r, (pj_n, lr_n, he_n) in zip(cases, results,
                                                          deltas):
        check((pj_n, lr_n, he_n) == (N_JUMPS * r.compress_syncs,
                                     N_JUMPS * r.rank_syncs, r.steps + 1),
              f"{label}: launches {(pj_n, lr_n, he_n)} do not match syncs "
              f"{(r.compress_syncs, r.rank_syncs, r.steps)}")
        verdict = validate_rst(g, r.parent, 0)
        check(verdict["all_ok"], f"{label}: invalid tree {verdict}")
        p = rooted_spanning_tree(g, 0, method="gconn_euler",
                                 use_kernel=False)
        for field in ("parent", "rep", "forest_mask"):
            check(torch.equal(getattr(r, field), getattr(p, field)),
                  f"{label}: {field} differs from the plain path")
        check((r.steps, r.compress_syncs, r.rank_syncs)
              == (p.steps, p.compress_syncs, p.rank_syncs),
              f"{label}: counts differ from the plain path")

        def run(use_kernel, g=g):
            torch.cuda.synchronize()
            t = time.perf_counter()
            rooted_spanning_tree(g, 0, method="gconn_euler",
                                 use_kernel=use_kernel)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3

        kernel_ms, plain_ms = [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(E2E_RUNS):       # in turns: k p p k k p ...
            for use_kernel in ((None, False) if i % 2 == 0 else (False, None)):
                (kernel_ms if use_kernel is None else plain_ms).append(
                    run(use_kernel))
        emit({"graph": label, "n": g.n_nodes, "half_edges": g.n_half_edges,
              "generate_s": round(build_s, 3), "rounds": r.steps,
              "compress_syncs": r.compress_syncs,
              "rank_syncs": r.rank_syncs,
              "launches": {"pointer_jump_double": pj_n,
                           "list_rank_double": lr_n, "hook_edges": he_n},
              "e2e_ms_median": statistics.median(kernel_ms),
              "e2e_ms": kernel_ms,
              "plain_e2e_ms_median": statistics.median(plain_ms),
              "plain_e2e_ms": plain_ms,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "valid": verdict["all_ok"], "card": card})

    if args.profile_out is not None:
        from torch.profiler import ProfilerActivity, profile
        tables = [card]
        for label, g, _ in cases:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t = time.perf_counter()
                rooted_spanning_tree(g, 0, method="gconn_euler")
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
            tables.append(f"{label} gconn_euler, profiled run: {wall_ms:.3f} "
                          "ms wall\n" + prof.key_averages().table(
                              sort_by="cuda_time_total", row_limit=40))
        args.profile_out.parent.mkdir(parents=True, exist_ok=True)
        args.profile_out.write_text("\n\n".join(tables) + "\n")

    # 6. Results.
    sources = {
        "pointer_jump_double": ("src/repro_torch/kernels/pointer_jump/csrc/"
                                "pointer_jump.cu",
                                "src/repro/kernels/pointer_jump/"
                                "pointer_jump.py:45"),
        "list_rank_double": ("src/repro_torch/kernels/list_rank/csrc/"
                             "list_rank.cu",
                             "src/repro/kernels/list_rank/list_rank.py:47"),
        "hook_edges": ("src/repro_torch/kernels/hook_edges/csrc/"
                       "hook_edges.cu",
                       "src/repro/kernels/hook_edges/hook_edges.py:30"),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], **rows[name]}
        for name, (src, tpu) in sources.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
