#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--profile-out FILE]

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit (``nvidia-smi``);
  2. build every CUDA kernel from the repository's sources;
  3. kernels: each of the seven against its plain PyTorch version on the
     card, bit-equal, at the main paths' sizes, timed with CUDA events
     (segment_table: min and max, int32 at 2^24 and float32 at an odd n
     with one NaN);
  4. the engine's sync contract on a 2^24-long chain;
  5. the paths, each driven through its entry point with the launch
     counts set to 0 just before and read just after:
     a. the chain kernels' own entry points, ``ops.pointer_jump_k`` and
        ``ops.list_rank_k``, as the reference's kernel benchmark rows
        call them, at 2^24 elements;
     b. ``rooted_spanning_tree(g, 0, method=m)`` for the three methods
        ``gconn_euler``, ``bfs`` and ``pr_rst``: first on ``chain(256)`` and
        ``rmat(6, edge_factor=4)`` (the step counts of the table1/smoke_*
        rows, the same tree as the port's run on the CPU, a valid tree,
        and for gconn_euler the union-find oracle's components); then on
        ``grid2d(4096)`` (16.8M vertices, road-network regime) and
        ``rmat(20, edge_factor=16)`` (kron_g500-logn20 analogue) with the
        default device and kernels: trees validated, every output and
        count bit-equal to the same call with ``use_kernel=False``,
        launches matched to the syncs, end-to-end times, and one line per
        graph comparing the three methods (the paper's Fig. 1 and Fig. 2);
     c. ``biconnectivity(g, 0, rst_flavor=m)`` on ``chain(256)`` and
        ``rmat(6, edge_factor=4)`` for the three flavors: the table3/smoke_*
        counts and the same result as the port's CPU run;
     d. biconnectivity on the two large graphs for the three flavors (bfs
        on ``grid2d(4096)`` through ``bcc_from_parent`` on the paths
        phase's BFS tree): every field and count bit-equal to
        ``use_kernel=False``, segment_table launches equal to ``seg_syncs``,
        grid2d(4096)'s known answer (one block, no articulation point, no
        bridge), the same articulation points, bridges and block count from
        every flavor, end-to-end times, the articulation scatter's time,
        and one line per graph;
     e. tree queries on ``grid2d(4096)``'s gconn_euler tree:
        ``build_tables``, then one batch of 2^20 seeded random pairs through
        ``lca``, ``connected``, ``is_ancestor``, ``depth_of``,
        ``path_agg("add")`` and ``subtree_agg("min"/"max")`` (the last two
        through segment_table), held against the plain path and, on the
        first 4096 pairs, against the port's CPU run; ms per batch;
  6. one JSON line listing the kernels, then the result line
     ``{"ok": true, "device": {...}}`` as the last line.

``--profile-out`` also writes ``torch.profiler`` tables to FILE: one
gconn_euler and one pr_rst run per graph, one bfs run on
``rmat(20, edge_factor=16)`` and one gconn_euler ``biconnectivity`` per
graph. Without a CUDA card, or outside the repository, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
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

GRID_SIDE = 4096
RMAT_SCALE = 20
N_JUMPS = 5
TIMED_RUNS = 7
E2E_RUNS = 5
# A method whose first run on a graph takes longer than this is timed by
# that run and the plain run of the bit-equality check alone.
SLOW_RUN_MS = 5000.0
METHODS = ("gconn_euler", "bfs", "pr_rst")
# The outputs held bit-equal, and the counts, of each method.
FIELDS = {"gconn_euler": ("parent", "rep", "forest_mask"),
          "bfs": ("parent", "dist"),
          "pr_rst": ("parent",)}
COUNTS = {"gconn_euler": ("steps", "compress_syncs", "rank_syncs"),
          "bfs": ("steps",),
          "pr_rst": ("steps", "compress_syncs")}
# The table1/smoke_* rows of BENCH_rst.json: steps per method.
SMOKE_STEPS = {"chain(256)": {"gconn_euler": 1, "bfs": 255, "pr_rst": 1},
               "rmat(6, edge_factor=4)": {"gconn_euler": 2, "bfs": 3,
                                          "pr_rst": 2}}
# The table3/smoke_* rows: n_bcc, articulation points, bridges, aux rounds
# and seg syncs, the same for every flavor.
SMOKE_BCC = {"chain(256)": (255, 254, 255, 0, 16),
             "rmat(6, edge_factor=4)": (3, 2, 2, 2, 12)}
BCC_FIELDS = ("articulation", "bridge", "edge_bcc", "pre", "size", "low",
              "high")
BCC_COUNTS = ("n_bcc", "rst_steps", "aux_rounds", "seg_syncs")
QUERY_PAIRS = 1 << 20
CPU_QUERY_PAIRS = 4096


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
    from repro_torch.core import (BCCResult, QueryTables, bcc_from_parent,
                                  bcc_from_tour, bfs_rst, biconnectivity,
                                  components_reference,
                                  compress_full, connected_components,
                                  count_components, queries, reroot,
                                  rooted_spanning_tree, tour_numbering,
                                  tree_depth, validate_rst)
    from repro_torch.core.bcc import _articulation
    from repro_torch.core.queries import build_tables as build_query_tables
    from repro_torch.core.euler import _tour_successors
    from repro_torch.core.rst import forest_edges
    from repro_torch.data import graphs
    from repro_torch.kernels import build
    from repro_torch.kernels.frontier_relax.ops import frontier_relax
    from repro_torch.kernels.frontier_relax.ref import INF32
    from repro_torch.kernels.hook_edges.ops import hook_edges
    from repro_torch.kernels.list_rank.ops import list_rank_double_k, list_rank_k
    from repro_torch.kernels.pointer_jump.ops import (pointer_jump_double_k,
                                                      pointer_jump_k)
    from repro_torch.kernels.segment_table.ops import segment_table

    counters = {"pointer_jump_double": pointer_jump_double_k,
                "list_rank_double": list_rank_double_k,
                "hook_edges": hook_edges, "frontier_relax": frontier_relax,
                "pointer_jump_k": pointer_jump_k, "list_rank_k": list_rank_k,
                "segment_table": segment_table}

    def zero_counts():
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {name: c.launches for name, c in counters.items()}

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

    # The chain variants, on the same two tables: pointer_jump_k follows
    # each table; list_rank_k ranks it as a successor table whose roots
    # end their lists.
    pjk, lrk, err_pjk, err_lrk = {}, {}, 0, 0
    for label, table in (("chain", chain), ("forest", forest)):
        err_pjk = max(err_pjk, max_abs_err(
            torch, pointer_jump_k(table, n_jumps=N_JUMPS, use_kernel=True),
            pointer_jump_k(table, n_jumps=N_JUMPS, use_kernel=False)))
        pjk[label] = {
            "kernel_ms": cuda_ms(torch, lambda: pointer_jump_k(
                table, n_jumps=N_JUMPS, use_kernel=True)),
            "plain_ms": cuda_ms(torch, lambda: pointer_jump_k(
                table, n_jumps=N_JUMPS, use_kernel=False))}
        succ = torch.where(table == ids, -1, table)
        dist = (succ != -1).to(torch.int32)
        got = list_rank_k(succ, dist, n_steps=N_JUMPS, use_kernel=True)
        want = list_rank_k(succ, dist, n_steps=N_JUMPS, use_kernel=False)
        err_lrk = max(err_lrk, max_abs_err(torch, got[0], want[0]),
                      max_abs_err(torch, got[1], want[1]))
        lrk[label] = {
            "kernel_ms": cuda_ms(torch, lambda: list_rank_k(
                succ, dist, n_steps=N_JUMPS, use_kernel=True)),
            "plain_ms": cuda_ms(torch, lambda: list_rank_k(
                succ, dist, n_steps=N_JUMPS, use_kernel=False))}
    check(err_pjk == 0, f"pointer_jump_k differs from plain by {err_pjk}")
    check(err_lrk == 0, f"list_rank_k differs from plain by {err_lrk}")
    for name, res, err, nbytes, ops in (
            ("pointer_jump_k", pjk, err_pjk, 8 * n_tab, N_JUMPS * n_tab),
            ("list_rank_k", lrk, err_lrk, 16 * n_tab, 3 * N_JUMPS * n_tab)):
        b_ms, b_by = bound(nbytes, ops)
        rows[name] = dict(ms=res["forest"]["kernel_ms"],
                          plain_ms=res["forest"]["plain_ms"], library_ms=None,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        emit({"kernel": name, "n": n_tab, "n_steps": N_JUMPS,
              "input": "relabelled random forest (chain_*: the 2^24 chain)",
              **kernel_line(rows[name]), **{
                  f"{label}_{k}": v for label in res
                  for k, v in res[label].items()}})
    del below, perm, succ, dist, got, want

    t0 = time.perf_counter()
    grid = graphs.grid2d(GRID_SIDE, device=dev)
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

    # frontier_relax at a mid-BFS state. On grid2d(4096) from corner 0 the
    # BFS distance is row + col, so level L's state is every vertex with
    # row + col <= L set and the rest INF32. On rmat(20, 16), the state
    # after two BFS levels of the plain path.
    t0 = time.perf_counter()
    rmat = graphs.rmat(RMAT_SCALE, edge_factor=16, device=dev)
    rmat_build_s = time.perf_counter() - t0
    level = GRID_SIDE - 1
    verts = torch.arange(n, dtype=torch.int32, device=dev)
    manhattan = verts // GRID_SIDE + verts % GRID_SIDE
    grid_dist = torch.where(manhattan <= level, manhattan, INF32)
    _, rmat_dist, rmat_level = bfs_rst(rmat, 0, max_levels=2,
                                       use_kernel=False)
    rmat_level += 1
    fr = {}
    err = 0
    for label, g, d, lvl in (("grid", grid, grid_dist, level),
                             ("rmat", rmat, rmat_dist, rmat_level)):
        def run(use_kernel, g=g, d=d, lvl=lvl):
            return frontier_relax(d, g.src, g.dst, lvl, use_kernel=use_kernel)
        got, want = run(True), run(False)
        err = max(err, max_abs_err(torch, got, want))
        nb, nops = 9 * g.n_half_edges + 4 * g.n_nodes, 3 * g.n_half_edges
        b_ms, b_by = bound(nb, nops)
        fr[label] = dict(ms=cuda_ms(torch, lambda: run(True)),
                         plain_ms=cuda_ms(torch, lambda: run(False)),
                         library_ms=None, bound_ms=b_ms, bound_by=b_by,
                         frontier_edges=int(got.sum()), level=int(lvl))
    check(err == 0, f"frontier_relax differs from plain by {err}")
    rows["frontier_relax"] = {**{k: v for k, v in fr["grid"].items()
                                 if k not in ("frontier_edges", "level")},
                              "max_abs_err": err}
    emit({"kernel": "frontier_relax", "n_half_edges": e, "n_nodes": n,
          "input": "grid2d(4096) edges at BFS level 4095 from vertex 0 "
                   "(rmat_*: rmat(20, 16) after 2 levels)",
          **kernel_line(rows["frontier_relax"]),
          "frontier_edges": fr["grid"]["frontier_edges"],
          **{f"rmat_{k}": v for k, v in kernel_line(fr["rmat"]).items()}})
    del verts, manhattan, grid_dist, rmat_dist, got, want

    # segment_table at the BCC path's shapes: int32 at grid2d(4096)'s n
    # (2^24, 24 levels) and rmat(20, 16)'s (2^20, 20 levels), min and max;
    # and float32 at an odd n with one NaN, which must propagate.
    st = {}
    err = 0
    for label, size in (("grid", n), ("rmat", rmat.n_nodes)):
        vals = torch.randint(-2**31, 2**31 - 1, (size,), generator=gen,
                             device=dev, dtype=torch.int32)
        lv = (size - 1).bit_length()
        for op in ("min", "max"):
            err = max(err, max_abs_err(
                torch, segment_table(vals, levels=lv, op=op, use_kernel=True),
                segment_table(vals, levels=lv, op=op, use_kernel=False)))
        st[label] = dict(
            ms=cuda_ms(torch, lambda: segment_table(
                vals, levels=lv, op="min", use_kernel=True)),
            plain_ms=cuda_ms(torch, lambda: segment_table(
                vals, levels=lv, op="min", use_kernel=False)),
            library_ms=None,
            **dict(zip(("bound_ms", "bound_by"),
                       bound(4 * size * (lv + 2), lv * size))))
    n_odd = (1 << 20) + 1
    fvals = torch.randn(n_odd, generator=gen, device=dev)
    fvals[n_odd // 3] = float("nan")
    lv = (n_odd - 1).bit_length()
    for op in ("min", "max"):
        got = segment_table(fvals, levels=lv, op=op, use_kernel=True)
        want = segment_table(fvals, levels=lv, op=op, use_kernel=False)
        nan = want.isnan()
        check(torch.equal(got.isnan(), nan) and int(nan.sum()) > 0,
              f"segment_table float32 {op}: NaN not where the plain "
              "version has it")
        check(torch.equal(got[~nan].view(torch.int32),
                          want[~nan].view(torch.int32)),
              f"segment_table float32 {op} differs from plain")
    check(err == 0, f"segment_table differs from plain by {err}")
    rows["segment_table"] = {**st["grid"], "max_abs_err": err}
    emit({"kernel": "segment_table", "n": n, "levels": (n - 1).bit_length(),
          "input": "random int32 at grid2d(4096)'s n, op min (rmat_*: "
                   "rmat(20, 16)'s n); float32 with one NaN at n = 2^20 + 1 "
                   "checked, min and max",
          **kernel_line(rows["segment_table"]),
          **{f"rmat_{k}": v for k, v in kernel_line(st["rmat"]).items()}})
    del vals, fvals, got, want, nan

    # 4. The engine's sync contract: ⌈log2(d)/k⌉ + 1 checks.
    engine = {"phase": "engine", "chain": n_tab}
    for k, want_syncs in ((5, 6), (1, 25)):
        out, syncs = compress_full(chain, n_jumps=k, return_syncs=True)
        check(syncs == want_syncs and int(out.max()) == 0,
              f"compress_full(chain 2^24, k={k}): syncs={syncs}, "
              f"want {want_syncs}")
        engine[f"syncs_k{k}"] = syncs
    emit(engine)
    del chain, forest, out, ids

    # 5a. The chain kernels' own entry points, as the reference's
    # kernels/pointer_jump_*_x5 and list_rank_*_x5 rows call them: a
    # random table, and one list over every element.
    launches = dict.fromkeys(counters, 0)
    p_rand = torch.randint(0, n_tab, (n_tab,), generator=gen, device=dev,
                           dtype=torch.int32)
    succ = torch.arange(1, n_tab + 1, dtype=torch.int32, device=dev)
    succ[-1] = -1
    d0 = torch.ones(n_tab, dtype=torch.int32, device=dev)
    d0[-1] = 0
    zero_counts()
    out_p = pointer_jump_k(p_rand)
    out_s, out_d = list_rank_k(succ, d0)
    ops_path = read_counts()
    check(ops_path["pointer_jump_k"] == 1 and ops_path["list_rank_k"] == 1,
          f"the chain kernels' entry points launched {ops_path}")
    check(torch.equal(out_p, pointer_jump_k(p_rand, use_kernel=False))
          and torch.equal(out_s, list_rank_k(succ, d0, use_kernel=False)[0])
          and torch.equal(out_d, list_rank_k(succ, d0, use_kernel=False)[1]),
          "the chain kernels' entry points differ from the plain path")
    for name in launches:
        launches[name] += ops_path[name]
    emit({"path": "ops.pointer_jump_k, ops.list_rank_k", "n": n_tab,
          "launches": {k: v for k, v in ops_path.items() if v}})
    del p_rand, succ, d0, out_p, out_s, out_d

    # 5b. The three methods on two small graphs: the step counts of the
    # table1/smoke_* rows, and the card's tree against the port's run on
    # the CPU (and, for gconn_euler, the union-find oracle).
    small = (("chain(256)", graphs.chain(256, device=dev)),
             ("rmat(6, edge_factor=4)", graphs.rmat(6, edge_factor=4,
                                                    device=dev)))
    for label, g in small:
        for method in METHODS:
            r = rooted_spanning_tree(g, 0, method=method)
            c = rooted_spanning_tree(g, 0, method=method, device="cpu")
            want_steps = SMOKE_STEPS[label][method]
            check(r.steps == want_steps,
                  f"{label} {method}: steps {r.steps}, want {want_steps}")
            for field in FIELDS[method]:
                check(torch.equal(getattr(r, field).cpu(), getattr(c, field)),
                      f"{label} {method}: {field} differs from the CPU run")
            check(all(getattr(r, k) == getattr(c, k)
                      for k in COUNTS[method]),
                  f"{label} {method}: counts differ from the CPU run")
            check(validate_rst(g, r.parent, 0)["all_ok"],
                  f"{label} {method}: invalid tree")
            if method == "gconn_euler":
                oracle = components_reference(g)
                check(np.array_equal(oracle[r.rep.cpu().numpy()], oracle)
                      and count_components(r.rep) == len(set(oracle.tolist())),
                      f"{label}: components differ from the union-find "
                      "oracle")
    emit({"phase": "small graphs", "steps": SMOKE_STEPS})

    # 5c. The three methods on the two large graphs.
    cases = (("grid2d(4096)", grid, grid_build_s),
             ("rmat(20, edge_factor=16)", rmat, rmat_build_s))

    def timed(g, method, use_kernel):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = rooted_spanning_tree(g, 0, method=method, use_kernel=use_kernel)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    def expected_launches(method, r):
        want = dict.fromkeys(counters, 0)
        if method == "gconn_euler":
            want.update(pointer_jump_double=N_JUMPS * r.compress_syncs,
                        list_rank_double=N_JUMPS * r.rank_syncs,
                        hook_edges=r.steps + 1)
        elif method == "bfs":
            want.update(frontier_relax=r.steps + 1)
        else:
            want.update(pointer_jump_double=N_JUMPS * r.compress_syncs)
        return want

    summary, bfs_parent, gconn_parent = {}, {}, {}
    for label, g, build_s in cases:
        summary[label] = {}
        for method in METHODS:
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            r, first_ms = timed(g, method, None)
            got = read_counts()
            for name in launches:
                launches[name] += got[name]
            want = expected_launches(method, r)
            check(got == want, f"{label} {method}: launches {got}, "
                               f"want {want} from the syncs")
            verdict = validate_rst(g, r.parent, 0)
            check(verdict["all_ok"], f"{label} {method}: invalid tree "
                                     f"{verdict}")
            p, plain_first_ms = timed(g, method, False)
            for field in FIELDS[method]:
                check(torch.equal(getattr(r, field), getattr(p, field)),
                      f"{label} {method}: {field} differs from the plain "
                      "path")
            check(all(getattr(r, k) == getattr(p, k)
                      for k in COUNTS[method]),
                  f"{label} {method}: counts differ from the plain path")
            del p
            if first_ms <= SLOW_RUN_MS:
                kernel_ms, plain_ms = [], []
                for i in range(E2E_RUNS):       # in turns: k p p k k p ...
                    for use_kernel in ((None, False) if i % 2 == 0
                                       else (False, None)):
                        (kernel_ms if use_kernel is None else plain_ms
                         ).append(timed(g, method, use_kernel)[1])
                timing = "5 interleaved runs"
            else:
                kernel_ms, plain_ms = [first_ms], [plain_first_ms]
                timing = "the counted run and the bit-equality check's run"
            depth = tree_depth(r.parent)
            summary[label][method] = (statistics.median(kernel_ms), depth,
                                      r.steps)
            emit({"graph": label, "method": method, "n": g.n_nodes,
                  "half_edges": g.n_half_edges,
                  "generate_s": round(build_s, 3), "steps": r.steps,
                  **{k: getattr(r, k) for k in COUNTS[method][1:]},
                  "tree_depth": depth,
                  "launches": {k: v for k, v in got.items() if v},
                  "timed_by": timing,
                  "e2e_ms_median": statistics.median(kernel_ms),
                  "e2e_ms": kernel_ms,
                  "plain_e2e_ms_median": statistics.median(plain_ms),
                  "plain_e2e_ms": plain_ms,
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "valid": verdict["all_ok"], "card": card})
            if method == "bfs":
                bfs_parent[label] = r.parent
            elif method == "gconn_euler":
                gconn_parent[label] = r.parent
            del r

        # PR-RST's doubling tables: the levels each ancestor_tables call
        # built (one call per round, then the final re-root).
        used = []
        build_tables = reroot.ancestor_tables

        def recording(p, levels):
            out = build_tables(p, levels)
            used.append(out[3])
            return out
        reroot.ancestor_tables = recording
        try:
            rooted_spanning_tree(g, 0, method="pr_rst")
        finally:
            reroot.ancestor_tables = build_tables
        gc_ms = summary[label]["gconn_euler"][0]
        emit({"compare": label, "card": card,
              **{m: {"e2e_ms_median": ms, "tree_depth": depth, "steps": st}
                 for m, (ms, depth, st) in summary[label].items()},
              "bfs/gconn_euler": summary[label]["bfs"][0] / gc_ms,
              "pr_rst/gconn_euler": summary[label]["pr_rst"][0] / gc_ms,
              "pr_rst_table_levels_per_round": used})
    # 5d. Biconnectivity on the small graphs: the table3/smoke_* counts,
    # and the card's result against the port's CPU run.
    for label, g in small:
        for method in METHODS:
            b = biconnectivity(g, 0, rst_flavor=method)
            c = biconnectivity(g, 0, rst_flavor=method, device="cpu")
            counts = (b.n_bcc, int(b.articulation.sum()),
                      int(b.bridge.sum()) // 2, b.aux_rounds, b.seg_syncs)
            check(counts == SMOKE_BCC[label]
                  and b.rst_steps == SMOKE_STEPS[label][method],
                  f"{label} {method}: bcc counts {counts}, steps "
                  f"{b.rst_steps}, want {SMOKE_BCC[label]}")
            for field in BCC_FIELDS:
                check(torch.equal(getattr(b, field).cpu(), getattr(c, field)),
                      f"{label} {method}: bcc {field} differs from the CPU "
                      "run")
            check(all(getattr(b, k) == getattr(c, k) for k in BCC_COUNTS),
                  f"{label} {method}: bcc counts differ from the CPU run")
    emit({"phase": "bcc small graphs", "counts": SMOKE_BCC})

    # 5e. Biconnectivity at full width. BFS on grid2d(4096) (15 s) is not
    # run again: its tree from 5b goes through bcc_from_parent.
    def timed_call(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    for label, g, _ in cases:
        per = {}
        for method in METHODS:
            if method == "bfs" and label == cases[0][0]:
                steps = summary[label]["bfs"][2]

                def run(use_kernel, parent=bfs_parent[label], g=g,
                        steps=steps):
                    return BCCResult(rst_steps=steps, method="bfs",
                                     **bcc_from_parent(g, parent,
                                                       use_kernel=use_kernel))
                entry = "bcc_from_parent(g, bfs parent)"
            else:
                def run(use_kernel, g=g, method=method):
                    return biconnectivity(g, 0, rst_flavor=method,
                                          use_kernel=use_kernel)
                entry = "biconnectivity(g, 0, rst_flavor)"
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            r, first_ms = timed_call(lambda: run(None))
            got = read_counts()
            for name in launches:
                launches[name] += got[name]
            need = ["pointer_jump_double", "list_rank_double", "hook_edges",
                    "segment_table"]
            if entry.startswith("biconnectivity") and method == "bfs":
                need.append("frontier_relax")
            check(got["segment_table"] == r.seg_syncs
                  and all(got[k] > 0 for k in need),
                  f"{label} bcc {method}: launches {got}, seg_syncs "
                  f"{r.seg_syncs}")
            p, plain_first_ms = timed_call(lambda: run(False))
            for field in BCC_FIELDS:
                check(torch.equal(getattr(r, field), getattr(p, field)),
                      f"{label} bcc {method}: {field} differs from the plain "
                      "path")
            check(all(getattr(r, k) == getattr(p, k) for k in BCC_COUNTS),
                  f"{label} bcc {method}: counts differ from the plain path")
            del p
            if first_ms <= SLOW_RUN_MS:
                kernel_ms, plain_ms = [], []
                for i in range(E2E_RUNS):
                    for use_kernel in ((None, False) if i % 2 == 0
                                       else (False, None)):
                        (kernel_ms if use_kernel is None else plain_ms
                         ).append(timed_call(lambda: run(use_kernel))[1])
            else:
                kernel_ms, plain_ms = [first_ms], [plain_first_ms]
            per[method] = dict(
                entry=entry, e2e_ms_median=statistics.median(kernel_ms),
                e2e_ms=kernel_ms,
                plain_e2e_ms_median=statistics.median(plain_ms),
                plain_e2e_ms=plain_ms, n_bcc=r.n_bcc,
                articulation=int(r.articulation.sum()),
                bridges=int(r.bridge.sum()) // 2, rst_steps=r.rst_steps,
                aux_rounds=r.aux_rounds, seg_syncs=r.seg_syncs,
                launches={k: v for k, v in got.items() if v},
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            if method == METHODS[0]:
                first = r
            else:
                check(torch.equal(r.articulation, first.articulation)
                      and torch.equal(r.bridge, first.bridge)
                      and r.n_bcc == first.n_bcc,
                      f"{label} bcc {method}: articulation, bridges or "
                      f"n_bcc differ from {METHODS[0]}")
            del r
        if label == cases[0][0]:
            check(all(v["n_bcc"] == 1 and v["articulation"] == 0
                      and v["bridges"] == 0 for v in per.values()),
                  f"{label}: not one block without cut vertices or bridges")
        # The children-to-parent scatters of the articulation readout, on
        # the gconn_euler tree: a hub's children all land on the hub.
        tn = tour_numbering(gconn_parent[label])
        rep = bcc_from_tour(g, gconn_parent[label], tn)["rep"]
        nonroot = tn.parent != torch.arange(g.n_nodes, device=dev,
                                            dtype=torch.int32)
        hub = int(torch.bincount(tn.parent[nonroot].long()).max())
        art_ms = cuda_ms(torch, lambda: _articulation(tn.parent, rep))
        emit({"bcc": label, "card": card, "n": g.n_nodes,
              "half_edges": g.n_half_edges, **per,
              "articulation_scatter_ms": art_ms, "most_children": hub})
        del first, tn, rep, nonroot
    del bfs_parent

    # 5f. Tree queries on grid2d(4096)'s gconn_euler tree.
    label, g = cases[0][0], grid
    tn = tour_numbering(gconn_parent[label])
    zero_counts()
    tables, build_ms = timed_call(lambda: build_query_tables(tn))
    qgen = torch.Generator(device=dev).manual_seed(13)
    u = torch.randint(0, n, (QUERY_PAIRS,), generator=qgen, device=dev,
                      dtype=torch.int32)
    v = torch.randint(0, n, (QUERY_PAIRS,), generator=qgen, device=dev,
                      dtype=torch.int32)
    pay_f = torch.randn(n, generator=qgen, device=dev)
    pay_i = torch.randint(-100, 100, (n,), generator=qgen, device=dev,
                          dtype=torch.int32)
    batch = {
        "lca": lambda t, a, b, pf, pi: queries.lca(t, a, b),
        "connected": lambda t, a, b, pf, pi: queries.connected(t, a, b),
        "is_ancestor": lambda t, a, b, pf, pi: queries.is_ancestor(t, a, b),
        "depth_of": lambda t, a, b, pf, pi: queries.depth_of(t, a),
        "path_agg_add": lambda t, a, b, pf, pi: queries.path_agg(
            t, a, b, pi, "add"),
        "subtree_agg_min": lambda t, a, b, pf, pi: queries.subtree_agg(
            t, a, pf, "min"),
        "subtree_agg_max": lambda t, a, b, pf, pi: queries.subtree_agg(
            t, a, pf, "max"),
    }
    answers = {k: f(tables, u, v, pay_f, pay_i) for k, f in batch.items()}
    got = read_counts()
    for name in launches:
        launches[name] += got[name]
    check(got["segment_table"] == 2 * (n - 1).bit_length(),
          f"queries: launches {got}")
    for op in ("min", "max"):
        check(torch.equal(answers[f"subtree_agg_{op}"],
                          queries.subtree_agg(tables, u, pay_f, op,
                                              use_kernel=False)),
              f"queries: subtree_agg {op} differs from the plain path")
    w = answers["lca"]
    check(bool(answers["connected"].all() & (w >= 0).all()
               & queries.is_ancestor(tables, w, u).all()
               & queries.is_ancestor(tables, w, v).all()),
          "queries: an lca is not a common ancestor")
    cpu_tables = QueryTables(*(getattr(tables, f.name).cpu()
                               for f in dataclasses.fields(QueryTables)
                               if f.name != "build_syncs"),
                             build_syncs=tables.build_syncs)
    k = CPU_QUERY_PAIRS
    for name, f in batch.items():
        check(torch.equal(answers[name][:k].cpu(),
                          f(cpu_tables, u[:k].cpu(), v[:k].cpu(),
                            pay_f.cpu(), pay_i.cpu())),
              f"queries: {name} differs from the CPU run")
    del cpu_tables
    q_ms = {name: cuda_ms(torch, lambda f=f: f(tables, u, v, pay_f, pay_i))
            for name, f in batch.items()}
    q_plain_ms = {f"subtree_agg_{op}": cuda_ms(
        torch, lambda op=op: queries.subtree_agg(tables, u, pay_f, op,
                                                 use_kernel=False))
        for op in ("min", "max")}
    emit({"queries": label, "card": card, "pairs": QUERY_PAIRS,
          "build_syncs": tables.build_syncs, "levels": tables.levels,
          "build_ms": build_ms, "ms_per_batch": q_ms,
          "plain_ms_per_batch": q_plain_ms,
          "launches": {k: v for k, v in got.items() if v}})
    del tables, tn, u, v, pay_f, pay_i, answers, w

    check(all(v > 0 for v in launches.values()),
          f"a kernel of the paths never launched: {launches}")

    if args.profile_out is not None:
        from torch.profiler import ProfilerActivity, profile
        tables = [card]
        runs = [(label, g, m) for label, g, _ in cases
                for m in ("gconn_euler", "pr_rst")]
        runs.append((cases[1][0], rmat, "bfs"))
        runs += [(label, g, "biconnectivity gconn_euler")
                 for label, g, _ in cases]
        for label, g, method in runs:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                if method.startswith("biconnectivity"):
                    _, wall_ms = timed_call(lambda g=g: biconnectivity(g, 0))
                else:
                    _, wall_ms = timed(g, method, None)
            tables.append(f"{label} {method}, profiled run: {wall_ms:.3f} "
                          "ms wall\n" + prof.key_averages().table(
                              sort_by="cuda_time_total", row_limit=40))
        args.profile_out.parent.mkdir(parents=True, exist_ok=True)
        args.profile_out.write_text("\n\n".join(tables) + "\n")

    # 6. Results.
    kdir = "src/repro_torch/kernels"
    tdir = "src/repro/kernels"
    sources = {
        "pointer_jump_double": (f"{kdir}/pointer_jump/csrc/pointer_jump.cu",
                                f"{tdir}/pointer_jump/pointer_jump.py:45"),
        "list_rank_double": (f"{kdir}/list_rank/csrc/list_rank.cu",
                             f"{tdir}/list_rank/list_rank.py:47"),
        "hook_edges": (f"{kdir}/hook_edges/csrc/hook_edges.cu",
                       f"{tdir}/hook_edges/hook_edges.py:30"),
        "frontier_relax": (f"{kdir}/frontier_relax/csrc/frontier_relax.cu",
                           f"{tdir}/frontier_relax/frontier_relax.py:26"),
        "pointer_jump_k": (f"{kdir}/pointer_jump/csrc/pointer_jump.cu",
                           f"{tdir}/pointer_jump/pointer_jump.py:33"),
        "list_rank_k": (f"{kdir}/list_rank/csrc/list_rank.cu",
                        f"{tdir}/list_rank/list_rank.py:27"),
        "segment_table": (f"{kdir}/segment_table/csrc/segment_table.cu",
                          f"{tdir}/segment_table/segment_table.py:37"),
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
