#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--profile-out FILE]

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit (``nvidia-smi``);
  2. build every CUDA kernel from the repository's sources;
  3. kernels: each of the nine against its plain PyTorch version on the
     card, at the main paths' sizes, timed with CUDA events (every row but
     the BFS level queued behind a sleep on the card, in turns with its
     plain version, so the events time the card alone): the eight
     graph kernels bit-equal (segment_table: min and max, int32 at 2^24 and
     2^20, also against its previous design, one launch a level, timed in
     turns with it, and float32 at an odd n with one NaN; bfs_level, one
     BFS level with the parent scatter-min fused, at a mid-BFS state of
     both large graphs, dist, parent and flag, timed in turns with its plain
     version and with the previous level, the mask kernel and the plain
     scatter-min); embed_bag at DIEN's serve_bulk
     user profile in float32 and bf16 and at the item table's size, within
     1e-6 (float32) and 2e-2 (bf16) of the plain version and
     ``F.embedding_bag`` and bit-equal to its previous design
     (``embed_bag_previous``), timed in turns with all three, also at
     train_batch's 65,536 bags, serve_p99's 512 and retrieval's 1; the two
     doubling kernels (one cooperative launch a call, their convergence
     flags fused) also against their previous design, one launch a step
     (the ``*_stepwise`` entries), flags included, timed in turns at a
     2^24 random forest and chain, at the first table ``compress_full``
     receives in ``connected_components`` on both large graphs, and at
     both graphs' Euler lists; the two chain kernels (one cooperative
     launch a call, the hops composed from squarings) also against their
     previous design, one thread an element (the ``*_chain_previous``
     entries), timed in turns at a 2^24 random forest, chain and random
     function, at k = 5 and k = 31;
  4. the engine's sync contract on a 2^24-long chain;
  5. the paths, each driven through its entry point with the launch
     counts set to 0 just before and read just after (the doubling
     kernels launch once per sync, and no path launches a stepwise entry):
     a. the chain kernels' own entry points, ``ops.pointer_jump_k`` and
        ``ops.list_rank_k``, as the reference's kernel benchmark rows
        call them, at 2^24 elements, and the mask kernel's,
        ``ops.frontier_relax``, at grid2d(4096)'s mid-BFS state (the BFS
        path runs ``bfs_level`` instead);
     b. ``rooted_spanning_tree(g, 0, method=m)`` for the three methods
        ``gconn_euler``, ``bfs`` and ``pr_rst``: first on ``chain(256)`` and
        ``rmat(6, edge_factor=4)`` (the step counts of the table1/smoke_*
        rows, the same tree as the port's run on the CPU, a valid tree,
        and for gconn_euler the union-find oracle's components); then on
        ``grid2d(4096)`` (16.8M vertices, road-network regime) and
        ``rmat(20, edge_factor=16)`` (kron_g500-logn20 analogue) with the
        default device and kernels: trees validated, every output and
        count bit-equal to the same call with ``use_kernel=False``,
        launches matched to the syncs (bfs: one ``bfs_level`` a level),
        end-to-end times (gconn_euler and pr_rst also with the engine on
        the stepwise doubling kernels, bfs also on the previous level, in
        turns; a variant whose first run takes over 2 s is timed by that
        run), and one line per graph comparing the three methods (the
        paper's Fig. 1 and Fig. 2);
     c. ``biconnectivity(g, 0, rst_flavor=m)`` on ``chain(256)`` and
        ``rmat(6, edge_factor=4)`` for the three flavors: the table3/smoke_*
        counts and the same result as the port's CPU run;
     d. biconnectivity on the two large graphs for the three flavors (bfs
        on ``grid2d(4096)`` through ``bcc_from_parent`` on the paths
        phase's BFS tree): every field and count bit-equal to
        ``use_kernel=False``, segment_table launches equal to its calls
        (``seg_syncs`` / levels) times the launches a call,
        grid2d(4096)'s known answer (one block, no articulation point, no
        bridge), the same articulation points, bridges and block count from
        every flavor, end-to-end times (also with the engine on the
        stepwise doubling kernels and on the previous segment_table, in
        turns), the articulation scatter's time, and one line per graph;
     e. tree queries on ``grid2d(4096)``'s gconn_euler tree:
        ``build_tables``, then one batch of 2^20 seeded random pairs through
        ``lca``, ``connected``, ``is_ancestor``, ``depth_of``,
        ``path_agg("add")`` and ``subtree_agg("min"/"max")`` (the last two
        through segment_table), held against the plain path and, on the
        first 4096 pairs, against the port's CPU run; ms per batch;
     g. DIEN serving at the full config (embed 18, T 100, GRU 108, MLP
        200-80, 10^6 items), the graphs freed first, through
        ``build_cell`` for ``serve_p99`` (512 rows), ``serve_bulk``
        (262,144 rows) and ``retrieval_cand`` (one user against 1,000,448
        candidates): one embed_bag launch a call, the scores within 1e-6 of
        ``use_kernel=False``, finite (serve: in [0, 1]; retrieval returns
        logits, 1,007,616 of them with the padding), the first 64 within
        1e-6 of the port's CPU run (and what TF32 matmuls would give
        there), the median of 5 interleaved runs, rows or candidates a
        second, peak memory, one line per shape;
     h. DIEN training at the full config, after the serving cells are
        freed, through ``build_cell`` for ``train_batch`` (65,536 rows a
        step) and a plain twin (``use_kernel=False``) from the same seed-0
        parameters and the same synthetic batches: one step's loss and
        every gradient on the first 256 rows within 1e-6 of the port's CPU
        run; 3 checked steps, each with one embed_bag launch (none on the
        plain twin), a finite loss and grad_norm within 1e-6 of the plain
        twin's, and the parameters and AdamW moments after them within
        1e-6; each gradient, grad_norm, m, v and parameter change also
        within 1e-5 of its own largest value (and what TF32 matmuls would
        give the gradients); then the median of 5 further steps in turns with the plain
        twin, rows a second, peak memory and the time of embed_bag's
        backward at the step's shape on the card alone, one line;
  6. one JSON line listing the kernels, then the result line
     ``{"ok": true, "device": {...}}`` as the last line.

``--profile-out`` also writes ``torch.profiler`` tables to FILE: one
gconn_euler and one pr_rst run per graph, one bfs run on
``rmat(20, edge_factor=16)`` and its first 64 levels on ``grid2d(4096)``,
one gconn_euler ``biconnectivity`` per
graph, one DIEN forward at ``serve_p99`` and at ``serve_bulk``, and one DIEN
training step at ``train_batch``.
Without a CUDA card, or outside the repository, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
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
# The chain kernels' second count: 31 hops of a chain, five squarings.
CHAIN_LONG = 31
TIMED_RUNS = 7
# A sleep on the card of about 1 ms at the H100's clock, longer than the
# host takes to enqueue one call of a doubling kernel.
QUEUE_CYCLES = 2_000_000
E2E_RUNS = 5
# An end-to-end variant whose first run takes longer than this is timed by
# that run alone.
SLOW_RUN_MS = 2000.0
# BFS levels of grid2d(4096) in the profile.
PROFILE_GRID_LEVELS = 64
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
# DIEN's serving shapes (repro_torch.configs.RECSYS_SHAPES, full config).
DIEN_SHAPES = ("serve_p99", "serve_bulk", "retrieval_cand")
DIEN_RETRIEVAL_SCORES = 1_007_616   # 1,000,448 candidates in blocks of 8192
DIEN_CPU_ROWS = 64
# Float tolerances (abs and rel): the reference's own for embed_bag
# (tests/test_kernels.py); kernel and plain DIEN differ only in embed_bag's
# sum order; the card against the CPU differs in every matmul's, and was
# measured at one ulp of a 0.5 score (6e-8), so 1e-6 leaves room for that
# and not for a matmul run at lower precision (the TF32 line shows it).
EMBED_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
DIEN_KERNEL_TOL = 1e-6
DIEN_CPU_TOL = 1e-6
# DIEN training (train_batch): the steps checked against the plain twin,
# and the rows of the one step held against the port's CPU run. Kernel and
# plain run the same forward (embed_bag bit-equal) and the same backward,
# whose scatter-adds (index_add_, the gathers' index_put_) sum in an order
# the card does not fix: measured 0 on loss and grad_norm and 7.5e-9 on
# the parameters after 3 steps, held to 1e-6 as serving is. The card
# against the CPU differs in every matmul's and reduction's order through
# 100 + 100 recurrent steps and their backward: measured 6.0e-8 on the
# loss (one ulp of 0.69) and 1.9e-9 on the gradients, held to 1e-6 as
# serving is, which leaves room for that and not for TF32 matmuls (1.8e-6
# on serve_p99's scores).
# Most leaves lie wholly below 1e-6 (grad_norm is 0.003 over 20.3M values,
# v is about 0.05 g^2), so each gradient, m, v and grad_norm is also held
# to its own scale: max |got - want| <= DIEN_TRAIN_SCALED_TOL * max |want|.
# The parameters' change over the 3 steps (lr 0, 2e-6, 4e-6) is a
# difference of two rounded parameters, so its limit adds two float32 ulps
# of the leaf's largest entry. Measured: the card against the CPU at most
# 9.7e-7 of a gradient's scale (gru1.bz), kernel against plain 1.2e-7 (v)
# and a parameter off by one ulp (7.5e-9), which the two ulps cover; the
# same gradients with TF32 matmuls 2.7e-4 (mlp.2.0) and 1.5e-2 to 0.13 on
# the other leaves with a matmul (the TF32 line). 1e-5 sits 10x above the
# first and well below the second.
TRAIN_STEPS = 3
TRAIN_CPU_ROWS = 256
DIEN_TRAIN_TOL = 1e-6
DIEN_TRAIN_CPU_TOL = 1e-6
DIEN_TRAIN_SCALED_TOL = 1e-5


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


def cuda_ms_turns(torch, fns: dict, reps: int = TIMED_RUNS) -> dict:
    """Median CUDA-event timing of each of ``fns``, timed in turns (the
    order reversed every other round) after two warm-ups of each. Each
    timed call is queued behind a sleep on the card, so the host has
    enqueued all of its work before the start event runs: the events time
    the card, not the host's launch path (which dominates at 2^20). The
    functions must not synchronise."""
    for fn in fns.values():
        fn()
        fn()
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(reps):
        for name in (order if r % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(QUEUE_CYCLES)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def cuda_ms_fresh(torch, fns: dict, fresh, reps: int = TIMED_RUNS) -> dict:
    """Median CUDA-event timing of each of ``fns``, timed in turns (the
    order reversed every other round) after two warm-ups of each; every
    call gets a state of its own, ``fresh()``, made before its window.
    For calls that end in a host read (a BFS level): the window holds the
    host's launches and its read, as a BFS pays them, so no sleep is
    queued in front."""
    for fn in fns.values():
        fn(fresh())
        fn(fresh())
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(reps):
        for name in (order if r % 2 == 0 else order[::-1]):
            state = fresh()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fns[name](state)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


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


def allclose_err(torch, got, want, tol: float, what: str) -> float:
    """Max abs difference of two float tensors, held to
    |got - want| <= tol + tol * |want| everywhere (fails otherwise)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    check(bool((diff <= tol + tol * want.abs()).all()),
          f"{what}: differs by up to {float(diff.max())} (tolerance {tol})")
    return float(diff.max()) if diff.numel() else 0.0


def scaled_err(torch, got, want, tol: float, what: str,
               floor: float = 0.0) -> float:
    """(max |got - want| - floor) over max |want| for a whole tensor, held
    to max |got - want| <= tol * max |want| + floor (fails otherwise): a
    limit set by the tensor's own scale, for one whose entries all lie far
    below an absolute tolerance."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    diff = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    check(scale > 0, f"{what}: the reference is all zero")
    check(diff <= tol * scale + floor,
          f"{what}: differs by up to {diff} against {tol} * {scale} "
          f"+ {floor}")
    return max(diff - floor, 0.0) / scale


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
    from repro_torch.core import bfs as bfs_module
    from repro_torch.kernels.frontier_relax.ops import (bfs_level,
                                                        bfs_level_buffer,
                                                        frontier_relax)
    from repro_torch.kernels.frontier_relax.ref import (INF32, bfs_level_ref,
                                                        level_constants)
    from repro_torch.kernels.hook_edges.ops import hook_edges
    from repro_torch.core import compress, connectivity
    from repro_torch.kernels.hops import gathers, hop_schedule
    from repro_torch.kernels.list_rank.ops import (list_rank_chain_previous,
                                                   list_rank_double_k,
                                                   list_rank_double_stepwise,
                                                   list_rank_k)
    from repro_torch.kernels.pointer_jump.ops import (
        pointer_jump_chain_previous, pointer_jump_double_k,
        pointer_jump_double_stepwise, pointer_jump_k)
    from repro_torch.kernels.segment_table.ops import (
        launches_per_call, segment_table, segment_table_stepwise)
    from repro_torch.kernels.embed_bag.ops import (embed_bag,
                                                   embed_bag_backward,
                                                   embed_bag_previous)
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models.dien import dien_loss, params_from_reference
    from repro_torch.train.step import build_cell

    counters = {"pointer_jump_double": pointer_jump_double_k,
                "list_rank_double": list_rank_double_k,
                "hook_edges": hook_edges, "frontier_relax": frontier_relax,
                "bfs_level": bfs_level,
                "pointer_jump_k": pointer_jump_k, "list_rank_k": list_rank_k,
                "segment_table": segment_table, "embed_bag": embed_bag}
    # The previous designs of the two doubling kernels, the two chain
    # kernels, segment_table and embed_bag: timed in phase 3, and no path
    # may launch them.
    yardsticks = (pointer_jump_double_stepwise, list_rank_double_stepwise,
                  pointer_jump_chain_previous, list_rank_chain_previous,
                  segment_table_stepwise, embed_bag_previous)
    # One graph's constants of the previous level, built once, as its loop
    # hoisted them.
    old_consts = {}

    def old_level(dist, parent, cand, src, dst, level, *, consts=None,
                  use_kernel=None):
        """The previous BFS level on the card: the mask kernel, then the
        plain scatter-min and updates (``bfs_level_ref``'s glue)."""
        key = (src.data_ptr(), dst.data_ptr(), dist.numel())
        if key not in old_consts:
            old_consts.clear()
            old_consts[key] = level_constants(src, dst, dist.numel())
        return bfs_level_ref(dist, parent, src, dst, level,
                             active=frontier_relax(dist, src, dst, level,
                                                   use_kernel=True),
                             consts=old_consts[key])

    def on_old_level(fn):
        """``fn()`` with the BFS on the previous level, for an end-to-end
        comparison in the same run; never inside a counted run."""
        real = bfs_module.bfs_level
        bfs_module.bfs_level = old_level
        try:
            return fn()
        finally:
            bfs_module.bfs_level = real

    def on_segment_stepwise(fn):
        """``fn()`` with ``segment_reduce`` on the previous segment_table
        design (one launch a level); never inside a counted run."""
        real = compress.segment_table
        compress.segment_table = (
            lambda values, *, levels, op, use_kernel:
            segment_table_stepwise(values, levels=levels, op=op))
        try:
            return fn()
        finally:
            compress.segment_table = real

    def on_stepwise(fn):
        """``fn()`` with the engine on the previous design of the doubling
        kernels (one launch a step and a ``torch.any`` pass a group), for an
        end-to-end comparison in the same run; never inside a counted run."""
        real = compress.pointer_jump_double_k, compress.list_rank_double_k
        compress.pointer_jump_double_k = (
            lambda p, *, n_jumps, use_kernel, return_changed:
            pointer_jump_double_stepwise(p, n_jumps=n_jumps,
                                         return_changed=return_changed))
        compress.list_rank_double_k = (
            lambda s, d, *, n_steps, use_kernel, return_open:
            list_rank_double_stepwise(s, d, n_steps=n_steps,
                                      return_open=return_open))
        try:
            return fn()
        finally:
            compress.pointer_jump_double_k, compress.list_rank_double_k = real

    def time_variants(runs: dict, firsts: dict) -> dict:
        """Timings (ms lists) of each of ``runs`` (functions returning ms):
        one whose first run (``firsts``) took over SLOW_RUN_MS keeps that
        run alone; the rest run E2E_RUNS times in turns, the order reversed
        every other round."""
        fast = [name for name in runs if firsts[name] <= SLOW_RUN_MS]
        times = {name: [] for name in fast}
        for i in range(E2E_RUNS if fast else 0):
            for name in (fast if i % 2 == 0 else fast[::-1]):
                times[name].append(runs[name]())
        return {name: times.get(name, [firsts[name]]) for name in runs}

    def e2e_fields(times: dict) -> dict:
        """The emitted end-to-end times: ``e2e_ms`` for the kernel path,
        ``<variant>_e2e_ms`` for the others, each with its median and its
        number of runs."""
        out = {"runs": {name: len(t) for name, t in times.items()}}
        for name, t in times.items():
            key = "e2e_ms" if name == "kernel" else f"{name}_e2e_ms"
            out[f"{key}_median"] = statistics.median(t)
            out[key] = t
        return out

    def zero_counts():
        torch.cuda.synchronize()
        for c in (*counters.values(), *yardsticks):
            c.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        check(all(c.launches == 0 for c in yardsticks),
              "a path launched a previous design (a yardstick)")
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

    t0 = time.perf_counter()
    grid = graphs.grid2d(GRID_SIDE, device=dev)
    grid_build_s = time.perf_counter() - t0
    n = grid.n_nodes
    t0 = time.perf_counter()
    rmat = graphs.rmat(RMAT_SCALE, edge_factor=16, device=dev)
    rmat_build_s = time.perf_counter() - t0

    def first_compress_input(g):
        """The table ``compress_full`` first receives in
        ``connected_components(g)`` (after the first hook round), and the
        call's ``(rep, forest_mask)``."""
        seen = []
        real = connectivity.compress_full

        def recording(p, **kwargs):
            if not seen:
                seen.append(p.clone())
            return real(p, **kwargs)
        connectivity.compress_full = recording
        try:
            rep, forest_mask, _ = connected_components(g, use_kernel=False)
        finally:
            connectivity.compress_full = real
        return seen[0], rep, forest_mask

    def euler_list(g, rep, forest_mask):
        """The Euler successor list ``wyllie_rank`` first ranks in
        ``euler_tour_root`` (rooted at 0), and its initial distances."""
        fu, fv, valid = forest_edges(g, forest_mask)
        comp_root = torch.where(rep == rep[0], 0, rep)
        succ, dvalid = _tour_successors(g.n_nodes, fu, fv, valid, comp_root)
        return succ, (dvalid & (succ != -1)).to(torch.int32)

    pj_inputs = {"forest": forest, "chain": chain}
    lr_inputs = {}
    for label, g in (("grid", grid), ("rmat", rmat)):
        first, rep, forest_mask = first_compress_input(g)
        pj_inputs[f"{label}_first_compress"] = first
        lr_inputs[f"{label}_euler"] = euler_list(g, rep, forest_mask)
    del first, rep, forest_mask

    # The two doubling kernels (rows 1 and 2): the cooperative kernel as the
    # engine calls it (with its fused flag), the stepwise design with the
    # flag as a separate pass (the engine's previous group), the stepwise
    # design alone (the previous row's measure), and the plain version with
    # its flag, bit-equal, flags equal, timed in turns.
    pj, err = {}, 0
    for label, table in pj_inputs.items():
        fns = {
            "kernel": lambda t=table: pointer_jump_double_k(
                t, n_jumps=N_JUMPS, use_kernel=True, return_changed=True),
            "stepwise": lambda t=table: pointer_jump_double_stepwise(
                t, n_jumps=N_JUMPS, return_changed=True),
            "plain": lambda t=table: pointer_jump_double_k(
                t, n_jumps=N_JUMPS, use_kernel=False, return_changed=True)}
        outs = {k: f() for k, f in fns.items()}
        for k in ("kernel", "stepwise"):
            err = max(err, max_abs_err(torch, outs[k][0], outs["plain"][0]))
            check(bool(outs[k][1]) == bool(outs["plain"][1]),
                  f"pointer_jump_double {label}: the {k} flag differs from "
                  "the plain version's")
        ms = cuda_ms_turns(torch, {
            **fns, "stepwise_no_flag": lambda t=table:
                pointer_jump_double_stepwise(t, n_jumps=N_JUMPS),
            "library_one_step": lambda t=table: t[t]})
        size = table.numel()
        pj[label] = {"n": size, "changed": bool(outs["kernel"][1]),
                     **{f"{k}_ms": v for k, v in ms.items()},
                     "bound_ms": bound(8 * size, N_JUMPS * size)[0]}
    check(err == 0, f"pointer_jump_double differs from plain by {err}")
    b_ms, b_by = bound(8 * n_tab, N_JUMPS * n_tab)
    rows["pointer_jump_double"] = dict(
        ms=pj["forest"]["kernel_ms"], plain_ms=pj["forest"]["plain_ms"],
        library_ms=pj["forest"]["library_one_step_ms"], bound_ms=b_ms,
        bound_by=b_by, max_abs_err=err)
    emit({"kernel": "pointer_jump_double", "n": n_tab, "n_jumps": N_JUMPS,
          "card": card, "coop_blocks": build.cooperative_blocks(
              "pointer_jump", "pointer_jump_double_blocks", chain.device,
              n_tab),
          "input": "relabelled random forest; also the 2^24 chain and the "
                   "first compress_full table of connected_components on "
                   "grid2d(4096) and rmat(20, 16)",
          **kernel_line(rows["pointer_jump_double"]), "inputs": pj})
    del pj_inputs

    lr, err = {}, 0
    for label, (succ, dist) in lr_inputs.items():
        fns = {
            "kernel": lambda s=succ, d=dist: list_rank_double_k(
                s, d, n_steps=N_JUMPS, use_kernel=True, return_open=True),
            "stepwise": lambda s=succ, d=dist: list_rank_double_stepwise(
                s, d, n_steps=N_JUMPS, return_open=True),
            "plain": lambda s=succ, d=dist: list_rank_double_k(
                s, d, n_steps=N_JUMPS, use_kernel=False, return_open=True)}
        outs = {k: f() for k, f in fns.items()}
        for k in ("kernel", "stepwise"):
            err = max(err, max_abs_err(torch, outs[k][0], outs["plain"][0]),
                      max_abs_err(torch, outs[k][1], outs["plain"][1]))
            check(bool(outs[k][2]) == bool(outs["plain"][2]),
                  f"list_rank_double {label}: the {k} flag differs from "
                  "the plain version's")
        ms = cuda_ms_turns(torch, {
            **fns, "stepwise_no_flag": lambda s=succ, d=dist:
                list_rank_double_stepwise(s, d, n_steps=N_JUMPS)})
        size = succ.numel()
        lr[label] = {"n": size, "open": bool(outs["kernel"][2]),
                     **{f"{k}_ms": v for k, v in ms.items()},
                     "bound_ms": bound(16 * size, 3 * N_JUMPS * size)[0]}
    check(err == 0, f"list_rank_double differs from plain by {err}")
    n_list = lr_inputs["grid_euler"][0].numel()
    b_ms, b_by = bound(16 * n_list, 3 * N_JUMPS * n_list)
    rows["list_rank_double"] = dict(
        ms=lr["grid_euler"]["kernel_ms"], plain_ms=lr["grid_euler"]["plain_ms"],
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    emit({"kernel": "list_rank_double", "n": n_list, "n_steps": N_JUMPS,
          "card": card, "coop_blocks": build.cooperative_blocks(
              "list_rank", "list_rank_double_blocks", chain.device, n_list),
          "input": "Euler successor list of grid2d(4096); also rmat(20, 16)'s",
          **kernel_line(rows["list_rank_double"]), "inputs": lr})
    del lr_inputs, succ, dist, outs, fns

    # The chain variants (rows 5 and 6): pointer_jump_k follows each of
    # the 2^24 forest, the chain and a random function; list_rank_k ranks
    # it as a successor table whose roots end their lists. At k = 5 and
    # k = 31, the kernel (squarings in one cooperative launch), its previous
    # design (one thread an element following the table) and the plain
    # version, bit-equal, timed in turns behind a sleep. ``sectors``: the
    # random 32-byte sectors an element's gathers fetch (one a gather;
    # the previous list ranking fetched two a step, from its two int32
    # tables).
    chain_inputs = {"forest": forest, "chain": chain,
                    "function": torch.randint(0, n_tab, (n_tab,),
                                              generator=gen, device=dev,
                                              dtype=torch.int32)}
    pjk, lrk, err_pjk, err_lrk = {}, {}, 0, 0
    for (label, table), k in itertools.product(chain_inputs.items(),
                                               (N_JUMPS, CHAIN_LONG)):
        case = f"{label}_k{k}"
        pj_fns = {
            "kernel": lambda t=table, k=k: pointer_jump_k(
                t, n_jumps=k, use_kernel=True),
            "previous": lambda t=table, k=k: pointer_jump_chain_previous(
                t, n_jumps=k),
            "plain": lambda t=table, k=k: pointer_jump_k(
                t, n_jumps=k, use_kernel=False)}
        outs = {name: f() for name, f in pj_fns.items()}
        for name in ("kernel", "previous"):
            err_pjk = max(err_pjk, max_abs_err(torch, outs[name],
                                               outs["plain"]))
        plan = hop_schedule(k)
        pjk[case] = {**{f"{name}_ms": v for name, v in
                        cuda_ms_turns(torch, pj_fns).items()},
                     "passes": len(plan), "sectors": gathers(plan),
                     "previous_sectors": k}
        succ = torch.where(table == ids, -1, table)
        dist = (succ != -1).to(torch.int32)
        lr_fns = {
            "kernel": lambda s=succ, d=dist, k=k: list_rank_k(
                s, d, n_steps=k, use_kernel=True),
            "previous": lambda s=succ, d=dist, k=k: list_rank_chain_previous(
                s, d, n_steps=k),
            "plain": lambda s=succ, d=dist, k=k: list_rank_k(
                s, d, n_steps=k, use_kernel=False)}
        outs = {name: f() for name, f in lr_fns.items()}
        plan = hop_schedule(k, pack_input=True)
        for name in ("kernel", "previous"):
            err_lrk = max(err_lrk,
                          max_abs_err(torch, outs[name][0], outs["plain"][0]),
                          max_abs_err(torch, outs[name][1], outs["plain"][1]))
        lrk[case] = {**{f"{name}_ms": v for name, v in
                        cuda_ms_turns(torch, lr_fns).items()},
                     "passes": len(plan), "sectors": gathers(plan),
                     "previous_sectors": 2 * k}
    check(err_pjk == 0, f"pointer_jump_k differs from plain by {err_pjk}")
    check(err_lrk == 0, f"list_rank_k differs from plain by {err_lrk}")
    for name, res, err, nbytes, ops, lib, symbol in (
            ("pointer_jump_k", pjk, err_pjk, 8 * n_tab, N_JUMPS * n_tab,
             "pointer_jump", "pointer_jump_chain_blocks"),
            ("list_rank_k", lrk, err_lrk, 16 * n_tab, 3 * N_JUMPS * n_tab,
             "list_rank", "list_rank_chain_blocks")):
        b_ms, b_by = bound(nbytes, ops)
        forest_k = res[f"forest_k{N_JUMPS}"]
        rows[name] = dict(ms=forest_k["kernel_ms"],
                          plain_ms=forest_k["plain_ms"], library_ms=None,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        emit({"kernel": name, "n": n_tab, "n_steps": N_JUMPS, "card": card,
              "coop_blocks": build.cooperative_blocks(lib, symbol,
                                                      chain.device, n_tab),
              "input": "relabelled random forest at k = 5 (<input>_k<k>: "
                       "also the 2^24 chain and a random function, and k = "
                       f"{CHAIN_LONG}); previous: the previous design",
              **kernel_line(rows[name]),
              "previous_ms": forest_k["previous_ms"],
              "sector_bound_ms": bound(
                  nbytes + 32 * forest_k["sectors"] * n_tab, 0)[0],
              **{f"{case}_{k}": v for case in res
                 for k, v in res[case].items()}})
    del below, perm, succ, dist, outs, pj_fns, lr_fns, chain_inputs

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
    ms = cuda_ms_turns(torch, {
        "kernel": lambda: hook_edges(grid.src, grid.dst, rand_rep, True,
                                     n_nodes=n, use_kernel=True),
        "plain": lambda: hook_edges(grid.src, grid.dst, rand_rep, True,
                                    n_nodes=n, use_kernel=False)})
    rows["hook_edges"] = dict(
        ms=ms["kernel"], plain_ms=ms["plain"], library_ms=None,
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    emit({"kernel": "hook_edges", "n_half_edges": e, "n_nodes": n,
          "input": "grid2d(4096) edges, random rep",
          **kernel_line(rows["hook_edges"])})
    del rand_rep, got, want

    # frontier_relax at a mid-BFS state. On grid2d(4096) from corner 0 the
    # BFS distance is row + col, so level L's state is every vertex with
    # row + col <= L set and the rest INF32. On rmat(20, 16), the state
    # after two BFS levels of the plain path.
    level = GRID_SIDE - 1
    verts = torch.arange(n, dtype=torch.int32, device=dev)
    manhattan = verts // GRID_SIDE + verts % GRID_SIDE
    grid_dist = torch.where(manhattan <= level, manhattan, INF32)
    rmat_parent, rmat_dist, rmat_level = bfs_rst(rmat, 0, max_levels=2,
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
        ms = cuda_ms_turns(torch, {"kernel": lambda: run(True),
                                   "plain": lambda: run(False)})
        fr[label] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
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
    del got, want

    # bfs_level at the same two states (the grid's parents by its closed
    # form: the vertex above, else the one to the left), against its plain
    # version and the previous level (the mask kernel and the plain
    # scatter-min), each on a fresh copy of the state: dist, parent and the
    # flag bit-equal, timed in turns. Bound: the bytes this state needs (src
    # whole, dst of the frontier's edges, dist once, cand of the
    # undiscovered, the discovered's dist, parent and cand written); the
    # 8E + 12n of reading every input once is given beside it.
    grid_parent = torch.where(
        manhattan <= level,
        torch.where(verts >= GRID_SIDE, verts - GRID_SIDE, verts - 1), -1)
    grid_parent[0] = 0
    bl, err = {}, 0
    for label, g, d, par, lvl in (
            ("grid", grid, grid_dist, grid_parent, level),
            ("rmat", rmat, rmat_dist, rmat_parent, rmat_level)):
        def fresh(d=d, par=par, n_g=g.n_nodes):
            return d.clone(), par.clone(), bfs_level_buffer(n_g, dev)
        consts = level_constants(g.src, g.dst, g.n_nodes)
        fns = {
            "kernel": lambda st, g=g, lvl=lvl: bfs_level(
                *st, g.src, g.dst, lvl, use_kernel=True),
            "plain": lambda st, g=g, lvl=lvl, c=consts: bfs_level(
                *st, g.src, g.dst, lvl, consts=c, use_kernel=False),
            "old_level": lambda st, g=g, lvl=lvl: old_level(
                *st, g.src, g.dst, lvl)}
        outs = {}
        for name, fn in fns.items():
            st = fresh()
            outs[name] = (st[0], st[1], fn(st))
        for name in ("kernel", "old_level"):
            err = max(err, max_abs_err(torch, outs[name][0], outs["plain"][0]),
                      max_abs_err(torch, outs[name][1], outs["plain"][1]))
            check(outs[name][2] == outs["plain"][2],
                  f"bfs_level {label}: the {name} flag differs from the "
                  "plain version's")
        check(outs["kernel"][2], f"bfs_level {label}: nothing discovered")
        ms = cuda_ms_fresh(torch, fns, fresh)
        e_g, n_g = g.n_half_edges, g.n_nodes
        frontier = int((d[g.src] == lvl).sum())
        undiscovered = int((d == INF32).sum())
        discovered = int((outs["kernel"][0] == lvl + 1).sum())
        b_ms, b_by = bound(4 * e_g + 4 * frontier + 4 * n_g
                           + 4 * undiscovered + 12 * discovered, 3 * e_g)
        bl[label] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                         old_level_ms=ms["old_level"], library_ms=None,
                         bound_ms=b_ms, bound_by=b_by,
                         bound_8e_12n_ms=bound(8 * e_g + 12 * n_g, 0)[0],
                         level=int(lvl), frontier_edges=frontier,
                         undiscovered=undiscovered, discovered=discovered)
        del outs, st, consts, fns
    check(err == 0, f"bfs_level differs from plain by {err}")
    rows["bfs_level"] = {**{k: bl["grid"][k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "max_abs_err": err}
    emit({"kernel": "bfs_level", "n_half_edges": e, "n_nodes": n,
          "card": card,
          "input": "grid2d(4096) at BFS level 4095 from vertex 0 (rmat_*: "
                   "rmat(20, 16) after 2 levels); a fresh state a call, the "
                   "flag's host read included; plain and old_level (the "
                   "mask kernel and the plain scatter-min) on graph "
                   "constants built once",
          **kernel_line(rows["bfs_level"]),
          **{k: v for k, v in bl["grid"].items()
             if k not in rows["bfs_level"]},
          **{f"rmat_{k}": v for k, v in kernel_line(bl["rmat"]).items()}})
    del verts, manhattan, grid_dist, grid_parent, rmat_dist, rmat_parent

    # segment_table at the BCC path's shapes: int32 at grid2d(4096)'s n
    # (2^24, 24 levels) and rmat(20, 16)'s (2^20, 20 levels), min and max,
    # against the plain version and the previous design (one launch a
    # level), timed in turns with both behind a sleep; and float32 at an odd
    # n with one NaN, which must propagate.
    st = {}
    err = 0
    for label, size in (("grid", n), ("rmat", rmat.n_nodes)):
        vals = torch.randint(-2**31, 2**31 - 1, (size,), generator=gen,
                             device=dev, dtype=torch.int32)
        lv = (size - 1).bit_length()
        for op in ("min", "max"):
            want = segment_table(vals, levels=lv, op=op, use_kernel=False)
            err = max(err, max_abs_err(
                torch, segment_table(vals, levels=lv, op=op, use_kernel=True),
                want), max_abs_err(torch, segment_table_stepwise(
                    vals, levels=lv, op=op), want))
        ms = cuda_ms_turns(torch, {
            "kernel": lambda v=vals, lv=lv: segment_table(
                v, levels=lv, op="min", use_kernel=True),
            "stepwise": lambda v=vals, lv=lv: segment_table_stepwise(
                v, levels=lv, op="min"),
            "plain": lambda v=vals, lv=lv: segment_table(
                v, levels=lv, op="min", use_kernel=False)})
        st[label] = dict(
            ms=ms["kernel"], plain_ms=ms["plain"],
            stepwise_ms=ms["stepwise"], library_ms=None,
            **dict(zip(("bound_ms", "bound_by"),
                       bound(4 * size * (lv + 2), lv * size))),
            launches_per_call=launches_per_call(size, lv))
    n_odd = (1 << 20) + 1
    fvals = torch.randn(n_odd, generator=gen, device=dev)
    fvals[n_odd // 3] = float("nan")
    lv = (n_odd - 1).bit_length()
    for op in ("min", "max"):
        want = segment_table(fvals, levels=lv, op=op, use_kernel=False)
        nan = want.isnan()
        for name, got in (
                ("kernel", segment_table(fvals, levels=lv, op=op,
                                         use_kernel=True)),
                ("stepwise", segment_table_stepwise(fvals, levels=lv,
                                                    op=op))):
            check(torch.equal(got.isnan(), nan) and int(nan.sum()) > 0,
                  f"segment_table float32 {op}: the {name}'s NaN not where "
                  "the plain version has it")
            check(torch.equal(got[~nan].view(torch.int32),
                              want[~nan].view(torch.int32)),
                  f"segment_table float32 {op}: the {name} differs from "
                  "plain")
    check(err == 0, f"segment_table differs from plain by {err}")
    rows["segment_table"] = {**{k: st["grid"][k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "max_abs_err": err}
    emit({"kernel": "segment_table", "n": n, "levels": (n - 1).bit_length(),
          "card": card,
          "input": "random int32 at grid2d(4096)'s n, op min (rmat_*: "
                   "rmat(20, 16)'s n); stepwise: the previous design; "
                   "float32 with one NaN at n = 2^20 + 1 checked, min and "
                   "max",
          **kernel_line(rows["segment_table"]),
          **{k: v for k, v in st["grid"].items()
             if k not in rows["segment_table"]},
          **{f"rmat_{k}": v for k, v in kernel_line(st["rmat"]).items()}})
    del vals, fvals, got, want, nan

    # embed_bag at DIEN's shapes: the user profile of serve_bulk (262,144
    # bags of 8 from the 100,000 x 18 user table, 7.2 MB, which L2 holds)
    # in float32 and bf16, and the same bags from a table of the item
    # table's size (1,000,000 x 18, 72 MB, which it does not). DIEN calls
    # it with mean and no weights (the timed call); the weighted sum and
    # mean are checked too, every result bit-equal to the previous kernel.
    # Timed in turns behind a sleep: the kernel, the previous kernel, the
    # plain version and F.embedding_bag (its int64 ids made outside the
    # window); also at serve_p99's 512 bags and retrieval's 1 bag of the
    # user table, where the launch sets the time. Byte bound: idx and out,
    # and each distinct row gathered, once. Beside it the sector bound:
    # idx and out, and the 32-byte sectors every gathered row spans (3 a
    # float32 row of 18), all at the HBM rate (the user table's sectors
    # come from L2).
    spec = get_arch("dien")
    cfg = spec.make_config()
    bags, hot, dim = (spec.shapes["serve_bulk"]["batch"], cfg.user_hot,
                      cfg.embed_dim)
    eb, eb_err = {}, dict.fromkeys(EMBED_TOL, 0.0)
    for label, rows_v in (("user", cfg.n_user_feats), ("item", cfg.n_items)):
        idx = torch.randint(0, rows_v, (bags, hot), generator=gen,
                            device=dev, dtype=torch.int32)
        wts = torch.rand((bags, hot), generator=gen, device=dev)
        table32 = torch.randn((rows_v, dim), generator=gen,
                              device=dev) * 0.05
        for dtype in (torch.float32, torch.bfloat16):
            if label == "item" and dtype == torch.bfloat16:
                continue
            table = table32.to(dtype)
            dname = str(dtype).removeprefix("torch.")
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            for mean in (True, False):
                for w in (None, wts):
                    what = (f"embed_bag {label} {dname} mean={mean} "
                            f"weighted={w is not None}")
                    got = embed_bag(idx, table, w, mean=mean, use_kernel=True)
                    want = embed_bag(idx, table, w, mean=mean,
                                     use_kernel=False)
                    eb_err[dname] = max(eb_err[dname], allclose_err(
                        torch, got, want, EMBED_TOL[dname], what))
                    check(torch.equal(got.view(bits), embed_bag_previous(
                        idx, table, w, mean=mean).view(bits)),
                          f"{what}: differs from the previous kernel")
            lib = torch.nn.functional.embedding_bag(idx.long(), table,
                                                    mode="mean")
            allclose_err(torch, embed_bag(idx, table, mean=True), lib,
                         EMBED_TOL[dname], f"embed_bag {label} {dname} "
                         "against F.embedding_bag")
            cases = {f"{label}_{dname}": idx}
            if label == "user" and dtype == torch.float32:
                train_bags = spec.shapes["train_batch"]["batch"]
                cases.update({f"train_{train_bags}": idx[:train_bags],
                              "p99_512": idx[:512], "retrieval_1": idx[:1]})
            for case, bag_ids in cases.items():
                ids_long = bag_ids.long()
                check(torch.equal(
                    embed_bag(bag_ids, table, mean=True).view(bits),
                    embed_bag_previous(bag_ids, table, mean=True).view(bits)),
                      f"embed_bag {case}: differs from the previous kernel")
                ms = cuda_ms_turns(torch, {
                    "kernel": lambda i=bag_ids: embed_bag(
                        i, table, mean=True, use_kernel=True),
                    "previous": lambda i=bag_ids: embed_bag_previous(
                        i, table, mean=True),
                    "plain": lambda i=bag_ids: embed_bag(
                        i, table, mean=True, use_kernel=False),
                    "library": lambda i=ids_long: (
                        torch.nn.functional.embedding_bag(i, table,
                                                          mode="mean"))})
                esize, nb = table.element_size(), bag_ids.shape[0]
                io_bytes = bag_ids.numel() * 4 + nb * dim * esize
                row_bytes = dim * esize
                start = ids_long * row_bytes
                sectors = int(((start + row_bytes - 1) // 32 - start // 32
                               + 1).sum())
                distinct = int(torch.unique(ids_long).numel())
                b_ms, b_by = bound(io_bytes + distinct * row_bytes,
                                   2 * bag_ids.numel() * dim)
                eb[case] = dict(
                    ms=ms["kernel"], previous_ms=ms["previous"],
                    plain_ms=ms["plain"], library_ms=ms["library"],
                    bound_ms=b_ms, bound_by=b_by,
                    sector_bound_ms=bound(io_bytes + 32 * sectors, 0)[0],
                    gathered_sectors=sectors, distinct_rows=distinct,
                    bags=nb)
    rows["embed_bag"] = {**{k: eb["user_float32"][k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "max_abs_err": eb_err["float32"]}
    emit({"kernel": "embed_bag", "bags": bags, "hot": hot, "dim": dim,
          "user_rows": cfg.n_user_feats, "item_rows": cfg.n_items,
          "card": card,
          "input": "random idx, mean, no weights (serve_bulk's user profile; "
                   "user_bfloat16_*: the same in bf16; item_float32_*: the "
                   "item table's size; train_65536_*: the first 65,536 bags, "
                   "train_batch's; p99_512_*, retrieval_1_*: the first "
                   "512 and 1 bags, launch-bound); weighted sum and mean "
                   "checked; every result bit-equal to the previous kernel; "
                   "sector bound: idx, out and the gathered rows' 32-byte "
                   "sectors at the HBM rate",
          **kernel_line(rows["embed_bag"]),
          "bit_equal_to_previous": True,
          "bf16_max_abs_err": eb_err["bfloat16"],
          **{f"{case}_{k}": v for case in eb
             for k, v in kernel_line(eb[case]).items()}})
    del idx, bag_ids, ids_long, wts, table32, table, got, want, lib, start

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
    # random table, and one list over every element; and the mask kernel's,
    # at grid2d(4096)'s state after level 4095.
    launches = dict.fromkeys(counters, 0)
    p_rand = torch.randint(0, n_tab, (n_tab,), generator=gen, device=dev,
                           dtype=torch.int32)
    succ = torch.arange(1, n_tab + 1, dtype=torch.int32, device=dev)
    succ[-1] = -1
    d0 = torch.ones(n_tab, dtype=torch.int32, device=dev)
    d0[-1] = 0
    verts = torch.arange(n, dtype=torch.int32, device=dev)
    manhattan = verts // GRID_SIDE + verts % GRID_SIDE
    mid = torch.where(manhattan <= GRID_SIDE - 1, manhattan, INF32)
    zero_counts()
    out_p = pointer_jump_k(p_rand)
    out_s, out_d = list_rank_k(succ, d0)
    mask = frontier_relax(mid, grid.src, grid.dst, GRID_SIDE - 1)
    ops_path = read_counts()
    check(ops_path == {**dict.fromkeys(counters, 0), "pointer_jump_k": 1,
                       "list_rank_k": 1, "frontier_relax": 1},
          f"the kernels' own entry points launched {ops_path}")
    check(torch.equal(out_p, pointer_jump_k(p_rand, use_kernel=False))
          and torch.equal(out_s, list_rank_k(succ, d0, use_kernel=False)[0])
          and torch.equal(out_d, list_rank_k(succ, d0, use_kernel=False)[1])
          and torch.equal(mask, frontier_relax(mid, grid.src, grid.dst,
                                               GRID_SIDE - 1,
                                               use_kernel=False)),
          "the kernels' own entry points differ from the plain path")
    for name in launches:
        launches[name] += ops_path[name]
    emit({"path": "ops.pointer_jump_k, ops.list_rank_k, ops.frontier_relax",
          "n": n_tab, "launches": {k: v for k, v in ops_path.items() if v}})
    del p_rand, succ, d0, out_p, out_s, out_d, verts, manhattan, mid, mask

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
            want.update(pointer_jump_double=r.compress_syncs,
                        list_rank_double=r.rank_syncs,
                        hook_edges=r.steps + 1)
        elif method == "bfs":
            want.update(bfs_level=r.steps + 1)
        else:
            want.update(pointer_jump_double=r.compress_syncs)
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
            # The kernel path against the plain one and the previous design
            # (bfs: the previous level; else the stepwise doubling kernels).
            runs = {"kernel": lambda: timed(g, method, None)[1],
                    "plain": lambda: timed(g, method, False)[1]}
            firsts = {"kernel": first_ms, "plain": plain_first_ms}
            other = on_old_level if method == "bfs" else on_stepwise
            name = "old_level" if method == "bfs" else "stepwise"
            o, firsts[name] = other(lambda: timed(g, method, None))
            for field in FIELDS[method]:
                check(torch.equal(getattr(o, field), getattr(r, field)),
                      f"{label} {method}: {field} differs on the {name} "
                      "design")
            del o
            runs[name] = lambda: other(lambda: timed(g, method, None)[1])
            e2e = time_variants(runs, firsts)
            kernel_ms = e2e["kernel"]
            depth = tree_depth(r.parent)
            summary[label][method] = (statistics.median(kernel_ms), depth,
                                      r.steps)
            emit({"graph": label, "method": method, "n": g.n_nodes,
                  "half_edges": g.n_half_edges,
                  "generate_s": round(build_s, 3), "steps": r.steps,
                  **{k: getattr(r, k) for k in COUNTS[method][1:]},
                  "tree_depth": depth,
                  "launches": {k: v for k, v in got.items() if v},
                  **e2e_fields(e2e),
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
    old_consts.clear()

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
                need.append("bfs_level")
            # Two tables (low and high) of ⌈log2 n⌉ levels each.
            lv = (g.n_nodes - 1).bit_length()
            check(r.seg_syncs == 2 * lv
                  and got["segment_table"]
                  == 2 * launches_per_call(g.n_nodes, lv)
                  and got["frontier_relax"] == 0
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
            # Against the plain path, the stepwise doubling kernels and the
            # previous segment_table design.
            runs = {"kernel": lambda: timed_call(lambda: run(None))[1],
                    "plain": lambda: timed_call(lambda: run(False))[1]}
            firsts = {"kernel": first_ms, "plain": plain_first_ms}
            for name, other in (("stepwise", on_stepwise),
                                ("segment_stepwise", on_segment_stepwise)):
                o, firsts[name] = other(lambda: timed_call(lambda: run(None)))
                check(all(torch.equal(getattr(o, f), getattr(r, f))
                          for f in BCC_FIELDS),
                      f"{label} bcc {method}: differs on the {name} design")
                del o
                runs[name] = lambda other=other: other(
                    lambda: timed_call(lambda: run(None))[1])
            e2e = time_variants(runs, firsts)
            per[method] = dict(
                entry=entry, **e2e_fields(e2e),
                n_bcc=r.n_bcc,
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
    check(got["segment_table"] == 2 * launches_per_call(
              n, (n - 1).bit_length()), f"queries: launches {got}")
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

    if args.profile_out is not None:
        from torch.profiler import ProfilerActivity, profile

        def profiled(what, fn):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, wall_ms = timed_call(fn)
            return (f"{what}, profiled run: {wall_ms:.3f} ms wall\n"
                    + prof.key_averages().table(sort_by="cuda_time_total",
                                                row_limit=40))
        profiles = [card]
        runs = [(label, g, m) for label, g, _ in cases
                for m in ("gconn_euler", "pr_rst")]
        runs.append((cases[1][0], rmat, "bfs"))
        for label, g, method in runs:
            profiles.append(profiled(f"{label} {method}", lambda g=g, m=method:
                                     rooted_spanning_tree(g, 0, method=m)))
        profiles.append(profiled(
            f"{cases[0][0]} bfs, first {PROFILE_GRID_LEVELS} levels",
            lambda: bfs_rst(grid, 0, max_levels=PROFILE_GRID_LEVELS)))
        for label, g, _ in cases:
            profiles.append(profiled(f"{label} biconnectivity gconn_euler",
                                     lambda g=g: biconnectivity(g, 0)))

    # 5g. DIEN serving at the full config, through build_cell, after the
    # graphs are freed: serve_bulk holds hs [262144, 100, 108] (11.3 GB)
    # and behavior (3.8 GB). Float32 matmuls stay in full float32.
    del grid, rmat, cases, small, g, gconn_parent, summary
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    emit({"phase": "dien", "matmul_allow_tf32":
          torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision()})
    for name in DIEN_SHAPES:
        shape = spec.shapes[name]
        step, params, inputs = build_cell(spec, name)
        plain, plain_params, _ = build_cell(spec, name, use_kernel=False)
        del plain_params
        _, batch = next(synthetic_batches(spec, shape, cfg, seed=0))
        batch = {k: batch[k] for k in inputs}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        scores, first_ms = timed_call(lambda: step(params, batch))
        got = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for k in launches:
            launches[k] += got[k]
        check(got == {**dict.fromkeys(counters, 0), "embed_bag": 1},
              f"dien {name}: launches {got}, want embed_bag once")
        err = allclose_err(torch, scores, plain(params, batch),
                           DIEN_KERNEL_TOL, f"dien {name} against plain")
        check(bool(torch.isfinite(scores).all()), f"dien {name}: non-finite")
        if shape["kind"] == "serve":
            n_rows = shape["batch"]
            check(scores.shape == (n_rows,) and float(scores.min()) >= 0
                  and float(scores.max()) <= 1,
                  f"dien {name}: scores not in [0, 1] or shape "
                  f"{tuple(scores.shape)}")
            cpu_batch = {k: v[:DIEN_CPU_ROWS].cpu() for k, v in batch.items()}
        else:
            n_rows = shape["n_candidates"]
            check(scores.shape == (DIEN_RETRIEVAL_SCORES,),
                  f"dien {name}: {tuple(scores.shape)} scores, want "
                  f"{DIEN_RETRIEVAL_SCORES}")
            cpu_batch = {k: (v[:DIEN_CPU_ROWS] if k.startswith("cand")
                             else v).cpu() for k, v in batch.items()}
        cpu_step, _, _ = build_cell(spec, name, device="cpu")
        cpu_scores = cpu_step(params_from_reference(params.to_reference(),
                                                    device="cpu"), cpu_batch)
        cpu_err = allclose_err(torch, scores[:DIEN_CPU_ROWS].cpu(),
                               cpu_scores[:DIEN_CPU_ROWS], DIEN_CPU_TOL,
                               f"dien {name} against the CPU run")
        # What the CPU check would see if the matmuls ran in TF32.
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32_err = float((step(params, batch)[:DIEN_CPU_ROWS].cpu()
                          - cpu_scores[:DIEN_CPU_ROWS]).abs().max())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        kernel_ms, plain_ms = [], []
        for i in range(E2E_RUNS):
            for use_kernel in ((True, False) if i % 2 == 0
                               else (False, True)):
                fn = step if use_kernel else plain
                (kernel_ms if use_kernel else plain_ms).append(
                    timed_call(lambda: fn(params, batch))[1])
        ms = statistics.median(kernel_ms)
        rate = "rows_per_s" if shape["kind"] == "serve" else "candidates_per_s"
        emit({"dien": name, "card": card, "batch": shape["batch"],
              **({"n_candidates": n_rows} if shape["kind"] == "retrieval"
                 else {}),
              "scores": scores.numel(),
              "launches": {k: v for k, v in got.items() if v},
              "max_abs_err_vs_plain": err,
              f"max_abs_err_vs_cpu_first_{DIEN_CPU_ROWS}": cpu_err,
              "cpu_tol": DIEN_CPU_TOL,
              f"tf32_max_abs_err_vs_cpu_first_{DIEN_CPU_ROWS}": tf32_err,
              "score_min": float(scores.min()),
              "score_max": float(scores.max()),
              "first_call_ms": first_ms, "ms_median": ms, "ms": kernel_ms,
              "plain_ms_median": statistics.median(plain_ms),
              "plain_ms": plain_ms, rate: n_rows / (ms / 1e3),
              "peak_mem_gb": peak_gb})
        if shape["kind"] == "serve" and args.profile_out is not None:
            profiles.append(profiled(f"dien {name} forward",
                                     lambda: step(params, batch)))
        del step, plain, params, batch, scores, cpu_step, cpu_scores
        torch.cuda.empty_cache()

    # 5h. DIEN training at the full config through build_cell's train cell
    # (train_batch: 65,536 rows a step; autograd keeps each recurrent step's
    # activations), after the serving cells are freed: the kernel cell and
    # a plain twin (use_kernel=False) from the same seed-0 parameters, fed
    # the same synthetic batches.
    name = "train_batch"
    shape = spec.shapes[name]
    step, state, inputs = build_cell(spec, name)
    plain, plain_state, _ = build_cell(spec, name, use_kernel=False)
    check(all(torch.equal(a, b) for a, b in zip(
        state["params"].parameters(), plain_state["params"].parameters())),
          "dien train: the plain twin's parameters differ")
    data = synthetic_batches(spec, shape, cfg, seed=0)
    batches = [next(data)[1] for _ in range(TRAIN_STEPS + E2E_RUNS)]
    check(all(set(b) == set(inputs) for b in batches),
          f"dien train: batch keys {sorted(batches[0])}, want "
          f"{sorted(inputs)}")
    # One step's loss and gradients on the first rows, against the port's
    # CPU run of the same step.
    names, leaves = zip(*state["params"].named_parameters())
    rows_cpu = {k: v[:TRAIN_CPU_ROWS] for k, v in batches[0].items()}
    card_loss = dien_loss(cfg, state["params"], rows_cpu)
    card_grads = torch.autograd.grad(card_loss, leaves)
    cpu_params = params_from_reference(state["params"].to_reference(),
                                       device="cpu").requires_grad_()
    cpu_loss = dien_loss(cfg, cpu_params,
                         {k: v.cpu() for k, v in rows_cpu.items()},
                         device="cpu")
    cpu_grads = torch.autograd.grad(cpu_loss, list(cpu_params.parameters()))
    train_cpu_err = {"loss": allclose_err(
        torch, card_loss.detach().cpu(), cpu_loss.detach(),
        DIEN_TRAIN_CPU_TOL, "dien train loss against the CPU run")}
    train_cpu_ratio = {}
    for n_, a, b in zip(names, card_grads, cpu_grads):
        train_cpu_err[n_] = allclose_err(
            torch, a.cpu(), b, DIEN_TRAIN_CPU_TOL,
            f"dien train gradient of {n_} against the CPU run")
        train_cpu_ratio[n_] = scaled_err(
            torch, a.cpu(), b, DIEN_TRAIN_SCALED_TOL,
            f"dien train gradient of {n_} against the CPU run, scaled")
    # What the scaled check would see if the matmuls ran in TF32.
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32_grads = torch.autograd.grad(
        dien_loss(cfg, state["params"], rows_cpu), leaves)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    tf32_ratio = {n_: float((a.cpu().double() - b.double()).abs().max()
                            / b.double().abs().max())
                  for n_, a, b in zip(names, tf32_grads, cpu_grads)}
    del card_loss, card_grads, cpu_params, cpu_loss, cpu_grads, rows_cpu
    del tf32_grads
    # The checked steps: one embed_bag launch a kernel step, none a plain
    # one; loss and grad_norm finite and within DIEN_TRAIN_TOL of the plain
    # twin's at every step, parameters and moments after the last.
    initial = {n_: p_.detach().clone()
               for n_, p_ in state["params"].named_parameters()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics = {"kernel": [], "plain": []}
    step_ms = []
    for i in range(TRAIN_STEPS):
        zero_counts()
        (state, m), t = timed_call(lambda: step(state, batches[i]))
        got = read_counts()
        check(got == {**dict.fromkeys(counters, 0), "embed_bag": 1},
              f"dien train step {i}: launches {got}, want embed_bag once")
        for k in launches:
            launches[k] += got[k]
        step_ms.append(t)
        zero_counts()
        plain_state, pm = plain(plain_state, batches[i])
        check(read_counts() == dict.fromkeys(counters, 0),
              f"dien train step {i}: the plain twin launched a kernel")
        for who, mm in (("kernel", m), ("plain", pm)):
            check(all(bool(torch.isfinite(v)) for v in mm.values()),
                  f"dien train step {i}: {who} {mm} not finite")
            metrics[who].append({k: float(v) for k, v in mm.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_err = {}
    for k in ("loss", "grad_norm"):
        got_k = torch.tensor([mm[k] for mm in metrics["kernel"]])
        want_k = torch.tensor([mm[k] for mm in metrics["plain"]])
        train_err[k] = allclose_err(torch, got_k, want_k, DIEN_TRAIN_TOL,
                                    f"dien train {k} against plain")
    train_ratio = {"grad_norm": max(scaled_err(
        torch, torch.tensor(mk["grad_norm"]), torch.tensor(mp["grad_norm"]),
        DIEN_TRAIN_SCALED_TOL, f"dien train grad_norm of step {i}")
        for i, (mk, mp) in enumerate(zip(metrics["kernel"],
                                         metrics["plain"])))}
    plain_named = dict(plain_state["params"].named_parameters())
    train_err["params"] = max(allclose_err(
        torch, p_.detach(), plain_named[n_].detach(), DIEN_TRAIN_TOL,
        f"dien train {n_} after {TRAIN_STEPS} steps against plain")
        for n_, p_ in state["params"].named_parameters())
    ulps = 2 * torch.finfo(torch.float32).eps
    train_ratio["change"] = max(scaled_err(
        torch, p_.detach() - initial[n_], plain_named[n_].detach()
        - initial[n_], DIEN_TRAIN_SCALED_TOL,
        f"dien train change of {n_} over {TRAIN_STEPS} steps against plain",
        floor=ulps * float(initial[n_].abs().max()))
        for n_, p_ in state["params"].named_parameters())
    for part in ("m", "v"):
        train_err[part] = max(allclose_err(
            torch, t_, plain_state["opt"][part][n_], DIEN_TRAIN_TOL,
            f"dien train {part} of {n_} against plain")
            for n_, t_ in state["opt"][part].items())
        train_ratio[part] = max(scaled_err(
            torch, t_, plain_state["opt"][part][n_], DIEN_TRAIN_SCALED_TOL,
            f"dien train {part} of {n_} against plain, scaled")
            for n_, t_ in state["opt"][part].items())
    del initial
    check(int(state["opt"]["step"]) == TRAIN_STEPS,
          f"dien train: step count {int(state['opt']['step'])}")
    kernel_ms, plain_ms = [], []
    for i in range(E2E_RUNS):
        batch = batches[TRAIN_STEPS + i]
        for use_kernel in ((True, False) if i % 2 == 0 else (False, True)):
            if use_kernel:
                (state, _), t = timed_call(lambda: step(state, batch))
                kernel_ms.append(t)
            else:
                (plain_state, _), t = timed_call(
                    lambda: plain(plain_state, batch))
                plain_ms.append(t)
    ms = statistics.median(kernel_ms)
    # embed_bag's backward (torch ops, no kernel of its own) at the step's
    # shape, timed on the card alone: the user table's gradient for a
    # random output gradient (the weights take none).
    users = batches[0]["user_feats"]
    user_table = state["params"]["user_table"].detach()
    g_user = torch.randn((users.shape[0], cfg.embed_dim), generator=gen,
                         device=dev)
    out_user = embed_bag(users, user_table, mean=True)
    backward_ms = cuda_ms_turns(torch, {"backward": lambda: embed_bag_backward(
        g_user, users, user_table, None, out_user, mean=True,
        need_weights=False)})["backward"]
    emit({"dien_train": name, "card": card, "batch": shape["batch"],
          "steps_checked": TRAIN_STEPS,
          "launches_per_step": {"embed_bag": 1},
          "loss": [mm["loss"] for mm in metrics["kernel"]],
          "grad_norm": [mm["grad_norm"] for mm in metrics["kernel"]],
          "plain_loss": [mm["loss"] for mm in metrics["plain"]],
          "plain_grad_norm": [mm["grad_norm"] for mm in metrics["plain"]],
          "max_abs_err_vs_plain": train_err, "tol": DIEN_TRAIN_TOL,
          "max_scaled_err_vs_plain": train_ratio,
          f"max_abs_err_vs_cpu_first_{TRAIN_CPU_ROWS}": {
              "loss": train_cpu_err.pop("loss"),
              "gradients": max(train_cpu_err.values()),
              "worst_gradient": max(train_cpu_err, key=train_cpu_err.get)},
          "cpu_tol": DIEN_TRAIN_CPU_TOL,
          f"scaled_err_vs_cpu_first_{TRAIN_CPU_ROWS}": train_cpu_ratio,
          f"tf32_scaled_err_vs_cpu_first_{TRAIN_CPU_ROWS}": tf32_ratio,
          "scaled_tol": DIEN_TRAIN_SCALED_TOL,
          "checked_step_ms": step_ms, "ms_median": ms, "ms": kernel_ms,
          "plain_ms_median": statistics.median(plain_ms),
          "plain_ms": plain_ms, "rows_per_s": shape["batch"] / (ms / 1e3),
          "peak_mem_gb": peak_gb, "embed_bag_backward_ms": backward_ms})
    if args.profile_out is not None:
        profiles.append(profiled(f"dien {name} step",
                                 lambda: step(state, batches[-1])))
    del step, plain, state, plain_state, batches, batch, data, users
    del user_table, g_user, out_user
    torch.cuda.empty_cache()

    check(all(v > 0 for v in launches.values()),
          f"a kernel of the paths never launched: {launches}")
    if args.profile_out is not None:
        args.profile_out.parent.mkdir(parents=True, exist_ok=True)
        args.profile_out.write_text("\n\n".join(profiles) + "\n")

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
        "bfs_level": (f"{kdir}/frontier_relax/csrc/frontier_relax.cu",
                      f"{tdir}/frontier_relax/frontier_relax.py:26"),
        "pointer_jump_k": (f"{kdir}/pointer_jump/csrc/pointer_jump.cu",
                           f"{tdir}/pointer_jump/pointer_jump.py:33"),
        "list_rank_k": (f"{kdir}/list_rank/csrc/list_rank.cu",
                        f"{tdir}/list_rank/list_rank.py:27"),
        "segment_table": (f"{kdir}/segment_table/csrc/segment_table.cu",
                          f"{tdir}/segment_table/segment_table.py:37"),
        "embed_bag": (f"{kdir}/embed_bag/csrc/embed_bag.cu",
                      f"{tdir}/embed_bag/embed_bag.py:30"),
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
