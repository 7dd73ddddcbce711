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
     i. the streaming layer (``repro_torch.dynamic``): first the 32
        table4_dynamic / table5_dynamic_bcc smoke rows of BENCH_rst.json
        (chain(256) and rmat(6, edge_factor=4), churn and sliding_window,
        B = 4 and 16, seed 0, 6 batches) by the benchmarks' procedure,
        every derived count equal; then eight full-size configurations,
        grid2d(4096) and rmat(20, edge_factor=16) × churn and
        sliding_window × B = 256 and 65,536, seed 0: ``init_state``, a
        ``ForestView`` (tour and BCC incremental, a query session, every
        batch) primed on it, ``replay_batch`` + ``view.refresh`` for 6
        batches (counted: pointer_jump_double, list_rank_double, hook_edges
        and segment_table each launch, nothing else), every refresh held
        bit-equal to a full recompute; the 6th batch again from the same
        pre-state: its host syncs per phase (torch's sync debug mode)
        beside the ledger's, its apply, tour and BCC times incremental,
        full and from scratch (the RST and numbering of ``live_graph``),
        3 runs in turns, the plain path bit-equal in state, stats,
        numbering and BCC, ``rep`` against scipy's components, the forest
        a valid rooted spanning forest, the pre-state unchanged; one
        ``{"stream": ...}`` line each with peak memory. On grid2d(4096)
        churn B = 65,536 the view's session answers 2^20 seeded pairs of
        connected, lca, depth, is_bridge and is_articulation, bit-equal to
        a session over a full recompute and to the plain path, timed; after
        a 7th batch ``strict`` raises, ``refresh`` answers as a fresh
        session and ``stale`` counts what it served;
     j. the self-healing layer (``dynamic.chaos``, ``audit``,
        ``recovery``, ``launch.resilient``, ``launch.serve_stream``): the 13
        table6_robustness/grid_32 rows of BENCH_rst.json by the benchmark's
        procedure, every derived count equal; then, from phase 5i's
        measured churn B = 65,536 states of both large graphs, each of the
        six injectors at K = 1 and 4 effective faults: the audit flags it,
        ``recover`` heals it (its mode in the expected set, a fresh audit
        healthy), the scoped repair and the full rebuild give one partition,
        scipy's; everything bit-equal to ``use_kernel=False``, the pre-state
        unchanged, only the four kernels of the path launched; one
        ``{"heal": ...}`` line each with the audit, repair, rebuild and
        recover times (3 runs in turns at K = 1), the ledger's syncs beside
        the host syncs, and at K = 1 the re-rooting tables' share of a
        repair; then ``ResilientStreamLoop`` at full size: rmat churn B =
        65,536, 12 polluted batches under chaos, audits, the sanitizer and
        checkpoints, killed after batch 8 and resumed bit-identical to the
        uninterrupted run (checkpoint MB, save and restore ms), and grid
        churn B = 65,536, 8 batches with a fault every batch (updates/s,
        recoveries by mode), one ``{"heal_loop": ...}`` line each; then
        ``serve_stream.main`` with scripts/chaos_smoke.sh's first command
        line, its trace's audit_violation and recovery events checked as
        that script checks them (one ``{"heal_cli": ...}`` line);
     k. the multi-tenant fleet (``dynamic.fleet``, ``launch.serve_fleet``):
        two schemas, 16 × grid2d(1024) and 32 × rmat(16, edge_factor=16),
        each tenant its own churn stream (seed t, B = 4,096 a tick): 5
        ticks of ``apply_batches``, full refreshes, then the measured 6th
        tick with incremental ``refresh_tours`` / ``refresh_bccs`` and
        ``build_fleet_tables`` (counted: the four kernels of the path and
        nothing else), every lane after every tick bit-equal to its
        sequential twin (T separate ``replay_batch`` calls), the stacked
        caches to the twins' refreshes, the 6th tick also on the plain
        path; the ledger's syncs and the host syncs per phase on both
        sides (fleet below sequential, a fleet tick's host syncs those of
        its slowest lane), the tick, refresh and table times, 3 runs in
        turns with the twin, the re-rooting tables' share of a tick, 2^20
        query pairs through the ``FleetQuerySession``, peak memory; one
        ``{"fleet": ...}`` line each. Then a ``BucketedFleet`` of both
        schemas (20 grid tenants over 16 slots, 40 rmat over 32, drain 2,
        tours every 2, a second wave of units once the first has drained,
        so evicted tenants come back through the prefetch): every tenant bit-equal to
        its replayed twin, its partition to a rebuild and to scipy's; then
        ``serve_fleet.main`` with the README's two fleet drives; the 8
        table8_fleet and 2 table9_buckets smoke rows' counts; ``bcc_batch``
        over 16 relabelled grid2d(256) graphs against 16 separate
        ``biconnectivity`` calls and its plain path;
     l. GNN training and the training CLI (``models.gnn``,
        ``data.gnn_batch``, ``train.fault.FaultTolerantLoop``,
        ``launch.train``): GAT, SchNet, DimeNet and MeshGraphNet at their
        full configs through ``build_cell`` at full_graph_sm, minibatch_lg
        and molecule: step 1's loss and every gradient (within 1e-4 of
        its own largest value, MeshGraphNet 5e-3; each side's distance to
        float64 printed) against the same cell on the CPU, 6 steps under ``FaultTolerantLoop`` with a checkpoint
        every 3 (step ms, nodes/s, edges/s, first and last loss, peak GB,
        checkpoint MB and save ms), a run killed after 4 steps and resumed
        from 3 within 1e-5 of an uninterrupted one (the three runs in
        torch's deterministic mode), no kernel launched;
        one ``{"gnn": ...}`` line each, and one ``{"gnn_meta": ...}`` line
        per architecture with the bytes of its ogb_products cell, built on
        ``meta`` (it does not fit one card); then ``reorder_by_rst`` on
        ``rmat(19, edge_factor=16)`` (hook_edges, pointer_jump_double and
        list_rank_double launched; the permutation bit-equal to the plain
        path) and the full GAT (d_in 100) on that graph in its original
        and its RST order: the same loss within 1e-5, 5 timed steps a side
        in turns (one ``{"gnn_reorder": ...}`` line); then
        ``launch.train.main`` for gat-cora (6 steps, then resumed to 9)
        and for DIEN at train_batch (3 steps, embed_bag launched, its
        checkpoint's MB and save ms), one ``{"train_cli": ...}`` line
        each; then the loop's own checks on the forest stream of
        grid2d(256) (three injected timeouts retried, a kill after 6
        resumed from 4, both bit-equal to a clean run) and a StepTimeout
        from a sleep on the card that outlasts the watchdog (one
        ``{"train_loop": ...}`` line);
     m. the five LMs (``models.transformer``, ``launch.serve``, the LM
        cells of ``train.step``, ``launch.train``), TF32 off (printed):
        ``serve_requests`` at the full config of llama3.2-1b, qwen3-1.7b,
        minicpm-2b and moonshot-v1-16b-a3b (56 GB of bf16 weights) with
        the serve CLI's defaults (batch 8, prompt 32, 32 new tokens, 2
        requests): prefill ms, decode ms a token beside its bound, tokens/s,
        peak GB and the host syncs of 4 decode steps (torch's sync debug
        mode: 0), each model freed before the next (one ``{"lm_serve":
        ...}`` line each); ``serve.main`` for dbrx-132b (its smoke config:
        263 GB of weights do not fit); ``long_500k`` unreduced for
        llama3.2-1b and qwen3-1.7b (524,288 cached positions of seeded
        normals, 5 decode steps attending to all of them: ms a token beside
        the bound of one pass over weights and cache, host syncs 0), then
        at full width with the batch cut (printed as ``reduced``):
        llama3.2-1b's decode_32k at batch 16, prefill_32k at batch 1 and
        train_4k at batch 4 (3 steps under ``FaultTolerantLoop``, the
        full config's two-level remat, cosine lr); ``launch.train.main
        --smoke`` for minicpm-2b (WSD), moonshot and dbrx; every other
        full-shape cell built on ``meta`` with its state's and inputs'
        bytes (one ``{"lm_meta": ...}`` line an arch); then the gates, the
        card against the port on the CPU in float32 on the same weights
        and tokens, within 1e-4 of each output's scale: llama3.2-1b at full
        width (4 teacher-forced decode steps' logits at batch 2, a prefill
        at sequence 256, one train step's loss and every gradient at 1 ×
        128) and moonshot at its full widths with 2 layers (the same
        decode and prefill, and layer 0's MoE routing of 256 tokens: top
        experts, positions, keep masks and capacity bit-equal), and
        llama's bf16 run on the card within 5e-2 of its float32 one; no
        kernel launched (the nine counts printed);
     n. the mesh code (``core.distributed``, ``launch.mesh``,
        ``models.transformer.moe_block_shard_map``,
        ``optim.compression``, ``launch.dryrun``): a. on a world-1 NCCL
        ``("data",)`` mesh, ``distributed_cc_spanning_forest`` on
        ``grid2d(4096)`` and ``rmat(20, edge_factor=16)``: rep, forest and
        rounds bit-equal to ``use_kernel=False``, pointer_jump_double
        launches equal to the compress syncs, host syncs (torch's sync
        debug mode) equal to rounds + 1 + the compress syncs, the partition
        equal to ``connected_components``' and scipy's, n − #components
        forest edges rooted by Euler tour into a valid spanning forest, ms a
        call and a round beside ``connected_components`` (5 runs in turns);
        b. four processes of this script (``--mesh-rank``), gloo on the
        card's tensors, on ``grid2d(1024)`` and ``rmat(20, 16)`` padded to
        a multiple of 4: every rank bit-equal to the world-1 run, each
        rank's pointer_jump_double launches equal to its compress syncs;
        c. ``moe_block_shard_map`` on a world-1 ``("data", "model")`` mesh
        at moonshot-v1-16b-a3b's widths: float32 on 256 tokens through two
        layers' expert weights, card against CPU within 1e-4 of scale,
        routing bit-equal; one bf16 timing at 65,536 tokens beside
        ``moe_block``; d. ``compress_with_error_feedback`` at llama3.2-1b's
        gradient size (1.24e9 float32 values), its first 2^26 values
        bit-equal to the CPU's, GB/s against the bytes it reads and
        writes; e. ``python -m repro_torch.launch.dryrun --all --jobs 6``
        in a subprocess without the card (started with 5o d's analyses
        right after the build, on the host's CPU at the lowest priority
        beside the phases before), every one of the 80 cells ok, one
        ``{"dryrun": ...}`` line each with its per-card GB, its counted
        TFLOP, collective GB (by kind) and temp GB a card for one step;
     o. the sharded cells (``build_cell(..., mesh)``: state and inputs as
        DTensors placed by ``distributed.sharding``): a. on a world-1 NCCL
        ``("data", "model")`` mesh against the same cell with no mesh, the
        same seed-0 weights and batch: llama3.2-1b's train step at full
        width, batch 4 × 4096 (reduced as 5m b), GAT at minibatch_lg and
        DIEN at train_batch (65,536 rows), each from a nonzero learning
        rate, loss, grad norm and every updated master weight compared
        (1e-5 of scale; GAT and DIEN also 1e-5 absolute and relative), ms a
        step both ways, peak GB, DIEN's embed_bag launches on the mesh path
        (> 0); moonshot's prefill_32k at batch 2 (reduced: the largest that
        fits beside its 56.1 GB of weights), the mesh path through
        ``moe_block_shard_map``, logits within 1e-5 of scale; b. eight
        processes of this script (``--mesh-cells``), gloo on the host's
        CPU, on the (2, 4) mesh beside one at world 1: the smoke train step
        of qwen3-1.7b, moonshot (its three mesh fields set, capacity factor
        8 so no token is dropped), GAT and DIEN, every rank's loss and grad
        norm and the gathered state within the float tolerances of the
        world-1 run's; c. ``launch.train.main`` for gat-cora and DIEN
        through its mesh cell (world-1 NCCL), 2 steps then 3, resuming at
        2; d. ``launch.cost_analysis.analyze_cell`` on a's four cells at
        their cuts, on a fake world of one (a process without the card):
        the predicted peak (arguments + temp) within 25 % of the mesh
        step's measured peak (``torch.cuda.max_memory_allocated`` above
        what was held outside the step, plus its arguments), the counted
        flops within 2 % of ``torch.profiler``'s ``with_flops`` count of
        the products (mm, addmm, bmm, baddbmm) that launched a kernel in
        the plain step, and the achieved TFLOP/s and its share of the
        card's peak;
  6. one JSON line listing the kernels, then the result line
     ``{"ok": true, "device": {...}}`` as the last line.

``--profile-out`` also writes ``torch.profiler`` tables to FILE: one
gconn_euler and one pr_rst run per graph, one bfs run on
``rmat(20, edge_factor=16)`` and its first 64 levels on ``grid2d(4096)``,
one gconn_euler ``biconnectivity`` per
graph, one DIEN forward at ``serve_p99`` and at ``serve_bulk``, one DIEN
training step at ``train_batch``, the measured batch of grid2d(4096)
churn B = 65,536 (apply, incremental tour and BCC), one train step of
each GNN at minibatch_lg, one GAT step on rmat(19, edge_factor=16) in
RST order, one llama3.2-1b decode step at batch 8, its prefill_32k at
batch 1 and one train_4k step at batch 4.
Without a CUDA card, or outside the repository, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import os
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
# Phase 5i: the streams (the regimes table4_dynamic and table5_dynamic_bcc
# measure), the batch sizes (the reference benchmark's largest, and 2^16),
# the batches of each (5 warm, then the measured one; a 7th is made only to
# make the query session stale), the timed runs of the measured batch, and
# the configuration whose final state answers a batch of queries.
STREAM_KINDS = ("churn", "sliding_window")
STREAM_BATCHES = (256, 65536)
STREAM_N_BATCHES = 6
STREAM_RUNS = 3
STREAM_QUERY_CASE = ("grid2d(4096)", "churn", 65536)
STREAM_QUERY_PAIRS = 1 << 20
TOUR_FIELDS = ("pre", "size", "last", "comp", "parent")
DYN_STATE = ("parent", "rep", "pool_src", "pool_dst", "pool_valid",
             "tree_mask", "dirty")
DYN_STATS = ("cuts", "links", "rounds", "overflow", "pending",
             "deletes_found")
# Every tensor field of DynamicBCC; incremental and full refresh agree on
# these and on n_bcc (their aux_rounds, seg_syncs and dirty_count differ by
# design: the incremental refresh works on the dirty components only).
DYN_BCC = ("parent", "pool_src", "pool_dst", "pool_valid", "tree_mask",
           "pre", "rep", "low", "high", "articulation", "bridge", "edge_bcc")
DYN_BCC_COUNTS = ("n_bcc", "aux_rounds", "seg_syncs", "dirty_count")
# Phase 5j: the self-healing layer. The injectors and fault counts of each
# full-size case (phase 5i's churn B = 65,536 states), the runs in turns of
# the single-fault cases, the kernels its path may launch, the table6 rows'
# injectors (benchmarks/table6_robustness.py), the resilient loop's batches
# (rmat: killed after LOOP_KILL and resumed; grid: no checkpoint), and the
# AuditReport fields held against the plain path.
HEAL_INJECTORS = ("parent_bitflip", "parent_cycle", "rep_corrupt",
                  "tree_mask_desync", "pool_desync", "stale_bcc")
HEAL_FAULTS = (1, 4)
HEAL_RUNS = 3
HEAL_KERNELS = ("pointer_jump_double", "list_rank_double", "hook_edges",
                "segment_table")
HEAL_CASE = ("churn", 65536)
TABLE6_INJECTORS = ("parent_bitflip", "rep_corrupt", "tree_mask_desync")
LOOP_BATCH = 65536
LOOP_BATCHES = 12
LOOP_KILL = 8
GRID_LOOP_BATCHES = 8
REPORT_FIELDS = ("acyclic", "roots_fixed", "rep_consistent",
                 "tree_cover_ok", "tree_slots_ok", "spanning_ok",
                 "counts_ok", "forest_ok", "tour_fresh", "bcc_fresh",
                 "healthy", "violating", "comp_violating", "sever", "stale",
                 "bad_slots", "n_violating")


# Phase 5k: the multi-tenant fleet (``dynamic.fleet``). Two schemas, each
# holding as many vertices and pool slots in all as phase 5i's grid state:
# 16 × grid2d(1024) and 32 × rmat(16, edge_factor=16), churn B = 4,096 a
# tenant a tick (seed t for tenant t), the 6th tick measured, 3 runs in
# turns with the sequential twin; the kernels of the path; the table
# fields held lane by lane; the two CLI drives (and their tenants);
# bcc_batch's graphs and grid side.
FLEET_BATCH = 4096
FLEET_N_BATCHES = 6
FLEET_RUNS = 3
FLEET_QUERY_PAIRS = 1 << 20
FLEET_KERNELS = ("pointer_jump_double", "list_rank_double", "hook_edges",
                 "segment_table")
FLEET_TABLE_FIELDS = ("pre", "last", "comp", "parent", "depth", "up")
FLEET_CLI = (("--graph grid_64 --stream churn --batch 32 --steps 10 "
              "--tenants 5 --slots 3 --bcc incremental --read-ratio 0.3 "
              "--validate", 5),
             ("--buckets chain_64:12:4,rmat_9:2:2:32 --stream churn "
              "--batch 8 --steps 8 --validate", 14))
BCC_BATCH = (16, 256)
# Phase 5l: GNN training and the training CLI. The four GNNs at the three
# GNN_SHAPES that fit one card (ogb_products: its cells built on meta),
# 6 steps a cell under FaultTolerantLoop with a checkpoint every 3, a run
# killed after 4 steps and resumed from 3; step 1's loss and gradients
# against the CPU. Float32 sums run in another order on the card (cuBLAS,
# the scatter-adds' atomics, which also make two card runs differ): the
# loss and each gradient within 1e-4 of its own largest value (a graph's
# energy sums up to 172,032 nodes);
# gradients that are 0 in exact arithmetic (below 1e-8 on the CPU: GAT's
# attention vectors, gnn_grads_close) are held below 1e-8. The
# RST-reordered pipeline: reorder_by_rst on rmat(19, edge_factor=16),
# then the full GAT at ogb_products' feature width on it in both orders,
# 5 timed steps a side in turns. The loop's own
# checks: the forest stream of grid2d(256), churn B = 1,024, 12 batches
# (retries at steps 3 and 7, a kill after 6 resumed from 4), and a sleep on
# the card of ≈ 0.5 s against a 0.2 s watchdog.
GNN_ARCHS = ("gat-cora", "schnet", "dimenet", "meshgraphnet")
GNN_CARD_SHAPES = ("full_graph_sm", "minibatch_lg", "molecule")
GNN_META_SHAPE = "ogb_products"
GNN_STEPS = 6
GNN_CKPT_EVERY = 3
GNN_KILL = 4
GNN_TOL = 1e-5
GNN_SCALED_TOL = 1e-4
# MeshGraphNet's 15 layer norms amplify float32 rounding: on either device
# its gradients lie up to ≈ 2e-4 of their scale from float64 (each line's
# grad_vs_float64_scaled), and the scatter-adds' atomics make the card's
# share of that differ from run to run; a wrong formula is off by O(1).
GNN_SCALED_TOL_BY_ARCH = {"meshgraphnet": 5e-3}
GNN_ZERO_GRAD = 1e-8
REORDER_SCALE = 19
REORDER_RUNS = 5
LOOP_GRID_SIDE = 256
LOOP_STREAM_BATCH = 1024
LOOP_STREAM_BATCHES = 12
WATCHDOG_CYCLES = 1_000_000_000
WATCHDOG_S = 0.2
TRAIN_LOOP_KERNELS = ("hook_edges", "pointer_jump_double", "list_rank_double",
                      "embed_bag")
# Phase 5m, the LMs. The bf16 dense tensor-core rate of the H100 SXM at
# 700 W (NVIDIA data sheet), against which the LM cells' products count.
BF16_FLOP_PER_S = 989e12
LM_IDS = ("llama3.2-1b", "qwen3-1.7b", "minicpm-2b", "moonshot-v1-16b-a3b",
          "dbrx-132b")
# Served at full width with the serve CLI's defaults (dbrx-132b's 263 GB of
# weights do not fit: its smoke config through the CLI).
LM_SERVE_ARCHS = ("llama3.2-1b", "qwen3-1.7b", "minicpm-2b",
                  "moonshot-v1-16b-a3b")
LM_SERVE = dict(batch=8, prompt_len=32, max_new=32, requests=2)
LM_SYNC_STEPS = 4
# long_500k unreduced (batch 1, 524,288 cached positions).
LM_LONG = ("llama3.2-1b", "qwen3-1.7b")
LM_DECODE_STEPS = 4
# The cells' batches cut to fit one card: decode_32k 128 -> 16, prefill_32k
# 32 -> 1, train_4k 256 -> 4.
LM_DECODE_BATCH = 16
LM_PREFILL_BATCH = 1
LM_TRAIN_BATCH = 4
LM_TRAIN_STEPS = 3
LM_SMOKE_TRAIN = ("minicpm-2b", "moonshot-v1-16b-a3b", "dbrx-132b")
LM_GATE_SEED = 24
# The float32 gates (card against CPU), of each output's or leaf's scale;
# bf16 on the card against its own float32 run.
LM_GATE_TOL = 1e-4
LM_BF16_TOL = 5e-2


#: Processes started in the background (phase 5n e's dry run, 5o d's
#: analyses); every one still running is killed on the way out.
BACKGROUND: list = []


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def stop_background() -> None:
    for proc in BACKGROUND:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


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


def host_syncs(torch, fn):
    """``(fn(), n)``: n is the synchronizing CUDA calls ``fn`` made (host
    reads of the card and blocking copies), as torch's sync debug mode
    reports them (not its one-time notice that the mode is a prototype,
    which the first call in a process also records)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message)
                    for w in caught)


def stream_smoke_counts(g, kind, batch) -> dict:
    """The derived counts of one configuration's table4_dynamic and
    table5_dynamic_bcc smoke rows, by the benchmarks' procedure: 5 warm
    batches and a refresh, then the 6th batch incrementally (replay,
    incremental tour, incremental BCC) and from scratch (replay, full
    numbering, full BCC)."""
    from repro_torch import dynamic, obs
    from repro_torch.core import tour_numbering
    from repro_torch.data import streams as stream_gen
    s_ = stream_gen.STREAMS[kind](g.to("cpu"), batch=batch, seed=0,
                                  n_batches=STREAM_N_BATCHES)
    state = dynamic.init_state(s_, device=g.device)
    for b in s_.batches[:-1]:
        state, _ = dynamic.replay_batch(state, b)
    tn, state = dynamic.refresh_tour(state, None)
    bcc = dynamic.refresh_bcc(state, None, tour=tn)
    b = s_.batches[-1]
    s2, stats = dynamic.replay_batch(state, b)
    with obs.SyncLedger() as led_i:
        tn2, s2 = dynamic.refresh_tour(s2, tn, incremental=True)
        bcc_i = dynamic.refresh_bcc(s2, bcc, tour=tn2, incremental=True)
    s3, _ = dynamic.replay_batch(state, b)
    with obs.SyncLedger() as led_f:
        bcc_f = dynamic.refresh_bcc(s3, None, tour=tour_numbering(s3.parent),
                                    incremental=False)
    live = int(s3.n_live_edges)
    out = {"table4/incremental": {"rounds": stats["rounds"], "live": live},
           "table4/recompute": {"live": live}}
    for tag, bc, led in (("incremental", bcc_i, led_i),
                         ("recompute", bcc_f, led_f)):
        check(led.total("refresh_bcc") == bc.seg_syncs + bc.aux_rounds,
              f"{kind} b{batch}: the ledger's refresh_bcc syncs differ from "
              "the DynamicBCC counts")
        out[f"table5/{tag}"] = {
            "sync_total": led.total("refresh_bcc"),
            "seg_syncs": bc.seg_syncs, "aux_rounds": bc.aux_rounds,
            "dirty": bc.dirty_count, "n_bcc": bc.n_bcc,
            "bridges": int(bc.n_bridges)}
    return out


def queries_of_session(sess, state, u, v) -> dict:
    """One batch of each query kind phase 5i serves."""
    return {"connected": lambda: sess.connected(state, u, v),
            "lca": lambda: sess.lca(state, u, v),
            "depth": lambda: sess.depth(state, v),
            "is_bridge": lambda: sess.is_bridge(state, u, v),
            "is_articulation": lambda: sess.is_articulation(state, v)}


def same_partition(torch, a, b) -> bool:
    """Two labelings of the same vertices name the same partition."""
    n = a.numel()
    pairs = torch.unique(a.long() * n + b.long()).numel()
    return pairs == torch.unique(a).numel() == torch.unique(b).numel()


def stream_config(torch, g_cpu, glabel, kind, batch, card, counted,
                  timed_call, with_queries, profile) -> tuple:
    """Phase 5i for one graph, stream and batch size; returns its line, and
    for ``HEAL_CASE`` the measured state, numbering, BCC and scipy's labels
    of its pool (phase 5j's starting points; else None).

    The main path, counted: ``init_state``, a ``ForestView`` (tour and BCC
    incremental, a query session, every batch) primed on it, then
    ``replay_batch`` and ``view.refresh`` for each of the 6 batches. After
    every refresh the view's numbering and BCC are held against a full
    recompute. Then the 6th batch again from the same pre-state: its host
    syncs per phase, its times in turns (incremental; full numbering and
    BCC; the from-scratch RST and numbering of the live graph), the plain
    path, the partition against scipy, the tree's validity and the
    pre-state left unchanged. ``counted(fn)`` runs ``fn`` with the launch
    counts set to 0 before and returns ``(fn(), the counts after)``;
    ``profile(what, fn)``, where given, profiles one run.
    """
    import numpy as np
    import scipy.sparse
    import scipy.sparse.csgraph
    from repro_torch import dynamic, obs
    from repro_torch.core import (rooted_spanning_tree, tour_numbering,
                                  validate_rst)
    from repro_torch.data import streams as stream_gen

    t_cfg = time.perf_counter()
    label = f"{glabel}/{kind}/b{batch}"
    s_ = stream_gen.STREAMS[kind](g_cpu, batch=batch, seed=0,
                                  n_batches=STREAM_N_BATCHES + 1)
    path, extra = s_.batches[:STREAM_N_BATCHES], s_.batches[-1]
    n = g_cpu.n_nodes
    dev = torch.device("cuda")
    gen_s = time.perf_counter() - t_cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = {}

    def on_path(fn):
        """``fn()`` on the main path, its launches added to ``got``."""
        out, counts = counted(fn)
        for k, v in counts.items():
            got[k] = got.get(k, 0) + v
        return out

    view = dynamic.ForestView(dynamic.CadencePolicy(
        tour="incremental", bcc="incremental", queries=True, every=1))

    def full(state):
        tn_f = tour_numbering(state.parent)
        return tn_f, dynamic.refresh_bcc_once(state, None, tour=tn_f,
                                              incremental=False)

    def check_caches(state, tn, bcc, what):
        tn_f, bcc_f = full(state)
        for f in TOUR_FIELDS:
            check(torch.equal(getattr(tn, f), getattr(tn_f, f)),
                  f"{label} {what}: incremental tour {f} differs from full")
        for f in DYN_BCC:
            check(torch.equal(getattr(bcc, f), getattr(bcc_f, f)),
                  f"{label} {what}: incremental BCC {f} differs from full")
        check(bcc.n_bcc == bcc_f.n_bcc,
              f"{label} {what}: n_bcc {bcc.n_bcc} != {bcc_f.n_bcc}")
        return tn_f, bcc_f

    state, init_ms = on_path(lambda: timed_call(
        lambda: view.prime(dynamic.init_state(s_, device=dev))))
    check_caches(state, view.tn, view.bcc, "seed")
    warm_rounds = []
    for i, b in enumerate(path[:-1]):
        state, stats = on_path(lambda: dynamic.replay_batch(state, b))
        state = on_path(lambda: view.refresh(state, step=i))
        warm_rounds.append(stats["rounds"])
        check_caches(state, view.tn, view.bcc, f"batch {i}")

    # The measured batch through the main path, under a ledger.
    pre, tn0, bcc0 = state, view.tn, view.bcc
    snap = {f: getattr(pre, f).clone() for f in DYN_STATE}
    b6 = path[-1]
    with obs.SyncLedger() as led:
        s6, stats6 = on_path(lambda: dynamic.replay_batch(pre, b6))
        s6 = on_path(lambda: view.refresh(s6, step=STREAM_N_BATCHES - 1))
    tn_f, bcc_f = check_caches(s6, view.tn, view.bcc, "measured batch")
    ledger = led.totals()

    # The same batch, phase by phase, counting host syncs.
    (s_a, st_a), sync_apply = host_syncs(
        torch, lambda: dynamic.replay_batch(pre, b6))
    (tn_a, s_b), sync_tour = host_syncs(
        torch, lambda: dynamic.refresh_tour_once(s_a, tn0))
    bcc_a, sync_bcc = host_syncs(
        torch, lambda: dynamic.refresh_bcc_once(s_b, bcc0, tour=tn_a))
    for f in DYN_STATE:
        check(torch.equal(getattr(s_b, f), getattr(s6, f)),
              f"{label}: the measured batch's {f} differs between two runs")

    # The plain path from the same pre-state.
    p_a, pst = dynamic.replay_batch(pre, b6, use_kernel=False)
    ptn, p_b = dynamic.refresh_tour_once(p_a, tn0, use_kernel=False)
    pbcc = dynamic.refresh_bcc_once(p_b, bcc0, tour=ptn, use_kernel=False)
    for f in DYN_STATE:
        check(torch.equal(getattr(p_a, f), getattr(s_a, f)),
              f"{label}: state {f} differs from the plain path")
    check(all(int(pst[k]) == int(st_a[k]) for k in DYN_STATS),
          f"{label}: stats differ from the plain path")
    for f in TOUR_FIELDS:
        check(torch.equal(getattr(ptn, f), getattr(tn_a, f)),
              f"{label}: tour {f} differs from the plain path")
    for f in DYN_BCC:
        check(torch.equal(getattr(pbcc, f), getattr(bcc_a, f)),
              f"{label}: BCC {f} differs from the plain path")
    check(all(getattr(pbcc, c) == getattr(bcc_a, c) for c in DYN_BCC_COUNTS),
          f"{label}: BCC counts differ from the plain path")
    del p_a, p_b, pst, ptn, pbcc, s_a, s_b, tn_a, bcc_a

    # Times in turns, each run from the same pre-state.
    def ms_since(t):
        torch.cuda.synchronize()
        now = time.perf_counter()
        return (now - t) * 1e3, now

    def run_incremental():
        torch.cuda.synchronize()
        t = time.perf_counter()
        s, _ = dynamic.replay_batch(pre, b6)
        apply_ms, t = ms_since(t)
        tn, s = dynamic.refresh_tour_once(s, tn0)
        tour_ms, t = ms_since(t)
        dynamic.refresh_bcc_once(s, bcc0, tour=tn)
        bcc_ms, _ = ms_since(t)
        return {"apply": apply_ms, "tour": tour_ms, "bcc": bcc_ms}

    def run_full():
        torch.cuda.synchronize()
        t = time.perf_counter()
        s, _ = dynamic.replay_batch(pre, b6)
        apply_ms, t = ms_since(t)
        tn = tour_numbering(s.parent)
        tour_ms, t = ms_since(t)
        dynamic.refresh_bcc_once(s, None, tour=tn, incremental=False)
        bcc_ms, _ = ms_since(t)
        return {"apply": apply_ms, "tour": tour_ms, "bcc": bcc_ms}

    root = int(s6.rep[0])
    live = dynamic.live_graph(s6)

    def run_recompute():
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = rooted_spanning_tree(live, root, "gconn_euler")
        rst_ms, t = ms_since(t)
        tour_numbering(res.parent)
        tour_ms, _ = ms_since(t)
        return {"rst": rst_ms, "tour": tour_ms}

    runs = {"incremental": run_incremental, "full": run_full,
            "recompute": run_recompute}
    times = {name: [] for name in runs}
    order = list(runs)
    for r in range(STREAM_RUNS):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(runs[name]())
    med = {name: {k: statistics.median(t[k] for t in ts)
                  for k in ts[0]} for name, ts in times.items()}
    if profile is not None and (glabel, kind, batch) == STREAM_QUERY_CASE:
        profile(f"{label} measured batch, incremental", run_incremental)

    # The from-scratch tree, the partition and the pool's tree.
    res = rooted_spanning_tree(live, root, "gconn_euler")
    check(validate_rst(live, res.parent, root, connected=False)["all_ok"],
          f"{label}: the from-scratch tree is not valid")
    check(same_partition(torch, res.rep, s6.rep),
          f"{label}: rep differs from the from-scratch components")
    valid = s6.pool_valid
    pu = s6.pool_src[valid].cpu().numpy()
    pv = s6.pool_dst[valid].cpu().numpy()
    adj = scipy.sparse.coo_matrix((np.ones(pu.size, np.int8), (pu, pv)),
                                  shape=(n, n))
    n_comp, labels = scipy.sparse.csgraph.connected_components(
        adj, directed=False)
    check(same_partition(torch, torch.from_numpy(labels).to(dev), s6.rep),
          f"{label}: rep differs from scipy's components")
    check(int(s6.n_components) == n_comp,
          f"{label}: {int(s6.n_components)} components, scipy {n_comp}")
    check(validate_rst(live, s6.parent, root, connected=False)["all_ok"],
          f"{label}: the dynamic forest is not a valid rooted spanning forest")
    check(all(torch.equal(getattr(pre, f), snap[f]) for f in DYN_STATE),
          f"{label}: apply_batch wrote into its input state")
    # Phase 5j starts from this configuration's measured state.
    kept = None
    if (kind, batch) == HEAL_CASE:
        kept = {"state": s6, "tn": view.tn, "bcc": view.bcc,
                "labels": torch.from_numpy(labels).to(dev)}
    del res, adj, labels, pu, pv

    need = ("pointer_jump_double", "list_rank_double", "hook_edges",
            "segment_table")
    check(all(got[k] > 0 for k in need)
          and all(v == 0 for k, v in got.items() if k not in need),
          f"{label}: launches {got}")

    applied = int(st_a["deletes_found"]) + int(
        ((b6.ins_u < n) & (b6.ins_u != b6.ins_v)).sum()) \
        - int(st_a["overflow"])
    inc = med["incremental"]
    line = {"stream": label, "card": card, "n": n,
            "capacity": s6.capacity, "batch": batch,
            "events": int((b6.ins_u < n).sum() + (b6.del_u < n).sum()),
            "applied": applied, "rounds": stats6["rounds"],
            "warm_rounds": warm_rounds,
            "cuts": int(stats6["cuts"]), "links": int(stats6["links"]),
            "init_ms": init_ms,
            "apply_ms": inc["apply"], "tour_ms": inc["tour"],
            "bcc_ms": inc["bcc"],
            "full_apply_ms": med["full"]["apply"],
            "full_tour_ms": med["full"]["tour"],
            "full_bcc_ms": med["full"]["bcc"],
            "recompute_rst_ms": med["recompute"]["rst"],
            "recompute_tour_ms": med["recompute"]["tour"],
            "runs": STREAM_RUNS,
            "updates_per_s": applied / (sum(inc.values()) / 1e3),
            "apply_updates_per_s": applied / (inc["apply"] / 1e3),
            "ledger_syncs": ledger,
            "host_syncs": {"apply": sync_apply, "refresh_tour": sync_tour,
                           "refresh_bcc": sync_bcc},
            "dirty_count": view.bcc.dirty_count,
            "live": int(s6.n_live_edges),
            "components": n_comp, "n_bcc": view.bcc.n_bcc,
            "bridges": int(view.bcc.n_bridges),
            "aux_rounds": view.bcc.aux_rounds,
            "seg_syncs": view.bcc.seg_syncs,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": got,
            "checks": {"incremental_equals_full": True,
                       "kernel_equals_plain": True,
                       "rep_equals_scipy": True, "valid_rst": True,
                       "input_unchanged": True}}
    if with_queries:
        line["queries"] = stream_queries(torch, view, s6, tn_f, bcc_f, extra,
                                         label)
    line["seconds"] = time.perf_counter() - t_cfg
    line["stream_gen_s"] = gen_s
    del view, state, pre, s6, tn0, bcc0, tn_f, bcc_f, live, snap
    torch.cuda.empty_cache()
    return line, kept


def stream_queries(torch, view, s6, tn_f, bcc_f, extra, label) -> dict:
    """The view's session after the measured batch: 2^20 seeded pairs of
    each kind, bit-equal to a session over a full recompute and to one on
    the plain path; its times; then one more batch, under each policy."""
    from repro_torch import dynamic
    dev = torch.device("cuda")
    sess = view.session
    check(sess.is_fresh(s6) and sess.bcc is view.bcc,
          f"{label}: the view's session is not over the measured batch")
    n = s6.n_nodes
    qgen = torch.Generator(device=dev).manual_seed(17)
    u = torch.randint(0, n, (STREAM_QUERY_PAIRS,), generator=qgen,
                      device=dev, dtype=torch.int32)
    v = torch.randint(0, n, (STREAM_QUERY_PAIRS,), generator=qgen,
                      device=dev, dtype=torch.int32)
    # Half the bridge pairs are live pool edges, so some are bridges.
    valid_slots = torch.nonzero(s6.pool_valid).flatten()
    pick = valid_slots[torch.randint(0, valid_slots.numel(),
                                     (STREAM_QUERY_PAIRS // 2,),
                                     generator=qgen, device=dev)]
    u[:pick.numel()] = s6.pool_src[pick]
    v[:pick.numel()] = s6.pool_dst[pick]
    batch = queries_of_session(sess, s6, u, v)
    answers = {k: f() for k, f in batch.items()}
    fresh = dynamic.QuerySession.from_state(s6, tn_f, bcc_f)
    plain = dynamic.QuerySession.from_state(s6, tn_f, bcc_f,
                                            use_kernel=False)
    for other, what in ((fresh, "a session over a full recompute"),
                        (plain, "the plain path")):
        for k, f in queries_of_session(other, s6, u, v).items():
            check(torch.equal(f(), answers[k]),
                  f"{label} queries: {k} differs from {what}")
    ms = {k: cuda_ms(torch, f) for k, f in batch.items()}

    # One more batch: strict raises, refresh answers as a fresh session,
    # stale serves the old view and counts it.
    s7, _ = dynamic.replay_batch(s6, extra)
    strict = dynamic.QuerySession.from_state(s6, view.tn, view.bcc,
                                             policy="strict")
    try:
        strict.connected(s7, u, v)
        fail(f"{label} queries: a strict session answered a stale query")
    except dynamic.StaleQueryError:
        pass
    refresh = dynamic.QuerySession.from_state(s6, view.tn, view.bcc,
                                              policy="refresh")
    stale = dynamic.QuerySession.from_state(s6, view.tn, view.bcc,
                                            policy="stale")
    tn7, _ = dynamic.refresh_tour_once(s7, None)
    fresh7 = dynamic.QuerySession.from_state(
        s7, tn7, dynamic.refresh_bcc_once(s7, None, tour=tn7))
    for k, f in queries_of_session(refresh, s7, u, v).items():
        want = queries_of_session(fresh7, s7, u, v)[k]()
        check(torch.equal(f(), want),
              f"{label} queries: refresh policy {k} differs from a fresh "
              "session")
    for k, f in queries_of_session(stale, s7, u, v).items():
        check(torch.equal(f(), answers[k]),
              f"{label} queries: stale policy {k} differs from the old view")
    check(refresh.auto_refreshes == 1 and refresh.builds == 2
          and stale.stale_served == len(batch),
          f"{label} queries: counters {refresh.sync_stats()} "
          f"{stale.sync_stats()}")
    return {"pairs": STREAM_QUERY_PAIRS, "ms_per_batch": ms,
            "build_syncs": sess.tables.build_syncs,
            "session": sess.sync_stats(),
            "bridges_asked": int(answers["is_bridge"].sum()),
            "articulation_asked": int(answers["is_articulation"].sum()),
            "strict_raised": True,
            "refresh": refresh.sync_stats(), "stale": stale.sync_stats()}


def bench_rows(prefix: str) -> dict:
    """The derived counts of BENCH_rst.json's rows under ``prefix``."""
    rows = {}
    for r in json.loads((ROOT / "BENCH_rst.json").read_text()):
        if r.get("name", "").startswith(prefix):
            rows[r["name"]] = dict(kv.split("=")
                                   for kv in r["derived"].split(";"))
    return rows


def land_faults(dynamic, injector, state, tn, bcc, k):
    """K effective injections, table6's procedure: from seed 1000·K, each
    re-audited and kept only if the damage shows (a later fault can cancel
    an earlier one), the seed bumped every try. A structural fault shows in
    the bare audit's ``forest_ok``; ``stale_bcc`` in the audit with the
    caches. Returns ``(state, bcc, descriptions)``."""
    bad, bad_bcc, descs = state, bcc, []
    seed, tries = 1000 * k, 0
    while len(descs) < k and tries < 16 * k:
        nxt, nxt_bcc, desc = dynamic.inject(injector, bad, bad_bcc,
                                            seed=seed)
        seed += 1
        tries += 1
        if injector == "stale_bcc":
            shows = not bool(dynamic.audit_forest(nxt, tn, nxt_bcc).healthy)
        else:
            shows = not bool(dynamic.audit_forest(nxt).forest_ok)
        if shows:
            bad, bad_bcc = nxt, nxt_bcc
            descs.append(desc)
    return bad, bad_bcc, descs


def heal_table6(torch, dev, counted) -> dict:
    """Phase 5j a: the 13 table6_robustness/grid_32 rows on the card, by
    benchmarks/table6_robustness.py's procedure (grid2d(32) churn at batch
    16, seed 0, 6 batches, tour and BCC refreshed; K = 1 and 4 effective
    injections; every derived count equal). Returns the launches."""
    from repro_torch import dynamic, obs
    from repro_torch.data import graphs
    from repro_torch.data import streams as stream_gen
    rows = bench_rows("table6_robustness/grid_32/")
    check(len(rows) == 13, f"{len(rows)} table6 grid_32 rows, want 13")

    def run():
        got = {}
        g = graphs.grid2d(32, device="cpu")
        s_ = stream_gen.STREAMS["churn"](g, batch=16, seed=0)
        state = dynamic.init_state(s_, device=dev)
        for b in s_.batches[:6]:
            state, _ = dynamic.replay_batch(state, b)
        tn, state = dynamic.refresh_tour(state, None)
        bcc = dynamic.refresh_bcc(state, None, tour=tn)
        base = "table6_robustness/grid_32"
        with obs.SyncLedger() as led:
            report = dynamic.audit_forest(state, tn, bcc)
        check(led.total("audit") == report.syncs, "table6: audit ledger")
        got[f"{base}/audit"] = {"syncs": led.total("audit"),
                                "healthy": int(bool(report.healthy))}
        for injector in TABLE6_INJECTORS:
            for k in HEAL_FAULTS:
                bad, _, _ = land_faults(dynamic, injector, state, tn, bcc, k)
                rep = dynamic.audit_forest(bad)
                check(not bool(rep.forest_ok), f"table6 {injector} f{k}: "
                      "the faults do not show")
                with obs.SyncLedger() as led_s:
                    fixed, rs = dynamic.repair_forest(bad, rep)
                with obs.SyncLedger() as led_f:
                    rebuilt, bs = dynamic.rebuild_forest(bad)
                check(led_s.total("repair") == rs["sync_total"]
                      and led_f.total("rebuild") == bs["sync_total"],
                      f"table6 {injector} f{k}: ledger")
                check(bool(dynamic.audit_forest(fixed).forest_ok)
                      and bool(dynamic.audit_forest(rebuilt).forest_ok)
                      and same_partition(torch, fixed.rep, rebuilt.rep),
                      f"table6 {injector} f{k}: repair and rebuild disagree")
                kb = f"{base}/{injector}/f{k}"
                got[f"{kb}/scoped"] = {
                    "sync_total": led_s.total("repair"),
                    "rounds": rs["rounds"], "severed": int(rs["severed"]),
                    "repaired": int(rs["repaired"]),
                    "audit_syncs": rep.syncs}
                got[f"{kb}/full"] = {
                    "sync_total": led_f.total("rebuild"),
                    "cc_rounds": bs["cc_rounds"],
                    "rank_syncs": bs["rank_syncs"]}
        return got

    got, counts = counted(run)
    check(set(got) == set(rows), f"table6 rows {sorted(set(got) ^ set(rows))}")
    for name, derived in got.items():
        mine = {k: str(v) for k, v in derived.items()}
        check(mine == rows[name], f"{name}: {mine}, want {rows[name]}")
    check(all(v == 0 for k, v in counts.items() if k not in HEAL_KERNELS),
          f"table6: launches {counts}")
    return counts


def heal_equal(torch, a, b, what) -> None:
    """Two heal results, as ``heal_outputs`` returns them, hold the same
    values: states, numberings, caches, reports, stats and info."""
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, torch.Tensor):
            check(torch.equal(x, y), f"{what}: {key} differs")
        else:
            check(x == y, f"{what}: {key} {x} != {y}")


def heal_outputs(res) -> dict:
    """Every output of one pass of the heal path as a flat dict."""
    out = {}
    for name in ("audit", "bare_audit"):
        rep = res[name]
        out.update({f"{name}.{f}": getattr(rep, f) for f in REPORT_FIELDS})
        out[f"{name}.syncs"] = rep.syncs
    state, tn, bcc, rep0, info = res["recover"]
    for f in DYN_STATE:
        out[f"recover.state.{f}"] = getattr(state, f)
    out["recover.state.version"] = state.version
    if tn is not None:
        for f in TOUR_FIELDS:
            out[f"recover.tour.{f}"] = getattr(tn, f)
    if bcc is not None:
        for f in DYN_BCC:
            out[f"recover.bcc.{f}"] = getattr(bcc, f)
        for f in DYN_BCC_COUNTS:
            out[f"recover.bcc.{f}"] = getattr(bcc, f)
    out["recover.report.healthy"] = rep0.healthy
    out["recover.info"] = info
    for name in ("repair", "rebuild"):
        st, stats = res[name]
        for f in DYN_STATE:
            out[f"{name}.state.{f}"] = getattr(st, f)
        out[f"{name}.state.version"] = st.version
        out[f"{name}.stats"] = {k: int(v) for k, v in stats.items()}
    return out


def pool_labels(torch, state):
    """scipy's connected components of the live pool, as a tensor on the
    state's device, and their count."""
    import numpy as np
    import scipy.sparse
    import scipy.sparse.csgraph
    n = state.n_nodes
    valid = state.pool_valid
    pu = state.pool_src[valid].cpu().numpy()
    pv = state.pool_dst[valid].cpu().numpy()
    adj = scipy.sparse.coo_matrix((np.ones(pu.size, np.int8), (pu, pv)),
                                  shape=(n, n))
    n_comp, labels = scipy.sparse.csgraph.connected_components(
        adj, directed=False)
    return torch.from_numpy(labels).to(state.device), n_comp


def heal_case(torch, glabel, base, injector, k, card, counted) -> dict:
    """Phase 5j b for one graph, injector and fault count; returns its line.

    ``base`` holds phase 5i's measured state, numbering, BCC and scipy's
    labels of its pool. K effective injections; then the heal path,
    counted, each call under the ``obs`` ledger and torch's sync debug
    mode: the audit with the caches (it must flag the fault), the bare
    audit, ``recover`` (its mode in the expected set, a fresh audit of its
    result healthy), and ``repair_forest`` and ``rebuild_forest`` on the bare
    report (each passing a fresh audit, one partition, scipy's). Then the
    same calls with ``use_kernel=False``, every output bit-equal; the
    pre-state unchanged; times (HEAL_RUNS runs in turns at K = 1, else one),
    and at K = 1 the re-rooting tables' share of one repair."""
    from repro_torch import dynamic, obs
    from repro_torch.core import reroot
    label = f"{glabel}/{injector}/f{k}"
    state, tn, bcc = base["state"], base["tn"], base["bcc"]
    t_case = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bad, bad_bcc, descs = land_faults(dynamic, injector, state, tn, bcc, k)
    check(len(descs) == k, f"{label}: {len(descs)} of {k} faults landed")
    snap = {f: getattr(bad, f).clone() for f in DYN_STATE}
    structural = injector != "stale_bcc"

    def calls(use_kernel, res):
        """The heal path's calls, in order; ``repair`` reads the bare
        audit from ``res``."""
        return (
            ("audit", lambda: dynamic.audit_forest(
                bad, tn, bad_bcc, use_kernel=use_kernel)),
            ("bare_audit", lambda: dynamic.audit_forest(
                bad, use_kernel=use_kernel)),
            ("recover", lambda: dynamic.recover(
                bad, tn, bad_bcc, use_kernel=use_kernel)),
            ("repair", lambda: dynamic.repair_forest(
                bad, res["bare_audit"], use_kernel=use_kernel)),
            ("rebuild", lambda: dynamic.rebuild_forest(
                bad, use_kernel=use_kernel)))

    def heal_path():
        res, ledger, hsyncs = {}, {}, {}
        for name, fn in calls(None, res):
            with obs.SyncLedger() as led:
                res[name], hsyncs[name] = host_syncs(torch, fn)
            ledger[name] = led.total()
        return res, ledger, hsyncs

    (res, ledger, hsyncs), got = counted(heal_path)
    check(all(v == 0 for kk, v in got.items() if kk not in HEAL_KERNELS),
          f"{label}: launches {got}")
    report = res["audit"]
    if structural:
        check(not bool(report.forest_ok), f"{label}: the audit missed it")
    else:
        check(bool(report.forest_ok) and not bool(report.bcc_fresh),
              f"{label}: the audit missed the stale cache")
    s2, tn2, bcc2, _, info = res["recover"]
    want_modes = ("scoped", "full") if structural else ("refresh",)
    check(info["mode"] in want_modes, f"{label}: recover mode {info}")
    check(bool(dynamic.audit_forest(s2, tn2, bcc2).healthy),
          f"{label}: the recovered state fails a fresh audit")
    fixed, rstats = res["repair"]
    rebuilt, bstats = res["rebuild"]
    check(bool(dynamic.audit_forest(fixed).forest_ok)
          and bool(dynamic.audit_forest(rebuilt).forest_ok),
          f"{label}: the repair or the rebuild fails a fresh audit")
    same_pool = all(torch.equal(getattr(bad, f), getattr(state, f))
                    for f in ("pool_src", "pool_dst", "pool_valid"))
    labels = base["labels"] if same_pool else pool_labels(torch, bad)[0]
    check(same_partition(torch, fixed.rep, rebuilt.rep)
          and same_partition(torch, fixed.rep, labels)
          and same_partition(torch, s2.rep, labels),
          f"{label}: partitions of repair, rebuild, recover and scipy "
          "disagree")

    # The plain path, every output bit-equal; the pre-state unchanged.
    res_p = {}
    for name, fn in calls(False, res_p):
        res_p[name] = fn()
    heal_equal(torch, heal_outputs(res), heal_outputs(res_p),
               f"{label} kernel vs plain")
    check(all(torch.equal(getattr(bad, f), snap[f]) for f in DYN_STATE),
          f"{label}: the heal path wrote into its input state")
    del res_p

    # Times: runs in turns (K = 1), each call timed on its own.
    def ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3
    timed = {name: fn for name, fn in calls(None, res)
             if name != "bare_audit"}
    runs = HEAL_RUNS if k == 1 else 1
    times = {name: [] for name in timed}
    order = list(timed)
    for r in range(runs):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(ms(timed[name]))
    line = {"heal": label, "card": card, "faults": descs,
            "mode": info["mode"], "reason": info.get("reason"),
            "n_violating": info["n_violating"], "runs": runs}
    for name, t in times.items():
        line[f"{name}_ms"] = statistics.median(t)
        line[f"{name}_ms_runs"] = t
    if k == 1:
        # One more repair, the re-rooting tables' build timed inside it.
        real, spent = reroot.ancestor_tables, []

        def tables(p, levels):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(p, levels)
            torch.cuda.synchronize()
            spent.append((time.perf_counter() - t) * 1e3)
            return out
        reroot.ancestor_tables = tables
        try:
            total = ms(timed["repair"])
        finally:
            reroot.ancestor_tables = real
        line["repair_tables_ms"] = sum(spent)
        line["repair_tables_share"] = sum(spent) / total if total else 0.0
        line["repair_tables_calls"] = len(spent)
    line.update({
        "audit_syncs": report.syncs,
        "repair": {"sync_total": rstats["sync_total"],
                   "rounds": rstats["rounds"], "links": int(rstats["links"]),
                   "severed": int(rstats["severed"]),
                   "repaired": int(rstats["repaired"])},
        "rebuild": {"sync_total": bstats["sync_total"],
                    "cc_rounds": bstats["cc_rounds"],
                    "rank_syncs": bstats["rank_syncs"]},
        "ledger_syncs": ledger, "host_syncs": hsyncs,
        "launches": got,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "checks": {"detected": True, "recovered_healthy": True,
                   "repair_equals_rebuild_and_scipy": True,
                   "kernel_equals_plain": True, "input_unchanged": True},
        "seconds": time.perf_counter() - t_case})
    del res, bad, bad_bcc, snap, s2, tn2, bcc2, fixed, rebuilt
    return line


def loop_equal(torch, a, b, what) -> None:
    """Two resilient loops end in the same state, numbering and cache."""
    for f in DYN_STATE:
        check(torch.equal(getattr(a.state, f), getattr(b.state, f)),
              f"{what}: state {f} differs")
    check(a.state.version == b.state.version, f"{what}: version differs")
    for f in TOUR_FIELDS:
        check(torch.equal(getattr(a.tn, f), getattr(b.tn, f)),
              f"{what}: tour {f} differs")
    for f in DYN_BCC:
        check(torch.equal(getattr(a.bcc, f), getattr(b.bcc, f)),
              f"{what}: BCC {f} differs")
    check(all(getattr(a.bcc, c) == getattr(b.bcc, c)
              for c in DYN_BCC_COUNTS), f"{what}: BCC counts differ")


def dir_mb(path) -> float:
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*")
               if f.is_file()) / 1e6


def heal_loops(torch, dev, g_rmat, g_grid, card, counted) -> tuple:
    """Phase 5j c: ``ResilientStreamLoop`` at full size; returns (lines,
    launches).

    rmat: churn B = 65,536, LOOP_BATCHES batches of the stream after every
    polluter, every injector on a cadence of 3, audits every 4, the
    sanitizer, tour and BCC incremental, checkpoints every 4 into a
    directory under build/; killed after LOOP_KILL batches and resumed, it
    must end bit-identical to the uninterrupted run (state, tour, BCC,
    injected steps, recoveries). grid: churn B = 65,536, every injector one
    batch apart, audits every 4, no checkpoint."""
    import shutil
    import tempfile
    from repro_torch import dynamic
    from repro_torch.data import streams as stream_gen
    from repro_torch.launch.resilient import ResilientStreamLoop
    from repro_torch.train import checkpoint as ckpt
    lines, launches = [], {}

    def add(counts):
        for kk, v in counts.items():
            launches[kk] = launches.get(kk, 0) + v
        check(all(v == 0 for kk, v in counts.items()
                  if kk not in HEAL_KERNELS), f"resilient loop: {counts}")

    t0 = time.perf_counter()
    s_ = stream_gen.STREAMS["churn"](g_rmat, batch=LOOP_BATCH, seed=0,
                                     n_batches=LOOP_BATCHES)
    polluted = dynamic.pollute_stream(s_, tuple(dynamic.POLLUTERS), seed=0)
    batches = list(polluted.batches[:LOOP_BATCHES])
    gen_s = time.perf_counter() - t0
    cfg = dict(tour_mode="incremental", bcc_mode="incremental",
               tour_every=4, audit_every=4, chaos=tuple(dynamic.INJECTORS),
               chaos_every=3, chaos_seed=0, sanitize=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = ResilientStreamLoop.from_stream(polluted, device=dev, **cfg)
    t = time.perf_counter()
    _, counts = counted(lambda: a.run(batches))
    run_s = time.perf_counter() - t
    add(counts)
    check(bool(a.audit_now().healthy), "rmat loop: the final state fails "
          "its audit")
    root = pathlib.Path(ROOT / "build")
    root.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="heal-ckpt-", dir=root))
    try:
        b1 = ResilientStreamLoop.from_stream(
            polluted, device=dev, ckpt_dir=tmp / "loop", ckpt_every=4, **cfg)
        _, counts = counted(lambda: b1.run(batches[:LOOP_KILL]))
        add(counts)
        del b1
        b2 = ResilientStreamLoop.from_stream(
            polluted, device=dev, ckpt_dir=tmp / "loop", ckpt_every=4, **cfg)
        torch.cuda.synchronize()
        t = time.perf_counter()
        cursor = b2.resume()
        torch.cuda.synchronize()
        resume_ms = (time.perf_counter() - t) * 1e3
        check(cursor == LOOP_KILL, f"rmat loop: resumed at {cursor}")
        _, counts = counted(lambda: b2.run(batches))
        add(counts)
        loop_equal(torch, a, b2, "rmat loop, killed and resumed")
        check(b2.injected == [x for x in a.injected if x[0] >= LOOP_KILL]
              and [(s, i) for s, i in b2.recoveries] ==
              [(s, i) for s, i in a.recoveries if s >= LOOP_KILL],
              f"rmat loop: injections {b2.injected} / {a.injected}")
        ck_mb = dir_mb(tmp / "loop" / f"step_{LOOP_BATCHES:010d}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        ckpt.save(tmp / "timed", a._ckpt_tree(), LOOP_BATCHES)
        save_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        tree, _ = ckpt.restore(tmp / "timed", a._ckpt_tree())
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t) * 1e3
        check(all(torch.equal(getattr(tree["forest"], f),
                              getattr(a.state, f)) for f in DYN_STATE)
              and tree["forest"].version == a.state.version,
              "rmat loop: a restored checkpoint differs")
        del tree, b2
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    modes = {}
    for _, info in a.recoveries:
        modes[info["mode"]] = modes.get(info["mode"], 0) + 1
    lines.append({
        "heal_loop": f"rmat/churn/b{LOOP_BATCH}", "n": g_rmat.n_nodes,
        "card": card,
        "batches": LOOP_BATCHES, "killed_after": LOOP_KILL,
        "polluters": list(dynamic.POLLUTERS), "chaos_every": 3,
        "audit_every": 4, "injected": a.injected,
        "recoveries_by_mode": modes, "quarantine": a.quarantine,
        "applied": a.applied, "run_s": run_s,
        "applied_updates_per_s": a.applied / run_s,
        "batch_ms_median": statistics.median(a.lat) * 1e3,
        "checkpoint_mb": ck_mb, "save_ms": save_ms,
        "restore_ms": restore_ms, "resume_ms": resume_ms,
        "stream_gen_s": gen_s,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "checks": {"resumed_bit_identical": True, "final_audit_healthy": True,
                   "restore_equal": True}})
    del a
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    s_ = stream_gen.STREAMS["churn"](g_grid, batch=LOOP_BATCH, seed=0,
                                     n_batches=GRID_LOOP_BATCHES)
    gen_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop = ResilientStreamLoop.from_stream(
        s_, device=dev, tour_mode="incremental", bcc_mode="incremental",
        tour_every=4, audit_every=4, chaos=tuple(dynamic.INJECTORS),
        chaos_every=1, chaos_seed=0, sanitize=True)
    t = time.perf_counter()
    _, counts = counted(lambda: loop.run(list(s_.batches)))
    run_s = time.perf_counter() - t
    add(counts)
    check(bool(loop.audit_now().healthy), "grid loop: the final state fails "
          "its audit")
    modes = {}
    for _, info in loop.recoveries:
        modes[info["mode"]] = modes.get(info["mode"], 0) + 1
    check(len(loop.injected) == GRID_LOOP_BATCHES and loop.recoveries,
          f"grid loop: {len(loop.injected)} injected, {modes}")
    lines.append({
        "heal_loop": f"grid/churn/b{LOOP_BATCH}", "n": g_grid.n_nodes,
        "card": card,
        "batches": GRID_LOOP_BATCHES, "chaos_every": 1, "audit_every": 4,
        "injected": loop.injected, "recoveries_by_mode": modes,
        "recovery_steps": [s for s, _ in loop.recoveries],
        "applied": loop.applied, "run_s": run_s,
        "applied_updates_per_s": loop.applied / run_s,
        "batch_ms_median": statistics.median(loop.lat) * 1e3,
        "tour_ms_median": statistics.median(loop.tour_lat) * 1e3,
        "bcc_ms_median": statistics.median(loop.bcc_lat) * 1e3,
        "stream_gen_s": gen_s,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "checks": {"final_audit_healthy": True}})
    del loop
    torch.cuda.empty_cache()
    return lines, launches


def heal_cli(torch, counted) -> tuple:
    """Phase 5j d: ``serve_stream.main`` with scripts/chaos_smoke.sh's first
    command line on the card, its trace asserted as that script asserts it
    (audit_violation and recovery events, each recovery with a known mode
    and reason). Returns (line, launches)."""
    import contextlib
    import io
    import shutil
    import tempfile
    from repro_torch import obs
    from repro_torch.launch import serve_stream
    root = pathlib.Path(ROOT / "build")
    root.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="heal-cli-", dir=root))
    cli = ["--graph", "grid_64", "--stream", "churn", "--batch", "64",
           "--steps", "24", "--tour", "incremental", "--tour-every", "4",
           "--bcc", "incremental", "--chaos", "all", "--chaos-every", "4",
           "--audit-every", "4", "--sanitize", "--validate"]
    argv = cli + ["--trace-out", str(tmp / "trace.jsonl")]
    try:
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            _, counts = counted(lambda: serve_stream.main(argv))
        seconds = time.perf_counter() - t
        records = obs.read_jsonl(str(tmp / "trace.jsonl"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    events = [r for r in records if r["type"] == "event"]
    violations = [e for e in events if e["name"] == "audit_violation"]
    recoveries = [e for e in events if e["name"] == "recovery"]
    check(violations and recoveries, "cli: no audit_violation or recovery "
          "events in the trace")
    for e in violations:
        check(e["args"]["violations"] and e["args"]["n_violating"] > 0,
              f"cli: {e}")
    for e in recoveries:
        check(e["args"]["mode"] in ("scoped", "full", "refresh")
              and e["args"]["reason"] in ("scoped_repair",
                                          "sever_insufficient",
                                          "reaudit_failed", "caches_stale"),
              f"cli: {e}")
    text = out.getvalue()
    check("partition==from-scratch: True" in text, "cli: --validate")
    check(all(v == 0 for kk, v in counts.items() if kk not in HEAL_KERNELS),
          f"cli: launches {counts}")
    return ({"heal_cli": " ".join(cli),
             "audit_violations": len(violations),
             "recoveries": len(recoveries),
             "modes": sorted({e["args"]["mode"] for e in recoveries}),
             "seconds": seconds,
             "report": [ln for ln in text.splitlines()
                        if ln.startswith(("sustained", "chaos:",
                                          "final audit", "validate"))]},
            counts)


def fleet_lanes_equal(torch, fleet, twins, stats, seq, what) -> None:
    """Every lane of ``fleet`` bit-equal to its sequential twin: the state,
    the version and every per-lane stat."""
    for t, twin in enumerate(twins):
        lane = fleet.tenant(t)
        for f in DYN_STATE:
            check(torch.equal(getattr(lane, f), getattr(twin, f)),
                  f"{what}: lane {t} {f} differs from its sequential twin")
        check(lane.version == twin.version,
              f"{what}: lane {t} version {lane.version} != {twin.version}")
    if stats is not None:
        for k in DYN_STATS:
            mine = stats[k].tolist()
            want = [int(s[k]) for s in seq]
            check(mine == want, f"{what}: {k} {mine}, twins {want}")


def fleet_caches_equal(torch, tn, bcc, tables, tns, bccs, tabs, what):
    """The stacked numbering, BCC and tables, lane by lane, bit-equal to
    the sequential twins' single-tenant refreshes."""
    from repro_torch.dynamic.fleet import tenant_slice
    for t in range(len(tns)):
        for f in TOUR_FIELDS:
            check(torch.equal(getattr(tn, f)[t], getattr(tns[t], f)),
                  f"{what}: lane {t} tour {f} differs from its twin's")
        lane = tenant_slice(bcc, t)
        for f in DYN_BCC:
            check(torch.equal(getattr(lane, f), getattr(bccs[t], f)),
                  f"{what}: lane {t} BCC {f} differs from its twin's")
        for c in DYN_BCC_COUNTS:
            check(int(getattr(lane, c)) == int(getattr(bccs[t], c)),
                  f"{what}: lane {t} BCC {c} differs from its twin's")
        tab = tenant_slice(tables, t)
        for f in FLEET_TABLE_FIELDS:
            check(torch.equal(getattr(tab, f), getattr(tabs[t], f)),
                  f"{what}: lane {t} table {f} differs from its twin's")
        check(int(tab.build_syncs) == int(tabs[t].build_syncs),
              f"{what}: lane {t} build_syncs differs from its twin's")


def fleet_schema(torch, glabel, g_cpu, tenants, card, counted) -> dict:
    """Phase 5k a, one schema: ``tenants`` lanes of ``g_cpu``, each its own
    churn stream (seed t, as ``serve_fleet`` seeds tenants, B = 4,096 a
    tenant a tick), against the sequential twin, T separate
    ``replay_batch`` calls over the same streams.

    The main path, counted: ``init_state`` per tenant into ``fleet_empty``,
    5 ticks of ``apply_batches``, a full ``refresh_tours`` /
    ``refresh_bccs`` / ``build_fleet_tables``, then the measured 6th tick
    and incremental refreshes (table4's procedure). Every tick every lane
    is held bit-equal to its twin; after the refreshes the stacked caches
    to the twins' single-tenant refreshes. Then the 6th tick again from the
    same pre-state: host syncs per phase beside the ledger's, the plain
    path, 3 runs in turns (fleet, fleet with full refreshes, sequential),
    the re-rooting tables' share of a tick, and 2^20 query pairs through
    the ``FleetQuerySession`` on two lanes.
    """
    import numpy as np
    from repro_torch import dynamic, obs
    from repro_torch.core import queries as q
    from repro_torch.core import reroot
    from repro_torch.data import streams as stream_gen
    from repro_torch.dynamic import fleet as fl

    t_cfg = time.perf_counter()
    dev = torch.device("cuda")
    ss = [stream_gen.churn(g_cpu, batch=FLEET_BATCH,
                           n_batches=FLEET_N_BATCHES, seed=t)
          for t in range(tenants)]
    n = g_cpu.n_nodes
    cap = max(dynamic.stream_capacity(s) for s in ss)
    check(all(len(s.batches) == FLEET_N_BATCHES for s in ss),
          f"{glabel}: a stream has fewer than {FLEET_N_BATCHES} batches")
    blocks = [tuple(np.stack([getattr(s.batches[i], f) for s in ss])
                    for f in ("ins_u", "ins_v", "del_u", "del_v"))
              for i in range(FLEET_N_BATCHES)]
    gen_s = time.perf_counter() - t_cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = {}

    def on_path(fn):
        out, counts = counted(fn)
        for k, v in counts.items():
            got[k] = got.get(k, 0) + v
        return out

    def seeds():
        return [dynamic.init_state(s, cap, device=dev) for s in ss]

    twins = seeds()
    fleet = on_path(lambda: fl.fleet_empty(tenants, n, cap, device=dev))
    for t, s in enumerate(on_path(seeds)):
        fleet.set_tenant(t, s)
    fleet_lanes_equal(torch, fleet, twins, None, None, f"{glabel} seed")
    bill = {"fleet": 0, "sequential": 0}
    warm_rounds = []
    for i in range(FLEET_N_BATCHES - 1):
        fleet, stats = on_path(lambda: fl.apply_batches(fleet, *blocks[i]))
        seq = []
        for t, s in enumerate(ss):
            twins[t], st = dynamic.replay_batch(twins[t], s.batches[i])
            seq.append(st)
        fleet_lanes_equal(torch, fleet, twins, stats, seq,
                          f"{glabel} tick {i}")
        bill["fleet"] += fl.fleet_sync_cost(stats)
        bill["sequential"] += sum(st["rounds"] + 1 for st in seq)
        warm_rounds.append(stats["link_rounds"])
    tn, fleet = on_path(lambda: fl.refresh_tours(fleet, None))
    bcc = on_path(lambda: fl.refresh_bccs(fleet, None, tour=tn))
    on_path(lambda: fl.build_fleet_tables(tn))
    tns, bccs = [], []
    for t in range(tenants):
        tn_t, twins[t] = dynamic.refresh_tour_once(twins[t], None)
        tns.append(tn_t)
        bccs.append(dynamic.refresh_bcc_once(twins[t], None, tour=tn_t))

    # The measured tick through the main path, under a ledger each side.
    pre, tn0, bcc0 = fleet, tn, bcc
    pre_twins, tns0, bccs0 = list(twins), list(tns), list(bccs)
    blk = blocks[-1]
    with obs.SyncLedger() as led_f:
        f6, st6 = on_path(lambda: fl.apply_batches(pre, *blk))
        tn6, f6 = on_path(lambda: fl.refresh_tours(f6, tn0))
        bcc6 = on_path(lambda: fl.refresh_bccs(f6, bcc0, tour=tn6))
        tab6 = on_path(lambda: fl.build_fleet_tables(tn6))
    seq6, tns6, bccs6, tabs6, s6 = [], [], [], [], []
    with obs.SyncLedger() as led_s:
        for t, s in enumerate(ss):
            x, st = dynamic.replay_batch(pre_twins[t], s.batches[-1])
            seq6.append(st)
            tn_t, x = dynamic.refresh_tour_once(x, tns0[t])
            tns6.append(tn_t)
            bccs6.append(dynamic.refresh_bcc_once(x, bccs0[t], tour=tn_t))
            tabs6.append(q.build_tables(tn_t))
            s6.append(x)
    fleet_lanes_equal(torch, f6, s6, st6, seq6, f"{glabel} measured tick")
    fleet_caches_equal(torch, tn6, bcc6, tab6, tns6, bccs6, tabs6,
                       f"{glabel} measured tick")
    bill["fleet"] += fl.fleet_sync_cost(st6)
    bill["sequential"] += sum(st["rounds"] + 1 for st in seq6)
    ledger = {"fleet": led_f.totals(), "sequential": led_s.totals()}
    sync_total = {"fleet": led_f.total(), "sequential": led_s.total()}
    check(fl.fleet_sync_cost(st6) == int(st6["rounds"].max()) + 1
          == led_f.total("fleet_apply"),
          f"{glabel}: fleet_sync_cost {fl.fleet_sync_cost(st6)}, rounds "
          f"{st6['rounds'].tolist()}, ledger {led_f.totals()}")
    check(sync_total["fleet"] < sync_total["sequential"]
          and bill["fleet"] < bill["sequential"],
          f"{glabel}: fleet syncs {sync_total} {bill} not below sequential")

    # The measured tick again, phase by phase, counting host syncs.
    (fa, sta), h_apply = host_syncs(torch, lambda: fl.apply_batches(
        pre, *blk))
    (tna, fb), h_tour = host_syncs(torch, lambda: fl.refresh_tours(fa, tn0))
    bcca, h_bcc = host_syncs(torch, lambda: fl.refresh_bccs(
        fb, bcc0, tour=tna))
    taba, h_tab = host_syncs(torch, lambda: fl.build_fleet_tables(tna))
    h_seq = {"apply": [], "refresh_tour": 0, "refresh_bcc": 0,
             "build_tables": 0}
    for t, s in enumerate(ss):
        (x, _), h = host_syncs(torch, lambda: dynamic.replay_batch(
            pre_twins[t], s.batches[-1]))
        h_seq["apply"].append(h)
        (tn_t, x), h = host_syncs(torch, lambda: dynamic.refresh_tour_once(
            x, tns0[t]))
        h_seq["refresh_tour"] += h
        _, h = host_syncs(torch, lambda: dynamic.refresh_bcc_once(
            x, bccs0[t], tour=tn_t))
        h_seq["refresh_bcc"] += h
        _, h = host_syncs(torch, lambda: q.build_tables(tn_t))
        h_seq["build_tables"] += h
    # One read a round for all lanes: the tick's host syncs are those of
    # its slowest lane, not the lanes' sum.
    check(h_apply <= 2 * max(h_seq["apply"]) < sum(h_seq["apply"]),
          f"{glabel}: a fleet tick's host syncs {h_apply} against the "
          f"lanes' own {h_seq['apply']}")
    for f in DYN_STATE:
        check(torch.equal(getattr(fb, f), getattr(f6, f)),
              f"{glabel}: the measured tick's {f} differs between two runs")

    # The plain path from the same pre-state.
    pa, pst = fl.apply_batches(pre, *blk, use_kernel=False)
    ptn, pb = fl.refresh_tours(pa, tn0, use_kernel=False)
    pbcc = fl.refresh_bccs(pb, bcc0, tour=ptn, use_kernel=False)
    for f in DYN_STATE:
        check(torch.equal(getattr(pa, f), getattr(fa, f)),
              f"{glabel}: fleet {f} differs from the plain path")
    check(all(torch.equal(pst[k], sta[k]) for k in DYN_STATS),
          f"{glabel}: fleet stats differ from the plain path")
    for f in TOUR_FIELDS:
        check(torch.equal(getattr(ptn, f), getattr(tna, f)),
              f"{glabel}: fleet tour {f} differs from the plain path")
    for f in DYN_BCC + DYN_BCC_COUNTS:
        check(torch.equal(getattr(pbcc, f), getattr(bcca, f)),
              f"{glabel}: fleet BCC {f} differs from the plain path")
    del pa, pb, pst, ptn, pbcc, fa, fb, tna, bcca, taba

    # Times in turns, each run from the same pre-states.
    def ms_since(t):
        torch.cuda.synchronize()
        now = time.perf_counter()
        return (now - t) * 1e3, now

    def run_fleet():
        torch.cuda.synchronize()
        t = time.perf_counter()
        f, _ = fl.apply_batches(pre, *blk)
        tick, t = ms_since(t)
        tnx, f = fl.refresh_tours(f, tn0)
        tour, t = ms_since(t)
        fl.refresh_bccs(f, bcc0, tour=tnx)
        bcc_ms, t = ms_since(t)
        fl.build_fleet_tables(tnx)
        tables, _ = ms_since(t)
        return {"tick": tick, "tour": tour, "bcc": bcc_ms, "tables": tables}

    def run_fleet_full():
        torch.cuda.synchronize()
        t = time.perf_counter()
        f, _ = fl.apply_batches(pre, *blk)
        tick, t = ms_since(t)
        tnx, f = fl.refresh_tours(f, None)
        tour, t = ms_since(t)
        fl.refresh_bccs(f, None, tour=tnx)
        bcc_ms, _ = ms_since(t)
        return {"tick": tick, "tour": tour, "bcc": bcc_ms}

    def run_seq():
        torch.cuda.synchronize()
        t = time.perf_counter()
        xs = [dynamic.replay_batch(pre_twins[i], s.batches[-1])[0]
              for i, s in enumerate(ss)]
        tick, t = ms_since(t)
        tx = []
        for i in range(tenants):
            tn_i, xs[i] = dynamic.refresh_tour_once(xs[i], tns0[i])
            tx.append(tn_i)
        tour, t = ms_since(t)
        for i in range(tenants):
            dynamic.refresh_bcc_once(xs[i], bccs0[i], tour=tx[i])
        bcc_ms, t = ms_since(t)
        for i in range(tenants):
            q.build_tables(tx[i])
        tables, _ = ms_since(t)
        return {"tick": tick, "tour": tour, "bcc": bcc_ms, "tables": tables}

    runs = {"fleet": run_fleet, "fleet_full": run_fleet_full,
            "sequential": run_seq}
    times = {name: [] for name in runs}
    order = list(runs)
    for r in range(FLEET_RUNS):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(runs[name]())
    med = {name: {k: statistics.median(t[k] for t in ts) for k in ts[0]}
           for name, ts in times.items()}

    # The re-rooting tables' share of a tick (one instrumented run).
    spent = []
    real_tables = reroot.ancestor_tables

    def timed_tables(p, levels):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_tables(p, levels)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    reroot.ancestor_tables = timed_tables
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fl.apply_batches(pre, *blk)
        torch.cuda.synchronize()
        instr_ms = (time.perf_counter() - t) * 1e3
    finally:
        reroot.ancestor_tables = real_tables
    tables_share = sum(spent) * 1e3 / instr_ms

    # Reads: 2^20 seeded pairs on two lanes, against the twins' tables.
    gen = torch.Generator(device=dev).manual_seed(7)
    u = torch.randint(0, n, (FLEET_QUERY_PAIRS,), generator=gen,
                      device=dev, dtype=torch.int32)
    v = torch.randint(0, n, (FLEET_QUERY_PAIRS,), generator=gen,
                      device=dev, dtype=torch.int32)
    sess = on_path(lambda: fl.FleetQuerySession.from_fleet(
        f6, tn6, bcc6, policy="strict"))
    queries = {}
    for t in (0, tenants - 1):
        for op in ("lca", "connected"):
            mine = getattr(sess, op)(f6, t, u, v)
            want = getattr(q, op)(tabs6[t], u, v)
            check(torch.equal(mine, want),
                  f"{glabel}: lane {t} {op} differs from its twin's tables")
    for op in ("lca", "connected"):
        queries[f"{op}_ms"] = cuda_ms(
            torch, lambda: getattr(sess, op)(f6, tenants - 1, u, v))
    queries["pairs"] = FLEET_QUERY_PAIRS
    queries["build_syncs"] = tab6.build_syncs.tolist()

    check(all(got.get(k, 0) > 0 for k in FLEET_KERNELS)
          and all(v_ == 0 for k, v_ in got.items()
                  if k not in FLEET_KERNELS),
          f"{glabel}: fleet launches {got}")
    applied = int(sum(int(st6["deletes_found"][t]) - int(st6["overflow"][t])
                      + int(((blk[0][t] < n) & (blk[0][t] != blk[1][t])
                             ).sum()) for t in range(tenants)))
    fm, sm = med["fleet"], med["sequential"]
    line = {"fleet": glabel, "card": card, "tenants": tenants, "n": n,
            "union_n": tenants * n, "capacity": cap,
            "union_capacity": tenants * cap, "batch": FLEET_BATCH,
            "events": int(sum((b < n).sum() for b in (blk[0], blk[2]))),
            "applied": applied, "rounds": st6["rounds"].tolist(),
            "link_rounds": st6["link_rounds"], "warm_link_rounds":
                warm_rounds,
            "tick_ms": fm["tick"], "seq_tick_ms": sm["tick"],
            "tour_ms": fm["tour"], "tour_full_ms": med["fleet_full"]["tour"],
            "seq_tour_ms": sm["tour"],
            "bcc_ms": fm["bcc"], "bcc_full_ms": med["fleet_full"]["bcc"],
            "seq_bcc_ms": sm["bcc"],
            "tables_ms": fm["tables"], "seq_tables_ms": sm["tables"],
            "runs": FLEET_RUNS, "times": times,
            "updates_per_s": applied / (fm["tick"] / 1e3),
            "seq_updates_per_s": applied / (sm["tick"] / 1e3),
            "ledger_syncs": ledger, "sync_total": sync_total,
            "run_apply_syncs": bill,
            "host_syncs": {"fleet": {"apply": h_apply, "refresh_tour": h_tour,
                                     "refresh_bcc": h_bcc,
                                     "build_tables": h_tab},
                           "sequential": h_seq},
            "reroot_tables_share": tables_share,
            "reroot_tables_ms": sum(spent) * 1e3,
            "instrumented_tick_ms": instr_ms,
            "n_bcc": bcc6.n_bcc.tolist()[:4], "queries": queries,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": got, "stream_gen_s": gen_s,
            "checks": {"lanes_equal_twins": True, "caches_equal_twins": True,
                       "kernel_equals_plain": True,
                       "fleet_syncs_below_sequential": True,
                       "host_syncs_of_the_slowest_lane": True}}
    line["seconds"] = time.perf_counter() - t_cfg
    del fleet, pre, f6, twins, pre_twins, s6, tns, bccs, tns6, bccs6, tabs6
    del tn, bcc, tn0, bcc0, tn6, bcc6, tab6, sess
    torch.cuda.empty_cache()
    return line


def fleet_buckets(torch, g_grid, g_rmat, card, counted) -> dict:
    """Phase 5k b: a ``BucketedFleet`` with both schemas as two buckets,
    20 grid tenants over 16 slots and 40 rmat tenants over 32, ``max_drain``
    2, tours every 2, two waves of 2 units a tenant (the second offered
    once the first has drained, so evicted tenants come back through the
    async prefetch). Every tenant, evicted and re-admitted or not, is
    then held bit-identical to a twin that replayed the same units, and its
    partition to a from-scratch rebuild and to scipy's components."""
    import shutil
    import tempfile
    import numpy as np
    import scipy.sparse
    import scipy.sparse.csgraph
    from repro_torch import dynamic
    from repro_torch.core import rooted_spanning_tree
    from repro_torch.data import streams as stream_gen
    from repro_torch.dynamic import fleet as fl
    from repro_torch.dynamic.view import CadencePolicy

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    root = pathlib.Path(ROOT / "build")
    root.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="fleet-buckets-", dir=root))
    saves, restores = [], []
    real_save, real_restore = fl.ckpt.save, fl.ckpt.restore

    def timed(fn, out):
        def call(*a, **k):
            t = time.perf_counter()
            res = fn(*a, **k)
            out.append((time.perf_counter() - t) * 1e3)
            return res
        return call

    groups = []
    bf = fl.BucketedFleet(tmp, max_drain=2, device=dev)
    try:
        fl.ckpt.save = timed(real_save, saves)
        fl.ckpt.restore = timed(real_restore, restores)
        for name, g, tenants, slots in (("grid", g_grid, 20, 16),
                                        ("rmat", g_rmat, 40, 32)):
            ss = [stream_gen.churn(g, batch=FLEET_BATCH, n_batches=4,
                                   seed=t) for t in range(tenants)]
            cap = max(dynamic.stream_capacity(s) for s in ss)
            schema = fl.FleetSchema(g.n_nodes, cap, FLEET_BATCH)
            bf.add_bucket(schema, slots, name=name,
                          cadence=CadencePolicy(tour="incremental",
                                                every=2))
            for j, s in enumerate(ss):
                bf.route(f"{name}.{j}", schema,
                         seed=dynamic.init_state(s, cap, device=dev))
            groups.append((name, ss, cap))
        steps, idle = 0, 0

        def serve():
            # Two waves of 2 units a tenant, the second offered once the
            # first has drained, so evicted tenants come back through the
            # prefetch. A step that serves nothing only waits for in-flight
            # restores (``BucketedFleet.run`` spins the same way).
            nonlocal steps, idle
            for wave in (slice(0, 2), slice(2, 4)):
                for name, ss, _ in groups:
                    for j, s in enumerate(ss):
                        for unit in s.batches[wave]:
                            bf.offer(f"{name}.{j}", unit)
                while bf.pending():
                    if bf.step(steps):
                        steps += 1
                    else:
                        idle += 1
            bf.finalize()

        _, launches = counted(serve)
        serve_s = time.perf_counter() - t0
    finally:
        fl.ckpt.save, fl.ckpt.restore = real_save, real_restore
    ckpt_mb = sum(f.stat().st_size for f in tmp.rglob("*")
                  if f.is_file()) / 1e6
    buckets = {}
    for b in bf.buckets.values():
        m = b.manager
        buckets[b.name] = {
            "slots": m.fleet.n_slots, "tenants": len(b.tenants),
            "ticks": b.ticks, "blocks": b.blocks,
            "sync_apply": b.sync_apply, "sync_refresh": b.sync_refresh,
            "padded_rows": b.padded_rows, "padded_events": b.padded_events,
            "admissions": m.admissions, "evictions": m.evictions,
            "restores": m.restores, "prefetches": m.prefetches,
            "max_backlog": b.max_backlog}
        check(m.evictions > 0 and m.restores > 0 and m.prefetches > 0,
              f"buckets: {b.name} never evicted, restored or prefetched: "
              f"{buckets[b.name]}")

    # Every tenant against its twin, its rebuild and scipy.
    for name, ss, cap in groups:
        mgr = bf.buckets[name].manager
        for j, s in enumerate(ss):
            tid = f"{name}.{j}"
            check(mgr.cursors[tid] == 4, f"buckets: {tid} applied "
                  f"{mgr.cursors[tid]} units of 4")
            twin = dynamic.init_state(s, cap, device=dev)
            for unit in s.batches[:4]:
                twin, _ = dynamic.replay_batch(twin, unit)
            f = bf.tenant_forest(tid)
            for fld in ("parent", "rep", "pool_src", "pool_dst",
                        "pool_valid", "tree_mask"):
                check(torch.equal(getattr(f, fld), getattr(twin, fld)),
                      f"buckets: {tid} {fld} differs from its twin")
            live = dynamic.live_graph(f)
            res = rooted_spanning_tree(live, int(f.rep[0]), "gconn_euler")
            check(same_partition(torch, res.rep, f.rep),
                  f"buckets: {tid} differs from a from-scratch rebuild")
            valid = f.pool_valid
            pu = f.pool_src[valid].cpu().numpy()
            pv = f.pool_dst[valid].cpu().numpy()
            adj = scipy.sparse.coo_matrix(
                (np.ones(pu.size, np.int8), (pu, pv)),
                shape=(f.n_nodes, f.n_nodes))
            _, labels = scipy.sparse.csgraph.connected_components(
                adj, directed=False)
            check(same_partition(torch, torch.from_numpy(labels).to(dev),
                                 f.rep),
                  f"buckets: {tid} differs from scipy's components")
    bf.close()
    shutil.rmtree(tmp, ignore_errors=True)
    check(all(launches.get(k, 0) > 0 for k in FLEET_KERNELS[:2]),
          f"buckets: launches {launches}")
    return ({"fleet_buckets": "grid 20/16 + rmat 40/32, drain 2",
             "card": card, "steps": steps, "idle_steps": idle,
             "serve_s": serve_s,
             "sync_total": bf.sync_total(),
             "applied": bf.applied_events(),
             "padded_rows": bf.padded_rows(), "buckets": buckets,
             "checkpoint_mb": ckpt_mb,
             "save_ms": statistics.median(saves) if saves else None,
             "restore_ms": statistics.median(restores) if restores
             else None, "saves": len(saves), "restore_calls": len(restores),
             "launches": {k: v for k, v in launches.items() if v},
             "seconds": time.perf_counter() - t0,
             "checks": {"tenants_equal_twins": True,
                        "partition_equals_rebuild_and_scipy": True}},
            launches)


def fleet_cli(torch, counted) -> tuple:
    """Phase 5k c: ``serve_fleet.main`` on the card with the README's flat
    drive and with its bucketed drive; every tenant's
    ``partition==from-scratch`` must be True."""
    import contextlib
    import io
    import shutil
    import tempfile
    from repro_torch.launch import serve_fleet
    root = pathlib.Path(ROOT / "build")
    root.mkdir(parents=True, exist_ok=True)
    lines, total = [], {}
    for cli, tenants in FLEET_CLI:
        tmp = pathlib.Path(tempfile.mkdtemp(prefix="fleet-cli-", dir=root))
        out = io.StringIO()
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                _, counts = counted(lambda: serve_fleet.main(
                    cli.split() + ["--evict-dir", str(tmp)]))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        seconds = time.perf_counter() - t
        text = out.getvalue()
        check(text.count("partition==from-scratch: True") == tenants
              and "partition==from-scratch: False" not in text,
              f"fleet cli {cli!r}: --validate")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        lines.append({"fleet_cli": cli, "seconds": seconds,
                      "report": [ln for ln in text.splitlines()
                                 if ln.startswith(("fleet:", "admission",
                                                   "sync accounting",
                                                   "bucket "))],
                      "launches": {k: v for k, v in counts.items() if v}})
    return lines, total


def fleet_smoke_counts(torch, counted) -> tuple:
    """Phase 5k d: the 8 table8_fleet and 2 table9_buckets smoke rows of
    BENCH_rst.json by the benchmarks' procedures on the card, every
    sync_total (and table9's padded_rows) equal."""
    import tempfile
    import numpy as np
    from repro_torch import dynamic, obs
    from repro_torch.data import graphs, streams as stream_gen
    from repro_torch.dynamic import fleet as fl
    from repro_torch.dynamic.view import CadencePolicy
    dev = torch.device("cuda")
    rows = bench_rows("table8_fleet/")
    rows.update(bench_rows("table9_buckets/"))
    check(len(rows) == 10, f"{len(rows)} table8/table9 rows, want 10")
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    for glabel, g in (("smoke_chain_256", graphs.chain(256, device="cpu")),
                      ("smoke_rmat_6", graphs.rmat(6, edge_factor=4, seed=0,
                                                   device="cpu"))):
        for kind in ("churn", "sliding_window"):
            def pair():
                ss = [stream_gen.STREAMS[kind](g, batch=16, n_batches=6,
                                               seed=t) for t in range(4)]
                steps = min(6, min(len(s.batches) for s in ss))
                cap = max(dynamic.stream_capacity(s) for s in ss)
                fleet = fl.fleet_empty(4, g.n_nodes, cap, device=dev)
                for t, s in enumerate(ss):
                    fleet.set_tenant(t, dynamic.init_state(s, cap,
                                                           device=dev))
                tn = None
                with obs.SyncLedger() as led:
                    for i in range(steps):
                        blk = tuple(np.stack([getattr(s.batches[i], f)
                                              for s in ss])
                                    for f in ("ins_u", "ins_v", "del_u",
                                              "del_v"))
                        fleet, _ = fl.apply_batches(fleet, *blk)
                        if (i + 1) % 2 == 0:
                            tn, fleet = fl.refresh_tours(fleet, tn)
                    fl.refresh_tours(fleet, tn)
                states = [dynamic.init_state(s, cap, device=dev)
                          for s in ss]
                tns = [None] * 4
                with obs.SyncLedger() as led_s:
                    for i in range(steps):
                        for t, s in enumerate(ss):
                            states[t], _ = dynamic.replay_batch(
                                states[t], s.batches[i])
                            if (i + 1) % 2 == 0:
                                tns[t], states[t] = dynamic.refresh_tour(
                                    states[t], tns[t])
                    for t in range(4):
                        dynamic.refresh_tour(states[t], tns[t])
                fleet_lanes_equal(torch, fleet, states, None, None,
                                  f"table8 {glabel}/{kind}")
                return led.total("fleet_apply"), led_s.total("apply")

            (f_sync, s_sync), counts = counted(pair)
            add(counts)
            base = f"table8_fleet/{glabel}/{kind}/T4/b16"
            check(str(f_sync) == rows[f"{base}/fleet"]["sync_total"]
                  and str(s_sync) == rows[f"{base}/sequential"]["sync_total"],
                  f"{base}: {f_sync} / {s_sync}")

    # table9: the smoke mix, bucketed and single-schema.
    mix = (("chain_64", 8, 4, 8, 6), ("rmat_8", 2, 2, 32, 3))
    cadence = CadencePolicy(tour="full", bcc="off", every=2, queries=False)

    def table9():
        groups, seed = [], 0
        for graph, tenants, slots, batch, units in mix:
            g = graphs.resolve_graph(graph, device="cpu")
            ss = []
            for _ in range(tenants):
                ss.append(stream_gen.churn(g, batch=batch, n_batches=units,
                                           seed=seed))
                seed += 1
            units = min(units, min(len(s.batches) for s in ss))
            cap = max(dynamic.stream_capacity(s) for s in ss)
            groups.append((graph, ss, units, min(slots, tenants),
                           fl.FleetSchema(g.n_nodes, cap, batch)))
        out = {}
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            bucketed = fl.BucketedFleet(pathlib.Path(tmp) / "b", device=dev)
            for graph, ss, units, slots, schema in groups:
                bucketed.add_bucket(schema, slots, cadence=cadence,
                                    name=graph)
                for j, s in enumerate(ss):
                    bucketed.route(f"{graph}.{j}", schema,
                                   seed=dynamic.init_state(
                                       s, schema.capacity, device=dev))
                    for unit in s.batches[:units]:
                        bucketed.offer(f"{graph}.{j}", unit)
            bucketed.run()
            bucketed.finalize()
            out["bucketed"] = (bucketed.sync_total(),
                               bucketed.padded_rows())
            bucketed.close()
            wide = fl.FleetSchema(max(x[4].n_nodes for x in groups),
                                  max(x[4].capacity for x in groups),
                                  max(x[4].batch for x in groups))
            total_t = sum(len(x[1]) for x in groups)
            budget = sum(x[3] * x[4].slot_cost for x in groups)
            single = fl.BucketedFleet(pathlib.Path(tmp) / "s", device=dev)
            single.add_bucket(wide, min(total_t, max(
                1, budget // wide.slot_cost)), cadence=cadence,
                name="single")
            for graph, ss, units, slots, schema in groups:
                for j, s in enumerate(ss):
                    seed_f = dynamic.forest_empty(wide.n_nodes,
                                                  wide.capacity, device=dev)
                    seed_f, _ = dynamic.apply_batch(
                        seed_f, torch.from_numpy(s.init_u).to(dev),
                        torch.from_numpy(s.init_v).to(dev),
                        torch.zeros(wide.capacity, dtype=torch.bool,
                                    device=dev))
                    single.route(f"{graph}.{j}", wide, seed=seed_f)
                    for unit in s.batches[:units]:
                        def pad(a):
                            o = np.full(wide.batch, wide.n_nodes, np.int32)
                            o[:a.shape[0]] = np.where(
                                a == schema.n_nodes, wide.n_nodes, a)
                            return o
                        single.offer(f"{graph}.{j}", type(unit)(
                            pad(unit.ins_u), pad(unit.ins_v),
                            pad(unit.del_u), pad(unit.del_v)))
            single.run()
            single.finalize()
            out["single_schema"] = (single.sync_total(),
                                    single.padded_rows())
            single.close()
        return out

    got, counts = counted(table9)
    add(counts)
    for side, (sync, padded) in got.items():
        want = rows[f"table9_buckets/8xchain_64+2xrmat_8/T10/{side}"]
        check((str(sync), str(padded)) == (want["sync_total"],
                                           want["padded_rows"]),
              f"table9 {side}: {sync} / {padded}, want {want}")
    return {"phase": "fleet smoke", "rows": len(rows),
            "table9": {k: list(v) for k, v in got.items()}}, total


def fleet_bcc_batch(torch, card, counted) -> tuple:
    """Phase 5k e: ``bcc_batch`` over B = 16 relabelled grid2d(256) graphs
    as one union program, against B separate ``biconnectivity`` calls and
    its plain path; launches and times of both."""
    import numpy as np
    from repro_torch.core import Graph, bcc_batch, biconnectivity
    from repro_torch.data import graphs
    dev = torch.device("cuda")
    b, side = BCC_BATCH
    n = side * side
    g = graphs.grid2d(side, device="cpu")
    rng = np.random.default_rng(0)
    perms = [torch.from_numpy(rng.permutation(n).astype(np.int32))
             for _ in range(b)]
    src = torch.stack([p[g.src.long()] for p in perms]).to(dev)
    dst = torch.stack([p[g.dst.long()] for p in perms]).to(dev)
    roots = torch.from_numpy(rng.integers(0, n, b).astype(np.int32))
    union, c_union = counted(lambda: bcc_batch(src, dst, roots, n_nodes=n,
                                               device=dev))
    singles, c_single = counted(lambda: [
        biconnectivity(Graph(n, src[i], dst[i]), int(roots[i]), device=dev)
        for i in range(b)])
    plain = bcc_batch(src, dst, roots, n_nodes=n, use_kernel=False,
                      device=dev)
    for f in BCC_FIELDS + BCC_COUNTS:
        check(torch.equal(getattr(union, f), getattr(plain, f)),
              f"bcc_batch: {f} differs from its plain path")
        for i, one in enumerate(singles):
            mine = getattr(union, f)[i]
            want = getattr(one, f)
            check(torch.equal(mine, want) if isinstance(want, torch.Tensor)
                  else int(mine) == int(want),
                  f"bcc_batch: graph {i} {f} differs from its own call")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    runs = {"union": lambda: bcc_batch(src, dst, roots, n_nodes=n,
                                       device=dev),
            "separate": lambda: [biconnectivity(
                Graph(n, src[i], dst[i]), int(roots[i]), device=dev)
                for i in range(b)]}
    times = {k: [] for k in runs}
    for r in range(FLEET_RUNS):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[k].append(timed(runs[k]))
    return ({"bcc_batch": f"{b} x grid2d({side})", "card": card,
             "union_ms": statistics.median(times["union"]),
             "separate_ms": statistics.median(times["separate"]),
             "launches_union": {k: v for k, v in c_union.items() if v},
             "launches_separate": {k: v for k, v in c_single.items() if v},
             "rst_steps": union.rst_steps.tolist(),
             "aux_rounds": union.aux_rounds.tolist()},
            c_union, c_single)


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@contextlib.contextmanager
def deterministic(torch):
    """torch's deterministic algorithms (warnings only) inside the block;
    yields the list of distinct warnings it raised."""
    import warnings
    seen = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield seen
        finally:
            torch.use_deterministic_algorithms(False)
            seen += sorted({str(w.message)[:120] for w in caught})


def gnn_loss_and_grads(torch, arch, cfg, params, batch, shape):
    """One step's loss (``gnn_loss``) and every gradient, by name."""
    from repro_torch.models.gnn import GraphBatch
    from repro_torch.train.step import gnn_loss
    g = GraphBatch(n_nodes=shape["n_nodes"], n_graphs=shape["n_graphs"],
                   **batch["graph"])
    names, leaves = zip(*params.named_parameters())
    loss = gnn_loss(arch, cfg, params, g, batch["labels"])
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))


def gnn_float64(torch, arch, cfg, params, batch, shape):
    """``gnn_loss_and_grads`` in float64 (parameters and float inputs
    cast): the exact answer's stand-in, against which each float32
    result's rounding is read."""
    from repro_torch.models.gnn import GNNParams

    def f64(t):
        return t.double() if t.is_floating_point() else t
    p = GNNParams.from_named({k: t.detach().double()
                              for k, t in params.named_parameters()})
    p.requires_grad_()
    batch = {"graph": {k: f64(v) for k, v in batch["graph"].items()},
             "labels": f64(batch["labels"])}
    return gnn_loss_and_grads(torch, arch,
                              dataclasses.replace(cfg, dtype=torch.float64),
                              p, batch, shape)


def worst_scaled(got: dict, want: dict) -> float:
    """max over the leaves of max |got - want| / max |want| (leaves below
    GNN_ZERO_GRAD skipped)."""
    return max((float((got[k].detach().cpu().double() - w.cpu()).abs().max())
                / float(w.abs().max()) for k, w in want.items()
                if float(w.abs().max()) >= GNN_ZERO_GRAD), default=0.0)


def gnn_state_on(torch, params, dev) -> dict:
    """A fresh train state on ``dev`` holding ``params``' values."""
    from repro_torch.models.gnn import GNNParams
    from repro_torch.optim import adamw_init
    p = GNNParams.from_named({k: t.detach().to(dev)
                              for k, t in params.named_parameters()})
    p.requires_grad_()
    return {"params": p, "opt": adamw_init(dict(p.named_parameters()))}


def gnn_grads_close(torch, got: dict, want: dict, what, tol) -> tuple:
    """Every gradient within ``tol`` of its own largest value (the
    full configs' gradients reach 1e3 where a graph's energy sums
    thousands of nodes, so an entry near 0 carries its leaf's rounding). A
    gradient that is 0 in exact arithmetic, below GNN_ZERO_GRAD everywhere
    on the CPU, is held below it on the card too: GAT's a_dst (a constant
    per softmax group), and GAT's a_src and a_dst where every node has at
    most one incoming edge (minibatch_lg's graph: one direction of its
    tree, so every softmax is over one score). Returns (max abs
    difference, max scaled difference, the zero leaves)."""
    check(set(got) == set(want), f"{what}: gradient names differ")
    worst_abs = worst_scaled = 0.0
    zero = []
    for k, w in want.items():
        g = got[k].detach().cpu()
        if float(w.abs().max()) < GNN_ZERO_GRAD:
            check(float(g.abs().max()) < GNN_ZERO_GRAD,
                  f"{what} {k}: 0 on the CPU, {float(g.abs().max())} here")
            zero.append(k)
            continue
        worst_abs = max(worst_abs, float((g - w).abs().max()))
        worst_scaled = max(worst_scaled, scaled_err(
            torch, g, w.detach(), tol, f"{what} {k} (scaled)"))
    return worst_abs, worst_scaled, zero


def gnn_cell(torch, arch, shape_name, card, counted, profile=None) -> tuple:
    """Phase 5l a: one GNN cell at the full config on the card through
    ``build_cell`` and ``FaultTolerantLoop``; returns its line and the
    kernel launches of its measured run (none: the GNNs' message passing is
    torch ops). ``profile(what, fn)``, where given, profiles one step at
    minibatch_lg."""
    import shutil
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import FaultTolerantLoop
    from repro_torch.train.step import build_cell, gnn_cell_config
    dev = torch.device("cuda")
    label = f"{arch}/{shape_name}"
    spec = get_arch(arch)
    shape = spec.shapes[shape_name]
    cfg = gnn_cell_config(arch, spec.make_config(), shape)
    t0 = time.perf_counter()
    batches = [b for _, b in itertools.islice(
        synthetic_batches(spec, shape, cfg, device=dev), GNN_STEPS)]
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    step_fn, _, _ = build_cell(spec, shape_name)
    _, state_cpu, _ = build_cell(spec, shape_name, device="cpu")
    state0 = gnn_state_on(torch, state_cpu["params"], dev)

    # Step 1's loss and gradients: the card against the CPU, the same
    # parameters and batch.
    batch_cpu = {"graph": {k: v.cpu() for k, v in batches[0]["graph"].items()},
                 "labels": batches[0]["labels"].cpu()}
    t0 = time.perf_counter()
    loss_cpu, grads_cpu = gnn_loss_and_grads(
        torch, arch, cfg, state_cpu["params"], batch_cpu, shape)
    cpu_s = time.perf_counter() - t0
    loss_gpu, grads_gpu = gnn_loss_and_grads(
        torch, arch, cfg, state0["params"], batches[0], shape)
    check(bool(torch.isfinite(loss_gpu)), f"{label}: loss not finite")
    # The loss sums the whole batch (SchNet's and DimeNet's energies sum
    # every node into its graph's, 2,720 or 172,032 nodes into one), so
    # it is held, as the gradients are, to its own scale.
    tol = GNN_SCALED_TOL_BY_ARCH.get(arch, GNN_SCALED_TOL)
    loss_err = scaled_err(torch, loss_gpu.cpu(), loss_cpu, tol,
                          f"{label}: loss against the CPU")
    grad_abs, grad_scaled, zero_grads = gnn_grads_close(
        torch, grads_gpu, grads_cpu, f"{label}: gradient", tol)
    # Each float32 result's own rounding, read against float64 on the card.
    _, grads_64 = gnn_float64(torch, arch, cfg, state0["params"], batches[0],
                              shape)
    rounding = {"card_float32": worst_scaled(grads_gpu, grads_64),
                "cpu_float32": worst_scaled(grads_cpu, grads_64)}
    n_params = sum(t.numel() for t in grads_cpu.values())
    del grads_cpu, grads_gpu, grads_64, state_cpu, batch_cpu

    root = ROOT / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="gnn-", dir=root))
    try:
        # The measured run: GNN_STEPS steps, a checkpoint every
        # GNN_CKPT_EVERY (written in the background).
        times, losses = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loop = FaultTolerantLoop(step_fn=step_fn, state=state0,
                                 data_iter=iter(list(enumerate(batches))),
                                 ckpt_dir=tmp / "run",
                                 ckpt_every=GNN_CKPT_EVERY)
        _, counts = counted(lambda: loop.run(
            GNN_STEPS, on_metrics=lambda s, m, dt: (times.append(dt),
                                                    losses.append(m["loss"]))))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(loop.step == GNN_STEPS and loop.retries == 0,
              f"{label}: {loop.step} steps, {loop.retries} retries")
        losses = [float(x) for x in losses]
        check(all(map(math.isfinite, losses)), f"{label}: losses {losses}")
        if profile is not None and shape_name == "minibatch_lg":
            profile(f"{label} train step",
                    lambda: step_fn(loop.state, batches[-1]))
        ckpt_mb = dir_mb(tmp / "run" / f"step_{GNN_CKPT_EVERY:010d}")
        t0 = time.perf_counter()
        ckpt.save(tmp / "save", loop.state, GNN_STEPS)
        save_ms = (time.perf_counter() - t0) * 1e3

        # Killed after GNN_KILL steps, resumed from the checkpoint at
        # GNN_CKPT_EVERY, replaying the cursor, against an uninterrupted
        # run: all three in torch's deterministic mode, since the
        # scatter-adds' atomics otherwise order their sums anew each run
        # and Adam turns the rounding of a gradient that is 0 in exact
        # arithmetic (GAT's a_dst at init) into a step of up to lr.
        def run(name, n, start=0):
            loop = FaultTolerantLoop(
                step_fn=step_fn, state=state0,
                data_iter=iter(list(enumerate(batches))[start:]),
                ckpt_dir=tmp / name, ckpt_every=GNN_CKPT_EVERY)
            if start:
                check(loop.resume() == start, f"{label}: resume step")
            loop.run(n)
            return loop

        with deterministic(torch) as det_warnings:
            base = run("base", GNN_STEPS)
            run("kill", GNN_KILL)
            heir = run("kill", GNN_STEPS, start=GNN_CKPT_EVERY)
        check(heir.step == GNN_STEPS
              and int(heir.state["opt"]["step"]) == GNN_STEPS,
              f"{label}: resumed run ended at {heir.step}")
        want = dict(base.state["params"].named_parameters())
        pairs = [(p.detach(), want[k].detach(), f"parameter {k}")
                 for k, p in heir.state["params"].named_parameters()]
        pairs += [(t, base.state["opt"][part][k], f"{part} {k}")
                  for part in ("m", "v")
                  for k, t in heir.state["opt"][part].items()]
        resume_err = max(allclose_err(torch, a, b, GNN_TOL,
                                      f"{label}: resumed {what}")
                         for a, b, what in pairs)
        resume_bit_equal = all(torch.equal(a, b) for a, b, _ in pairs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    step_s = statistics.median(times[1:])
    n_trip = (int(batches[0]["graph"]["trip_in"].numel())
              if "trip_in" in batches[0]["graph"] else 0)
    return ({"gnn": label, "card": card, "n_nodes": shape["n_nodes"],
             "n_edges": shape["n_edges"], "n_triplets": n_trip,
             "params": n_params, "steps": GNN_STEPS,
             "step_ms": step_s * 1e3,
             "step_ms_all": [t * 1e3 for t in times],
             "nodes_per_s": shape["n_nodes"] / step_s,
             "edges_per_s": shape["n_edges"] / step_s,
             "loss_first": losses[0], "loss_last": losses[-1],
             "peak_gb": peak_gb, "ckpt_mb": ckpt_mb, "save_ms": save_ms,
             "data_s": data_s, "cpu_grad_s": cpu_s,
             "loss_cpu": float(loss_cpu), "loss_vs_cpu_scaled": loss_err,
             "scaled_tol": tol,
             "grad_vs_cpu_max_abs": grad_abs,
             "grad_vs_cpu_max_scaled": grad_scaled,
             "zero_grad_leaves": zero_grads,
             "grad_vs_float64_scaled": rounding,
             "resume_vs_uninterrupted_max_abs": resume_err,
             "resume_bit_equal": resume_bit_equal,
             "deterministic_warnings": det_warnings,
             "launches": {k: v for k, v in counts.items() if v},
             "checks": {"step1_vs_cpu": True, "kill_resume": True}},
            counts)


def gnn_meta(torch, arch) -> dict:
    """Phase 5l a: the ogb_products cell, built on meta: its state's and
    inputs' bytes."""
    from repro_torch.configs import get_arch
    from repro_torch.train.step import build_cell
    _, state, inputs = build_cell(get_arch(arch), GNN_META_SHAPE)
    params = list(state["params"].parameters())
    opt = [t for part in ("m", "v", "master")
           for t in state["opt"][part].values()] + [state["opt"]["step"]]
    check(all(t.device.type == "meta" for t in
              (*params, *opt, *inputs["graph"].values(), inputs["labels"])),
          f"{arch}/{GNN_META_SHAPE}: a tensor off the meta device")
    return {"gnn_meta": f"{arch}/{GNN_META_SHAPE}", "device": "meta",
            "params": sum(p.numel() for p in params),
            "params_gb": tensor_bytes(params) / 1e9,
            "state_gb": tensor_bytes([*params, *opt]) / 1e9,
            "inputs_gb": tensor_bytes([*inputs["graph"].values(),
                                       inputs["labels"]]) / 1e9,
            "inputs": {k: list(v.shape) for k, v in inputs["graph"].items()}}


def gnn_reorder(torch, card, counted, profile=None) -> tuple:
    """Phase 5l b: ``reorder_by_rst`` on rmat(19, edge_factor=16) (the
    paper's pipeline in the GNN data path: hook_edges, pointer_jump_double
    and list_rank_double), the permutation against the plain path; then
    the full GAT (d_in 100, ogb_products' feature width) on the graph in
    its original order and in RST order: the same loss, step times in
    turns."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.data import graphs
    from repro_torch.data.gnn_batch import reorder_by_rst
    from repro_torch.train.step import gnn_cell_config, gnn_train_cell
    dev = torch.device("cuda")
    g = graphs.rmat(REORDER_SCALE, edge_factor=16, device="cpu")
    n, m2 = g.n_nodes, g.n_half_edges
    src, dst = g.src.numpy(), g.dst.numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    perm, counts = counted(lambda: reorder_by_rst(src, dst, n))
    reorder_ms = (time.perf_counter() - t0) * 1e3
    check(all(counts[k] > 0 for k in ("hook_edges", "pointer_jump_double",
                                      "list_rank_double")),
          f"reorder_by_rst launched {counts}")
    plain = reorder_by_rst(src, dst, n, use_kernel=False)
    check(torch.equal(perm, plain), "reorder_by_rst: kernel != plain path")
    ids = torch.arange(n, device=dev)
    check(torch.equal(torch.sort(perm).values, ids),
          "reorder_by_rst: not a permutation")
    inv = torch.empty_like(perm)
    inv[perm] = ids

    spec = get_arch("gat-cora")
    d_feat = spec.shapes[GNN_META_SHAPE]["d_feat"]
    shape = dict(kind="train", n_nodes=n, n_edges=m2, d_feat=d_feat,
                 n_graphs=1)
    cfg = gnn_cell_config("gat-cora", spec.make_config(), shape)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((n, d_feat)).astype(
        np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.n_classes, n).astype(
        np.int32)).to(dev)
    s_t, d_t = g.src.to(dev), g.dst.to(dev)
    gid = torch.zeros(n, dtype=torch.int32, device=dev)
    batches = {
        "original": {"graph": {"node_feat": x, "src": s_t, "dst": d_t,
                               "graph_id": gid}, "labels": labels},
        "rst": {"graph": {"node_feat": x[inv],
                          "src": perm[s_t.long()].to(torch.int32),
                          "dst": perm[d_t.long()].to(torch.int32),
                          "graph_id": gid}, "labels": labels[inv]}}
    span = {k: float((b["graph"]["src"] - b["graph"]["dst"]).abs().double()
                     .mean()) for k, b in batches.items()}
    del x, labels, s_t, d_t
    step_fn, state, _ = gnn_train_cell("gat-cora", cfg, shape, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = {k: float(step_fn(state, b)[1]["loss"]) for k, b in batches.items()}
    check(all(map(math.isfinite, loss.values())), f"reorder losses {loss}")
    check(abs(loss["original"] - loss["rst"])
          <= GNN_TOL + GNN_TOL * abs(loss["original"]),
          f"GAT loss in RST order {loss['rst']} against {loss['original']}")
    times = {k: [] for k in batches}
    order = list(batches)
    for r in range(REORDER_RUNS):
        for k in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, _ = step_fn(state, batches[k])
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
            del new
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = {k: statistics.median(t) for k, t in times.items()}
    if profile is not None:
        profile(f"GAT train step, rmat({REORDER_SCALE}, 16), RST order",
                lambda: step_fn(state, batches["rst"]))
    return ({"gnn_reorder": f"rmat({REORDER_SCALE}, 16)", "card": card,
             "n_nodes": n, "half_edges": m2, "d_in": cfg.d_in,
             "reorder_ms": reorder_ms, "plain_bit_equal": True,
             "launches": {k: v for k, v in counts.items() if v},
             "mean_edge_span": span, "loss": loss,
             "loss_diff": abs(loss["original"] - loss["rst"]),
             "step_ms": med, "step_ms_all": times,
             "rst_speedup": med["original"] / med["rst"],
             "peak_gb": peak_gb}, counts)


def gnn_train_cli(torch, card, counted) -> tuple:
    """Phase 5l c: ``launch.train.main`` on the card: gat-cora (its first
    shape, full_graph_sm) for 6 steps with a checkpoint every 3, then again
    to 9, resuming at 6; DIEN at train_batch for 3 steps (embed_bag)."""
    import contextlib
    import io
    import shutil
    import tempfile
    from repro_torch.launch import train as train_cli
    from repro_torch.train import checkpoint as ckpt
    root = ROOT / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="train-cli-", dir=root))
    total = {}

    def drive(argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            loop, counts = counted(lambda: train_cli.main(
                argv + ["--ckpt-dir", str(tmp)]))
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return (loop, counts, out.getvalue().splitlines(),
                time.perf_counter() - t0)

    lines = []
    try:
        argv = ["--arch", "gat-cora", "--ckpt-every", "3"]
        first, _, report1, s1 = drive(argv + ["--steps", "6"])
        check(first.step == 6 and report1[-1].startswith("done: 6 steps")
              and report1[0].startswith("step     1  loss"),
              f"train cli gat-cora: {report1}")
        check(ckpt.latest_step(tmp / "gat-cora") == 6, "gat-cora checkpoint")
        ckpt_mb = dir_mb(tmp / "gat-cora" / "step_0000000006")
        second, _, report2, s2 = drive(argv + ["--steps", "9"])
        check(second.step == 9 and report2 == [report2[-1]]
              and report2[-1].startswith("done: 9 steps")
              and int(second.state["opt"]["step"]) == 9,
              f"train cli gat-cora resumed: {report2}")
        lines.append({"train_cli": "gat-cora", "card": card,
                      "shape": "full_graph_sm", "argv": argv,
                      "steps": [6, 9], "resumed_at": 6,
                      "seconds": [s1, s2], "ckpt_mb": ckpt_mb,
                      "report": report1 + report2,
                      "retries": second.retries,
                      "stragglers": len(second.stragglers)})
        argv = ["--arch", "dien", "--steps", "3", "--ckpt-every", "3"]
        loop, counts, report, s = drive(argv)
        check(loop.step == 3 and counts["embed_bag"] > 0
              and report[-1].startswith("done: 3 steps"),
              f"train cli dien: {report}, {counts}")
        ckpt_mb = dir_mb(tmp / "dien" / "step_0000000003")
        t0 = time.perf_counter()
        ckpt.save(tmp / "dien-save", loop.state, 3)
        save_ms = (time.perf_counter() - t0) * 1e3
        like, _ = ckpt.restore(tmp / "dien-save", loop.state)
        check(all(torch.equal(a.detach(), b.detach()) for a, b in zip(
            like["params"].parameters(), loop.state["params"].parameters())),
            "dien checkpoint round trip")
        lines.append({"train_cli": "dien", "card": card,
                      "shape": "train_batch", "argv": argv, "seconds": s,
                      "ckpt_mb": ckpt_mb, "save_ms": save_ms,
                      "params": sum(p.numel() for p in
                                    loop.state["params"].parameters()),
                      "report": report,
                      "launches": {k: v for k, v in counts.items() if v}})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lines, total


def train_loop_checks(torch, card, counted) -> tuple:
    """Phase 5l d: ``FaultTolerantLoop``'s own checks on the card, on the
    forest stream step (integer work, so bit-identity holds): three
    injected StepTimeouts retried to the forest of a clean run, a kill after
    6 steps resumed from 4 bit-identical to an uninterrupted run; and a
    StepTimeout raised when a step's work on the card (a sleep) outlasts
    the watchdog."""
    import shutil
    import tempfile
    from repro_torch.data import graphs, streams
    from repro_torch.dynamic import init_state, replay_batch
    from repro_torch.train.fault import FaultTolerantLoop, StepTimeout
    dev = torch.device("cuda")
    g = graphs.grid2d(LOOP_GRID_SIDE, device="cpu")
    s = streams.STREAMS["churn"](g, batch=LOOP_STREAM_BATCH,
                                 n_batches=LOOP_STREAM_BATCHES, seed=5)
    fields = ("parent", "rep", "pool_src", "pool_dst", "pool_valid",
              "tree_mask", "dirty")
    cursor = {}

    def step(state, batch):
        state, stats = replay_batch(state, batch)
        return state, {"deletes_found": stats["deletes_found"]}

    def flaky(state, batch):
        i = cursor["at"]
        cursor[i] = cursor.get(i, 0) + 1
        if {3: 1, 7: 2}.get(i, 0) >= cursor[i]:
            raise StepTimeout(f"injected at step {i}")
        return step(state, batch)

    def data(start=0):
        for c, b in enumerate(s.batches):
            if c >= start:
                cursor["at"] = c
                yield c, b

    def same(a, b, what):
        check(all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)
              and a.version == b.version, what)

    state0 = init_state(s, device=dev)
    ref = state0
    for b in s.batches:
        ref, _ = step(ref, b)
    root = ROOT / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="train-loop-", dir=root))
    total = {}

    def run(loop, n):
        _, counts = counted(lambda: loop.run(n))
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    try:
        loop = FaultTolerantLoop(step_fn=flaky, state=state0, data_iter=data(),
                                 ckpt_dir=tmp / "retry", ckpt_every=4,
                                 max_retries=2, async_ckpt=False)
        run(loop, LOOP_STREAM_BATCHES)
        check(loop.retries == 3, f"retries {loop.retries}")
        same(loop.state, ref, "retried forest != clean forest")
        dead = FaultTolerantLoop(step_fn=step, state=state0, data_iter=data(),
                                 ckpt_dir=tmp / "kill", ckpt_every=4,
                                 async_ckpt=False)
        run(dead, 6)
        heir = FaultTolerantLoop(step_fn=step, state=state0, data_iter=None,
                                 ckpt_dir=tmp / "kill", ckpt_every=4,
                                 async_ckpt=False)
        check(heir.resume() == 4, "forest resume step")
        heir.data_iter = data(4)
        run(heir, LOOP_STREAM_BATCHES)
        same(heir.state, ref, "resumed forest != uninterrupted forest")

        def sleepy(state, batch):
            torch.cuda._sleep(WATCHDOG_CYCLES)
            return state, {}

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sleepy(None, None)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        device_ms = (time.perf_counter() - t0) * 1e3
        wd = FaultTolerantLoop(step_fn=sleepy,
                               state={"x": torch.zeros((), device=dev)},
                               data_iter=iter([(0, {})]),
                               ckpt_dir=tmp / "sleep",
                               step_timeout_s=WATCHDOG_S, max_retries=0)
        try:
            wd.run(1)
            fired = False
        except StepTimeout:
            fired = True
        check(fired and enqueue_ms < WATCHDOG_S * 1e3 < device_ms,
              f"watchdog: fired {fired}, enqueue {enqueue_ms} ms, "
              f"device {device_ms} ms")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ({"train_loop": f"grid2d({LOOP_GRID_SIDE})/churn/"
                           f"b{LOOP_STREAM_BATCH}", "card": card,
             "batches": LOOP_STREAM_BATCHES, "retries": loop.retries,
             "retried_bit_equal": True, "killed_at": 6, "resumed_at": 4,
             "resume_bit_equal": True,
             "watchdog": {"timeout_s": WATCHDOG_S, "enqueue_ms": enqueue_ms,
                          "device_ms": device_ms, "fired": fired},
             "launches": {k: v for k, v in total.items() if v}}, total)


# ---------------------------------------------------------------------------
# 5m. The LMs
# ---------------------------------------------------------------------------

def lm_param_bytes(params) -> int:
    return tensor_bytes(list(params.parameters()))


def lm_decode_bound_ms(cfg, params, batch: int, cache_len: int) -> tuple:
    """The least time of one decode step: every weight read once (the
    embedding table only for its ``batch`` rows unless tied, where the
    unembed reads it whole) and the whole static cache's K and V, over the
    HBM rate; against the step's operations (2 a weight a token, 4 a cached
    position a query head a lane of Dh) over the bf16 tensor rate. Returns
    (ms, "bytes" or "operations")."""
    weights = lm_param_bytes(params)
    embed = params["embed"]
    if params.get("unembed") is not None:
        weights -= tensor_bytes([embed]) - batch * embed.shape[1] * 2
    kv = 2 * cfg.n_layers * batch * cache_len * cfg.n_kv_heads * cfg.d_head * 2
    flops = (2 * batch * cfg.active_param_count()
             + 4 * batch * cfg.n_layers * cfg.n_heads * cache_len * cfg.d_head)
    t_bytes = (weights + kv) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def lm_attention_flops(cfg, batch: int, seq: int) -> int:
    """The causal chunked attention's products over the blocks the port
    computes (a key block wholly after its query block is skipped): 4 a
    query head, query, key and lane of Dh, every layer."""
    n_q = max(seq // cfg.q_chunk, 1)
    qc = seq // n_q
    n_kv = max(seq // cfg.kv_chunk, 1)
    kvc = seq // n_kv
    blocks = sum(1 for i in range(n_q) for j in range(n_kv)
                 if j * kvc <= i * qc + qc - 1)
    return 4 * batch * cfg.n_heads * qc * kvc * cfg.d_head * blocks \
        * cfg.n_layers


def lm_serve_line(torch, dev, arch, card, counted, profile=None) -> dict:
    """Phase 5m a: ``serve_requests`` at the full config with the CLI's
    defaults; then the host syncs of LM_SYNC_STEPS decode steps (torch's
    sync debug mode). ``profile``, where given, profiles one decode step of
    llama3.2-1b at batch 8."""
    import contextlib
    import io
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    cfg = get_arch(arch).make_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res, counts = counted(lambda: serve.serve_requests(
            cfg, params, device=dev, **LM_SERVE))
    report = out.getvalue().splitlines()
    check(len(report) == LM_SERVE["requests"]
          and all(ln.startswith(f"request batch {i}: prefill")
                  for i, ln in enumerate(report)), f"{arch} serve: {report}")
    toks = torch.cat(res["tokens"])
    check(toks.shape == (LM_SERVE["requests"] * LM_SERVE["batch"],
                         LM_SERVE["max_new"])
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"{arch} serve: tokens {toks.shape}")
    new = LM_SERVE["max_new"] - 1
    cache = tfm.init_kv_cache(cfg, LM_SERVE["batch"], LM_SYNC_STEPS + 1,
                              device=dev)
    tok = toks[:LM_SERVE["batch"], 0].contiguous()

    def steps():
        with torch.inference_mode():
            for _ in range(LM_SYNC_STEPS):
                logits, _ = tfm.decode_step(cfg, params, tok, cache)
        return logits

    torch.cuda.synchronize()
    logits, syncs = host_syncs(torch, steps)
    check(bool(torch.isfinite(logits).all()), f"{arch}: logits not finite")
    if profile is not None:
        cache["len"] = 0
        profile(f"{arch} decode step, batch {LM_SERVE['batch']}",
                lambda: torch.inference_mode()(
                    lambda: tfm.decode_step(cfg, params, tok, cache))())
    bound, bound_by = lm_decode_bound_ms(
        cfg, params, LM_SERVE["batch"],
        LM_SERVE["prompt_len"] + LM_SERVE["max_new"])
    line = {"lm_serve": arch, "card": card, "config": "full",
            **LM_SERVE, "params": sum(p.numel() for p in params.parameters()),
            "weights_gb": lm_param_bytes(params) / 1e9,
            "init_s": init_s,
            "prefill_ms": [s * 1e3 for s in res["prefill_s"]],
            "prefill_tokens_per_s": [LM_SERVE["batch"] * LM_SERVE["prompt_len"]
                                     / s for s in res["prefill_s"]],
            "decode_ms_per_token": [s * 1e3 / new for s in res["decode_s"]],
            "decode_tokens_per_s": [LM_SERVE["batch"] * new / s
                                    for s in res["decode_s"]],
            "decode_bound_ms": bound, "bound_by": bound_by,
            "host_syncs_per_decode_step": syncs / LM_SYNC_STEPS,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {k: v for k, v in counts.items() if v},
            "report": report}
    check(syncs == 0, f"{arch}: {syncs} host syncs in {LM_SYNC_STEPS} "
          "decode steps")
    del params, cache, res, toks, logits
    torch.cuda.empty_cache()
    return line


def lm_serve_cli(torch, dev, card, counted) -> dict:
    """Phase 5m a: ``serve.main`` for dbrx-132b (the CLI serves the smoke
    config: its ``--smoke`` flag is on by default)."""
    import contextlib
    import io
    from repro_torch.launch import serve
    out = io.StringIO()
    argv = ["--arch", "dbrx-132b"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res, counts = counted(lambda: serve.main(argv, device=dev))
    report = out.getvalue().splitlines()
    check(report[-1].startswith("median decode throughput:")
          and report[-1].endswith("dbrx-132b smoke)"), f"serve cli: {report}")
    return {"lm_serve_cli": "dbrx-132b", "card": card, "argv": argv,
            "seconds": time.perf_counter() - t0, "report": report,
            "launches": {k: v for k, v in counts.items() if v}}


def reduced_spec(arch, shape_name, **changes):
    """``(spec, name)``: the arch with one cell, ``shape_name``'s shape with
    ``changes`` (a reduced batch), under a name of its own (so
    ``build_cell`` builds it on the card)."""
    from repro_torch.configs import get_arch
    base = get_arch(arch)
    shape = dict(base.shapes[shape_name], **changes)
    name = shape_name + "".join(f"/{k}{v}" for k, v in changes.items())
    return dataclasses.replace(base, shapes={name: shape}), name


def lm_decode_line(torch, dev, arch, shape_name, card, counted,
                   **changes) -> dict:
    """Phase 5m b: a decode cell through ``build_cell``: its cache filled
    with seeded normals and ``len`` set so the LM_DECODE_STEPS timed steps
    attend to the whole cache; ms a token (a synchronize after each step)
    beside the step's bound, host syncs a step, peak GB."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train.step import build_cell
    spec, name = reduced_spec(arch, shape_name, **changes)
    shape = spec.shapes[name]
    b, s = shape["batch"], shape["seq"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_fn, params, inputs = build_cell(spec, name, device=dev)
    cfg = spec.make_config()
    gen = torch.Generator(device=dev).manual_seed(1)
    cache = tfm.init_kv_cache(cfg, b, s, device=dev)
    check(cache["k"].shape == inputs["cache"]["k"].shape,
          f"{arch}/{name}: cache shape")
    for t in (cache["k"], cache["v"]):
        for layer in t:
            layer.normal_(generator=gen)
    cache["len"] = s - LM_DECODE_STEPS - 1
    tok = torch.randint(0, cfg.vocab, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    batch = {"token": tok, "cache": cache}
    ms = []
    total = {}
    for i in range(LM_DECODE_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (logits, _), counts = counted(lambda: step_fn(params, batch))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    check(bool(torch.isfinite(logits).all()) and logits.shape == (b,
                                                                  cfg.vocab),
          f"{arch}/{name}: logits")
    cache["len"] -= 1
    _, syncs = host_syncs(torch, lambda: step_fn(params, batch))
    check(syncs == 0, f"{arch}/{name}: {syncs} host syncs a decode step")
    bound, bound_by = lm_decode_bound_ms(cfg, params, b, s)
    line = {"lm_cell": f"{arch}/{shape_name}", "card": card,
            "reduced": changes or None, "batch": b, "cache_len": s,
            "kv_gb": tensor_bytes([cache["k"], cache["v"]]) / 1e9,
            "weights_gb": lm_param_bytes(params) / 1e9,
            "ms_per_token": ms[1:], "first_ms": ms[0],
            "ms_per_token_median": statistics.median(ms[1:]),
            "tokens_per_s": b * 1e3 / statistics.median(ms[1:]),
            "bound_ms": bound, "bound_by": bound_by,
            "host_syncs_per_step": syncs,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {k: v for k, v in total.items() if v}}
    del params, cache, batch, logits, inputs, step_fn
    torch.cuda.empty_cache()
    return line


def lm_prefill_line(torch, dev, arch, card, counted, profile=None,
                    **changes) -> dict:
    """Phase 5m b: prefill_32k through ``build_cell`` at a reduced batch:
    one call (and one more under ``profile``), ms and tokens/s beside its
    operations bound."""
    from repro_torch.train.step import build_cell
    spec, name = reduced_spec(arch, "prefill_32k", **changes)
    shape = spec.shapes[name]
    b, s = shape["batch"], shape["seq"]
    cfg = spec.make_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_fn, params, _ = build_cell(spec, name, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev,
                           dtype=torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, counts = counted(lambda: step_fn(params, {"tokens": tokens}))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(logits).all()) and logits.shape == (b,
                                                                  cfg.vocab),
          f"{arch}/{name}: logits")
    if profile is not None:
        profile(f"{arch} prefill_32k, batch {b}",
                lambda: step_fn(params, {"tokens": tokens}))
    embed_rows = b * s * cfg.d_model * 2
    tables = 1 if cfg.tie_embeddings else 2
    matmul = 2 * b * s * (cfg.active_param_count()
                          - tables * cfg.vocab * cfg.d_model) \
        + 2 * b * cfg.d_model * cfg.vocab_padded
    attn = lm_attention_flops(cfg, b, s)
    t_ops = (matmul + attn) / BF16_FLOP_PER_S * 1e3
    t_bytes = (lm_param_bytes(params) + embed_rows) / HBM_BYTES_PER_S * 1e3
    line = {"lm_cell": f"{arch}/prefill_32k", "card": card,
            "reduced": changes, "batch": b, "seq": s, "ms": ms,
            "tokens_per_s": b * s * 1e3 / ms,
            "matmul_tflop": matmul / 1e12, "attention_tflop": attn / 1e12,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {k: v for k, v in counts.items() if v}}
    del params, tokens, logits
    torch.cuda.empty_cache()
    return line


def lm_train_line(torch, dev, arch, card, counted, profile=None,
                  **changes) -> dict:
    """Phase 5m b: train_4k through ``build_cell`` (the full config's
    two-level remat) at a reduced batch, LM_TRAIN_STEPS steps under
    ``FaultTolerantLoop`` (no checkpoint): step ms (the watchdog's clock),
    tokens/s beside 6 N T over the bf16 rate, peak GB, the losses."""
    import shutil
    import tempfile
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.train.fault import FaultTolerantLoop
    from repro_torch.train.step import REMAT_GROUPS, build_cell
    spec, name = reduced_spec(arch, "train_4k", **changes)
    shape = spec.shapes[name]
    b, s = shape["batch"], shape["seq"]
    cfg = spec.make_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_fn, state, _ = build_cell(spec, name, device=dev)
    metrics = []
    root = ROOT / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="lm-train-", dir=root))
    try:
        loop = FaultTolerantLoop(
            step_fn=step_fn, state=state,
            data_iter=synthetic_batches(spec, shape, cfg, device=dev),
            ckpt_dir=tmp, ckpt_every=LM_TRAIN_STEPS + 1)
        _, counts = counted(lambda: loop.run(LM_TRAIN_STEPS, on_metrics=(
            lambda step, m, dt: metrics.append(
                (dt * 1e3, float(m["loss"]), float(m["grad_norm"]),
                 float(m["lr"]))))))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(len(metrics) == LM_TRAIN_STEPS and all(
        math.isfinite(x) for m in metrics for x in m),
        f"{arch}/{name}: metrics {metrics}")
    if profile is not None:
        _, batch = next(synthetic_batches(spec, shape, cfg, device=dev))
        profile(f"{arch} train_4k step, batch {b}",
                lambda: step_fn(loop.state, batch))
    step_ms = [m[0] for m in metrics]
    flops = 6 * b * s * cfg.active_param_count() \
        + 3 * lm_attention_flops(cfg, b, s)
    line = {"lm_cell": f"{arch}/train_4k", "card": card, "reduced": changes,
            "batch": b, "seq": s,
            "remat_groups": REMAT_GROUPS.get(cfg.n_layers, 0),
            "step_ms": step_ms,
            "step_ms_median": statistics.median(step_ms[1:]),
            "tokens_per_s": b * s * 1e3 / statistics.median(step_ms[1:]),
            "losses": [m[1] for m in metrics],
            "grad_norms": [m[2] for m in metrics],
            "lrs": [m[3] for m in metrics],
            "bound_ms": flops / BF16_FLOP_PER_S * 1e3,
            "bound_by": "operations (6 N T + 3 x attention; no recompute)",
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {k: v for k, v in counts.items() if v}}
    del state, loop, step_fn
    torch.cuda.empty_cache()
    return line


def lm_smoke_trains(torch, dev, card, counted) -> list:
    """Phase 5m b: ``launch.train.main --smoke`` for minicpm-2b (WSD),
    moonshot and dbrx, LM_TRAIN_STEPS steps each with a checkpoint."""
    import contextlib
    import io
    import shutil
    import tempfile
    from repro_torch.launch import train as train_cli
    root = ROOT / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="lm-cli-", dir=root))
    lines = []
    try:
        for arch in LM_SMOKE_TRAIN:
            argv = ["--arch", arch, "--smoke", "--steps", str(LM_TRAIN_STEPS),
                    "--ckpt-every", str(LM_TRAIN_STEPS), "--ckpt-dir",
                    str(tmp)]
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                loop, counts = counted(lambda: train_cli.main(argv, device=dev))
            report = out.getvalue().splitlines()
            check(loop.step == LM_TRAIN_STEPS and report[-1].startswith(
                f"done: {LM_TRAIN_STEPS} steps"), f"{arch}: {report}")
            lines.append({"lm_train_cli": arch, "card": card,
                          "argv": argv[:-2], "seconds":
                          time.perf_counter() - t0, "report": report,
                          "launches": {k: v for k, v in counts.items()
                                       if v}})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lines


def lm_meta(torch, arch) -> dict:
    """Phase 5m b: every full-shape cell of ``arch`` that does not fit one
    card, built on ``meta``: its state's and inputs' bytes."""
    from repro_torch.configs import LM_SHAPES, get_arch
    from repro_torch.train.step import build_cell, sharded_cell

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, torch.nn.Module):
            return list(tree.parameters())
        return [tree] if isinstance(tree, torch.Tensor) else []

    cells = {}
    for shape_name in LM_SHAPES:
        if not sharded_cell(arch, shape_name):
            continue
        _, state, inputs = build_cell(get_arch(arch), shape_name)
        ts = leaves(state) + leaves(inputs)
        check(all(t.device.type == "meta" for t in ts),
              f"{arch}/{shape_name}: a tensor off the meta device")
        cells[shape_name] = {"state_gb": tensor_bytes(leaves(state)) / 1e9,
                             "inputs_gb": tensor_bytes(leaves(inputs)) / 1e9}
    return {"lm_meta": arch, "device": "meta", "cells": cells}


def lm_gate_lines(torch, dev, card, counted) -> tuple:
    """Phase 5m c: the card against the port on the CPU, the same weights
    and tokens, in float32 (TF32 off): llama3.2-1b at full width (4
    teacher-forced decode steps at batch 2, a prefill at sequence 256, and
    one train step's loss and every gradient at 1 × 128), and moonshot at
    its full widths with 2 layers (the same decode and prefill, and the MoE
    routing of layer 0 on the same 256 tokens: keep masks, positions, top
    experts and capacity bit-equal); then llama in bf16 on the card against
    its float32 run. Returns (lines, launches)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    import numpy as np
    from repro_torch.train.step import lm_prefill_cell as prefill_cell
    cpu = torch.device("cpu")
    rng = np.random.default_rng(LM_GATE_SEED)
    total = {}
    lines = []

    def run(fn):
        out, counts = counted(fn)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out

    def scaled(got, want) -> float:
        got, want = got.detach().cpu().double(), want.detach().cpu().double()
        return float((got - want).abs().max() / want.abs().max())

    def decode_logits(cfg, params, toks):
        cache = tfm.init_kv_cache(cfg, toks.shape[0], 8,
                                  device=params["embed"].device)
        out = []
        with torch.inference_mode():
            for i in range(toks.shape[1]):
                logits, cache = tfm.decode_step(cfg, params, toks[:, i],
                                                cache)
                out.append(logits)
        return out

    for arch, changes in (("llama3.2-1b", {}),
                          ("moonshot-v1-16b-a3b", {"n_layers": 2})):
        cfg = dataclasses.replace(get_arch(arch).make_config(),
                                  dtype=torch.float32, **changes)
        gpu = tfm.init_params(cfg, generator=torch.Generator(
            device=dev).manual_seed(3), device=dev)
        host = tfm.LMParams.from_named({k: p.cpu() for k, p in
                                        gpu.named_parameters()})
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 4)
                                             ).astype(np.int32))
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 256)
                                               ).astype(np.int32))
        t0 = time.perf_counter()
        want_dec = decode_logits(cfg, host, toks)
        cell, _, _ = prefill_cell(cfg, batch=1, seq=256,
                                  device=torch.device("meta"))
        want_pre = cell(host, {"tokens": prompt})
        cpu_s = time.perf_counter() - t0
        got_dec = run(lambda: decode_logits(cfg, gpu, toks.to(dev)))
        got_pre = run(lambda: cell(gpu, {"tokens": prompt.to(dev)}))
        dec_err = max(scaled(g, w) for g, w in zip(got_dec, want_dec))
        pre_err = scaled(got_pre, want_pre)
        check(dec_err <= LM_GATE_TOL and pre_err <= LM_GATE_TOL,
              f"{arch} gate: decode {dec_err}, prefill {pre_err}")
        line = {"lm_gate": arch, "card": card, "dtype": "float32",
                "changes": changes or None, "tol": LM_GATE_TOL,
                "decode_steps": toks.shape[1], "decode_batch": 2,
                "decode_scaled_err": dec_err, "prefill_seq": 256,
                "prefill_scaled_err": pre_err, "cpu_s": cpu_s}
        if cfg.is_moe:
            with torch.inference_mode():
                x = tfm.rms_norm(tfm._embed(cfg, host, prompt[0]),
                                 host.layers.ln_mlp[0])
                w = host.layers.router[0]
                want_r = tfm.moe_route(x, w, cfg)
                got_r = run(lambda: tfm.moe_route(x.to(dev), w.to(dev), cfg))
            same = (got_r[4] == want_r[4] and all(
                torch.equal(g.cpu(), w_) for g, w_ in
                zip(got_r[1:4], want_r[1:4])))
            check(same, f"{arch} gate: routing differs")
            line.update(routing_tokens=x.shape[0], capacity=want_r[4],
                        routing_bit_equal=same,
                        kept=int(want_r[3].sum()),
                        top_gates_scaled_err=scaled(got_r[0], want_r[0]))
        else:
            # One train step's loss and every gradient (1 x 128).
            tgt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 128)
                                                ).astype(np.int32))
            src = prompt[:, :128]

            def loss_grads(params, t, y):
                params = tfm.LMParams.from_named(
                    {k: p.detach() for k, p in params.named_parameters()}
                ).requires_grad_()
                names, leaves_ = zip(*params.named_parameters())
                loss = tfm.lm_loss(cfg, params, t, y)
                return loss.detach(), dict(zip(
                    names, torch.autograd.grad(loss, leaves_)))

            t0 = time.perf_counter()
            want_l, want_g = loss_grads(host, src, tgt)
            line["cpu_s"] += time.perf_counter() - t0
            got_l, got_g = run(lambda: loss_grads(gpu, src.to(dev),
                                                  tgt.to(dev)))
            grad_err = {k: scaled(got_g[k], w) for k, w in want_g.items()}
            loss_err = scaled(got_l, want_l)
            check(loss_err <= LM_GATE_TOL and max(grad_err.values())
                  <= LM_GATE_TOL, f"{arch} train gate: loss {loss_err}, "
                  f"gradients {grad_err}")
            line.update(train_loss=float(want_l), train_loss_err=loss_err,
                        train_grad_scaled_err_max=max(grad_err.values()),
                        train_grad_scaled_err=grad_err)
            # bf16 on the card against its float32 run.
            cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
            p16 = tfm.LMParams.from_named(
                {k: p.to(torch.bfloat16) if p.dtype == torch.float32
                 and not k.split(".")[-1].startswith(("ln_", "q_norm",
                                                      "k_norm"))
                 else p for k, p in gpu.named_parameters()})
            cell16, _, _ = prefill_cell(cfg16, batch=1, seq=256,
                                        device=torch.device("meta"))
            got16 = run(lambda: cell16(p16, {"tokens": prompt.to(dev)}))
            dec16 = run(lambda: decode_logits(cfg16, p16, toks.to(dev)))
            err16 = max([scaled(got16, got_pre)]
                        + [scaled(g, w) for g, w in zip(dec16, got_dec)])
            check(err16 <= LM_BF16_TOL, f"{arch} bf16 gate: {err16}")
            line.update(bf16_vs_float32_scaled_err=err16,
                        bf16_tol=LM_BF16_TOL)
            del p16
        lines.append(line)
        del gpu, host
        torch.cuda.empty_cache()
    return lines, total


# ---------------------------------------------------------------------------
# 5n. The mesh code
# ---------------------------------------------------------------------------

# Phase 5n: the graphs of the world-1 run (full width) and of the four-rank
# run, the ranks and their time limit, the MoE gate's tokens and layers and
# the bf16 timing's tokens (moe_chunk's 65,536), the compression's checked
# slice, and the dry run's output directory.
MESH_RANKS = 4
MESH_RANK_TIMEOUT_S = 600
MESH_RANK_GRID_SIDE = 1024
MOE_GATE_SHAPE = (2, 128)
MOE_GATE_LAYERS = 2
MOE_TIME_SHAPE = (16, 4096)
MOE_GATE_TOL = 1e-4
COMPRESS_SLICE = 1 << 26
# The dry run's 80 cells each run one step on ``meta`` (a second to about
# a minute of host time a cell), in DRYRUN_JOBS processes at the lowest
# priority, so the phases that run meanwhile keep the cores they use.
DRYRUN_JOBS = 6
DRYRUN_TIMEOUT_S = 1000


def wall_ms(torch, fn) -> tuple:
    """``(fn(), ms)`` on the host's clock, the card idle at both ends."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def padded_edges(torch, g, world: int) -> tuple:
    """The graph's half-edges padded with (0, 0) self-loops to a multiple
    of ``world`` (the shard count ``distributed_cc_spanning_forest``
    asks for)."""
    pad = -g.src.numel() % world
    z = torch.zeros(pad, dtype=torch.int32, device=g.src.device)
    return torch.cat([g.src, z]), torch.cat([g.dst, z])


def mesh_graphs(rank_run: bool) -> tuple:
    """(label, maker) of phase 5n's graphs: (a)'s full-width pair, or the
    pair the four ranks run."""
    from repro_torch.data import graphs
    side = MESH_RANK_GRID_SIDE if rank_run else GRID_SIDE
    return ((f"grid2d({side})", lambda dev: graphs.grid2d(side, device=dev)),
            (f"rmat({RMAT_SCALE}, 16)",
             lambda dev: graphs.rmat(RMAT_SCALE, edge_factor=16, device=dev)))


def mesh_rank_main(args) -> int:
    """One of phase 5n b's ranks (a process of its own): the gloo backend
    on the card's tensors, rendezvous through a FileStore. Runs
    ``distributed_cc_spanning_forest`` over a (world,) ``("data",)`` mesh on
    both graphs of ``mesh_graphs(True)`` and writes each one's rep,
    forest, rounds, compress syncs, pointer_jump_double launches and ms."""
    import numpy as np
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.distributed import distributed_cc_spanning_forest
    from repro_torch.kernels.pointer_jump.ops import pointer_jump_double_k
    dev = torch.device("cuda")
    dist.init_process_group("gloo", store=dist.FileStore(args.mesh_store,
                                                         args.mesh_world),
                            rank=args.mesh_rank, world_size=args.mesh_world)
    try:
        mesh = init_device_mesh("cuda", (args.mesh_world,),
                                mesh_dim_names=("data",))
        run = distributed_cc_spanning_forest(mesh, "data")
        out = {}
        for i, (label, make) in enumerate(mesh_graphs(True)):
            g = make(dev)
            src, dst = padded_edges(torch, g, args.mesh_world)
            run(src, dst, n_nodes=g.n_nodes)             # warm-up
            dist.barrier()
            torch.cuda.synchronize()
            pointer_jump_double_k.launches = 0
            (rep, forest, rounds, syncs), ms = wall_ms(
                torch, lambda: run(src, dst, n_nodes=g.n_nodes,
                                   return_syncs=True))
            torch.cuda.synchronize()
            out[f"{i}/rep"] = rep.cpu().numpy()
            out[f"{i}/forest"] = forest.cpu().numpy()
            out[f"{i}/rounds"] = np.array(rounds)
            out[f"{i}/syncs"] = np.array(syncs)
            out[f"{i}/launches"] = np.array(pointer_jump_double_k.launches)
            out[f"{i}/ms"] = np.array(ms)
            del g, src, dst, rep, forest
            torch.cuda.empty_cache()
        np.savez(pathlib.Path(args.mesh_out) / f"rank{args.mesh_rank}.npz",
                 **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def mesh_cc_world1(torch, dev, card, counted, g, label, src, dst,
                   full: bool) -> tuple:
    """Phase 5n a for one graph on the world-1 NCCL mesh: ``(line, result,
    counts)``. The kernel run against ``use_kernel=False`` (bit-equal),
    the launches against the compress syncs, the host syncs against rounds
    + 1 + the compress syncs; with ``full`` also the partition against
    ``connected_components`` and scipy's, the forest rooted by Euler tour
    and validated (so acyclic, with n − #components edges), and the times
    beside ``connected_components``'."""
    import numpy as np
    import scipy.sparse
    import scipy.sparse.csgraph
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import (connected_components, count_components,
                                  euler_tour_root, validate_rst)
    from repro_torch.core.distributed import distributed_cc_spanning_forest
    from repro_torch.core.rst import forest_edges
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    run = distributed_cc_spanning_forest(mesh, "data")
    plain = distributed_cc_spanning_forest(mesh, "data", use_kernel=False)
    n = g.n_nodes

    def call():
        return run(src, dst, n_nodes=n, return_syncs=True)

    call()                                               # warm-up
    (rep, forest, rounds, syncs), counts = counted(call)
    check(counts["pointer_jump_double"] == syncs,
          f"{label}: {counts['pointer_jump_double']} pointer_jump_double "
          f"launches for {syncs} compress syncs")
    check(all(v == 0 for k, v in counts.items()
              if k != "pointer_jump_double"),
          f"{label}: distributed CC launched another kernel: {counts}")
    prep, pforest, prounds, psyncs = plain(src, dst, n_nodes=n,
                                           return_syncs=True)
    check(torch.equal(rep, prep) and torch.equal(forest, pforest)
          and rounds == prounds and syncs == psyncs,
          f"{label}: the kernel path differs from use_kernel=False")
    _, n_host = host_syncs(torch, call)
    check(n_host == rounds + 1 + syncs,
          f"{label}: {n_host} host syncs, want rounds + 1 + compress syncs "
          f"= {rounds + 1 + syncs}")
    n_comp = count_components(rep)
    m2 = g.src.numel()
    check(int(forest.sum()) == n - n_comp and not bool(forest[m2:].any()),
          f"{label}: {int(forest.sum())} forest edges, want {n - n_comp}")
    line = {"mesh_cc": label, "world": 1, "backend": "nccl", "n": n,
            "half_edges": m2, "padded": src.numel() - m2, "rounds": rounds,
            "compress_syncs": syncs, "host_syncs": n_host,
            "components": n_comp, "forest_edges": n - n_comp,
            "launches": {k: v for k, v in counts.items() if v},
            "card": card}
    if full:
        cc_rep, _f, cc_rounds = connected_components(g)
        check(same_partition(torch, rep, cc_rep),
              f"{label}: partition differs from connected_components'")
        line["rep_equal_connected_components"] = bool(torch.equal(rep,
                                                                   cc_rep))
        line["connected_components_rounds"] = cc_rounds
        u = g.src.cpu().numpy()
        v = g.dst.cpu().numpy()
        adj = scipy.sparse.coo_matrix((np.ones(u.size, np.int8), (u, v)),
                                      shape=(n, n))
        n_scipy, labels = scipy.sparse.csgraph.connected_components(
            adj, directed=False)
        check(n_scipy == n_comp and same_partition(
            torch, torch.from_numpy(labels).to(dev), rep),
              f"{label}: partition differs from scipy's")
        # Root the forest at each component's representative: a valid
        # rooted spanning forest, so the marked edges hold no cycle.
        fu, fv, valid = forest_edges(g, forest[:m2])
        parent = euler_tour_root(n, fu, fv, valid, rep)
        check(validate_rst(g, parent, 0, connected=False)["all_ok"],
              f"{label}: the distributed forest does not root to a valid "
              "spanning forest")
        times = {"distributed": [], "connected_components": []}
        for r in range(E2E_RUNS):
            order = list(times) if r % 2 == 0 else list(times)[::-1]
            for name in order:
                fn = call if name == "distributed" else \
                    (lambda: connected_components(g))
                times[name].append(wall_ms(torch, fn)[1])
        ms = statistics.median(times["distributed"])
        line.update({
            "ms": ms, "ms_per_round": ms / (rounds + 1),
            "connected_components_ms": statistics.median(
                times["connected_components"]),
            "runs": E2E_RUNS, "scipy_components": n_scipy})
    return line, (rep, forest, rounds), counts


def mesh_cc_ranks(torch, world1: dict, card) -> dict:
    """Phase 5n b: MESH_RANKS processes, gloo on the card's tensors, each
    rank's result bit-equal to the world-1 run on the same padded graph."""
    import numpy as np
    out_dir = ROOT / "build" / "mesh_ranks"
    if out_dir.exists():
        for f in out_dir.iterdir():
            f.unlink()
    out_dir.mkdir(parents=True, exist_ok=True)
    store = out_dir / "store"
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-world",
           str(MESH_RANKS), "--mesh-store", str(store), "--mesh-out",
           str(out_dir)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--mesh-rank", str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(MESH_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MESH_RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"mesh rank {r} exited {p.returncode}:\n"
              f"{log[-3000:]}")
    ranks = [dict(np.load(out_dir / f"rank{r}.npz"))
             for r in range(MESH_RANKS)]
    lines = []
    for i, (label, _make) in enumerate(mesh_graphs(True)):
        rep, forest, rounds = world1[label]
        for r, res in enumerate(ranks):
            check(np.array_equal(res[f"{i}/rep"], rep.cpu().numpy())
                  and np.array_equal(res[f"{i}/forest"],
                                     forest.cpu().numpy())
                  and int(res[f"{i}/rounds"]) == rounds,
                  f"{label}: rank {r} of {MESH_RANKS} differs from the "
                  "world-1 run")
            check(int(res[f"{i}/launches"]) == int(res[f"{i}/syncs"]),
                  f"{label}: rank {r} launched pointer_jump_double "
                  f"{int(res[f'{i}/launches'])} times for "
                  f"{int(res[f'{i}/syncs'])} compress syncs")
        lines.append({
            "mesh_cc": label, "world": MESH_RANKS,
            "backend": "gloo (CUDA tensors)", "rounds": rounds,
            "bit_equal_world1": True,
            "pointer_jump_double_launches": [int(res[f"{i}/launches"])
                                             for res in ranks],
            "ms": [float(res[f"{i}/ms"]) for res in ranks],
            "card": card})
    lines[-1]["seconds"] = wall
    return lines


def mesh_moe(torch, dev, card, counted) -> tuple:
    """Phase 5n c: ``moe_block_shard_map`` on a world-1 ("data", "model")
    mesh at moonshot-v1-16b-a3b's widths: float32, MOE_GATE_LAYERS layers'
    weights on MOE_GATE_SHAPE tokens, card against CPU (output within
    MOE_GATE_TOL of scale, routing bit-equal); one bf16 timing at
    MOE_TIME_SHAPE beside ``moe_block``'s."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tt
    mesh = make_host_mesh(device_type="cuda")
    base = get_arch("moonshot-v1-16b-a3b").make_config()
    mesh_fields = dict(act_batch_axes=("data",), act_seq_axis="model",
                       moe_expert_axis="model")
    d, e, f = base.d_model, base.n_experts, base.d_ff
    gen = torch.Generator().manual_seed(LM_GATE_SEED)

    def weights(device, dtype, generator):
        def normal(shape, fan_in):
            return (torch.randn(shape, generator=generator, device=device)
                    * fan_in ** -0.5).to(dtype)
        return (normal((d, e), d), normal((e, d, f), d), normal((e, d, f), d),
                normal((e, f, d), f))

    cfg32 = dataclasses.replace(base, dtype=torch.float32, **mesh_fields)
    x = torch.randn(MOE_GATE_SHAPE + (d,), generator=gen)
    errs, kept = [], []
    for _layer in range(MOE_GATE_LAYERS):
        w = weights("cpu", torch.float32, gen)
        want = tt.moe_block_shard_map(x, *w, cfg32, mesh)
        wd = [t.to(dev) for t in w]
        (got, counts) = counted(lambda: tt.moe_block_shard_map(
            x.to(dev), *wd, cfg32, mesh))
        check(not any(counts.values()), f"the MoE launched a kernel: "
              f"{counts}")
        errs.append(scaled_err(torch, got.cpu(), want, MOE_GATE_TOL,
                               "moe_block_shard_map card vs CPU"))
        flat = x.reshape(-1, d)
        r_cpu = tt.moe_route_local(flat, w[0], cfg32, 0, e)
        r_dev = tt.moe_route_local(flat.to(dev), wd[0], cfg32, 0, e)
        check(r_cpu[4] == r_dev[4] and all(
            torch.equal(a, b.cpu()) for a, b in zip(r_cpu[1:4], r_dev[1:4])),
              "MoE routing (expert, slot, keep) differs, card against CPU")
        kept.append(int(r_cpu[3].sum()))
        del wd, got
    cap = r_cpu[4]

    # One bf16 timing at full width: the shard_map function at world 1
    # against moe_block (the config without mesh fields).
    gdev = torch.Generator(device=dev).manual_seed(LM_GATE_SEED)
    cfg16 = dataclasses.replace(base, **mesh_fields)
    xt = torch.randn(MOE_TIME_SHAPE + (d,), generator=gdev, device=dev,
                     dtype=torch.bfloat16)
    w16 = weights(dev, torch.bfloat16, gdev)
    t = MOE_TIME_SHAPE[0] * MOE_TIME_SHAPE[1]
    cap16 = tt.moe_route(xt.reshape(-1, d), w16[0], base)[4]
    flop = 2 * 3 * e * cap16 * d * f
    times = cuda_ms_turns(torch, {
        "shard_map": lambda: tt.moe_block_shard_map(xt, *w16, cfg16, mesh),
        "moe_block": lambda: tt.moe_block(xt, *w16, base)})
    line = {"mesh_moe": "moonshot-v1-16b-a3b", "mesh": "1x1",
            "gate": {"tokens": MOE_GATE_SHAPE[0] * MOE_GATE_SHAPE[1],
                     "layers": MOE_GATE_LAYERS, "capacity": cap,
                     "kept_slots": kept, "scaled_err": errs,
                     "tol": MOE_GATE_TOL, "routing_bit_equal": True},
            "bf16": {"tokens": t, "capacity": cap16,
                     "shard_map_ms": times["shard_map"],
                     "moe_block_ms": times["moe_block"],
                     "expert_flop": flop,
                     "bound_ms": flop / BF16_FLOP_PER_S * 1e3},
            "card": card}
    del xt, w16
    torch.cuda.empty_cache()
    return line


def mesh_compression(torch, dev, card) -> dict:
    """Phase 5n d: ``compress_with_error_feedback`` at llama3.2-1b's
    gradient size (float32 gradient and residual), timed; its first
    COMPRESS_SLICE values bit-equal to the CPU's run and to the card's run
    of that slice alone."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tt
    from repro_torch.optim.compression import compress_with_error_feedback
    meta = tt.init_params(get_arch("llama3.2-1b").make_config(),
                          generator=None, device="meta")
    n = sum(p.numel() for p in meta.parameters())
    moved = 16 * n          # grad and residual read, both outputs written
    emit({"phase": "compress start", "values": n,
          "predicted_gb": {"inputs": 8 * n / 1e9, "outputs": 8 * n / 1e9,
                           "peak_temporaries": 20 * n / 1e9},
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(7)
    grad = torch.randn(n, generator=gen, device=dev)
    residual = torch.randn(n, generator=gen, device=dev) * 1e-3
    deq, new_res = compress_with_error_feedback(grad, residual)
    check(bool(torch.isfinite(deq).all()) and bool(
        torch.isfinite(new_res).all()), "compression: a non-finite value")
    k = COMPRESS_SLICE
    s_deq, s_res = compress_with_error_feedback(grad[:k], residual[:k])
    c_deq, c_res = compress_with_error_feedback(grad[:k].cpu(),
                                                residual[:k].cpu())
    check(torch.equal(s_deq.cpu(), c_deq) and torch.equal(s_res.cpu(), c_res),
          "compression: the card's slice differs from the CPU's")
    check(torch.equal(deq[:k], s_deq) and torch.equal(new_res[:k], s_res),
          "compression: the full run's first blocks differ from the slice")
    del deq, new_res, s_deq, s_res
    peak = torch.cuda.max_memory_allocated() - base
    ms = cuda_ms(torch, lambda: compress_with_error_feedback(grad, residual),
                 reps=5)
    line = {"mesh_compress": "llama3.2-1b gradient", "values": n,
            "slice_bit_equal_cpu": k, "ms": ms,
            "gb_per_s": moved / ms / 1e6,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            "bytes_moved": moved, "peak_gb": peak / 1e9, "card": card}
    del grad, residual
    torch.cuda.empty_cache()
    return line


def _lowest_priority() -> None:
    os.nice(19)


def start_cost_jobs() -> dict:
    """Start phase 5n e's dry run and phase 5o d's analyses, each in a
    process of its own without the card (``CUDA_VISIBLE_DEVICES=""``) at
    the lowest CPU priority, outputs under ``build/``; their phases wait
    for them."""
    build_dir = ROOT / "build"
    out_dir = build_dir / "dryrun"
    if out_dir.exists():
        for f in out_dir.glob("*.json"):
            f.unlink()
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    jobs = {}
    for name, argv, out in (
            ("dryrun", ["-m", "repro_torch.launch.dryrun", "--all",
                        "--jobs", str(DRYRUN_JOBS), "--out", str(out_dir)],
             out_dir),
            ("cells", [str(ROOT / "chip_smoke.py"), "--analyze-cells",
                       str(build_dir / "cost_cells.json")],
             build_dir / "cost_cells.json")):
        log = open(build_dir / f"{name}.log", "w")
        proc = subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                                stdout=log, stderr=subprocess.STDOUT,
                                preexec_fn=_lowest_priority)
        BACKGROUND.append(proc)
        jobs[name] = {"proc": proc, "log": log, "out": out,
                      "t0": time.perf_counter()}
    return jobs


def wait_job(job: dict, timeout: float, what: str) -> tuple:
    """``(exit code, log text, seconds from start to end)`` of a
    background job; fails if it runs past ``timeout`` seconds from its
    start."""
    left = timeout - (time.perf_counter() - job["t0"])
    try:
        rc = job["proc"].wait(timeout=max(left, 1.0))
    except subprocess.TimeoutExpired:
        job["proc"].kill()
        job["proc"].wait()
        fail(f"{what} ran past {timeout} s")
    job["log"].close()
    text = pathlib.Path(job["log"].name).read_text()
    return rc, text, time.perf_counter() - job["t0"]


def mesh_dryrun(card, job: dict) -> list:
    """Phase 5n e: ``launch/dryrun.py --all`` (started by
    ``start_cost_jobs``; no card: the fake process group of 256 or 512
    ranks), every cell ok, one line per cell with its per-card GB, and
    its analysis: TFLOP, collective GB by kind and temp GB a card for one
    step, and the peak (arguments + temp)."""
    rc, text, wall = wait_job(job, DRYRUN_TIMEOUT_S, "the dry run")
    check(rc == 0 and "all 80 cells OK" in text,
          f"the dry run failed ({rc}):\n{text[-3000:]}")
    lines = []
    for path in sorted(job["out"].glob("*.json")):
        res = json.loads(path.read_text())
        check(res["ok"], f"dry run cell {path.stem} not ok")
        b, c = res["bytes_per_device"], res["cost"]
        mem = res["memory_analysis"]
        check(mem["argument_size_in_bytes"] == b["total"],
              f"dry run cell {path.stem}: argument bytes "
              f"{mem['argument_size_in_bytes']} != {b['total']}")
        lines.append({"dryrun": path.stem, "n_devices": res["n_devices"],
                      "gb_per_device": b["total"] / 1e9,
                      "params_gb": b["params"] / 1e9,
                      "opt_gb": b["opt"] / 1e9,
                      "inputs_gb": b["inputs"] / 1e9,
                      "tflop_per_device": c["flops"] / 1e12,
                      "coll_gb_per_device": c["collective_bytes"] / 1e9,
                      "per_collective": {k: v / 1e9 for k, v in
                                         c["per_collective"].items()},
                      "bytes_accessed_gb": c["bytes_accessed"] / 1e9,
                      "temp_gb": mem["temp_size_in_bytes"] / 1e9,
                      "peak_gb": (b["total"] + mem["temp_size_in_bytes"])
                      / 1e9,
                      "analyze_s": res["timings_s"]["analyze"]})
    check(len(lines) == 80, f"{len(lines)} dry run cells, want 80")
    lines.append({"phase": "dryrun", "cells": len(lines), "seconds": wall,
                  "jobs": DRYRUN_JOBS, "card": card,
                  "over_80gb": sorted(ln["dryrun"] for ln in lines
                                      if ln["peak_gb"] > 80)})
    return lines


def mesh_phase(torch, dev, card, counted, dryrun_job) -> tuple:
    """Phase 5n: ``(lines, counts)``, the counts those of the world-1 runs
    (the other processes' launches are in their lines)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    lines = []
    counts_all = {}

    def add(counts):
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v

    torch.cuda.empty_cache()
    make_host_mesh(device_type="cuda")       # the world-1 NCCL group
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "the world-1 mesh is not NCCL")
    try:
        for full in (True, False):
            world1 = {}
            for label, make in mesh_graphs(not full):
                g = make(dev)
                src, dst = padded_edges(torch, g, 1 if full else MESH_RANKS)
                line, res, counts = mesh_cc_world1(
                    torch, dev, card, counted, g, label, src, dst, full)
                add(counts)
                world1[label] = res
                lines.append(line)
                del g, src, dst
                torch.cuda.empty_cache()
            if not full:
                lines.extend(mesh_cc_ranks(torch, world1, card))
            del world1
        lines.append(mesh_moe(torch, dev, card, counted))
        lines.append(mesh_compression(torch, dev, card))
    finally:
        dist.destroy_process_group()
    lines.extend(mesh_dryrun(card, dryrun_job))
    return lines, counts_all


# ---------------------------------------------------------------------------
# 5o. The sharded cells (the DTensor half of the mesh code)
# ---------------------------------------------------------------------------

# Phase 5o a: each cell built on the world-1 NCCL mesh against the same
# cell with no mesh, on the card: llama3.2-1b's train step at 5m b's
# reduced batch, moonshot's prefill at the largest batch of prefill_32k's
# length that fits beside its 56.1 GB of weights (2: its MoE dispatch holds
# about 8 GB a batch row), GAT at minibatch_lg and DIEN at train_batch,
# each train cell from MESH_CELL_START (a nonzero learning rate): one step
# compared, then MESH_CELL_TIMED steps timed each way.
MESH_CELL_TRAIN = (("llama3.2-1b", "train_4k", {"batch": 4}),
                   ("gat-cora", "minibatch_lg", {}),
                   ("dien", "train_batch", {}))
MESH_CELL_PREFILL = ("moonshot-v1-16b-a3b", "prefill_32k", {"batch": 2})
MESH_CELL_START = {"lm": 1999, "gnn": 5000, "recsys": 250}
MESH_CELL_TIMED = 2
MESH_CELL_TOL = 1e-5
MESH_CELL_SCALED_TOL = {"lm": 1e-5, "gnn": 1e-4, "recsys": 1e-4}
# Phase 5o b: 8 gloo ranks on the host's CPU, the (2, 4) mesh, against one
# rank; moonshot with its three mesh fields and a capacity factor at which
# no smoke token is dropped (capacity counts per data shard, so with drops
# the two shardings would route differently).
MESH_CELL_RANKS = 8
MESH_CELL_RANK_TIMEOUT_S = 300
MESH_CELL_RANK_ARCHS = ("qwen3-1.7b", "moonshot-v1-16b-a3b", "gat-cora",
                        "dien")
MESH_CELL_NO_DROP = 8.0
# Phase 5o d: launch.cost_analysis on a's cells against what a measured:
# the predicted peak memory of a step within COST_PEAK_TOL of the mesh
# step's, the counted flops within COST_FLOP_TOL of the profiler's count
# of the same products in the plain step. The card's dense peak rates (the
# H100 SXM data sheet at 700 W), bf16 on the tensor cores and float32
# (TF32 off) beside them.
COST_PEAK_TOL = 0.25
COST_FLOP_TOL = 0.02
COST_JOB_TIMEOUT_S = 900
PRODUCT_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
PEAK_FLOP_PER_S = {"bfloat16": BF16_FLOP_PER_S, "float32": 67e12}


def step_memory(torch, fn, args) -> tuple:
    """``(fn(), {"argument_gb", "step_peak_gb", "peak_gb"})``: the bytes of
    ``args`` on the card, and the most the step held above what was
    allocated before it; ``peak_gb`` is their sum. The peak counter is
    reset for the step; the peak before it is kept in ``before_gb``."""
    torch.cuda.synchronize()
    before = torch.cuda.max_memory_allocated()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    above = torch.cuda.max_memory_allocated() - base
    from repro_torch.launch.cost_analysis import storage_bytes
    arg = storage_bytes(args)
    return out, {"argument_gb": arg / 1e9, "step_peak_gb": above / 1e9,
                 "peak_gb": (arg + above) / 1e9, "before_gb": before / 1e9}


def profiled_flops(torch, fn, *, kernels: bool = True) -> tuple:
    """``(fn(), {"products", "products_entered", "all"})`` from
    ``torch.profiler``'s ``with_flops``: the flops of the products
    (PRODUCT_OPS) that ran, of every product the host entered, and of
    every op the profiler has a formula for (also ``mul`` and ``add``).
    The profiler records an op when the host enters it: under
    ``torch.utils.checkpoint``'s early stop the replay of a region ends
    inside the op whose inputs it saves last, which then runs no kernel.
    So with ``kernels`` (a step under autograd) the card's activity is
    traced too and a product counts as run only if it launched a kernel;
    without (a call under ``no_grad``, where nothing is replayed) the
    host's activity alone is traced, every product entered runs, and a
    long call's hundreds of thousands of kernels are not traced."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CPU]
    if kernels:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, with_flops=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    if not kernels:
        # The profiler's own events, not its parsed tree: parsing a long
        # call's million events takes minutes of host time.
        entered = every = 0.0
        for e in prof.profiler.kineto_results.events():
            f = e.flops()
            if f:
                every += f
                if e.name() in PRODUCT_OPS:
                    entered += f
        return out, {"products": entered, "products_entered": entered,
                     "all": every, "seconds": time.perf_counter() - t0}
    ran = entered = every = 0.0
    for e in prof.events():
        if not e.flops:
            continue
        every += e.flops
        if e.name in PRODUCT_OPS:
            entered += e.flops
            dt = getattr(e, "device_time_total", None)
            if dt is None:
                dt = e.cuda_time_total
            if dt > 0:
                ran += e.flops
    return out, {"products": ran, "products_entered": entered, "all": every,
                 "seconds": time.perf_counter() - t0}


def mesh_cell_train(torch, dev, card, counted, mesh, arch, shape_name,
                    changes) -> tuple:
    """Phase 5o a for one train cell: ``build_cell`` with no mesh and with
    the world-1 ``mesh``, the same seed-0 weights, the optimizer step set
    to MESH_CELL_START, the same first batch: one step each, its loss, grad
    norm and every updated parameter (the float32 master copy) compared,
    then MESH_CELL_TIMED steps timed each way (the host's clock, the card
    idle at both ends). ``(line, the mesh path's counts)``."""
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.train.step import build_cell
    spec, name = reduced_spec(arch, shape_name, **changes)
    shape = spec.shapes[name]
    cfg = spec.make_config()
    out = {}
    for way, m in (("plain", None), ("mesh", mesh)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_fn, state, _ = build_cell(spec, name, m, device=dev)
        state["opt"]["step"] = torch.tensor(MESH_CELL_START[spec.family],
                                            dtype=torch.int32, device=dev)
        batches = synthetic_batches(spec, shape, cfg, device=dev)
        _, batch = next(batches)
        torch.cuda.synchronize()
        if m is None:      # 5o d: the profiler's flops of the plain step
            ((state, metrics), counts), flops = profiled_flops(
                torch, lambda: counted(lambda: step_fn(state, batch)))
            extra = {"profiler_flops": flops}
        else:              # 5o d: the mesh step's memory
            ((state, metrics), counts), memory = step_memory(
                torch, lambda: counted(lambda: step_fn(state, batch)),
                (state, batch))
            extra = {"step_memory": memory}
        res = {"loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]), "counts": counts,
               "master": {k: v.detach().clone() for k, v in gather_tree(
                   state["opt"]["master"]).items()}, **extra}
        ms = []
        for _ in range(MESH_CELL_TIMED):
            _, batch = next(batches)
            (state, _), t = wall_ms(torch, lambda: step_fn(state, batch))
            ms.append(t)
        res["step_ms"] = ms
        res["peak_gb"] = max(torch.cuda.max_memory_allocated() / 1e9,
                             res.get("step_memory", {}).get("before_gb", 0))
        out[way] = res
        del step_fn, state, batch, batches
    plain, meshed = out["plain"], out["mesh"]
    tol = MESH_CELL_SCALED_TOL[spec.family]
    for k in ("loss", "grad_norm"):
        check(abs(meshed[k] - plain[k]) <= MESH_CELL_TOL * abs(plain[k]),
              f"{arch}/{name}: mesh {k} {meshed[k]} vs {plain[k]}")
    check(set(meshed["master"]) == set(plain["master"]),
          f"{arch}/{name}: parameter names differ")
    worst, equal = 0.0, True
    for k, want in plain["master"].items():
        got = meshed["master"][k]
        equal = equal and bool(torch.equal(got, want))
        if spec.family != "lm":
            allclose_err(torch, got, want, MESH_CELL_TOL,
                         f"{arch}/{name} {k}")
        if float(want.abs().max()) > 0:
            worst = max(worst, scaled_err(torch, got, want, tol,
                                          f"{arch}/{name} {k} (scaled)"))
    counts = meshed["counts"]
    if spec.family == "recsys":
        check(counts["embed_bag"] > 0,
              f"{arch}/{name}: the mesh path never launched embed_bag")
    line = {"mesh_cell": f"{arch}/{shape_name}", "card": card,
            "reduced": changes, "mesh": "1x1 nccl", "kind": "train",
            "start_step": MESH_CELL_START[spec.family],
            "loss": [plain["loss"], meshed["loss"]],
            "grad_norm": [plain["grad_norm"], meshed["grad_norm"]],
            "params_bit_equal": equal, "params_max_scaled_err": worst,
            "step_ms": {w: out[w]["step_ms"] for w in out},
            "ms_per_step": {w: statistics.median(out[w]["step_ms"])
                            for w in out},
            "peak_gb": {w: out[w]["peak_gb"] for w in out},
            "launches": {k: v for k, v in counts.items() if v},
            "plain_launches": {k: v for k, v in plain["counts"].items()
                               if v},
            "step_memory": meshed["step_memory"],
            "profiler_flops": plain["profiler_flops"]}
    del out, plain, meshed
    torch.cuda.empty_cache()
    return line, counts


def mesh_cell_prefill(torch, dev, card, counted, mesh) -> tuple:
    """Phase 5o a: moonshot's prefill_32k at MESH_CELL_PREFILL's batch with
    no mesh and on the world-1 ``mesh`` (the reference's prefill policy:
    the batch over the data axes and the experts over ``model``, so the
    MoE runs ``moe_block_shard_map``), the same seed-0 weights and tokens:
    the logits compared, one call timed each way. ``(line, counts)``."""
    from repro_torch.train.step import build_cell
    arch, shape_name, changes = MESH_CELL_PREFILL
    spec, name = reduced_spec(arch, shape_name, **changes)
    shape = spec.shapes[name]
    cfg = spec.make_config()
    out = {}
    for way, m in (("plain", None), ("mesh", mesh)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_fn, params, _ = build_cell(spec, name, m, device=dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        tokens = torch.randint(0, cfg.vocab, (shape["batch"], shape["seq"]),
                               generator=gen, device=dev, dtype=torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if m is None:
            logits, counts = counted(lambda: step_fn(params,
                                                     {"tokens": tokens}))
            torch.cuda.synchronize()
            extra = {}
        else:              # 5o d: the mesh call's memory
            (logits, counts), memory = step_memory(
                torch, lambda: counted(lambda: step_fn(
                    params, {"tokens": tokens})), (params, tokens))
            extra = {"step_memory": memory}
        ms = (time.perf_counter() - t0) * 1e3
        out[way] = {"logits": logits, "ms": ms, "counts": counts,
                    "peak_gb": max(torch.cuda.max_memory_allocated() / 1e9,
                                   extra.get("step_memory", {}).get(
                                       "before_gb", 0)), **extra}
        if m is None:      # 5o d: the profiler's flops of one more call
            out[way]["profiler_flops"] = profiled_flops(
                torch, lambda: step_fn(params, {"tokens": tokens}),
                kernels=False)[1]
        del step_fn, params, tokens
    got, want = out["mesh"]["logits"], out["plain"]["logits"]
    check(bool(torch.isfinite(want).all())
          and want.shape == (shape["batch"], cfg.vocab),
          f"{arch}/{name}: logits {tuple(want.shape)}")
    err = scaled_err(torch, got, want, MESH_CELL_TOL,
                     f"{arch}/{name}: mesh logits")
    line = {"mesh_cell": f"{arch}/{shape_name}", "card": card,
            "reduced": changes, "mesh": "1x1 nccl", "kind": "prefill",
            "moe_expert_axis": "model", "bit_equal": bool(torch.equal(got,
                                                                      want)),
            "logits_max_scaled_err": err,
            "ms": {w: out[w]["ms"] for w in out},
            "peak_gb": {w: out[w]["peak_gb"] for w in out},
            "launches": {k: v for k, v in out["mesh"]["counts"].items()
                         if v},
            "step_memory": out["mesh"]["step_memory"],
            "profiler_flops": out["plain"]["profiler_flops"]}
    counts = out["mesh"]["counts"]
    del out, got, want
    torch.cuda.empty_cache()
    return line, counts


def mesh_rank_cell(torch, arch, mesh) -> dict:
    """One smoke train step of ``arch`` on ``mesh`` (CPU tensors) for
    phase 5o b: the seed-0 weights (GAT's attention vectors drawn from
    N(0, 0.5^2), away from the zero init whose gradients are rounding
    noise), seeded mid-training moments (m ~ N(0, 1e-3^2), v ~ U(1e-6,
    2e-6): from zero moments an element whose gradient lies at the noise
    floor takes a step of full size and random sign), the step at
    MESH_CELL_START, placed by the cell's rules; the loss, grad norm and,
    gathered whole, the new master weights, m and v."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch.train import smoke_spec, synthetic_batches
    from repro_torch.train.step import build_cell
    base = get_arch(arch)
    cfg = base.make_smoke_config()
    if base.family == "lm":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        if cfg.is_moe:
            cfg = dataclasses.replace(
                cfg, act_batch_axes=("data",), act_seq_axis="model",
                moe_expert_axis="model", capacity_factor=MESH_CELL_NO_DROP)
    spec = dataclasses.replace(smoke_spec(base, cfg),
                               make_smoke_config=lambda: cfg)
    step_fn, _, _ = build_cell(spec, "smoke", mesh, smoke=True, device="cpu")
    _, state, _ = build_cell(spec, "smoke", smoke=True, device="cpu")
    rng = np.random.default_rng(12)
    with torch.no_grad():
        for k, p in state["params"].named_parameters():
            if arch == "gat-cora" and ".a_" in k:
                p.copy_(torch.from_numpy(0.5 * rng.standard_normal(
                    tuple(p.shape)).astype(np.float32)))
                state["opt"]["master"][k].copy_(p)
            shape = tuple(p.shape)
            state["opt"]["m"][k] = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32) * 1e-3)
            state["opt"]["v"][k] = torch.from_numpy(
                rng.uniform(1e-6, 2e-6, shape).astype(np.float32))
    state["opt"]["step"] = torch.tensor(MESH_CELL_START[base.family],
                                        dtype=torch.int32)
    if base.family == "lm":
        specs = shr.flat_specs(shr.lm_param_specs(cfg, mesh, fsdp=spec.fsdp))
    elif base.family == "gnn":
        specs = shr.gnn_param_specs(state["params"])
    else:
        specs = shr.dien_param_specs(state["params"])
    state = shr.place_tree(state, {"params": specs,
                                   "opt": shr.opt_specs(specs)}, mesh)
    _, batch = next(synthetic_batches(spec, spec.shapes["smoke"], cfg,
                                      device="cpu"))
    state, metrics = step_fn(state, batch)
    out = {"loss": metrics["loss"].numpy(),
           "grad_norm": metrics["grad_norm"].numpy()}
    for part in ("master", "m", "v"):
        for k, t in shr.gather_tree(state["opt"][part]).items():
            out[f"{part}/{k}"] = t.numpy()
    return out


def mesh_cells_rank_main(args) -> int:
    """One process of phase 5o b (CPU tensors, gloo, rendezvous through a
    FileStore): the smoke step of each of MESH_CELL_RANK_ARCHS on the (2,
    world / 2) ``("data", "model")`` mesh, or at world 1 on (1, 1); writes
    ``rank<R>.npz`` (every rank its loss and grad norm, rank 0 also the
    gathered state)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    world = args.mesh_world
    dist.init_process_group("gloo", store=dist.FileStore(args.mesh_store,
                                                         world),
                            rank=args.mesh_rank, world_size=world)
    try:
        mesh = make_host_mesh(2 if world > 1 else 1, max(world // 2, 1),
                              device_type="cpu")
        out = {}
        for arch in MESH_CELL_RANK_ARCHS:
            res = mesh_rank_cell(torch, arch, mesh)
            for k, v in res.items():
                if args.mesh_rank == 0 or k in ("loss", "grad_norm"):
                    out[f"{arch}/{k}"] = v
        np.savez(pathlib.Path(args.mesh_out) / f"rank{args.mesh_rank}.npz",
                 **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def mesh_cell_ranks(torch, card) -> dict:
    """Phase 5o b: MESH_CELL_RANKS processes of this script on the (2, 4)
    mesh beside one at world 1, all on the host's CPU (no card: there is no
    JAX on this machine, so the world-1 run is the reference): every
    rank's loss and grad norm, and rank 0's gathered master weights, m and
    v, within the float tolerances of the world-1 run's."""
    import numpy as np
    root = ROOT / "build" / "mesh_cells"
    runs = {}
    procs = []
    t0 = time.perf_counter()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for world in (MESH_CELL_RANKS, 1):
        d = root / f"world{world}"
        if d.exists():
            for f in d.iterdir():
                f.unlink()
        d.mkdir(parents=True, exist_ok=True)
        cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-cells",
               "--mesh-world", str(world), "--mesh-store", str(d / "store"),
               "--mesh-out", str(d)]
        procs += [(world, r, subprocess.Popen(
            cmd + ["--mesh-rank", str(r)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env))
            for r in range(world)]
    logs = []
    try:
        for _w, _r, p in procs:
            logs.append(p.communicate(timeout=MESH_CELL_RANK_TIMEOUT_S)[0])
    finally:
        for _w, _r, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for (world, r, p), log in zip(procs, logs):
        check(p.returncode == 0, f"mesh cell rank {r} of {world} exited "
              f"{p.returncode}:\n{log[-3000:]}")
    for world in (MESH_CELL_RANKS, 1):
        runs[world] = [dict(np.load(root / f"world{world}" / f"rank{r}.npz"))
                       for r in range(world)]
    want = runs[1][0]
    arch_errs = {}
    for arch in MESH_CELL_RANK_ARCHS:
        lm = arch in ("qwen3-1.7b", "moonshot-v1-16b-a3b")
        for k in ("loss", "grad_norm"):
            w = float(want[f"{arch}/{k}"])
            for r, res in enumerate(runs[MESH_CELL_RANKS]):
                g = float(res[f"{arch}/{k}"])
                check(abs(g - w) <= MESH_CELL_TOL * abs(w),
                      f"{arch} {k}: rank {r} {g} vs world 1 {w}")
        worst = 0.0
        got = runs[MESH_CELL_RANKS][0]
        for key in want:
            if not key.startswith(f"{arch}/") or key.endswith(
                    ("/loss", "/grad_norm")):
                continue
            g, w = torch.from_numpy(got[key]), torch.from_numpy(want[key])
            if not lm:
                allclose_err(torch, g, w, MESH_CELL_TOL, f"{key} (8 ranks)")
            if float(w.abs().max()) > 0:
                worst = max(worst, scaled_err(
                    torch, g, w, MESH_CELL_TOL if lm or "master" in key
                    else MESH_CELL_SCALED_TOL["gnn"], f"{key} (8 ranks)"))
        arch_errs[arch] = worst
    return {"mesh_cell_ranks": MESH_CELL_RANKS, "mesh": "2x4 gloo (CPU)",
            "torch": torch.__version__, "archs": list(MESH_CELL_RANK_ARCHS),
            "moonshot_capacity_factor": MESH_CELL_NO_DROP,
            "loss": {a: float(want[f"{a}/loss"])
                     for a in MESH_CELL_RANK_ARCHS},
            "max_scaled_err_vs_world1": arch_errs, "seconds": wall,
            "card": card}


def mesh_train_cli(torch, card, counted) -> tuple:
    """Phase 5o c: ``launch.train.main`` through its mesh cell (a spy on
    its ``build_cell`` records the mesh: world-1 NCCL, (1, 1)): gat-cora
    at full_graph_sm for 2 steps with a checkpoint every 2, then to 3,
    resuming at 2; DIEN at train_batch likewise (embed_bag on the mesh
    path)."""
    import contextlib
    import io
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch import train as train_cli
    from repro_torch.train import checkpoint as ckpt
    root = ROOT / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="mesh-cli-", dir=root))
    real = train_cli.build_cell
    meshes = []

    def spy(spec, shape_name, mesh=None, **kw):
        meshes.append((tuple(mesh.shape), dist.get_backend()))
        return real(spec, shape_name, mesh, **kw)

    total = {}
    lines = []
    train_cli.build_cell = spy
    try:
        for arch in ("gat-cora", "dien"):
            argv = ["--arch", arch, "--ckpt-every", "2", "--ckpt-dir",
                    str(tmp)]
            reports, secs = [], []
            for steps in (2, 3):
                out = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    loop, counts = counted(lambda: train_cli.main(
                        argv + ["--steps", str(steps)]))
                secs.append(time.perf_counter() - t0)
                reports.append(out.getvalue().splitlines())
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
                check(loop.step == steps
                      and reports[-1][-1].startswith(f"done: {steps} steps"),
                      f"train cli {arch} on the mesh: {reports[-1]}")
                check(not dist.is_initialized(),
                      "main left its process group behind")
            check(ckpt.latest_step(tmp / arch) == 2
                  and int(loop.state["opt"]["step"]) == 3,
                  f"train cli {arch}: resume at 2")
            if arch == "dien":
                check(total.get("embed_bag", 0) > 0,
                      "train cli dien: no embed_bag launch on the mesh path")
            lines.append({"mesh_train_cli": arch, "card": card,
                          "steps": [2, 3], "resumed_at": 2,
                          "seconds": secs, "report": reports[0] + reports[1],
                          "meshes": [f"{'x'.join(map(str, s))} {b}"
                                     for s, b in meshes]})
            meshes.clear()
    finally:
        train_cli.build_cell = real
        shutil.rmtree(tmp, ignore_errors=True)
    return lines, total


def analyze_cells_main(out: str) -> int:
    """Phase 5o d's predictions, in a process of its own without the card:
    ``launch.cost_analysis.analyze_cell`` on each of 5o a's cells at its
    cut, on a ``("data", "model")`` (1, 1) mesh (5o a's) over a fake world
    of one; JSON to ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.cost_analysis import analyze_cell
    from repro_torch.launch.dryrun import fake_world
    res = {}
    for arch, shape_name, changes in (*MESH_CELL_TRAIN, MESH_CELL_PREFILL):
        spec, name = reduced_spec(arch, shape_name, **changes)
        t0 = time.perf_counter()
        with fake_world(1):
            mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                              mesh_dim_names=("data", "model"))
            got = analyze_cell(spec, name, mesh)
        res[f"{arch}/{shape_name}"] = {
            "cost": got["cost"].to_json(),
            "memory_analysis": got["memory_analysis"],
            "dtype": str(spec.make_config().dtype).removeprefix("torch."),
            "seconds": time.perf_counter() - t0}
    pathlib.Path(out).write_text(json.dumps(res, indent=1))
    return 0


def cost_checks(torch, card, cell_lines: list, job: dict) -> list:
    """Phase 5o d: each of 5o a's cells, ``analyze_cell``'s prediction
    (``start_cost_jobs``) beside what 5o a measured: the predicted peak
    (arguments + temp) within COST_PEAK_TOL of the mesh step's, the
    counted flops within COST_FLOP_TOL of the profiler's products that
    ran in the plain step, and the achieved TFLOP/s (the counted flops
    over the mesh step's median time) and its share of the card's peak
    for the cell's dtype."""
    rc, text, wall = wait_job(job, COST_JOB_TIMEOUT_S, "5o d's analyses")
    check(rc == 0, f"5o d's analyses failed ({rc}):\n{text[-3000:]}")
    pred = json.loads(job["out"].read_text())
    lines = []
    for line in cell_lines:
        cell = line["mesh_cell"]
        p = pred[cell]
        mem, flops = p["memory_analysis"], p["cost"]["flops"]
        want = line["step_memory"]
        peak = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                ) / 1e9
        peak_ratio = peak / want["peak_gb"]
        prof = line["profiler_flops"]
        flop_ratio = flops / prof["products"] if prof["products"] else 0.0
        ms = (line["ms_per_step"]["mesh"] if line["kind"] == "train"
              else line["ms"]["mesh"])
        rate = flops / (ms / 1e3)
        out = {"cost_check": cell, "card": card, "reduced": line["reduced"],
               "mesh": line["mesh"], "kind": line["kind"],
               "predicted": {"argument_gb": mem["argument_size_in_bytes"]
                             / 1e9,
                             "temp_gb": mem["temp_size_in_bytes"] / 1e9,
                             "peak_gb": peak, "tflop": flops / 1e12,
                             "coll_gb": p["cost"]["collective_bytes"] / 1e9,
                             "bytes_accessed_gb":
                             p["cost"]["bytes_accessed"] / 1e9},
               "measured": {**{k: v for k, v in want.items()
                               if k != "before_gb"},
                            "profiler_tflop_products": prof["products"]
                            / 1e12,
                            "profiler_tflop_products_entered":
                            prof["products_entered"] / 1e12,
                            "profiler_tflop_all": prof["all"] / 1e12},
               "peak_ratio": peak_ratio, "flop_ratio": flop_ratio,
               "step_ms": ms, "achieved_tflop_s": rate / 1e12,
               "dtype": p["dtype"],
               "peak_share": rate / PEAK_FLOP_PER_S[p["dtype"]],
               "analyze_s": p["seconds"]}
        lines.append(out)
        check(abs(peak_ratio - 1) <= COST_PEAK_TOL,
              f"5o d {cell}: predicted peak {peak:.3f} GB against "
              f"{want['peak_gb']:.3f} GB measured")
        check(abs(flop_ratio - 1) <= COST_FLOP_TOL,
              f"5o d {cell}: counted {flops:.4e} flops against the "
              f"profiler's {prof['products']:.4e}")
    lines.append({"phase": "cost checks", "cells": len(lines),
                  "read_after_s": wall, "card": card})
    return lines


def mesh_cells_phase(torch, dev, card, counted, cost_job) -> tuple:
    """Phase 5o: ``(lines, counts)``, the counts those of the mesh paths of
    (a) and (c) (the CPU ranks of (b) launch no kernel)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    lines = []
    counts_all = {}

    def add(counts):
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v

    torch.cuda.empty_cache()
    mesh = make_host_mesh()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
          and tuple(mesh.shape) == (1, 1), "the 5o mesh is not world-1 NCCL")
    try:
        for arch, shape_name, changes in MESH_CELL_TRAIN:
            line, counts = mesh_cell_train(torch, dev, card, counted, mesh,
                                           arch, shape_name, changes)
            add(counts)
            lines.append(line)
        line, counts = mesh_cell_prefill(torch, dev, card, counted, mesh)
        add(counts)
        lines.append(line)
    finally:
        dist.destroy_process_group()
    cell_lines = list(lines)
    lines.append(mesh_cell_ranks(torch, card))
    cli_lines, counts = mesh_train_cli(torch, card, counted)
    add(counts)
    lines.extend(cli_lines)
    lines.extend(cost_checks(torch, card, cell_lines, cost_job))
    return lines, counts_all


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-out", type=pathlib.Path, default=None)
    # One rank of phase 5n b, started by this script itself.
    parser.add_argument("--mesh-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--mesh-world", type=int, default=MESH_RANKS,
                        help=argparse.SUPPRESS)
    parser.add_argument("--mesh-store", help=argparse.SUPPRESS)
    parser.add_argument("--mesh-out", help=argparse.SUPPRESS)
    # One process of phase 5o b (with the four flags above).
    parser.add_argument("--mesh-cells", action="store_true",
                        help=argparse.SUPPRESS)
    # Phase 5o d's analyses, started by this script itself.
    parser.add_argument("--analyze-cells", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.mesh_rank is not None:
        return (mesh_cells_rank_main if args.mesh_cells
                else mesh_rank_main)(args)
    if args.analyze_cells is not None:
        return analyze_cells_main(args.analyze_cells)

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
    # Phase 5n e's dry run and 5o d's analyses run on the host's CPU from
    # here on, beside the phases before them.
    cost_jobs = start_cost_jobs()

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
          **kernel_line(rows["pointer_jump_double"]),
          # The call's k passes, each reading and writing the table once;
          # and with each pass's gather one random 32-byte sector.
          "k_pass_bound_ms": bound(N_JUMPS * 8 * n_tab, 0)[0],
          "sector_bound_ms": bound(N_JUMPS * (8 + 32) * n_tab, 0)[0],
          "inputs": pj})
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
          **kernel_line(rows["list_rank_double"]),
          "k_pass_bound_ms": bound(N_JUMPS * 16 * n_list, 0)[0],
          "sector_bound_ms": bound(N_JUMPS * (16 + 32) * n_list, 0)[0],
          "inputs": lr})
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
        # Imported under its own name: main's ``profile(what, fn)`` below
        # takes the name ``profile`` in this scope.
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        def profiled(what, fn):
            with torch_profile(activities=[ProfilerActivity.CPU,
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
    # Host copies of the two graphs, for phase 5i's streams.
    stream_graphs = tuple((label, g.to("cpu")) for label, g, _ in cases)
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

    # 5i. The streaming layer: the table4/table5 smoke rows' counts on
    # small streams, then the eight full-size stream configurations.
    stream_rows = {}
    for r in json.loads((ROOT / "BENCH_rst.json").read_text()):
        if r.get("name", "").startswith(("table4_dynamic/smoke_",
                                         "table5_dynamic_bcc/smoke_")):
            stream_rows[r["name"]] = dict(
                kv.split("=") for kv in r["derived"].split(";"))
    check(len(stream_rows) == 32, f"{len(stream_rows)} table4/table5 smoke "
          "rows in BENCH_rst.json, want 32")
    t_streams = time.perf_counter()
    for glabel, make in (("smoke_chain_256", lambda: graphs.chain(256)),
                         ("smoke_rmat_6",
                          lambda: graphs.rmat(6, edge_factor=4, seed=0))):
        g = make()
        for kind in ("sliding_window", "churn"):
            for batch in (4, 16):
                zero_counts()
                counts = stream_smoke_counts(g, kind, batch)
                got = read_counts()
                for name in launches:
                    launches[name] += got[name]
                for table, prefix in (("table4", "table4_dynamic"),
                                      ("table5", "table5_dynamic_bcc")):
                    for tag in ("incremental", "recompute"):
                        row = f"{prefix}/{glabel}/{kind}/b{batch}/{tag}"
                        mine = {k: str(v) for k, v in
                                counts[f"{table}/{tag}"].items()}
                        want = {k: stream_rows[row][k] for k in mine}
                        check(mine == want, f"{row}: {mine}, want {want}")
    emit({"phase": "streams small", "rows": len(stream_rows),
          "seconds": time.perf_counter() - t_streams})

    def counted(fn):
        zero_counts()
        out = fn()
        return out, read_counts()

    def profile(what, fn):
        profiles.append(profiled(what, fn))

    heal_bases = {}
    for glabel, g_cpu in stream_graphs:
        for kind in STREAM_KINDS:
            for batch in STREAM_BATCHES:
                line, kept = stream_config(
                    torch, g_cpu, glabel, kind, batch, card, counted,
                    timed_call, (glabel, kind, batch) == STREAM_QUERY_CASE,
                    profile if args.profile_out is not None else None)
                if kept is not None:
                    heal_bases[glabel] = kept
                for name in launches:
                    launches[name] += line["launches"][name]
                line["launches"] = {k: v for k, v in line["launches"].items()
                                    if v}
                emit(line)
    emit({"phase": "streams", "seconds": time.perf_counter() - t_streams})

    # 5j. Self-healing: the table6 rows, the six injectors at K = 1 and 4 on
    # phase 5i's two churn B = 65,536 states, the resilient loop at full
    # size (with a kill and resume), and the streaming CLI under chaos.
    t_heal = time.perf_counter()
    heal_launches = dict.fromkeys(HEAL_KERNELS, 0)

    def add_heal(counts):
        for name in launches:
            launches[name] += counts[name]
        for name in HEAL_KERNELS:
            heal_launches[name] += counts[name]

    add_heal(heal_table6(torch, dev, counted))
    emit({"phase": "heal table6", "rows": 13,
          "seconds": time.perf_counter() - t_heal})
    from repro_torch.dynamic import audit_forest
    for glabel, base in heal_bases.items():
        check(bool(audit_forest(base["state"], base["tn"],
                                base["bcc"]).healthy),
              f"{glabel}: phase 5i's measured state fails its audit")
        for injector in HEAL_INJECTORS:
            for k in HEAL_FAULTS:
                line = heal_case(torch, glabel, base, injector, k, card,
                                 counted)
                add_heal(line["launches"])
                line["launches"] = {kk: v for kk, v in
                                    line["launches"].items() if v}
                emit(line)
    check(len(heal_bases) == 2, f"heal bases: {sorted(heal_bases)}")
    del heal_bases
    torch.cuda.empty_cache()
    loop_lines, counts = heal_loops(torch, dev, stream_graphs[1][1],
                                    stream_graphs[0][1], card, counted)
    for line in loop_lines:
        emit(line)
    add_heal(counts)
    line, counts = heal_cli(torch, counted)
    add_heal(counts)
    emit(line)
    del stream_graphs
    check(all(v > 0 for v in heal_launches.values()),
          f"a kernel of the heal path never launched: {heal_launches}")
    emit({"phase": "heal", "launches": heal_launches,
          "seconds": time.perf_counter() - t_heal})

    # 5k. The fleet: both schemas at full width against their sequential
    # twins, the buckets, the CLI, the table8/table9 smoke rows and the
    # union bcc_batch.
    t_fleet = time.perf_counter()
    fleet_launches = dict.fromkeys(launches, 0)

    def add_fleet(counts):
        for name in launches:
            launches[name] += counts.get(name, 0)
            fleet_launches[name] += counts.get(name, 0)

    g_grid = graphs.grid2d(1024, device="cpu")
    g_rmat = graphs.rmat(16, edge_factor=16, device="cpu")
    for glabel, g_cpu, tenants in (("grid2d(1024)", g_grid, 16),
                                   ("rmat(16, 16)", g_rmat, 32)):
        line = fleet_schema(torch, glabel, g_cpu, tenants, card, counted)
        add_fleet(line["launches"])
        line["launches"] = {k: v for k, v in line["launches"].items() if v}
        emit(line)
    line, counts = fleet_buckets(torch, g_grid, g_rmat, card, counted)
    add_fleet(counts)
    emit(line)
    del g_grid, g_rmat
    torch.cuda.empty_cache()
    lines, counts = fleet_cli(torch, counted)
    add_fleet(counts)
    for line in lines:
        emit(line)
    line, counts = fleet_smoke_counts(torch, counted)
    add_fleet(counts)
    emit(line)
    line, counts, _separate = fleet_bcc_batch(torch, card, counted)
    add_fleet(counts)
    emit(line)
    check(all(fleet_launches[k] > 0 for k in FLEET_KERNELS),
          f"a kernel of the fleet path never launched: {fleet_launches}")
    emit({"phase": "fleet", "launches": {k: v for k, v in
                                         fleet_launches.items() if v},
          "seconds": time.perf_counter() - t_fleet})

    # 5l. GNN training and the training CLI: the four GNNs' cells at full
    # width (ogb_products on meta), the RST-reordered pipeline, the CLI
    # (gat-cora with a resume, DIEN) and the loop's own checks.
    t_train = time.perf_counter()
    torch.cuda.empty_cache()
    train_launches = dict.fromkeys(launches, 0)

    def add_train(counts):
        for name in launches:
            launches[name] += counts.get(name, 0)
            train_launches[name] += counts.get(name, 0)

    for arch in GNN_ARCHS:
        for shape_name in GNN_CARD_SHAPES:
            line, counts = gnn_cell(
                torch, arch, shape_name, card, counted,
                profile if args.profile_out is not None else None)
            check(not any(counts.values()),
                  f"{arch}/{shape_name} launched a kernel: {counts}")
            emit(line)
            torch.cuda.empty_cache()
        emit(gnn_meta(torch, arch))
    line, counts = gnn_reorder(torch, card, counted,
                               profile if args.profile_out is not None
                               else None)
    add_train(counts)
    emit(line)
    torch.cuda.empty_cache()
    lines, counts = gnn_train_cli(torch, card, counted)
    add_train(counts)
    for line in lines:
        emit(line)
    line, counts = train_loop_checks(torch, card, counted)
    add_train(counts)
    emit(line)
    check(all(train_launches[k] > 0 for k in TRAIN_LOOP_KERNELS),
          f"a kernel of the training path never launched: {train_launches}")
    emit({"phase": "train", "launches": {k: v for k, v in
                                         train_launches.items() if v},
          "seconds": time.perf_counter() - t_train})

    # 5m. The LMs: serving at full width, the LM cells (cut to fit where
    # they do not), the float32 gates against the CPU; no kernel launched.
    t_lm = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    emit({"phase": "lm start", "matmul_allow_tf32":
          torch.backends.cuda.matmul.allow_tf32,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    lm_launches = dict.fromkeys(launches, 0)
    lm_profile = profile if args.profile_out is not None else None

    def add_lm(line, counts=None):
        for name in launches:
            n = (line["launches"] if counts is None else counts).get(name, 0)
            launches[name] += n
            lm_launches[name] += n

    for arch in LM_SERVE_ARCHS:
        line = lm_serve_line(torch, dev, arch, card, counted,
                             lm_profile if arch == LM_LONG[0] else None)
        add_lm(line)
        emit(line)
    line = lm_serve_cli(torch, dev, card, counted)
    add_lm(line)
    emit(line)
    for arch in LM_LONG:
        line = lm_decode_line(torch, dev, arch, "long_500k", card, counted)
        add_lm(line)
        emit(line)
    for line in (
            lm_decode_line(torch, dev, LM_LONG[0], "decode_32k", card, counted,
                           batch=LM_DECODE_BATCH),
            lm_prefill_line(torch, dev, LM_LONG[0], card, counted, lm_profile,
                            batch=LM_PREFILL_BATCH),
            lm_train_line(torch, dev, LM_LONG[0], card, counted, lm_profile,
                          batch=LM_TRAIN_BATCH),
            *lm_smoke_trains(torch, dev, card, counted)):
        add_lm(line)
        emit(line)
    for arch in LM_IDS:
        emit(lm_meta(torch, arch))
    lines, counts = lm_gate_lines(torch, dev, card, counted)
    add_lm(None, counts)
    for line in lines:
        emit(line)
    check(not any(lm_launches.values()),
          f"the LM path launched a kernel: {lm_launches}")
    emit({"phase": "lm", "matmul_allow_tf32":
          torch.backends.cuda.matmul.allow_tf32, "launches": lm_launches,
          "seconds": time.perf_counter() - t_lm})

    # 5n. The mesh code: distributed connectivity at world 1 (NCCL, full
    # width) and at four ranks (gloo on the card's tensors), the
    # expert-parallel MoE, the int8 gradient compression, the dry run.
    t_mesh = time.perf_counter()
    lines, counts = mesh_phase(torch, dev, card, counted,
                               cost_jobs["dryrun"])
    for line in lines:
        emit(line)
    for name in launches:
        launches[name] += counts.get(name, 0)
    check(counts.get("pointer_jump_double", 0) > 0,
          "the mesh path never launched pointer_jump_double")
    emit({"phase": "mesh", "launches": {k: v for k, v in counts.items()
                                        if v},
          "seconds": time.perf_counter() - t_mesh})

    # 5o. The sharded cells: each family's cell on the world-1 NCCL mesh
    # against no mesh, 8 gloo ranks on the CPU against one, the training
    # CLI through its mesh cell, the cost analysis against the first.
    t_cells = time.perf_counter()
    lines, counts = mesh_cells_phase(torch, dev, card, counted,
                                     cost_jobs["cells"])
    for line in lines:
        emit(line)
    for name in launches:
        launches[name] += counts.get(name, 0)
    emit({"phase": "mesh cells", "launches": {k: v for k, v in
                                              counts.items() if v},
          "seconds": time.perf_counter() - t_cells})

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
    try:
        rc = main()
    finally:
        stop_background()
    sys.exit(rc)
