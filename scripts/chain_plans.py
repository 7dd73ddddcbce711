#!/usr/bin/env python3
"""Time the chain kernels' candidate plans on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 scripts/chain_plans.py [--unroll 1 2 4]

``pointer_jump_chain`` and ``list_rank_chain`` run any plan of
``repro_torch.kernels.hops`` (passes of table indices). On 2^24-entry
inputs (the relabelled random forest, the chain ``p[i] = i - 1`` and a
random function, as ``chip_smoke.py`` builds them) at k = 5 and k = 31,
this times in turns, behind a sleep on the card: the shipped plan; the
same plan without list ranking's packing pass (every gather from the input
then fetches two sectors); T^3 before T^2 at k = 5; all k + 1 hops in one
pass (the previous design's gathers in the new kernel); the packed
single-pass chain (pack, then k hops on the packed table); and the
previous kernels. Each result is held bit-equal to the plain version.
``--unroll`` rebuilds both sources with other ``kChainUnroll`` values
(into ``build/chain_plans/``, which ``.gitignore`` lists) and times the
shipped plans with each. Prints the card's name and power limit, then one
JSON line per input and count.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 1 << 24
# kChainUnroll in both sources.
SHIPPED_UNROLL = 2


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--unroll", type=int, nargs="*", default=[])
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chain_plans: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms_turns
    from repro_torch.kernels import build
    from repro_torch.kernels.hops import hop_schedule
    from repro_torch.kernels.list_rank import ops as lr_ops
    from repro_torch.kernels.list_rank.ref import list_rank_steps_ref
    from repro_torch.kernels.pointer_jump import ops as pj_ops
    from repro_torch.kernels.pointer_jump.ref import pointer_jump_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build.build(("pointer_jump", "list_rank"))
    shipped = {name: build._library(name)
               for name in ("pointer_jump", "list_rank")}
    variants = {SHIPPED_UNROLL: shipped, **{
        u: {name: _variant(build, name, u) for name in shipped}
        for u in args.unroll if u != SHIPPED_UNROLL}}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    below = (torch.rand(N, generator=gen, device=dev) * ids).to(torch.int32)
    perm = torch.randperm(N, generator=gen, device=dev).to(torch.int32)
    forest = torch.empty_like(perm)
    forest[perm.long()] = perm[below.long()]
    inputs = {"forest": forest, "chain": torch.clamp(ids - 1, min=0),
              "function": torch.randint(0, N, (N,), generator=gen,
                                        device=dev, dtype=torch.int32)}
    del below, perm

    for (label, table), k in itertools.product(inputs.items(), (5, 31)):
        succ = torch.where(table == ids, -1, table)
        dist = (succ != -1).to(torch.int32)
        want_p = pointer_jump_ref(table, k)
        want_l = list_rank_steps_ref(succ, dist, k)
        pj_plans = {"shipped": hop_schedule(k),
                    "one_pass": ((0,) * (k + 1),)}
        lr_plans = {"shipped": hop_schedule(k, pack_input=True),
                    "no_pack": hop_schedule(k),
                    "packed_chain": ((0,), (1,) * (k + 1)),
                    "one_pass": ((0,) * (k + 1),)}
        if k == 5:
            pj_plans["cube_first"] = lr_plans["cube_first"] = (
                (0, 0, 0), (1, 1))
        pj_fns = {"previous": lambda: pj_ops.pointer_jump_chain_previous(
            table, n_jumps=k)}
        lr_fns = {"previous": lambda: lr_ops.list_rank_chain_previous(
            succ, dist, n_steps=k)}
        for unroll, libs in variants.items():
            tag = "" if libs is shipped else f"_unroll{unroll}"
            for name, plan in pj_plans.items():
                if tag and name != "shipped":
                    continue
                fn = _with(build, libs, lambda plan=plan: pj_ops._launch_chain(
                    table, plan))
                _check(torch.equal(fn(), want_p), kernel="pointer_jump",
                       input=label, k=k, plan=name, unroll=unroll)
                pj_fns[name + tag] = fn
            for name, plan in lr_plans.items():
                if tag and name != "shipped":
                    continue
                fn = _with(build, libs, lambda plan=plan: lr_ops._launch_chain(
                    succ, dist, plan))
                got = fn()
                _check(torch.equal(got[0], want_l[0])
                       and torch.equal(got[1], want_l[1]),
                       kernel="list_rank", input=label, k=k, plan=name,
                       unroll=unroll)
                lr_fns[name + tag] = fn
        for kernel, fns in (("pointer_jump_chain", pj_fns),
                            ("list_rank_chain", lr_fns)):
            print(json.dumps({"kernel": kernel, "input": label, "k": k,
                              "n": N, "ms": cuda_ms_turns(torch, fns)}),
                  flush=True)
    return 0


def _variant(build, name: str, unroll: int) -> ctypes.CDLL:
    """``name``'s library built with ``kChainUnroll = unroll``."""
    out_dir = ROOT / "build" / "chain_plans"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = build.source(name).read_text()
    line = f"constexpr int kChainUnroll = {SHIPPED_UNROLL};"
    _check(line in src, source=str(build.source(name)), missing=line)
    cu = out_dir / f"{name}_unroll{unroll}.cu"
    cu.write_text(src.replace(line, f"constexpr int kChainUnroll = {unroll};"))
    lib = out_dir / f"lib{name}_unroll{unroll}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True, capture_output=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.kernel_error_string.argtypes = [ctypes.c_int]
    cdll.kernel_error_string.restype = ctypes.c_char_p
    return cdll


def _check(ok: bool, **what) -> None:
    if not ok:
        raise SystemExit(f"chain_plans: FAILED: {what}")


def _with(build, libs: dict, fn):
    """``fn`` run with ``build``'s loaded libraries swapped for ``libs``."""
    def run():
        saved = dict(build._LIBS)
        build._LIBS.update(libs)
        try:
            return fn()
        finally:
            build._LIBS.clear()
            build._LIBS.update(saved)
    return run


if __name__ == "__main__":
    sys.exit(main())
