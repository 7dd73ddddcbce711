#!/usr/bin/env python3
"""Time embed_bag's kernel against the designs not kept on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 scripts/embed_bag_plans.py [--variants NAME ...] [--lanes 9 5 3 2 1]

At DIEN's shapes, as ``chip_smoke.py`` builds them (serve_bulk's user
profile, 262,144 bags of 8 from the 100,000 x 18 user table, in float32 and
bf16; the same bags from a table of the item table's size, 10^6 x 18; and
serve_p99's 512 bags and retrieval's 1 bag from the user table), mean and
no weights as DIEN calls it, this times in turns behind a sleep on the
card: the kernel (``kernel``, one thread a 2-element chunk, 9 a bag at D =
18); the designs of ``scripts/embed_bag_variants.cu`` (``designs``: the
indices staged in shared memory, shared by warp shuffles, the row loads
cached in L2 only, and ``lanes<L>`` for each ``--lanes`` L: L threads a
bag, each serving its chunks in a loop), built here into
``build/embed_bag_plans/``; the previous kernel (``previous``), the plain
version (``plain``) and ``F.embedding_bag`` (``library``, its int64
indices made outside the window). Each kernel result is held bit-equal to
the previous kernel's and within the float tolerance of the plain version
before it is timed. ``--variants`` times only those named. Prints the
card's name and power limit, then one JSON line per case.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
VARIANTS = ("kernel", "designs", "previous", "plain", "library")
DESIGNS = ("staged", "shuffle", "l2_only", "lanes")   # the .cu's numbers


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", nargs="+", choices=VARIANTS,
                        default=list(VARIANTS))
    parser.add_argument("--lanes", type=int, nargs="+",
                        default=[9, 5, 3, 2, 1])
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("embed_bag_plans: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import EMBED_TOL, allclose_err, cuda_ms_turns
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels.embed_bag import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build.build(("embed_bag",))
    designs = _designs(build)
    cfg = get_arch("dien").make_config()
    bags, hot, dim = 262_144, cfg.user_hot, cfg.embed_dim
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tables = {rows: torch.randn((rows, dim), generator=gen, device=dev) * 0.05
              for rows in (cfg.n_user_feats, cfg.n_items)}
    idx = {rows: torch.randint(0, rows, (bags, hot), generator=gen,
                               device=dev, dtype=torch.int32)
           for rows in tables}
    u = cfg.n_user_feats
    cases = {"user_float32": (idx[u], tables[u]),
             "user_bfloat16": (idx[u], tables[u].to(torch.bfloat16)),
             "item_float32": (idx[cfg.n_items], tables[cfg.n_items]),
             "p99_512": (idx[u][:512], tables[u]),
             "retrieval_1": (idx[u][:1], tables[u])}
    for label, (ids, table) in cases.items():
        ids_long = ids.long()
        out = table.new_empty((ids.shape[0], dim))
        fns, checked = {}, {}
        if "kernel" in args.variants:
            fns["kernel"] = checked["kernel"] = (
                lambda ids=ids, table=table: ops.embed_bag(ids, table,
                                                           mean=True))
        if "designs" in args.variants:
            runs = [(DESIGNS.index(name), name, 0) for name in DESIGNS[:-1]]
            runs += [(DESIGNS.index("lanes"), f"lanes{lanes}", lanes)
                     for lanes in args.lanes]
            for number, name, lanes in runs:
                fns[name] = checked[name] = (
                    lambda number=number, lanes=lanes, ids=ids, table=table,
                    out=out: _run_design(torch, designs, number, lanes, ids,
                                         table, out))
        if "previous" in args.variants:
            fns["previous"] = lambda ids=ids, table=table: (
                ops.embed_bag_previous(ids, table, mean=True))
        if "plain" in args.variants:
            fns["plain"] = lambda ids=ids, table=table: ops.embed_bag(
                ids, table, mean=True, use_kernel=False)
        if "library" in args.variants:
            fns["library"] = lambda ids=ids_long, table=table: (
                torch.nn.functional.embedding_bag(ids, table, mode="mean"))
        previous = ops.embed_bag_previous(ids, table, mean=True)
        plain = ops.embed_bag(ids, table, mean=True, use_kernel=False)
        tol = EMBED_TOL[str(table.dtype).removeprefix("torch.")]
        allclose_err(torch, previous, plain, tol, f"{label} previous")
        bits = torch.int16 if table.element_size() == 2 else torch.int32
        for name, fn in checked.items():
            got = fn().clone()
            _check(torch.equal(got.view(bits), previous.view(bits)),
                   case=label, variant=name,
                   differs="from the previous kernel")
            allclose_err(torch, got, plain, tol, f"{label} {name}")
        print(json.dumps({"case": label, "bags": ids.shape[0], "hot": hot,
                          "dim": dim, "rows": table.shape[0],
                          "dtype": str(table.dtype).removeprefix("torch."),
                          "ms": cuda_ms_turns(torch, fns)}), flush=True)
    return 0


def _designs(build) -> ctypes.CDLL:
    """``scripts/embed_bag_variants.cu``, built with the kernels' flags."""
    out_dir = ROOT / "build" / "embed_bag_plans"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libembed_bag_variants.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(ROOT / "scripts" / "embed_bag_variants.cu")],
                   check=True, capture_output=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.embed_bag_variant.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    cdll.embed_bag_variant.restype = ctypes.c_int
    return cdll


def _run_design(torch, lib, number, lanes, ids, table, out):
    rc = lib.embed_bag_variant(
        number, ids.data_ptr(), table.data_ptr(), out.data_ptr(),
        ids.shape[0], table.shape[0], table.shape[1],
        int(table.dtype == torch.bfloat16), lanes,
        torch.cuda.current_stream().cuda_stream)
    _check(rc == 0, design=DESIGNS[number], lanes=lanes, cuda_error=rc)
    return out


def _check(ok: bool, **what) -> None:
    if not ok:
        raise SystemExit(f"embed_bag_plans: FAILED: {what}")


if __name__ == "__main__":
    sys.exit(main())
