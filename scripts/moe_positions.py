#!/usr/bin/env python3
"""Profile the MoE dispatch at moonshot-v1-16b-a3b's widths on one CUDA
card, and time three ways to compute its bucket positions.

Run from the repository root on a machine with a card:

    python3 scripts/moe_positions.py [--tokens 65536]

On a world-1 ``("data", "model")`` NCCL mesh, one
``moe_block_shard_map`` call in bf16 on ``--tokens`` tokens (16 rows of
``tokens / 16``) under ``torch.profiler`` (the top ops by device time),
then, on that call's routing, the time of each way to compute each
(token, slot)'s place in its expert's bucket, each held equal to
``models.transformer.moe_route``'s:
  * ``cumsum_outer``: ``moe_route``'s own, a cumulative sum down dim 0 of
    the [T·k, E] one-hot;
  * ``cumsum_inner``: the same sum along the inner dim of the [E, T·k]
    one-hot;
  * ``stable_sort``: a stable sort of the expert ids, each slot's rank
    after its expert's first (``searchsorted``).
Prints the card's name and power limit, the profile table and one JSON
line of CUDA-event medians (ms, 5 runs after a warm-up).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tokens", type=int, default=65536)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("moe_positions: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tt

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    mesh = make_host_mesh()
    base = get_arch("moonshot-v1-16b-a3b").make_config()
    cfg = dataclasses.replace(base, act_batch_axes=("data",),
                              act_seq_axis="model", moe_expert_axis="model")
    d, e, f = base.d_model, base.n_experts, base.d_ff
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev)
                * fan_in ** -0.5).to(torch.bfloat16)

    w = (normal((d, e), d), normal((e, d, f), d), normal((e, d, f), d),
         normal((e, f, d), f))
    x = torch.randn((16, args.tokens // 16, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    try:
        for _ in range(2):
            tt.moe_block_shard_map(x, *w, cfg, mesh)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tt.moe_block_shard_map(x, *w, cfg, mesh)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=12), flush=True)

        _g, top_e, pos, _keep, _cap = tt.moe_route(x.reshape(-1, d), w[0],
                                                   base)
        t, k = top_e.shape

        def cumsum_outer():
            flat_e = top_e.reshape(t * k, 1)
            onehot = F.one_hot(flat_e[:, 0], e)
            return (torch.cumsum(onehot, dim=0) - onehot).gather(
                1, flat_e).reshape(t, k)

        def cumsum_inner():
            flat_e = top_e.reshape(1, t * k)
            onehot = (torch.arange(e, device=dev)[:, None] == flat_e).to(
                torch.int32)
            return (torch.cumsum(onehot, dim=1) - onehot).gather(
                0, flat_e).reshape(t, k)

        def stable_sort():
            flat_e = top_e.reshape(-1)
            s = torch.sort(flat_e, stable=True)
            start = torch.searchsorted(
                s.values, torch.arange(e, device=dev, dtype=flat_e.dtype))
            out = torch.empty_like(flat_e)
            out[s.indices] = torch.arange(t * k, device=dev) - start[s.values]
            return out.reshape(t, k)

        times = {}
        for name, fn in (("cumsum_outer", cumsum_outer),
                         ("cumsum_inner", cumsum_inner),
                         ("stable_sort", stable_sort)):
            if not torch.equal(fn(), pos):
                print(f"moe_positions: {name} differs from moe_route",
                      file=sys.stderr)
                return 1
            runs = []
            for _ in range(5):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                runs.append(a.elapsed_time(b))
            times[name] = statistics.median(runs)
        print(json.dumps({"moe_positions": "moonshot-v1-16b-a3b",
                          "tokens": t, "top_k": k, "experts": e,
                          "ms": times}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
