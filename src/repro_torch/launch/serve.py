"""The LM serving CLI: ``python -m repro_torch.launch.serve --arch <id> [--smoke]``.

The port of ``repro.launch.serve``. Batched request loop over the decode
path: admits requests up to ``--batch``, prefills their prompts into the KV
cache token by token, then decodes greedily until ``--max-new`` tokens,
with the tokens left on the card. Reports prefill and decode throughput.
As in the reference, ``--smoke`` is on by default and cannot be turned
off, so the CLI serves the smoke config; ``serve_requests`` serves any
config and parameters. Runs on the card unless the caller of ``main``
names another device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.graph import resolve_device
from repro_torch.models import transformer as tfm


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def serve_requests(cfg: tfm.LMConfig, params: tfm.LMParams, *, batch: int,
                   prompt_len: int, max_new: int, requests: int,
                   seed: int = 0,
                   device: str | torch.device | None = None) -> dict:
    """Serve ``requests`` batches of ``batch`` random prompts (``prompt_len``
    ids each from ``np.random.default_rng(seed)``, drawn as the reference
    draws them): each batch gets a fresh ``prompt_len + max_new`` cache, its
    prompt decoded token by token, then ``max_new - 1`` greedy steps. Prints
    the reference's line a batch and returns ``{"prefill_s", "decode_s"}``
    (seconds a batch, clocked around work that ends in a synchronize) and
    ``"tokens"`` (each batch's greedy tokens [B, max_new] on the card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    max_len = prompt_len + max_new
    tp, td, outs = [], [], []
    for req in range(requests):
        prompts = torch.from_numpy(
            rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
        ).to(dev)
        cache = tfm.init_kv_cache(cfg, batch, max_len, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(prompt_len):
            logits, cache = tfm.decode_step(cfg, params, prompts[:, i], cache)
        _sync(dev)
        tp.append(time.perf_counter() - t0)

        tok = torch.argmax(logits, -1).to(torch.int32)
        toks = [tok]
        t0 = time.perf_counter()
        for _ in range(max_new - 1):
            logits, cache = tfm.decode_step(cfg, params, tok, cache)
            tok = torch.argmax(logits, -1).to(torch.int32)
            toks.append(tok)
        _sync(dev)
        td.append(time.perf_counter() - t0)
        outs.append(torch.stack(toks, 1))
        print(f"request batch {req}: prefill {tp[-1]*1e3:.0f} ms, "
              f"decode {td[-1]*1e3:.0f} ms "
              f"({batch*(max_new-1)/max(td[-1],1e-9):.0f} tok/s)")
    return {"prefill_s": tp, "decode_s": td, "tokens": outs}


def main(argv: list[str] | None = None, *,
         device: str | torch.device | None = None) -> dict:
    """The CLI: the arch's smoke config with parameters from seed 0 on
    ``device`` (the card unless the caller passes another) through
    ``serve_requests``, then the median decode throughput line. Returns
    ``serve_requests``' result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=[a for a in ARCH_IDS], default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--requests", type=int, default=2,
                    help="number of serving batches to run")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit(f"{args.arch} is not an LM; serving loop is for "
                         "decode-capable archs")
    dev = resolve_device(device)
    cfg = spec.make_smoke_config() if args.smoke else spec.make_config()
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    out = serve_requests(cfg, params, batch=args.batch,
                         prompt_len=args.prompt_len, max_new=args.max_new,
                         requests=args.requests, device=dev)
    td = out["decode_s"]
    print(f"\nmedian decode throughput: "
          f"{args.batch*(args.max_new-1)/np.median(td):.0f} tok/s "
          f"(batch={args.batch}, {args.arch}"
          f"{' smoke' if args.smoke else ''})")
    return out


if __name__ == "__main__":
    main()
