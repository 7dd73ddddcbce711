"""LM serving in the port against the JAX package on the CPU: the prefill
and decode cells of ``train/step.py`` and ``launch/serve.py``.

The cells, at the smoke configs of the five LMs on the same weights (the
reference's bf16 init, cast to float32 for the float32 runs) and the same
numpy-seeded tokens: the prefill cell's last-position logits, and three
steps of the decode cell (logits and the cache's K and V) against the
reference's jitted ``lm_prefill_cell`` / ``lm_decode_cell``. The bf16
cells are built by ``build_cell`` (under ``inference_mode``); the float32
ones by ``lm_prefill_cell`` / ``lm_decode_cell`` with the config replaced.
Tolerances as in ``tests/test_torch_transformer.py``.

``serve.main`` for every LM id: the reference's report lines (run beside
the reference's own CLI), the prompts drawn as the reference draws them,
and greedy tokens that are the argmax of the port's own teacher-forced
decode.
"""
import dataclasses
import functools
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jax_serve
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as jt
from repro.train import step as jax_step
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import transformer as tt
from repro_torch.train.step import build_cell, lm_decode_cell, lm_prefill_cell
from test_torch_transformer import (DTYPES, LM_ARCHS, configs, hold,
                                    port_params, reference_params, tokens)
from test_torch_transformer import one_torch_thread  # noqa: F401 (autouse)

BATCH, SEQ, CACHE = 2, 24, 8
REQUEST = re.compile(r"^request batch (\d+): prefill \d+ ms, decode \d+ ms "
                     r"\(\d+ tok/s\)$")
MEDIAN = re.compile(r"^median decode throughput: \d+ tok/s \(batch=(\d+), "
                    r"(\S+) smoke\)$")


@functools.cache
def reference_cells(arch: str, dtype: str):
    jc, _ = configs(arch, dtype)
    mesh = make_host_mesh()
    fsdp = get_arch(arch).fsdp
    prefill, _, _ = jax_step.lm_prefill_cell(jc, mesh, batch=BATCH, seq=SEQ,
                                             fsdp=fsdp)
    decode, _, _ = jax_step.lm_decode_cell(jc, mesh, batch=BATCH, seq=CACHE,
                                           fsdp=fsdp)
    p = reference_params(arch, dtype)
    toks = tokens(jc.vocab, (BATCH, SEQ), seed=3)
    logits = jax.jit(prefill)(p, {"tokens": toks})
    step = jax.jit(decode)
    cache = jt.init_kv_cache(jc, BATCH, CACHE)
    dec = []
    for i in range(3):
        out, cache = step(p, {"token": toks[:, i], "cache": cache})
        dec.append(out)
    return toks, logits, dec, cache


def _cells(arch, dtype):
    spec = get_arch(arch)
    _, tc = configs(arch, dtype)
    cpu = torch.device("cpu")
    if dtype == "float32":
        return (lm_prefill_cell(tc, batch=BATCH, seq=SEQ, device=cpu),
                lm_decode_cell(tc, batch=BATCH, seq=CACHE, device=cpu))
    spec = dataclasses.replace(spec, shapes={
        "p": dict(kind="prefill", batch=BATCH, seq=SEQ),
        "d": dict(kind="decode", batch=BATCH, seq=CACHE)})
    return (build_cell(spec, "p", smoke=True, device="cpu"),
            build_cell(spec, "d", smoke=True, device="cpu"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_cells(arch, dtype):
    _, tc = configs(arch, dtype)
    (prefill, _, p_in), (decode, _, d_in) = _cells(arch, dtype)
    assert p_in["tokens"].shape == (BATCH, SEQ)
    assert d_in["token"].shape == (BATCH,) and d_in["cache"]["k"].shape == (
        tc.n_layers, BATCH, tc.n_kv_heads, CACHE, tc.d_head)
    assert all(t.device.type == "meta" for t in (
        p_in["tokens"], d_in["token"], d_in["cache"]["k"]))
    toks, logits, dec, cache = reference_cells(arch, dtype)
    f32 = reference_cells(arch, "float32")
    params = port_params(arch, dtype)
    t = torch.from_numpy(toks)
    got = prefill(params, {"tokens": t})
    assert got.dtype == torch.float32 and got.shape == (BATCH, tc.vocab)
    assert got.is_inference()
    hold(got, logits, dtype, "prefill", f32[1])
    pc = tt.init_kv_cache(tc, BATCH, CACHE, device="cpu")
    for i in range(3):
        out, pc = decode(params, {"token": t[:, i], "cache": pc})
        hold(out, dec[i], dtype, f"decode step {i}", f32[2][i])
    assert pc["len"] == 3
    for name in ("k", "v"):
        hold(pc[name].transpose(2, 3), cache[name], dtype, f"cache {name}",
             f32[3][name])


def _reference_report(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jax_serve.main()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_main(monkeypatch, capsys, arch):
    argv = ["--arch", arch, "--batch", "3", "--prompt-len", "5",
            "--max-new", "4", "--requests", "2"]
    want = _reference_report(monkeypatch, capsys, argv)
    out = serve.main(argv, device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4 and got[2] == want[2] == ""
    for lines in (got, want):
        assert [int(REQUEST.match(ln).group(1)) for ln in lines[:2]] == [0, 1]
        assert MEDIAN.match(lines[3]).groups() == ("3", arch)
    assert len(out["prefill_s"]) == len(out["decode_s"]) == 2
    assert all(s > 0 for s in out["prefill_s"] + out["decode_s"])

    # The prompts are the reference's draws; each greedy token is the argmax
    # of the port's own decode, teacher-forced on prompt and tokens.
    cfg = get_arch(arch).make_smoke_config()
    params = tt.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(0)
    for req, toks in enumerate(out["tokens"]):
        assert toks.shape == (3, 4) and toks.dtype == torch.int32
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 5)
                                               ).astype(np.int32))
        cache = tt.init_kv_cache(cfg, 3, 9, device="cpu")
        with torch.inference_mode():
            for i in range(5):
                logits, cache = tt.decode_step(cfg, params, prompt[:, i], cache)
            for j in range(4):
                assert torch.equal(torch.argmax(logits, -1).int(),
                                   toks[:, j]), (req, j)
                logits, cache = tt.decode_step(cfg, params, toks[:, j], cache)


def test_serve_main_refuses_what_is_not_an_lm():
    with pytest.raises(SystemExit, match="not an LM"):
        serve.main(["--arch", "dien"], device="cpu")
