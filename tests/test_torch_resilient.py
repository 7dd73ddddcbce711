"""The port's checkpoints, ``ResilientStreamLoop``, serving config and
``serve_stream`` against the reference.

* ``train.checkpoint``: round trip (float32, bf16, int and bool tensors,
  and host ints), retention, tree mismatch, the async writer, and the
  port's dynamic-state objects with their host-int fields;
* ``ResilientStreamLoop``: the reference's loop configurations (polluted
  stream behind the sanitizer, chaos on a cadence, every injector), run by
  both packages on the same streams: final state, tour, BCC, injected
  steps and descriptions, recoveries (step, mode, info), quarantine and
  event counters all equal; kill after batch 8 and resume from the
  checkpoint, bit-identical to the uninterrupted run; the retry rule;
* ``launch.config``: ``ServeConfig`` / ``FleetConfig`` on the same argv
  give the reference's ``to_dict()`` and the same errors;
* ``serve_stream.main(..., device="cpu")``: ``--steps 0``, and the chaos
  soak of ``scripts/chaos_smoke.sh`` (its trace's events equal the
  reference's).
Tolerance: bit-equal.
"""
import argparse
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro import dynamic as jd
from repro import obs as jax_obs
from repro.data import graphs as jax_graphs
from repro.data import streams as jax_streams
from repro.launch import config as jax_config
from repro.launch import serve_stream as jax_serve
from repro.launch.resilient import ResilientStreamLoop as JaxLoop
from repro_torch import dynamic as td
from repro_torch import obs
from repro_torch.core import Graph
from repro_torch.data import streams
from repro_torch.launch import config
from repro_torch.launch import serve_stream
from repro_torch.launch.resilient import RETRIED, ResilientStreamLoop
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import StepTimeout
from test_torch_chaos import assert_bcc, assert_state, assert_tour


def _info(info: dict) -> dict:
    return {k: v if isinstance(v, str) else int(v) for k, v in info.items()}


# ---- checkpoints ------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=g),
                       "b": torch.randn(8, generator=g).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "mask": torch.rand(5, generator=g) > 0.5,
                    "count": 12}}


def _assert_trees_equal(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (name, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert torch.equal(x, y), name
        else:
            assert type(x) is type(y) and x == y, name


def test_save_restore_roundtrip(tmp_path):
    s = _tree()
    ckpt.save(tmp_path, s, step=3, data_cursor=42)
    like = _tree(seed=1)
    restored, manifest = ckpt.restore(tmp_path, like)
    assert manifest["step"] == 3 and manifest["data_cursor"] == 42
    _assert_trees_equal(restored, s)
    assert list(restored["opt"]) == list(s["opt"])


def test_retention_keeps_last_n(tmp_path):
    s = _tree()
    for step in range(6):
        ckpt.save(tmp_path, s, step=step, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    dirs = sorted(d.name for d in tmp_path.iterdir() if d.is_dir())
    assert dirs == ["step_0000000004", "step_0000000005"]


def test_tree_mismatch_rejected(tmp_path):
    ckpt.save(tmp_path, _tree(), step=0)
    bad = {"params": {"w": torch.zeros(8, 8)},
           "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    with pytest.raises(ValueError, match="tree mismatch"):
        ckpt.restore(tmp_path, bad)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", _tree())


def test_async_save_and_extra(tmp_path):
    t = ckpt.save(tmp_path, _tree(), step=9, blocking=False,
                  extra={"schema": "grid_8"})
    t.join(timeout=60)
    assert not t.is_alive()
    assert ckpt.latest_step(tmp_path) == 9
    _, manifest = ckpt.restore(tmp_path, _tree())
    assert manifest["extra"] == {"schema": "grid_8"}


# Lists and tuples flatten by index (a training state's parameter pairs), so
# a list is rejected for the unsupported leaf inside it.
@pytest.mark.parametrize("leaf", [object(), 0.25, True, [1, 2.5]])
def test_unsupported_leaf_rejected(tmp_path, leaf):
    with pytest.raises(TypeError, match="unsupported leaf"):
        ckpt.save(tmp_path, {"x": leaf}, step=0)


def test_dynamic_state_roundtrip_keeps_host_ints(tmp_path):
    """A forest, its numbering and its BCC cache, with the fields the port
    keeps as host ints (version, n_bcc, aux_rounds, seg_syncs,
    dirty_count, n_nodes), restored bit-equal and as ints."""
    g = Graph.from_reference_arrays(*_grid_arrays(8), device="cpu")
    s = streams.STREAMS["churn"](g, batch=16, n_batches=3, seed=1)
    state = td.init_state(s, device="cpu")
    for b in s.batches:
        state, _ = td.replay_batch(state, b)
    tn, state = td.refresh_tour(state, None)
    bcc = td.refresh_bcc(state, None, tour=tn)
    tree = {"forest": state, "tour": tn, "bcc": bcc}
    ckpt.save(tmp_path, tree, step=3, data_cursor=3)

    fresh = td.init_state(s, device="cpu")
    tn0, fresh = td.refresh_tour(fresh, None)
    like = {"forest": fresh, "tour": tn0,
            "bcc": td.refresh_bcc(fresh, None, tour=tn0)}
    assert like["forest"].version != state.version
    restored, _ = ckpt.restore(tmp_path, like)
    _assert_trees_equal(restored, tree)
    assert isinstance(restored["forest"].version, int)
    assert restored["forest"].version == state.version == 4
    for f in ("n_bcc", "aux_rounds", "seg_syncs", "dirty_count"):
        assert getattr(restored["bcc"], f) == getattr(bcc, f)
        assert isinstance(getattr(restored["bcc"], f), int)
    assert restored["forest"].parent.device.type == "cpu"


# ---- the resilient loop against the reference's -----------------------------

def _grid_arrays(side):
    jg = jax_graphs.grid2d(side)
    return jg.n_nodes, np.asarray(jg.src), np.asarray(jg.dst)


@functools.cache
def _streams(side, batch, n_batches, seed):
    jg = jax_graphs.grid2d(side)
    g = Graph.from_reference_arrays(*_grid_arrays(side), device="cpu")
    kw = dict(batch=batch, n_batches=n_batches, seed=seed)
    return (jax_streams.STREAMS["churn"](jg, **kw),
            streams.STREAMS["churn"](g, **kw))


LOOPS = {
    # tests/test_chaos_recovery.py's three loop configurations, and one
    # that fires every injector.
    "polluted": (8, 16, 6, 3, ("out_of_range", "self_loops",
                               "phantom_deletes"),
                 dict(tour_mode="incremental", bcc_mode="incremental",
                      tour_every=2, audit_every=2, sanitize=True)),
    "chaos": (8, 16, 8, 1, (),
              dict(tour_mode="incremental", bcc_mode="incremental",
                   tour_every=2, audit_every=2,
                   chaos=("parent_cycle", "pool_desync"), chaos_every=3,
                   chaos_seed=5)),
    "all_injectors": (16, 32, 12, 4, tuple(jd.POLLUTERS),
                      dict(tour_mode="incremental", bcc_mode="incremental",
                           tour_every=3, audit_every=4, sanitize=True,
                           chaos=tuple(jd.INJECTORS), chaos_every=2,
                           chaos_seed=8)),
    "full_modes": (8, 16, 8, 6, (),
                   dict(tour_mode="full", bcc_mode="full", tour_every=1,
                        audit_every=3, chaos=("stale_bcc", "rep_corrupt"),
                        chaos_every=2, chaos_seed=2)),
}


@functools.cache
def _reference_loop(case):
    side, batch, n_batches, seed, pollute, cfg = LOOPS[case]
    js, _ = _streams(side, batch, n_batches, seed)
    if pollute:
        js = jd.pollute_stream(js, pollute, seed=seed)
    loop = JaxLoop.from_stream(js, **cfg)
    with jax_obs.Tracer() as tr:
        loop.run(list(js.batches))
    return loop, [(e["name"], e["step"], e["args"]) for e in tr.events()]


def _assert_loops_equal(lt, lj):
    assert_state(lt.state, lj.state, "loop state")
    if lj.tn is None:
        assert lt.tn is None
    else:
        assert_tour(lt.tn, lj.tn, "loop tour")
    if lj.bcc is None:
        assert lt.bcc is None
    else:
        assert_bcc(lt.bcc, lj.bcc, "loop bcc")
    assert lt.injected == lj.injected
    assert [(s, _info(i)) for s, i in lt.recoveries] == \
        [(s, _info(i)) for s, i in lj.recoveries]
    assert lt.quarantine == lj.quarantine
    assert (lt.cursor, lt.applied, lt.dropped_overflow,
            lt.dropped_unmatched, lt.retries) == \
        (lj.cursor, lj.applied, lj.dropped_overflow, lj.dropped_unmatched,
         lj.retries)
    assert lt.last_report.summary() == lj.last_report.summary()


@pytest.mark.parametrize("case", sorted(LOOPS))
def test_loop_matches_reference(case):
    side, batch, n_batches, seed, pollute, cfg = LOOPS[case]
    _, ts = _streams(side, batch, n_batches, seed)
    if pollute:
        ts = td.pollute_stream(ts, pollute, seed=seed)
    loop = ResilientStreamLoop.from_stream(ts, device="cpu", **cfg)
    with obs.Tracer() as tr:
        state = loop.run(list(ts.batches))
    assert state is loop.state
    lj, events_j = _reference_loop(case)
    _assert_loops_equal(loop, lj)
    assert [(e["name"], e["step"], e["args"]) for e in tr.events()] == \
        events_j
    assert bool(td.audit_forest(state, loop.tn, loop.bcc).healthy)
    if cfg.get("chaos"):
        assert len(loop.injected) >= 2 and loop.recoveries
    if pollute:
        assert sum(loop.quarantine.values()) > 0


KILL_CONFIG = dict(tour_mode="incremental", bcc_mode="incremental",
                   tour_every=4, audit_every=4,
                   chaos=("parent_cycle", "pool_desync"), chaos_every=3,
                   chaos_seed=9, async_ckpt=False)


@functools.cache
def _reference_uninterrupted():
    js, _ = _streams(8, 16, 12, 2)
    loop = JaxLoop.from_stream(js, **KILL_CONFIG)
    loop.run(list(js.batches))
    return loop


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_kill_resume_bit_identical(tmp_path, async_ckpt):
    """Killed after batch 8, resumed from the checkpoint: bit-identical to
    the uninterrupted run (the port's and the reference's), the same
    injected steps after the cursor."""
    _, ts = _streams(8, 16, 12, 2)
    batches = list(ts.batches)
    cfg = dict(KILL_CONFIG, async_ckpt=async_ckpt)
    a = ResilientStreamLoop.from_stream(ts, device="cpu", **cfg)
    a.run(batches)
    _assert_loops_equal(a, _reference_uninterrupted())

    b1 = ResilientStreamLoop.from_stream(ts, device="cpu",
                                         ckpt_dir=tmp_path / "ck",
                                         ckpt_every=4, **cfg)
    b1.run(batches[:8])
    b2 = ResilientStreamLoop.from_stream(ts, device="cpu",
                                         ckpt_dir=tmp_path / "ck",
                                         ckpt_every=4, **cfg)
    assert b2.resume() == 8
    b2.run(batches)
    assert [s for s, _ in b2.injected] == [s for s, _ in a.injected
                                           if s >= 8]
    assert b2.injected == [x for x in a.injected if x[0] >= 8]
    assert_state(b2.state, a.state, "resumed")
    assert b2.state.version == a.state.version
    for f in ("pre", "size", "last", "comp", "parent"):
        assert torch.equal(getattr(b2.tn, f), getattr(a.tn, f)), f
    for f in ("rep", "low", "high", "articulation", "bridge", "edge_bcc",
              "parent", "pool_src", "pool_dst", "pool_valid", "tree_mask"):
        assert torch.equal(getattr(b2.bcc, f), getattr(a.bcc, f)), f
    for f in ("n_bcc", "aux_rounds", "seg_syncs", "dirty_count"):
        assert getattr(b2.bcc, f) == getattr(a.bcc, f), f
    assert ckpt.latest_step(tmp_path / "ck") == 12


def test_resume_without_checkpoint_keeps_cursor(tmp_path):
    _, ts = _streams(8, 16, 6, 3)
    loop = ResilientStreamLoop.from_stream(ts, device="cpu",
                                           ckpt_dir=tmp_path / "none")
    assert loop.resume() == 0
    loop2 = ResilientStreamLoop.from_stream(ts, device="cpu")
    assert loop2.resume() == 0


def test_retry_rule(tmp_path):
    """A ``StepTimeout`` is retried and counted; an error that is not
    retried, or the last retry's, publishes a blocking checkpoint and
    re-raises. Nothing is caught and carried on."""
    assert RETRIED == (StepTimeout, torch.cuda.OutOfMemoryError)
    _, ts = _streams(8, 16, 6, 3)
    batches = list(ts.batches)
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise StepTimeout("injected")
        return td.replay_batch(state, batch)

    loop = ResilientStreamLoop.from_stream(ts, device="cpu", apply_fn=flaky,
                                           tour_mode="off")
    ref = ResilientStreamLoop.from_stream(ts, device="cpu", tour_mode="off")
    loop.run(batches)
    ref.run(batches)
    assert loop.retries == 1 and ref.retries == 0
    assert_state(loop.state, ref.state, "after a retry")

    def broken(state, batch):
        raise RuntimeError("device-side trap")

    loop = ResilientStreamLoop.from_stream(
        ts, device="cpu", apply_fn=broken, tour_mode="off",
        ckpt_dir=tmp_path / "a")
    with pytest.raises(RuntimeError, match="device-side trap"):
        loop.run(batches)
    assert loop.retries == 0 and ckpt.latest_step(tmp_path / "a") == 0

    def hung(state, batch):
        raise StepTimeout("always")

    loop = ResilientStreamLoop.from_stream(
        ts, device="cpu", apply_fn=hung, tour_mode="off", max_retries=2,
        ckpt_dir=tmp_path / "b")
    with pytest.raises(StepTimeout):
        loop.run(batches)
    assert loop.retries == 3 and ckpt.latest_step(tmp_path / "b") == 0


def test_watchdog_raises_step_timeout():
    _, ts = _streams(8, 16, 6, 3)
    loop = ResilientStreamLoop.from_stream(ts, device="cpu", tour_mode="off",
                                           step_timeout_s=1e-9,
                                           max_retries=1)
    with pytest.raises(StepTimeout):
        loop.run(list(ts.batches))
    assert loop.retries == 2


def test_from_config_matches_reference():
    argv = ("--graph grid_64 --stream churn --batch 16 --steps 6 --bcc "
            "incremental --tour-every 2 --chaos parent_cycle,rep_corrupt "
            "--chaos-every 2 --chaos-seed 3 --audit-every 3 --sanitize")
    cfg_t = _parse(config, argv.split())
    cfg_j = _parse(jax_config, argv.split())
    _, ts = _streams(8, 16, 6, 3)
    js, _ = _streams(8, 16, 6, 3)
    lt = ResilientStreamLoop.from_config(ts, cfg_t, device="cpu")
    lj = JaxLoop.from_config(js, cfg_j)
    for f in ("tour_mode", "bcc_mode", "tour_every", "ckpt_dir",
              "ckpt_every", "audit_every", "chaos", "chaos_every",
              "chaos_seed", "sanitize"):
        assert getattr(lt, f) == getattr(lj, f), f
    lt.run(list(ts.batches))
    lj.run(list(js.batches))
    _assert_loops_equal(lt, lj)


# ---- launch.config -----------------------------------------------------------

def _parse(mod, argv, fleet=False):
    ap = argparse.ArgumentParser()
    mod.ServeConfig.add_args(ap)
    if fleet:
        mod.FleetConfig.add_args(ap)
    ns = ap.parse_args(argv)
    cfg = mod.ServeConfig.from_args(ns)
    return (cfg, mod.FleetConfig.from_args(ns)) if fleet else cfg


ARGVS = {
    "defaults": [],
    "chaos_smoke": ("--graph grid_64 --stream churn --batch 64 --steps 24 "
                    "--tour incremental --tour-every 4 --bcc incremental "
                    "--chaos all --chaos-every 4 --audit-every 4 --sanitize "
                    "--trace-out t.jsonl --validate").split(),
    "resume": ("--graph grid_64 --steps 16 --chaos parent_cycle,pool_desync "
               "--chaos-every 3 --audit-every 4 --ckpt-dir ck --ckpt-every 4 "
               "--resume").split(),
    "reads": ("--graph rmat_14 --stream sliding_window --window 6 --batch 8 "
              "--read-ratio 0.75 --read-batch 32 --query-staleness strict "
              "--metrics-out m.json --metrics-every 2 --seed 5").split(),
    "insert_heavy": ("--stream insert_heavy --tour full --tour-every 1 "
                     "--bcc full").split(),
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_serve_config_matches_reference(name):
    argv = ARGVS[name]
    cfg_t, cfg_j = _parse(config, argv), _parse(jax_config, argv)
    assert cfg_t.to_dict() == cfg_j.to_dict()
    assert config.ServeConfig.from_dict(cfg_t.to_dict()) == cfg_t
    assert json.loads(json.dumps(cfg_t.to_dict())) == cfg_t.to_dict()
    assert cfg_t.stream_kwargs() == cfg_j.stream_kwargs()
    assert cfg_t.injector_names(td.INJECTORS) == \
        cfg_j.injector_names(jd.INJECTORS)
    assert cfg_t.injector_names() == cfg_j.injector_names()
    assert cfg_t.check() is cfg_t
    cad_t, cad_j = cfg_t.cadence(), cfg_j.cadence()
    assert dataclasses.asdict(cad_t) == dataclasses.asdict(cad_j)


@pytest.mark.parametrize("argv", [
    "--read-ratio 1.5", "--read-ratio 0.5 --tour off",
    "--chaos parent_cycle,nope"])
def test_serve_config_errors_match_reference(argv):
    cfg_t = _parse(config, argv.split())
    cfg_j = _parse(jax_config, argv.split())
    errs = []
    for cfg, known in ((cfg_t, td.INJECTORS), (cfg_j, jd.INJECTORS)):
        with pytest.raises(ValueError) as e:
            cfg.check().injector_names(known)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("argv", [
    "", "--tenants 5 --slots 3 --drain 2 --evict-dir ev",
    "--buckets chain_64:12:4,rmat_9:2:2:32", "--buckets grid_8:3"])
def test_fleet_config_matches_reference(argv):
    (_, ft), (_, fj) = (_parse(config, argv.split(), fleet=True),
                        _parse(jax_config, argv.split(), fleet=True))
    assert dataclasses.asdict(ft) == dataclasses.asdict(fj)
    assert ft.check() is ft
    assert [dataclasses.asdict(b) for b in ft.bucket_specs()] == \
        [dataclasses.asdict(b) for b in fj.bucket_specs()]


@pytest.mark.parametrize("argv", [
    "--tenants 0", "--drain 0", "--buckets chain_64", "--buckets a:b",
    "--buckets chain_64:0", "--buckets ,"])
def test_fleet_config_errors_match_reference(argv):
    errs = []
    for mod in (config, jax_config):
        _, fc = _parse(mod, argv.split(), fleet=True)
        with pytest.raises(ValueError) as e:
            fc.check()
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# ---- serve_stream ------------------------------------------------------------

def test_serve_stream_zero_steps(capsys):
    """--steps 0 reports an empty run instead of crashing on percentiles."""
    serve_stream.main(["--graph", "chain_4k", "--stream", "churn",
                       "--batch", "16", "--steps", "0", "--tour", "off"],
                      device="cpu")
    assert "no batches applied" in capsys.readouterr().out


def test_serve_stream_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_stream.main(["--graph", "chain_4k", "--steps", "0",
                           "--tour", "off"])


def test_loop_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ts = _streams(8, 16, 6, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResilientStreamLoop.from_stream(ts)


def test_serve_stream_chaos_soak_matches_reference(tmp_path, capsys):
    """scripts/chaos_smoke.sh's first command: the trace holds the
    reference's audit_violation and recovery events (every recovery with a
    known mode and reason), and the report's lines match but for times."""
    argv = ("--graph grid_64 --stream churn --batch 64 --steps 24 "
            "--tour incremental --tour-every 4 --bcc incremental "
            "--chaos all --chaos-every 4 --audit-every 4 --sanitize "
            "--validate --trace-out").split()
    serve_stream.main(argv + [str(tmp_path / "t.jsonl")], device="cpu")
    out_t = capsys.readouterr().out
    jax_serve.main(argv + [str(tmp_path / "j.jsonl")])
    out_j = capsys.readouterr().out

    events = [r for r in obs.read_jsonl(str(tmp_path / "t.jsonl"))
              if r["type"] == "event"]
    events_j = [r for r in jax_obs.read_jsonl(str(tmp_path / "j.jsonl"))
                if r["type"] == "event"]
    assert [(e["name"], e["step"], e["args"]) for e in events] == \
        [(e["name"], e["step"], e["args"]) for e in events_j]
    violations = [e for e in events if e["name"] == "audit_violation"]
    recoveries = [e for e in events if e["name"] == "recovery"]
    assert violations and recoveries
    for e in violations:
        assert e["args"]["violations"] and e["args"]["n_violating"] > 0
    for e in recoveries:
        assert e["args"]["mode"] in ("scoped", "full", "refresh")
        assert e["args"]["reason"] in ("scoped_repair", "sever_insufficient",
                                       "reaudit_failed", "caches_stale")

    def untimed(out):
        keep = []
        for line in out.splitlines():
            if " ms " in line or "ms over" in line or "/sec" in line \
                    or "latency" in line or line.startswith("trace:"):
                continue
            keep.append(line)
        return keep
    assert untimed(out_t) == untimed(out_j)
    assert "partition==from-scratch: True" in out_t


def test_serve_stream_reads_and_metrics(tmp_path, capsys):
    """The read interleave and the metrics export run on the CPU and count
    what the reference counts."""
    argv = ("--graph grid_64 --stream churn --batch 32 --steps 4 "
            "--tour-every 2 --bcc incremental --read-ratio 0.5 "
            "--read-batch 64 --metrics-every 2 --metrics-out").split()
    serve_stream.main(argv + [str(tmp_path / "m.json")], device="cpu")
    out = capsys.readouterr().out
    jax_serve.main(argv + [str(tmp_path / "j.json")])
    out_j = capsys.readouterr().out
    pick = [ln for ln in out.splitlines()
            if ln.startswith(("query sync accounting", "reads:"))]
    assert pick and pick == [ln for ln in out_j.splitlines()
                             if ln.startswith(("query sync accounting",
                                               "reads:"))]
    def counts(path):
        return [m for m in json.loads(path.read_text())["metrics"]
                if m["type"] in ("counter", "gauge")]
    assert counts(tmp_path / "m.json") == counts(tmp_path / "j.json")
