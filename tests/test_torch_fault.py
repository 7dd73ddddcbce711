"""The port's ``FaultTolerantLoop`` and its checkpoints on the CPU.

The reference's loop tests (``tests/test_checkpoint_fault.py``) mirrored on
the port: resume at the last multiple of ``ckpt_every``, the straggler at
index 4, and, driving the port's dynamic forest (``replay_batch`` on the
churn stream of grid2d(8), integer work), three injected timeouts retried
to the forest of a clean run, the emergency checkpoint of the step-2
forest when the retries run out, and kill/resume bit-identical to an
uninterrupted run. Each forest is also held bit-equal to the reference's
loop on the same stream, and each loop's counts to the reference loop's.

Checkpoints of training states: DIEN's and each GNN's ``{"params": module,
"opt": AdamW state}`` round-trip bit-equal with ``requires_grad`` kept;
lists and tuples flatten by index; the leaf names of dicts and
dataclasses are unchanged.
"""
import dataclasses
import functools
import time

import numpy as np
import pytest
import torch

from repro.data import graphs as jax_graphs
from repro.data import streams as jax_streams
from repro.dynamic import init_state as jax_init_state
from repro.dynamic import replay_batch as jax_replay_batch
from repro.train.fault import FaultTolerantLoop as JaxLoop
from repro.train.fault import StepTimeout as JaxStepTimeout
from repro_torch.configs import get_arch
from repro_torch.data import graphs, streams
from repro_torch.dynamic import init_state, replay_batch
from repro_torch.launch.train import smoke_spec
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import RETRIED, FaultTolerantLoop, StepTimeout
from repro_torch.train.step import build_cell

FOREST_FIELDS = ("parent", "rep", "pool_src", "pool_dst", "pool_valid",
                 "tree_mask", "dirty")


def _data(n=None):
    c = 0
    while n is None or c < n:
        yield c, {}
        c += 1


def test_loop_resumes_at_the_last_checkpoint(tmp_path):
    """Train 10 steps w/ ckpt_every=4, kill, resume — continues from 8."""
    def step_fn(state, batch):
        s = state["opt"]["step"] + 1
        return ({"params": state["params"], "opt": {"step": s}},
                {"loss": 1.0 / s.float()})

    s0 = {"params": {"w": torch.zeros(2)},
          "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    loop = FaultTolerantLoop(step_fn=step_fn, state=s0, data_iter=_data(),
                             ckpt_dir=tmp_path, ckpt_every=4,
                             async_ckpt=False)
    loop.run(10)
    assert int(loop.state["opt"]["step"]) == 10
    loop2 = FaultTolerantLoop(step_fn=step_fn, state=s0, data_iter=_data(),
                              ckpt_dir=tmp_path, ckpt_every=4)
    assert loop2.resume() == 8
    loop2.run(12)
    assert int(loop2.state["opt"]["step"]) == 12
    assert ckpt.latest_step(tmp_path) == 12       # the async writer joined


def test_straggler_at_index_4(tmp_path):
    """Every step takes 10 ms and the fifth 260 ms: only the fifth is more
    than 3x the EWMA (steps of a few microseconds, as the reference's
    test has them, are 3x apart whenever the host is busy)."""
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        time.sleep(0.01)
        if calls["n"] == 5:
            time.sleep(0.25)               # synthetic straggler
        return state, {"loss": torch.zeros(())}

    loop = FaultTolerantLoop(step_fn=step_fn, state={"x": torch.zeros(())},
                             data_iter=_data(), ckpt_dir=tmp_path,
                             ckpt_every=1000, straggler_factor=3.0)
    loop.run(8)
    assert len(loop.stragglers) >= 1
    assert loop.stragglers[0][0] == 4      # 0-indexed step of the slow call


def test_watchdog_times_out_and_retries_only_its_errors(tmp_path):
    """A step over ``step_timeout_s`` raises StepTimeout (retried, then a
    checkpoint and the raise); an error outside ``RETRIED`` is not
    retried."""
    assert RETRIED == (StepTimeout, torch.cuda.OutOfMemoryError)

    def slow(state, batch):
        time.sleep(0.05)
        return state, {}

    loop = FaultTolerantLoop(step_fn=slow, state={"x": torch.zeros(())},
                             data_iter=_data(), ckpt_dir=tmp_path / "a",
                             step_timeout_s=0.01, max_retries=1)
    with pytest.raises(StepTimeout):
        loop.run(3)
    assert loop.retries == 2 and ckpt.latest_step(tmp_path / "a") == 0

    def broken(state, batch):
        raise ValueError("not transient")

    loop = FaultTolerantLoop(step_fn=broken, state={"x": torch.zeros(())},
                             data_iter=_data(), ckpt_dir=tmp_path / "b")
    with pytest.raises(ValueError):
        loop.run(3)
    assert loop.retries == 0 and ckpt.latest_step(tmp_path / "b") is None


# ---------------------------------------------------------------------------
# The loop driving the dynamic forest, against the reference's loop.

@functools.cache
def _streams(n_batches=12):
    kw = dict(batch=16, n_batches=n_batches, seed=5)
    return (jax_streams.STREAMS["churn"](jax_graphs.grid2d(8), **kw),
            streams.STREAMS["churn"](graphs.grid2d(8, device="cpu"), **kw))


def _forest_step(state, batch):
    state, stats = replay_batch(state, batch)
    return state, {"deletes_found": stats["deletes_found"]}


def _jax_forest_step(state, batch):
    state, stats = jax_replay_batch(state, batch)
    return state, {"deletes_found": stats["deletes_found"]}


def assert_forests_equal(a, b):
    for f in FOREST_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_array_equal(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x.numpy(), np.asarray(y) if not isinstance(
            y, torch.Tensor) else y.numpy(), err_msg=f)


def _flaky(step, fail_left, attempts, timeout):
    def flaky(state, batch):
        i = attempts["cursor"]
        attempts[i] = attempts.get(i, 0) + 1
        if fail_left.get(i, 0) >= attempts[i]:
            raise timeout(f"injected at step {i}")
        return step(state, batch)
    return flaky


def _cursor_data(batches, attempts, start=0):
    for c, b in enumerate(batches):
        if c >= start:
            attempts["cursor"] = c
            yield c, b


def test_forest_retries_are_sound(tmp_path):
    """Three injected StepTimeouts (one at step 3, two at step 7) are
    retried; the forest equals a clean run's and the reference loop's."""
    js, ts = _streams()
    ref = init_state(ts, device="cpu")
    for b in ts.batches:
        ref, _ = _forest_step(ref, b)
    fail_left = {3: 1, 7: 2}
    loops = []
    for loop_cls, step, timeout, s, init, d in (
            (JaxLoop, _jax_forest_step, JaxStepTimeout, js, jax_init_state,
             tmp_path / "jax"),
            (FaultTolerantLoop, _forest_step, StepTimeout, ts,
             functools.partial(init_state, device="cpu"), tmp_path / "port")):
        attempts = {}
        loop = loop_cls(step_fn=_flaky(step, fail_left, attempts, timeout),
                        state=init(s), data_iter=_cursor_data(s.batches,
                                                              attempts),
                        ckpt_dir=d, ckpt_every=4, max_retries=2,
                        async_ckpt=False)
        loop.run(len(s.batches))
        loops.append(loop)
    jloop, loop = loops
    assert loop.retries == jloop.retries == 3
    assert loop.step == jloop.step == 12
    assert_forests_equal(loop.state, ref)
    assert_forests_equal(loop.state, jloop.state)


def test_forest_final_failure_checkpoints_step_2(tmp_path):
    """Retries exhausted at step 2: the last good (step-2) forest is
    published, then the error is raised."""
    js, ts = _streams()
    attempts = {}

    def doomed(state, batch):
        if attempts["cursor"] == 2:
            raise StepTimeout("injected permanent fault")
        return _forest_step(state, batch)

    state0 = init_state(ts, device="cpu")
    loop = FaultTolerantLoop(step_fn=doomed, state=state0,
                             data_iter=_cursor_data(ts.batches, attempts),
                             ckpt_dir=tmp_path, ckpt_every=100,
                             max_retries=1, async_ckpt=False)
    with pytest.raises(StepTimeout):
        loop.run(len(ts.batches))
    assert loop.retries == 2               # max_retries + 1 attempts
    assert ckpt.latest_step(tmp_path) == 2
    restored, manifest = ckpt.restore(tmp_path, state0)
    assert manifest["data_cursor"] == 2
    assert_forests_equal(restored, loop.state)
    jstate = jax_init_state(js)
    for b in js.batches[:2]:
        jstate, _ = _jax_forest_step(jstate, b)
    assert_forests_equal(restored, jstate)
    assert restored.version == loop.state.version


def test_forest_kill_resume_is_bit_identical(tmp_path):
    """Kill after 6 steps, resume from the step-4 checkpoint, replay the
    cursor: the final forest equals an uninterrupted run's (and the
    reference loop's)."""
    js, ts = _streams()
    attempts = {}
    state0 = init_state(ts, device="cpu")
    ref = FaultTolerantLoop(step_fn=_forest_step, state=state0,
                            data_iter=_cursor_data(ts.batches, attempts),
                            ckpt_dir=tmp_path / "ref", ckpt_every=4,
                            async_ckpt=False)
    ref.run(len(ts.batches))
    dead = FaultTolerantLoop(step_fn=_forest_step, state=state0,
                             data_iter=_cursor_data(ts.batches, attempts),
                             ckpt_dir=tmp_path / "b", ckpt_every=4,
                             async_ckpt=False)
    dead.run(6)                            # "killed": ckpt exists at step 4
    heir = FaultTolerantLoop(step_fn=_forest_step, state=state0,
                             data_iter=None, ckpt_dir=tmp_path / "b",
                             ckpt_every=4, async_ckpt=False)
    assert heir.resume() == 4
    heir.data_iter = _cursor_data(ts.batches, attempts, start=4)
    heir.run(len(ts.batches))
    assert_forests_equal(heir.state, ref.state)
    assert heir.state.version == ref.state.version
    jref = JaxLoop(step_fn=_jax_forest_step, state=jax_init_state(js),
                   data_iter=enumerate(js.batches), ckpt_dir=tmp_path / "j",
                   ckpt_every=4, async_ckpt=False)
    jref.run(len(js.batches))
    assert_forests_equal(heir.state, jref.state)


# ---------------------------------------------------------------------------
# Checkpoints of training states.

def _train_state(arch_id):
    spec = get_arch(arch_id)
    spec = smoke_spec(spec, spec.make_smoke_config())
    _, state, _ = build_cell(spec, "smoke", smoke=True, device="cpu")
    return state


@pytest.mark.parametrize("arch_id", ["dien", "gat-cora", "schnet", "dimenet",
                                     "meshgraphnet"])
def test_train_state_round_trips(tmp_path, arch_id):
    state = _train_state(arch_id)
    gen = torch.Generator().manual_seed(1)
    for _, p in state["params"].named_parameters():
        p.data += torch.randn(p.shape, generator=gen)
    state["opt"]["step"] = torch.tensor(17, dtype=torch.int32)
    ckpt.save(tmp_path, state, step=5, data_cursor=4)
    like = _train_state(arch_id)
    restored, manifest = ckpt.restore(tmp_path, like)
    assert manifest["step"] == 5 and manifest["data_cursor"] == 4
    assert type(restored["params"]) is type(state["params"])
    want = dict(state["params"].named_parameters())
    got = dict(restored["params"].named_parameters())
    assert list(got) == list(want)
    for k, p in want.items():
        assert got[k].requires_grad and isinstance(got[k], torch.nn.Parameter)
        assert torch.equal(got[k].detach(), p.detach()), k
    for part in ("m", "v", "master"):
        assert list(restored["opt"][part]) == list(state["opt"][part])
        for k, t in state["opt"][part].items():
            assert torch.equal(restored["opt"][part][k], t)
    assert int(restored["opt"]["step"]) == 17
    names = [name for name, _ in ckpt._flatten(state)]
    assert names[0].startswith("['opt']") and \
        f"['params'].{next(iter(want))}" in names


def test_frozen_params_stay_frozen_and_lists_flatten_by_index(tmp_path):
    state = _train_state("gat-cora")
    state["params"].requires_grad_(False)
    tree = {"params": state["params"], "pairs": [(torch.arange(3), 4),
                                                  (torch.ones(2), 5)],
            "n": 7}
    ckpt.save(tmp_path, tree, step=1)
    restored, _ = ckpt.restore(tmp_path, tree)
    assert not any(p.requires_grad for p in restored["params"].parameters())
    assert isinstance(restored["pairs"], list)
    assert all(isinstance(x, tuple) for x in restored["pairs"])
    assert torch.equal(restored["pairs"][0][0], torch.arange(3))
    assert restored["pairs"][1][1] == 5 and restored["n"] == 7
    assert [n for n, _ in ckpt._flatten(tree)][:5] == [
        "['n']", "['pairs'][0][0]", "['pairs'][0][1]", "['pairs'][1][0]",
        "['pairs'][1][1]"]


def test_dict_and_dataclass_leaf_names_are_unchanged():
    @dataclasses.dataclass
    class Box:
        a: torch.Tensor
        k: int

    tree = {"b": Box(torch.zeros(2), 3), "a": {"z": torch.ones(1)}}
    assert [n for n, _ in ckpt._flatten(tree)] == ["['a']['z']", "['b'].a",
                                                   "['b'].k"]
