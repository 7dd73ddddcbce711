"""Fault-tolerance runtime: watchdog, retry, straggler log, checkpoints.

The port of ``repro.train.fault``:

1. **Checkpoint/restart** — ``FaultTolerantLoop`` checkpoints every
   ``ckpt_every`` steps (a background writer, one in flight, atomic
   publish; see checkpoint.py) and ``resume()`` restores the newest valid
   checkpoint, returning its step so the caller can replay the data cursor.

2. **Failure detection & retry** — each step runs under a watchdog: the
   clock stops once the step's work on the card is done
   (``torch.cuda.synchronize``; without it the clock would time only the
   launches and never fire). A step that outlasts ``step_timeout_s``
   raises ``StepTimeout``; on it, or on ``torch.cuda.OutOfMemoryError``,
   the step is retried from the last good state (steps are pure functions
   of (state, batch), so a retry is sound). When the retries are spent the
   loop publishes a last checkpoint of the last good state and re-raises.

3. **Straggler log** — per-step wall times feed an EWMA; steps slower than
   ``straggler_factor``× the EWMA are recorded.

``StepTimeout`` is also what ``launch.resilient.ResilientStreamLoop``
raises and retries on. There is no mesh, so ``resume()`` takes no
shardings.
"""
from __future__ import annotations

import dataclasses
import logging
import pathlib
import time
from typing import Any, Callable, Iterator

import torch

from repro_torch.train import checkpoint as ckpt

log = logging.getLogger("repro_torch.fault")


class StepTimeout(RuntimeError):
    """A step (a batch) took longer than its watchdog allows."""


#: The failures a step is retried on; both leave the CUDA context usable
#: (the reference: ``StepTimeout`` and ``JaxRuntimeError``).
RETRIED = (StepTimeout, torch.cuda.OutOfMemoryError)


@dataclasses.dataclass
class FaultTolerantLoop:
    step_fn: Callable                      # (state, batch) -> (state, metrics)
    state: Any
    data_iter: Iterator                    # yields (cursor, batch)
    ckpt_dir: str | pathlib.Path
    ckpt_every: int = 100
    keep: int = 3
    max_retries: int = 2
    straggler_factor: float = 3.0
    step_timeout_s: float | None = None
    async_ckpt: bool = True

    step: int = 0
    _ewma: float | None = None
    _writer: Any = None
    stragglers: list = dataclasses.field(default_factory=list)
    retries: int = 0

    def resume(self) -> int:
        """Restore the newest checkpoint if present; returns the start
        step."""
        latest = ckpt.latest_step(self.ckpt_dir)
        if latest is None:
            return 0
        self.state, manifest = ckpt.restore(self.ckpt_dir, self.state,
                                            step=latest)
        self.step = manifest["step"]
        log.info("resumed from step %d", self.step)
        return self.step

    def _watchdog_call(self, batch):
        t0 = time.time()
        new_state, metrics = self.step_fn(self.state, batch)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.time() - t0
        if self.step_timeout_s and dt > self.step_timeout_s:
            raise StepTimeout(f"step {self.step} took {dt:.1f}s "
                              f"> {self.step_timeout_s}s")
        return new_state, metrics, dt

    def run(self, n_steps: int, *, on_metrics=None):
        for cursor, batch in self.data_iter:
            if self.step >= n_steps:
                break
            for attempt in range(self.max_retries + 1):
                try:
                    new_state, metrics, dt = self._watchdog_call(batch)
                    break
                except RETRIED as e:
                    self.retries += 1
                    log.warning("step %d attempt %d failed: %s",
                                self.step, attempt, e)
                    if attempt == self.max_retries:
                        # Final failure: publish a last checkpoint for the
                        # scheduler's restart and re-raise.
                        ckpt.save(self.ckpt_dir, self.state, self.step,
                                  data_cursor=cursor, keep=self.keep)
                        raise
            self.state = new_state

            # Straggler detection (EWMA of step time).
            if self._ewma is None:
                self._ewma = dt
            if dt > self.straggler_factor * self._ewma:
                self.stragglers.append((self.step, dt, self._ewma))
                log.warning("straggler step %d: %.3fs vs ewma %.3fs",
                            self.step, dt, self._ewma)
            self._ewma = 0.9 * self._ewma + 0.1 * dt

            self.step += 1
            if self.step % self.ckpt_every == 0:
                if self._writer is not None:
                    self._writer.join()          # backpressure: one in flight
                self._writer = ckpt.save(self.ckpt_dir, self.state,
                                         self.step, data_cursor=cursor,
                                         keep=self.keep,
                                         blocking=not self.async_ckpt)
            if on_metrics:
                on_metrics(self.step, metrics, dt)
        if self._writer is not None:
            self._writer.join()
        return self.state
