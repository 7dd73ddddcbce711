"""Self-healing streaming loop: watchdog, audit cadence, checkpoints.

The port of ``repro.launch.resilient``. ``ResilientStreamLoop`` wraps the
batch-dynamic serving path (``dynamic.replay.replay_batch`` and the
cadenced tour/BCC refreshes of a ``ForestView``) in a fault-tolerance
posture (DESIGN.md §8, §11):

* **Watchdog and retry**: each batch applies under a wall-clock watchdog
  (the clock stops after ``torch.cuda.synchronize()`` on the card). On
  ``StepTimeout`` or ``torch.cuda.OutOfMemoryError`` the batch retries
  from the last good state (``replay_batch`` is a pure function of
  (state, batch)). Those are the only errors retried: a device-side trap
  loses the CUDA context, so any other error, and the last failed retry,
  ends in a blocking checkpoint and a re-raise for the scheduler, which
  resumes from it. Nothing moves to the CPU.
* **Straggler EWMA**: per-batch wall times feed an EWMA; outliers are
  recorded with their step index.
* **Invariant auditing** (``audit_every``): every k batches
  ``dynamic.recovery.recover`` audits the forest and its caches and runs
  the repair ladder on a violation. With auditing or chaos on, one final
  recover runs after the last batch.
* **Chaos injection** (``chaos``): deterministic seeded faults
  (``dynamic.chaos.INJECTORS``) before the batch applies; seeds derive
  from (chaos_seed, step), so a resumed run replays the same faults. With
  chaos on, every step first runs the bounded structural audit (the
  apply path's engine loops need the forest invariants).
* **Sanitization** (``sanitize``): ``chaos.sanitize_batch`` runs in front
  of every apply; per-category counters accumulate in ``loop.quarantine``.
* **Checkpoint / resume**: every ``ckpt_every`` batches the serving state
  (forest, tour numbering, BCC cache) is published with
  ``train.checkpoint`` and the stream cursor in the manifest; ``resume()``
  restores the newest one onto the loop's device. Everything downstream of
  the cursor is deterministic, so a killed-and-resumed run ends
  bit-identical to an uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import pathlib
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.data.streams import EdgeStream
from repro_torch.dynamic.audit import audit_forest
from repro_torch.dynamic.chaos import (INJECTORS, merge_quarantine,
                                       sanitize_batch)
from repro_torch.dynamic.recovery import recover
from repro_torch.dynamic.replay import init_state, replay_batch
from repro_torch.dynamic.view import CadencePolicy, ForestView
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import RETRIED, StepTimeout

log = logging.getLogger("repro_torch.resilient")


@dataclasses.dataclass
class ResilientStreamLoop:
    """Fault-tolerant loop over one dynamic forest under an edge stream.

    Build with ``from_stream`` (which seeds the state and, when tour/BCC
    maintenance is on, primes the caches so the checkpoint tree's structure
    is fixed for the loop's lifetime), call ``resume()`` if restarts should
    pick up prior progress, then ``run(stream.batches)``.
    """

    state: Any                               # DynamicForest
    view: ForestView | None = None           # built in __post_init__

    tour_mode: str = "incremental"           # incremental | full | off
    bcc_mode: str = "off"                    # incremental | full | off
    tour_every: int = 4

    ckpt_dir: str | pathlib.Path | None = None
    ckpt_every: int = 0
    keep: int = 3
    async_ckpt: bool = True

    audit_every: int = 0
    chaos: Sequence[str] = ()
    chaos_every: int = 1
    chaos_seed: int = 0
    sanitize: bool = False

    max_retries: int = 2
    step_timeout_s: float | None = None
    straggler_factor: float = 3.0
    use_kernel: bool | None = None
    apply_fn: Callable = None                # (state, batch) -> (state, stats)

    # progress + telemetry
    cursor: int = 0
    applied: int = 0
    dropped_overflow: int = 0
    dropped_unmatched: int = 0
    retries: int = 0
    lat: list = dataclasses.field(default_factory=list)
    stragglers: list = dataclasses.field(default_factory=list)
    quarantine: dict = dataclasses.field(default_factory=dict)
    injected: list = dataclasses.field(default_factory=list)
    recoveries: list = dataclasses.field(default_factory=list)
    last_report: Any = None
    _ewma: float | None = None
    _writer: Any = None

    def __post_init__(self):
        if self.apply_fn is None:
            self.apply_fn = functools.partial(replay_batch,
                                              use_kernel=self.use_kernel)
        if self.view is None:
            self.view = ForestView(
                CadencePolicy(tour=self.tour_mode, bcc=self.bcc_mode,
                              every=self.tour_every),
                use_kernel=self.use_kernel)

    # -- the derived caches + their telemetry live on the ForestView ---------

    @property
    def tn(self):
        return self.view.tn

    @tn.setter
    def tn(self, value):
        self.view.tn = value

    @property
    def bcc(self):
        return self.view.bcc

    @bcc.setter
    def bcc(self, value):
        self.view.bcc = value

    @property
    def tour_lat(self) -> list:
        return self.view.tour_lat

    @property
    def bcc_lat(self) -> list:
        return self.view.bcc_lat

    # ---- construction ------------------------------------------------------

    @classmethod
    def from_stream(cls, stream: EdgeStream, capacity: int | None = None, *,
                    device: str | torch.device | None = None,
                    **config) -> "ResilientStreamLoop":
        """Seed the state from ``stream`` on ``device`` (the card unless the
        caller names another) and prime the maintained caches."""
        state = init_state(stream, capacity, device=device,
                           use_kernel=config.get("use_kernel"))
        loop = cls(state=state, **config)
        # Fix the checkpoint tree's structure up front: when maintenance
        # is on, the caches exist from step 0.
        loop.state = loop.view.prime(loop.state)
        return loop

    @classmethod
    def from_config(cls, stream: EdgeStream, cfg,
                    capacity: int | None = None,
                    **overrides) -> "ResilientStreamLoop":
        """Build from a ``launch.config.ServeConfig`` (the typed flag
        schema) instead of loose kwargs."""
        injectors = cfg.injector_names(INJECTORS)
        return cls.from_stream(
            stream, capacity,
            tour_mode=cfg.refresh.tour, bcc_mode=cfg.refresh.bcc,
            tour_every=cfg.refresh.tour_every,
            ckpt_dir=cfg.ckpt.ckpt_dir, ckpt_every=cfg.ckpt.ckpt_every,
            audit_every=cfg.chaos.audit_every, chaos=injectors,
            chaos_every=cfg.chaos.chaos_every,
            chaos_seed=cfg.chaos.chaos_seed, sanitize=cfg.chaos.sanitize,
            **overrides)

    # ---- checkpointing -----------------------------------------------------

    def _ckpt_tree(self):
        """The serving state as one tree; {} stands in for a disabled cache
        so the tree's structure never changes across the run."""
        return {"forest": self.state,
                "tour": self.tn if self.tn is not None else {},
                "bcc": self.bcc if self.bcc is not None else {}}

    def _save(self, blocking: bool | None = None):
        if self.ckpt_dir is None:
            return
        if self._writer is not None:
            self._writer.join()              # backpressure: one in flight
            self._writer = None
        self._writer = ckpt.save(
            self.ckpt_dir, self._ckpt_tree(), self.cursor,
            data_cursor=self.cursor, keep=self.keep,
            blocking=blocking if blocking is not None
            else not self.async_ckpt)

    def resume(self) -> int:
        """Restore the newest checkpoint, if any; returns the cursor."""
        if self.ckpt_dir is None or ckpt.latest_step(self.ckpt_dir) is None:
            return self.cursor
        tree, manifest = ckpt.restore(self.ckpt_dir, self._ckpt_tree())
        self.state = tree["forest"]
        if self.tn is not None:
            self.tn = tree["tour"]
        if self.bcc is not None:
            self.bcc = tree["bcc"]
        self.cursor = int(manifest["data_cursor"])
        log.info("resumed at batch %d", self.cursor)
        return self.cursor

    # ---- fault machinery ---------------------------------------------------

    def _inject(self, step: int):
        name = self.chaos[(step // max(self.chaos_every, 1))
                          % len(self.chaos)]
        rng = np.random.default_rng((self.chaos_seed, step))
        self.state, bcc2, desc = INJECTORS[name](self.state, self.bcc, rng)
        if self.bcc is not None:
            self.bcc = bcc2
        self.injected.append((step, desc))
        log.warning("chaos @%d: %s", step, desc)

    def _recover(self, step: int):
        self.state, tn2, bcc2, report, info = recover(
            self.state, self.tn, self.bcc, use_kernel=self.use_kernel)
        if self.tn is not None and tn2 is not None:
            self.tn = tn2
        if self.bcc is not None and bcc2 is not None:
            self.bcc = bcc2
        self.last_report = report
        if info["mode"] != "clean":
            self.recoveries.append((step, info))
            log.warning("recovery @%d: %s -> %s", step, report.summary(),
                        info["mode"])
        return info

    def _structural_guard(self) -> bool:
        """Bounded structural pre-check (the hot path's admission guard).

        ``apply_batch`` and the refreshes require the forest invariants:
        the engine's unbounded convergence loops never end on a cyclic
        parent table, and a corrupted ``rep`` breaks the link loop's
        acyclic-overlay contract. With chaos on, every step re-verifies
        the structure with the bounded audit and recovers on a violation;
        cache-only faults wait for the cadenced audit.
        """
        return bool(audit_forest(self.state,
                                 use_kernel=self.use_kernel).forest_ok)

    def _watchdog_apply(self, batch):
        t0 = time.perf_counter()
        new_state, stats = self.apply_fn(self.state, batch)
        if new_state.parent.is_cuda:
            torch.cuda.synchronize(new_state.device)
        dt = time.perf_counter() - t0
        if self.step_timeout_s and dt > self.step_timeout_s:
            raise StepTimeout(f"batch took {dt:.1f}s "
                              f"> {self.step_timeout_s}s")
        return new_state, stats, dt

    # ---- the loop ----------------------------------------------------------

    def step(self, step: int, batch):
        """Process one batch end to end (inject → sanitize → apply →
        refresh → audit → checkpoint); returns (stats, dt)."""
        with obs.span("tick", step=step):
            return self._step(step, batch)

    def _apply(self, step: int, batch):
        """``_watchdog_apply`` with the retries; on an error that is not
        retried, or the last retry's, a blocking checkpoint and a
        re-raise."""
        for attempt in range(self.max_retries + 1):
            try:
                return self._watchdog_apply(batch)
            except RETRIED as e:
                self.retries += 1
                log.warning("batch %d attempt %d failed: %s",
                            step, attempt, e)
                if attempt == self.max_retries:
                    self._save(blocking=True)
                    raise
                if isinstance(e, torch.cuda.OutOfMemoryError):
                    torch.cuda.empty_cache()
            except Exception:
                self._save(blocking=True)
                raise

    def _step(self, step: int, batch):
        n = self.state.n_nodes
        if self.chaos and (step + 1) % max(self.chaos_every, 1) == 0:
            with obs.span("inject", step=step):
                self._inject(step)
        if self.chaos and not self._structural_guard():
            with obs.span("audit_recover", step=step):
                self._recover(step)
        if self.sanitize:
            with obs.span("sanitize", step=step):
                batch, q = sanitize_batch(batch, n)
                merge_quarantine(self.quarantine, q)

        with obs.span("apply_batch", step=step):
            new_state, stats, dt = self._apply(step, batch)
        self.state = new_state
        self.lat.append(dt)

        # Applied-events accounting: work done, not traffic offered.
        ins_offered = int((np.asarray(batch.ins_u) < n).sum())
        del_offered = int((np.asarray(batch.del_u) < n).sum())
        overflow = int(stats["overflow"])
        del_found = int(stats.get("deletes_found", 0))
        self.applied += (ins_offered - overflow) + del_found
        self.dropped_overflow += overflow
        self.dropped_unmatched += del_offered - del_found

        if self._ewma is None:
            self._ewma = dt
        if dt > self.straggler_factor * self._ewma:
            self.stragglers.append((step, dt, self._ewma))
        self._ewma = 0.9 * self._ewma + 0.1 * dt

        # Cadenced cache maintenance (the view opens its own spans).
        self.state = self.view.refresh(self.state, step=step)

        if self.audit_every and (step + 1) % self.audit_every == 0:
            with obs.span("audit_recover", step=step):
                self._recover(step)

        self.cursor = step + 1
        if self.ckpt_every and (step + 1) % self.ckpt_every == 0:
            with obs.span("checkpoint", step=step):
                self._save()
        return stats, dt

    def run(self, batches, *, on_batch=None):
        """Drive every batch from the current cursor; returns the state.

        With auditing or chaos on, a final recover runs after the last
        batch (a fault injected after the last cadenced audit must not
        leak out of the loop).
        """
        for step in range(self.cursor, len(batches)):
            stats, dt = self.step(step, batches[step])
            if on_batch:
                on_batch(step, stats, dt)
        if self.audit_every or self.chaos:
            with obs.span("audit_recover", step=len(batches)):
                self._recover(len(batches))
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        return self.state

    def audit_now(self):
        """One out-of-cadence audit (no repair); returns the report."""
        report = audit_forest(self.state, self.tn, self.bcc,
                              use_kernel=self.use_kernel)
        self.last_report = report
        return report
