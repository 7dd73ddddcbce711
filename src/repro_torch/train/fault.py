"""Fault-tolerance runtime: the watchdog's timeout error.

The port of ``repro.train.fault``'s ``StepTimeout``, which
``launch.resilient.ResilientStreamLoop`` raises when a batch outlasts its
watchdog and retries on. ``FaultTolerantLoop``, the training loop, is not
ported yet (ROADMAP §1, item 15).
"""
from __future__ import annotations


class StepTimeout(RuntimeError):
    """A step (a batch) took longer than its watchdog allows."""
