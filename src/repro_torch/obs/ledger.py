"""SyncLedger: the single host-side sync-accounting path (DESIGN.md §14).

The port's own copy of ``repro.obs.ledger``. A "sync" is one host read of
a convergence flag, the device round-trip each engine loop pays per check.
Every engine loop counts its syncs and returns the count when asked
(``return_syncs=True``); host-side wrappers report it with
``record(phase, syncs)`` (``core.queries.build_tables`` records
``build_syncs``), and consumers read per-phase totals from the ledger
instead of re-deriving sums by hand.

The zero-sync contract (guarded by tests/test_torch_obs.py): recording
must not change what the device computes. Two properties make that free:

  1. the counts exist whether or not anything records them, so the
     wrappers run the same code with recording on or off;
  2. ``record`` is a no-op until a ledger is installed, and lazy
     (callable) sync values are only evaluated, so a device scalar is only
     read back to the host, while one is.

Install a ledger with ``with SyncLedger() as led:`` (re-entrant: nested
ledgers all observe every record, so a benchmark ledger can sit inside a
tracing session's ledger without stealing its records).
"""
from __future__ import annotations

from typing import Callable

#: installed ledgers, innermost last; module-level on purpose: the
#: serving loops are single-threaded host drivers.
_LEDGERS: list["SyncLedger"] = []


def current_ledger() -> "SyncLedger | None":
    """The innermost installed ledger, or None (recording disabled)."""
    return _LEDGERS[-1] if _LEDGERS else None


def recording() -> bool:
    return bool(_LEDGERS)


def record(phase: str, syncs, *, tenant=None, bucket=None) -> None:
    """Report ``syncs`` convergence checks spent in ``phase``.

    No-op when no ledger is installed. ``syncs`` may be an int, a 0-d
    device scalar, or a zero-arg callable returning either — callables
    (and device→host pulls) are only evaluated while a ledger is
    installed, so uninstrumented runs pay nothing. ``tenant`` and
    ``bucket`` are optional attribution labels (stable tenant id /
    sub-fleet bucket name, DESIGN.md §15); omitting them is the
    default and changes nothing.
    """
    if not _LEDGERS:
        return
    value = int(syncs() if isinstance(syncs, Callable) else syncs)
    for led in _LEDGERS:
        led.add(phase, value, tenant=tenant, bucket=bucket)


class SyncLedger:
    """Per-phase sync totals for one scope (a run, a benchmark row).

    Context manager: entering installs the ledger so module-level
    ``record`` calls land here; exiting uninstalls it (totals remain
    readable).
    """

    def __init__(self) -> None:
        self._totals: dict[str, int] = {}
        self._counts: dict[str, int] = {}
        self._tenant_totals: dict[tuple[str, object], int] = {}
        self._bucket_totals: dict[tuple[str, object], int] = {}

    # -- recording -----------------------------------------------------------

    def add(self, phase: str, syncs: int, *, tenant=None,
            bucket=None) -> None:
        self._totals[phase] = self._totals.get(phase, 0) + int(syncs)
        self._counts[phase] = self._counts.get(phase, 0) + 1
        if tenant is not None:
            key = (phase, tenant)
            self._tenant_totals[key] = \
                self._tenant_totals.get(key, 0) + int(syncs)
        if bucket is not None:
            key = (phase, bucket)
            self._bucket_totals[key] = \
                self._bucket_totals.get(key, 0) + int(syncs)

    # -- reading -------------------------------------------------------------

    def totals(self) -> dict[str, int]:
        """{phase: total syncs}, insertion-ordered."""
        return dict(self._totals)

    def counts(self) -> dict[str, int]:
        """{phase: number of records}."""
        return dict(self._counts)

    def total(self, phase: str | None = None) -> int:
        """Total syncs — one phase's, or across every phase."""
        if phase is not None:
            return self._totals.get(phase, 0)
        return sum(self._totals.values())

    def by_tenant(self, phase: str) -> dict:
        """{tenant: syncs} for records that carried a tenant label."""
        return {t: v for (p, t), v in self._tenant_totals.items()
                if p == phase}

    def by_bucket(self, phase: str) -> dict:
        """{bucket: syncs} for records that carried a bucket label."""
        return {b: v for (p, b), v in self._bucket_totals.items()
                if p == phase}

    def clear(self) -> None:
        self._totals.clear()
        self._counts.clear()
        self._tenant_totals.clear()
        self._bucket_totals.clear()

    # -- install/uninstall ---------------------------------------------------

    def __enter__(self) -> "SyncLedger":
        _LEDGERS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        # Remove *this* ledger even under exotic nesting orders.
        for i in range(len(_LEDGERS) - 1, -1, -1):
            if _LEDGERS[i] is self:
                del _LEDGERS[i]
                break
