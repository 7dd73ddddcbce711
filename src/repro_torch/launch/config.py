"""Typed serving configuration: one schema for every serving entry.

The port of ``repro.launch.config`` (stdlib only; the same argv gives the
same ``to_dict()``). ``ServeConfig`` is the single typed schema of the
serving loops' flags (DESIGN.md §7, §13):

  * sub-configs group the flags: ``StreamConfig`` (graph/stream/batch),
    ``RefreshConfig`` (tour/bcc cadence), ``ReadConfig`` (query
    interleave), ``ChaosConfig`` (injection/audit/sanitize),
    ``CheckpointConfig`` (crash recovery), ``ObsConfig`` (exports);
  * ``add_args``/``from_args`` bind the schema to argparse once;
  * ``to_dict``/``from_dict`` round-trip exactly, so a config can ride a
    checkpoint manifest or a job spec;
  * consumers take the config object: ``ResilientStreamLoop.from_config``
    reads it instead of copying kwargs.

``FleetConfig`` adds the multi-tenant knobs (tenant count, fleet slots,
eviction checkpoint directory, shape buckets) on top, for the fleet loop.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any

STREAM_NAMES = ("sliding_window", "insert_heavy", "churn")
TOUR_MODES = ("incremental", "full", "off")
BCC_MODES = ("incremental", "full", "off")
STALENESS_POLICIES = ("strict", "refresh", "stale")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """The write workload: which graph, which traffic regime, how much."""

    graph: str = "grid_64"
    stream: str = "churn"
    batch: int = 64
    steps: int = 32
    window: int = 4
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class RefreshConfig:
    """Derived-cache maintenance: tour/BCC modes + shared cadence."""

    tour: str = "incremental"
    tour_every: int = 4
    bcc: str = "off"


@dataclasses.dataclass(frozen=True)
class ReadConfig:
    """The query interleave (DESIGN.md §12)."""

    read_ratio: float = 0.0
    read_batch: int = 64
    query_staleness: str = "stale"


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Fault injection + self-healing cadence (DESIGN.md §11)."""

    chaos: str = ""
    chaos_every: int = 8
    chaos_seed: int = 0
    sanitize: bool = False
    audit_every: int = 0


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Crash recovery (DESIGN.md §8)."""

    ckpt_dir: str | None = None
    ckpt_every: int = 0
    resume: bool = False


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability exports (DESIGN.md §14)."""

    trace_out: str | None = None
    metrics_out: str | None = None
    metrics_every: int = 0


#: (attribute on ServeConfig, sub-config class) — the schema, in flag order.
_GROUPS = (("stream", StreamConfig), ("refresh", RefreshConfig),
           ("read", ReadConfig), ("chaos", ChaosConfig),
           ("ckpt", CheckpointConfig), ("obs", ObsConfig))


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything a serving loop needs, as one typed object."""

    stream: StreamConfig = dataclasses.field(default_factory=StreamConfig)
    refresh: RefreshConfig = dataclasses.field(
        default_factory=RefreshConfig)
    read: ReadConfig = dataclasses.field(default_factory=ReadConfig)
    chaos: ChaosConfig = dataclasses.field(default_factory=ChaosConfig)
    ckpt: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    validate: bool = False

    # -- argparse binding ----------------------------------------------------

    @staticmethod
    def add_args(ap: argparse.ArgumentParser) -> None:
        """Register the full flag surface (same names ``serve_stream``
        always had, so existing invocations keep working)."""
        g = ap.add_argument_group("workload")
        g.add_argument("--graph", default=StreamConfig.graph,
                       help="data.graphs.SUITE name")
        g.add_argument("--stream", default=StreamConfig.stream,
                       choices=STREAM_NAMES)
        g.add_argument("--batch", type=int, default=StreamConfig.batch)
        g.add_argument("--steps", type=int, default=StreamConfig.steps,
                       help="max update batches to apply")
        g.add_argument("--window", type=int, default=StreamConfig.window,
                       help="sliding_window retention (batches)")
        g.add_argument("--seed", type=int, default=StreamConfig.seed)

        g = ap.add_argument_group("cache refresh")
        g.add_argument("--tour", default=RefreshConfig.tour,
                       choices=TOUR_MODES,
                       help="tour refresh mode (full = ablation baseline)")
        g.add_argument("--tour-every", type=int,
                       default=RefreshConfig.tour_every,
                       help="refresh the tour numbering every k batches")
        g.add_argument("--bcc", default=RefreshConfig.bcc,
                       choices=BCC_MODES,
                       help="maintain pool biconnectivity at the tour "
                            "cadence (DESIGN.md §10)")

        g = ap.add_argument_group("reads")
        g.add_argument("--read-ratio", type=float,
                       default=ReadConfig.read_ratio,
                       help="fraction of events that are queries: per "
                            "write batch, issue read batches until "
                            "reads/(reads+writes) ~ r (0 = writes only)")
        g.add_argument("--read-batch", type=int,
                       default=ReadConfig.read_batch,
                       help="queries per read batch")
        g.add_argument("--query-staleness",
                       default=ReadConfig.query_staleness,
                       choices=STALENESS_POLICIES,
                       help="QuerySession policy between tour refreshes "
                            "(DESIGN.md §12)")

        g = ap.add_argument_group("chaos / self-healing")
        g.add_argument("--chaos", default=ChaosConfig.chaos,
                       help="comma-separated dynamic.chaos injector "
                            "names, or 'all' (deterministic fault "
                            "injection)")
        g.add_argument("--chaos-every", type=int,
                       default=ChaosConfig.chaos_every,
                       help="inject one fault every k batches")
        g.add_argument("--chaos-seed", type=int,
                       default=ChaosConfig.chaos_seed)
        g.add_argument("--sanitize", action="store_true",
                       help="quarantine malformed events before apply")
        g.add_argument("--audit-every", type=int,
                       default=ChaosConfig.audit_every,
                       help="audit invariants every k batches and run "
                            "the repair ladder on violation "
                            "(DESIGN.md §11)")

        g = ap.add_argument_group("checkpointing")
        g.add_argument("--ckpt-dir", default=CheckpointConfig.ckpt_dir,
                       help="checkpoint directory (enables crash "
                            "recovery)")
        g.add_argument("--ckpt-every", type=int,
                       default=CheckpointConfig.ckpt_every,
                       help="checkpoint every k batches")
        g.add_argument("--resume", action="store_true",
                       help="resume from the newest checkpoint in "
                            "--ckpt-dir")

        g = ap.add_argument_group("observability")
        g.add_argument("--trace-out", default=ObsConfig.trace_out,
                       help="write the span trace as JSONL here, plus "
                            "Chrome trace-event JSON (Perfetto-loadable) "
                            "at <path>.chrome.json (DESIGN.md §14)")
        g.add_argument("--metrics-out", default=ObsConfig.metrics_out,
                       help="write the metrics registry as JSON here at "
                            "loop end (and every --metrics-every batches)")
        g.add_argument("--metrics-every", type=int,
                       default=ObsConfig.metrics_every,
                       help="flush --metrics-out every k batches "
                            "(0 = only at loop end)")

        ap.add_argument("--validate", action="store_true",
                        help="oracle-check the final forest")

    @classmethod
    def from_args(cls, ns: argparse.Namespace) -> "ServeConfig":
        groups = {}
        for attr, sub in _GROUPS:
            kwargs = {f.name: getattr(ns, f.name)
                      for f in dataclasses.fields(sub)}
            groups[attr] = sub(**kwargs)
        return cls(validate=ns.validate, **groups)

    # -- serialization round-trip --------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ServeConfig":
        groups = {attr: sub(**d[attr]) for attr, sub in _GROUPS}
        return cls(validate=d["validate"], **groups)

    # -- validation ----------------------------------------------------------

    def check(self) -> "ServeConfig":
        """Cross-field validation; raises ValueError with an argparse-
        friendly message."""
        r = self.read.read_ratio
        if r and not 0.0 < r < 1.0:
            raise ValueError("--read-ratio must be in (0, 1)")
        if r and self.refresh.tour == "off":
            raise ValueError("--read-ratio needs tour maintenance "
                             "(--tour incremental|full)")
        if self.stream.stream not in STREAM_NAMES:
            raise ValueError(f"unknown stream {self.stream.stream!r}")
        return self

    # -- consumer views ------------------------------------------------------

    def injector_names(self, known=None) -> tuple[str, ...]:
        """The chaos injector tuple (validated against ``known``)."""
        if not self.chaos.chaos:
            return ()
        if self.chaos.chaos == "all":
            return tuple(known) if known is not None else ("all",)
        names = tuple(self.chaos.chaos.split(","))
        if known is not None:
            for name in names:
                if name not in known:
                    raise ValueError(
                        f"unknown injector {name!r} "
                        f"(have: {', '.join(known)})")
        return names

    def stream_kwargs(self) -> dict[str, Any]:
        """Generator kwargs for ``data.streams.STREAMS[...]``."""
        kw: dict[str, Any] = {"batch": self.stream.batch,
                              "seed": self.stream.seed}
        if self.stream.stream == "sliding_window":
            kw["window"] = self.stream.window
        if self.stream.stream == "churn":
            kw["n_batches"] = self.stream.steps
        return kw

    def cadence(self):
        """The ``dynamic.view.CadencePolicy`` this config describes."""
        from repro_torch.dynamic.view import CadencePolicy

        return CadencePolicy(tour=self.refresh.tour,
                             bcc=self.refresh.bcc,
                             every=self.refresh.tour_every,
                             queries=self.read.read_ratio > 0,
                             staleness=self.read.query_staleness)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One parsed ``--buckets`` entry: a shape class + its population."""

    graph: str
    tenants: int
    slots: int
    batch: int | None = None   # None → ServeConfig.stream.batch


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Multi-tenant knobs on top of ``ServeConfig`` (DESIGN.md §13, §15)."""

    tenants: int = 4
    slots: int = 4
    evict_dir: str | None = None
    buckets: str = ""
    drain: int = 1

    @staticmethod
    def add_args(ap: argparse.ArgumentParser) -> None:
        g = ap.add_argument_group("fleet")
        g.add_argument("--tenants", type=int, default=FleetConfig.tenants,
                       help="session graphs (one edge stream each)")
        g.add_argument("--slots", type=int, default=FleetConfig.slots,
                       help="resident fleet slots T; tenants beyond this "
                            "are admitted by LRU eviction")
        g.add_argument("--evict-dir", default=FleetConfig.evict_dir,
                       help="checkpoint-on-evict directory (default: "
                            "a temp dir)")
        g.add_argument("--buckets", default=FleetConfig.buckets,
                       help="shape-bucketed sub-fleets (DESIGN.md §15): "
                            "comma-separated graph:tenants[:slots[:batch]] "
                            "specs, e.g. 'chain_64:12:4,rmat_9:2:2:32'. "
                            "Graph names may be SUITE keys or "
                            "chain_<n>/grid_<side>/rmat_<scale>/er_<n> "
                            "patterns; batch defaults to --batch. "
                            "Overrides --graph/--tenants/--slots.")
        g.add_argument("--drain", type=int, default=FleetConfig.drain,
                       help="max dispatcher blocks per serving tick "
                            "(cross-tick carryover for bursty tenants; "
                            "1 = one block a tick)")

    @classmethod
    def from_args(cls, ns: argparse.Namespace) -> "FleetConfig":
        return cls(tenants=ns.tenants, slots=ns.slots,
                   evict_dir=ns.evict_dir, buckets=ns.buckets,
                   drain=ns.drain)

    def check(self) -> "FleetConfig":
        if self.tenants < 1 or self.slots < 1:
            raise ValueError("--tenants and --slots must be >= 1")
        if self.drain < 1:
            raise ValueError("--drain must be >= 1")
        if self.buckets:
            self.bucket_specs()   # raises ValueError on a bad spec
        return self

    def bucket_specs(self) -> tuple[BucketSpec, ...]:
        """Parse ``--buckets`` into ``BucketSpec``s (empty when unset)."""
        specs = []
        for part in filter(None, (p.strip()
                                  for p in self.buckets.split(","))):
            fields = part.split(":")
            if not 2 <= len(fields) <= 4:
                raise ValueError(
                    f"--buckets entry {part!r}: expected "
                    "graph:tenants[:slots[:batch]]")
            graph = fields[0]
            try:
                nums = [int(f) for f in fields[1:]]
            except ValueError:
                raise ValueError(
                    f"--buckets entry {part!r}: tenants/slots/batch "
                    "must be integers") from None
            tenants = nums[0]
            slots = nums[1] if len(nums) > 1 else tenants
            batch = nums[2] if len(nums) > 2 else None
            if tenants < 1 or slots < 1 or (batch is not None
                                            and batch < 1):
                raise ValueError(
                    f"--buckets entry {part!r}: counts must be >= 1")
            specs.append(BucketSpec(graph=graph, tenants=tenants,
                                    slots=slots, batch=batch))
        if self.buckets and not specs:
            raise ValueError("--buckets was given but parsed to no specs")
        return tuple(specs)
