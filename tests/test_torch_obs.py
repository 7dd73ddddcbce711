"""The port's own ``obs`` (sync ledger, tracer, metrics) against ``repro.obs``.

The behaviours ``tests/test_obs.py`` pins for the reference's ledger,
percentile line, tracer and metrics registry, held on the port's copy; the
same script of records through both copies gives the same totals, records,
Chrome trace and metrics export; and ``build_tables`` records its
``build_syncs`` (equal to the reference's, recorded by the reference's own
``build_tables``) under a ledger, with no extra host read and tables
bit-equal with the ledger on and off. Everything here is exact: counts,
strings and int32 tables, no tolerance.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.core import queries as jq
from repro.core.euler import tour_numbering as jax_tour_numbering
from repro_torch import obs
from repro_torch.core import build_tables, rooted_spanning_tree, tour_numbering
from repro_torch.data import graphs


# ---- SyncLedger --------------------------------------------------------------

class TestSyncLedger:
    def test_record_accumulates_per_phase(self):
        with obs.SyncLedger() as led:
            obs.record("apply", 3)
            obs.record("apply", 2)
            obs.record("audit", 7)
        assert led.totals() == {"apply": 5, "audit": 7}
        assert led.counts() == {"apply": 2, "audit": 1}
        assert led.total() == 12
        assert led.total("apply") == 5
        assert led.total("missing") == 0

    def test_no_ledger_is_a_noop(self):
        assert obs.current_ledger() is None
        assert not obs.recording()
        obs.record("apply", 3)  # nothing installed: must not raise

    def test_lazy_callable_only_evaluated_when_recording(self):
        calls = []

        def cost():
            calls.append(1)
            return 5

        obs.record("apply", cost)          # no ledger: never evaluated
        assert calls == []
        with obs.SyncLedger() as led:
            assert obs.recording()
            obs.record("apply", cost)
        assert calls == [1]
        assert led.total("apply") == 5

    def test_nested_ledgers_both_receive(self):
        with obs.SyncLedger() as outer:
            obs.record("apply", 1)
            with obs.SyncLedger() as inner:
                obs.record("apply", 2)
            obs.record("audit", 4)
        assert inner.totals() == {"apply": 2}
        assert outer.totals() == {"apply": 3, "audit": 4}
        assert obs.current_ledger() is None

    def test_tenant_and_bucket_labels(self):
        with obs.SyncLedger() as led:
            obs.record("apply", 3, tenant=0, bucket="small")
            obs.record("apply", 4, tenant=1, bucket="large")
            obs.record("apply", 5, tenant=0)
        assert led.by_tenant("apply") == {0: 8, 1: 4}
        assert led.by_bucket("apply") == {"small": 3, "large": 4}
        assert led.total("apply") == 12
        led.clear()
        assert led.totals() == {} and led.by_tenant("apply") == {}

    def test_device_scalar_is_read_only_under_a_ledger(self):
        obs.record("apply", torch.tensor(6, dtype=torch.int32))
        with obs.SyncLedger() as led:
            obs.record("apply", torch.tensor(6, dtype=torch.int32))
        assert led.totals() == {"apply": 6}


# ---- percentile_line (the shared serving-report helper) ----------------------

class TestPercentileLine:
    def test_zero_samples_shared_path(self):
        assert obs.percentile_line([]) == "no samples"
        assert (obs.percentile_line((), empty_reason="op never reached")
                == "no samples (op never reached)")

    @pytest.mark.parametrize("samples,kwargs,want", [
        ([0.010, 0.020, 0.030], {}, "p50  20.00 ms  p95  29.00 ms"),
        ([0.010] * 4, dict(width=7, count_suffix=True),
         "p50   10.00 ms  p95   10.00 ms  (4 batches)")],
        ids=["fleet", "stream_per_op"])
    def test_formats_match_the_reference(self, samples, kwargs, want):
        assert obs.percentile_line(samples, **kwargs) == want
        assert jax_obs.percentile_line(samples, **kwargs) == want


# ---- Tracer: JSONL <-> Chrome round trip -------------------------------------

def _traced(o):
    """The same script of spans, records and events through ``o``."""
    tracer = o.Tracer()
    with tracer:
        with o.span("tick", step=0):
            o.record("apply", 3)
            with o.span("apply_batch", step=0, tenants=2):
                o.record("apply", 2)
        o.event("recovery", mode="scoped", reason="scoped_repair",
                n_violating=4)
    return tracer


class TestTracer:
    def test_span_sync_attribution_is_inclusive(self):
        tracer = _traced(obs)
        tick, = tracer.spans("tick")
        inner, = tracer.spans("apply_batch")
        assert tick["syncs"] == 5      # includes the child's 2
        assert inner["syncs"] == 2
        assert tracer.events("recovery")[0]["args"]["n_violating"] == 4
        assert tracer.summary()["sync_by_phase"] == {"apply": 5}
        assert obs.current_tracer() is None

    def test_jsonl_round_trip(self, tmp_path):
        tracer = _traced(obs)
        path = tmp_path / "trace.jsonl"
        tracer.write_jsonl(path)
        records = obs.read_jsonl(path)
        assert records == tracer.records + [tracer.summary()]

    def test_chrome_round_trip(self, tmp_path):
        tracer = _traced(obs)
        path = tmp_path / "trace.chrome.json"
        tracer.write_chrome(path)
        chrome = json.loads(path.read_text())
        assert {e["ph"] for e in chrome["traceEvents"]} == {"X", "i"}
        assert chrome["otherData"]["sync_total"] == 5
        assert chrome["otherData"]["schema_version"] == obs.SCHEMA_VERSION
        assert obs.chrome_to_records(chrome) == tracer.records

    def test_no_tracer_span_is_noop(self):
        with obs.span("tick", step=0):
            obs.event("recovery", mode="full")  # must not raise

    def test_same_records_and_exports_as_the_reference(self):
        """Timestamps aside, the port's copy writes what the reference's
        writes, and each reads the other's Chrome trace."""
        mine, theirs = _traced(obs), _traced(jax_obs)

        def untimed(records):
            return [{k: v for k, v in r.items() if k not in ("ts", "dur")}
                    for r in records]

        assert untimed(mine.records) == untimed(theirs.records)
        assert mine.summary() == theirs.summary()
        assert obs.SCHEMA_VERSION == jax_obs.SCHEMA_VERSION
        chrome = obs.records_to_chrome(theirs.records, theirs.summary())
        assert chrome == jax_obs.records_to_chrome(theirs.records,
                                                   theirs.summary())
        assert jax_obs.chrome_to_records(chrome) == theirs.records
        assert obs.chrome_to_records(chrome) == theirs.records


# ---- MetricsRegistry ---------------------------------------------------------

class TestMetrics:
    def test_counter_gauge_histogram(self):
        m = obs.MetricsRegistry()
        m.counter("applied").inc(3)
        m.counter("applied").inc(2)
        m.gauge("tenants").set(4)
        h = m.histogram("lat_ms")
        for v in (1.0, 2.0, 3.0, 100.0):
            h.observe(v)
        assert m.counter("applied").value == 5
        assert m.gauge("tenants").value == 4.0
        snap = h.snapshot()
        assert snap["count"] == 4
        assert snap["max"] == 100.0
        assert snap["p50"] == pytest.approx(2.0, rel=0.5)

    def test_labels_key_series_and_kind_conflicts_raise(self):
        m = obs.MetricsRegistry()
        m.counter("applied", tenant=0).inc(1)
        m.counter("applied", tenant=1).inc(2)
        assert m.counter("applied", tenant=0).value == 1
        assert m.counter("applied", tenant=1).value == 2
        with pytest.raises(TypeError):
            m.gauge("applied", tenant=0)

    def test_to_dict_stable_sorted(self, tmp_path):
        m = obs.MetricsRegistry()
        m.counter("b").inc(1)
        m.counter("a", tenant=1).inc(1)
        m.counter("a", tenant=0).inc(1)
        d = m.to_dict()
        keys = [(r["name"], tuple(sorted(r["labels"].items())))
                for r in d["metrics"]]
        assert keys == sorted(keys)
        assert d["schema_version"] == obs.METRICS_SCHEMA_VERSION
        m.write(tmp_path / "m.json")
        assert json.loads((tmp_path / "m.json").read_text()) == d

    def test_same_export_as_the_reference(self):
        def fill(o):
            m = o.MetricsRegistry()
            m.counter("applied", tenant=2).inc(7)
            m.gauge("live_edges").set(123)
            h = m.histogram("lat_ms", bucket="small")
            for v in (0.1, 0.3, 5.0, 2000.0):
                h.observe(v)
            return m.to_dict()

        assert fill(obs) == fill(jax_obs)


# ---- build_tables records build_syncs ----------------------------------------

_HOST_READS = ("__bool__", "item", "__int__", "__float__", "__index__",
               "tolist")


def _count_host_reads(monkeypatch):
    """Count every read of a tensor's value back to Python (a sync on the
    card)."""
    counts = {"reads": 0}
    for name in _HOST_READS:
        real = getattr(torch.Tensor, name)

        def counted(self, *args, _real=real, **kwargs):
            counts["reads"] += 1
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return counts


@pytest.mark.parametrize("graph", ["grid2d(9)", "rmat(7)"])
def test_build_tables_records_build_syncs(graph, monkeypatch):
    g = (graphs.grid2d(9, device="cpu") if graph == "grid2d(9)"
         else graphs.rmat(7, edge_factor=4, device="cpu"))
    tn = tour_numbering(rooted_spanning_tree(g, 0, device="cpu").parent)
    counts = _count_host_reads(monkeypatch)
    plain = build_tables(tn)
    reads_off = counts["reads"]
    with obs.SyncLedger() as led:
        counts["reads"] = 0
        recorded = build_tables(tn)
        reads_on = counts["reads"]
    monkeypatch.undo()
    assert led.totals() == {"build_tables": plain.build_syncs}
    assert led.counts() == {"build_tables": 1}
    # The depth pass reads one flag a check; recording reads nothing more.
    assert reads_on == reads_off == plain.build_syncs - plain.levels
    for field in ("pre", "last", "comp", "parent", "depth", "up"):
        assert torch.equal(getattr(recorded, field), getattr(plain, field))
    assert recorded.build_syncs == plain.build_syncs

    jtn = jax_tour_numbering(jnp.asarray(tn.parent.numpy()))
    with jax_obs.SyncLedger() as jled:
        jtables = jq.build_tables(jtn)
    assert jled.totals() == led.totals()
    np.testing.assert_array_equal(np.asarray(jtables.up), plain.up.numpy())
