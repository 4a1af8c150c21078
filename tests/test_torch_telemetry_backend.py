"""The port's backend tier against the reference's: collector, trace
store, TSDB and scraper, log store, and the shop's memory_limiter
back-off.

The cases of ``tests/test_telemetry_backend.py`` that need no gateway
(the dashboards, the Jaeger UI and the HTTP check against a live gateway
are in ``tests/test_torch_telemetry_ui.py``), each run on the port and, where it feeds a
store, on the reference with the same input: the trace-store queries,
the TSDB series and the log documents must be equal. Two shops, one per
package, run the same seeded load (``busy_pair``; the tracers' trace-id
source seeded alike); the series that read this process's own CPU,
memory and clock (the ``hostmetrics`` job, ``container_*`` and
``httpcheck_duration_ms``) are left out of the comparisons, and checked
for shape only. The ``hostmetrics`` receivers of both shops read a
fixture ``/proc`` tree each (``_fixture_receiver``) whose ``stat``
advances by the same jiffies on every read: on the live ``/proc`` the
two shops' first CPU-utilization sample could fall on different scrapes
(the receiver sets it only once the jiffies moved between two scrapes),
so the series' shapes differed now and then. Then the collector cases of
``tests/test_overload.py::TestCollectorBackpressure``.
"""

from __future__ import annotations

import os
import random

import numpy as np
import pytest

import opentelemetry_demo_tpu.telemetry as rt
import opentelemetry_demo_tpu_torch.telemetry as pt
from opentelemetry_demo_tpu.runtime.tensorize import SpanRecord as RefSpanRecord
from opentelemetry_demo_tpu.services.shop import Shop as RefShop
from opentelemetry_demo_tpu.services.shop import ShopConfig as RefShopConfig
from opentelemetry_demo_tpu.telemetry import hostmetrics as ref_hostmetrics
from opentelemetry_demo_tpu.telemetry import tracer as ref_tracer
from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanRecord
from opentelemetry_demo_tpu_torch.services.shop import Shop, ShopConfig
from opentelemetry_demo_tpu_torch.telemetry import hostmetrics as port_hostmetrics
from opentelemetry_demo_tpu_torch.telemetry import tracer as port_tracer
from opentelemetry_demo_tpu_torch.telemetry.collector import CALLS_TOTAL, DURATION_MS
from opentelemetry_demo_tpu_torch.telemetry.tracer import TraceContext


class _SeededIds:
    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def token_bytes(self, n: int) -> bytes:
        return self._rng.randbytes(n)


# Jiffies a fixture /proc/stat moves by on each read: (busy, idle).
_STAT_STEP = (3, 5)


def _stat_text(reads: int) -> str:
    user, idle = 1000 + _STAT_STEP[0] * reads, 8000 + _STAT_STEP[1] * reads
    return f"cpu  {user} 0 0 {idle} 0 0 0 0 0 0\ncpu0 {user} 0 0 {idle} 0 0 0 0 0 0\n"


def _fixture_receiver(cls, root):
    """``cls`` (a package's ``HostMetricsReceiver``) reading a fixture
    ``/proc`` tree under ``root`` whose ``stat`` advances by
    ``_STAT_STEP`` jiffies on each read."""
    (root / "self").mkdir(parents=True)
    (root / "net").mkdir()
    (root / "stat").write_text(_stat_text(0))
    (root / "meminfo").write_text("MemTotal: 16000000 kB\nMemAvailable: 12000000 kB\n")
    (root / "loadavg").write_text("0.50 0.40 0.30 1/200 4242\n")
    (root / "net" / "dev").write_text(
        "Inter-|   Receive\n face |bytes\n"
        "    lo: 10 1 0 0 0 0 0 0 10 1 0 0 0 0 0 0\n"
        "  eth0: 5000 40 0 0 0 0 0 0 3000 30 0 0 0 0 0 0\n"
    )
    (root / "self" / "statm").write_text("50000 12000 3000 100 0 9000 0\n")

    class FixtureProc(cls):
        def __init__(self, registry=None, proc_root=str(root)):
            super().__init__(registry, proc_root)
            self._stat_reads = 0

        def _read(self, name):
            if name == "stat":
                self._stat_reads += 1
                (root / "stat").write_text(_stat_text(self._stat_reads))
            return super()._read(name)

    return FixtureProc


def _shops(seed: int, proc_dir, flag=None, seconds: float = 60.0):
    """The reference's and the port's shop after the same seeded load,
    their host metrics read from fixture trees under ``proc_dir``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_tracer, "secrets", _SeededIds(seed))
        mp.setattr(port_tracer, "secrets", _SeededIds(seed))
        for module, name in ((ref_hostmetrics, "reference"), (port_hostmetrics, "port")):
            mp.setattr(module, "HostMetricsReceiver",
                       _fixture_receiver(module.HostMetricsReceiver, proc_dir / name))
        out = []
        for shop in (RefShop(RefShopConfig(users=5, seed=seed)), Shop(ShopConfig(users=5, seed=seed))):
            if flag is not None:
                shop.set_flag(*flag)
            shop.run(seconds)
            out.append(shop)
    return out


@pytest.fixture(scope="module")
def busy_pair(tmp_path_factory):
    """60 virtual seconds of the default Locust-profile load, both packages."""
    return _shops(7, tmp_path_factory.mktemp("proc"))


@pytest.fixture(scope="module")
def busy_shop(busy_pair):
    return busy_pair[1]


def _own_process(name: str, labels: dict) -> bool:
    """This process's CPU, memory and clock: the hostmetrics job, the
    ``container_*`` stats, and the HTTP check's wall-clock probe time."""
    return labels.get("job") == "hostmetrics" or name.startswith("container_") or name == "httpcheck_duration_ms"


def _tsdb_dump(tsdb) -> list:
    return sorted(
        (name, tuple(sorted(s.labels.items())), tuple(s.ts), tuple(s.values))
        for name in tsdb.series_names()
        for s in tsdb.select(name)
        if not _own_process(name, s.labels)
    )


def _traces_dump(store) -> list:
    return [
        (tid, [(s.ts, tuple(s.record)) for s in t.spans])
        for tid, t in store._traces.items()
    ]


def _logs_dump(store) -> list:
    return [
        (index, [(d.ts, d.service, d.severity, d.body, d.attrs, d.trace_id) for d in store._indices[index]])
        for index in store.indices()
    ]


# -- span-name normalization (transform processor) ---------------------------


@pytest.mark.parametrize("name,want", [
    ("GET /api/products/OLJCESPC7Z", "GET /api/products/{id}"),
    ("GET /api/data/123456789", "GET /api/data/{id}"),
    ("PlaceOrder", "PlaceOrder"),
    ("GET /api/cart", "GET /api/cart"),
    ("GET /api/cart/0a1b2c3d4e5f?x=1", "GET /api/cart/{id}?x=1"),
])
def test_normalize_collapses_id_segments(name, want):
    assert pt.normalize_span_name(name) == rt.normalize_span_name(name) == want


# -- the stores fed by two shops ---------------------------------------------


def test_both_collectors_hold_the_same_stores(busy_pair):
    ref, port = busy_pair
    assert _traces_dump(port.collector.trace_store) == _traces_dump(ref.collector.trace_store)
    assert _tsdb_dump(port.collector.tsdb) == _tsdb_dump(ref.collector.tsdb)
    assert _logs_dump(port.collector.log_store) == _logs_dump(ref.collector.log_store)
    assert port.collector.dropped_spans == ref.collector.dropped_spans
    assert port.collector.self_metrics.snapshot() == ref.collector.self_metrics.snapshot()


def test_trace_store_collects_full_shop_traces(busy_pair):
    ref, port = busy_pair
    store, want = port.collector.trace_store, ref.collector.trace_store
    assert len(store) == len(want) > 0
    services = store.services()
    assert services == want.services()
    for svc in ("checkout", "cart", "currency", "payment", "frontend"):
        assert svc in services, f"{svc} missing from {services}"
        assert store.operations(svc) == want.operations(svc)
    traces = store.find_traces(service="checkout", operation="PlaceOrder")
    assert traces and any(len(t.services) >= 5 for t in traces)
    assert [t.trace_id for t in traces] == [
        t.trace_id for t in want.find_traces(service="checkout", operation="PlaceOrder")
    ]


def test_trace_store_eviction_cap():
    stores = (pt.TraceStore(max_traces=10), rt.TraceStore(max_traces=10))
    for store, rec in zip(stores, (SpanRecord, RefSpanRecord)):
        for i in range(25):
            store.add_span(float(i), rec(service="s", duration_us=1.0, trace_id=i.to_bytes(16, "little")))
    store, want = stores
    assert len(store) == len(want) == 10
    assert store.evicted_traces == want.evicted_traces == 15
    assert store.get_trace((0).to_bytes(16, "little")) is None
    assert store.get_trace((24).to_bytes(16, "little")) is not None
    assert list(store._traces) == list(want._traces)


def test_trace_store_error_search(tmp_path):
    ref, port = _shops(11, tmp_path, flag=("paymentFailure", 1.0), seconds=40.0)
    errs = port.collector.trace_store.find_traces(service="payment", error_only=True, limit=5)
    assert errs and all(t.has_error for t in errs)
    want = ref.collector.trace_store.find_traces(service="payment", error_only=True, limit=5)
    assert [t.trace_id for t in errs] == [t.trace_id for t in want]


# -- spanmetrics connector + TSDB (Prometheus analogue) ----------------------


def test_spanmetrics_red_metrics_present(busy_pair):
    ref, port = busy_pair
    rates = port.collector.tsdb.sum_rate(CALLS_TOTAL, None, 60.0, port.now, by=("service_name",))
    assert rates, f"no call-rate series; names={port.collector.tsdb.series_names()}"
    assert rates.get(("frontend",), 0.0) > 0.1
    assert rates == ref.collector.tsdb.sum_rate(CALLS_TOTAL, None, 60.0, ref.now, by=("service_name",))


def test_spanmetrics_p95_is_plausible(busy_pair):
    ref, port = busy_pair
    args = (0.95, DURATION_MS + "_bucket", None, 60.0)
    p95 = port.collector.tsdb.histogram_quantile(*args, port.now, by=("service_name",))
    assert p95
    for (svc,), q in p95.items():
        assert 0.0 <= q <= 15_000.0, (svc, q)
    assert p95[("currency",)] < 1000.0
    assert p95 == ref.collector.tsdb.histogram_quantile(*args, ref.now, by=("service_name",))


def test_histogram_quantile_all_inf_is_nan():
    tsdb = pt.MetricTSDB()
    for t in (0.0, 5.0, 10.0):
        tsdb.append("lat_ms_bucket", {"le": "+Inf", "svc": "s"}, t, t)
    out = tsdb.histogram_quantile(0.95, "lat_ms_bucket", None, 60.0, 10.0, by=("svc",))
    assert np.isnan(out[("s",)])


def test_tsdb_rate_and_reset_handling():
    got = []
    for tsdb in (pt.MetricTSDB(), rt.MetricTSDB()):
        for i, v in enumerate([0, 50, 100, 10, 60]):  # reset at i=3
            tsdb.append("c_total", {"k": "a"}, float(i * 5), float(v))
        got.append(tsdb.rate("c_total", None, 100.0, 20.0))
    [(labels, r)] = got[0]
    assert r == pytest.approx(150.0 / 20.0)
    assert got[0] == got[1]


def test_tsdb_retention_trims_old_samples():
    tsdb = pt.MetricTSDB(retention_s=100.0)
    tsdb.append("g", {}, 0.0, 1.0)
    for t in range(0, 400, 61):
        tsdb.append("g", {}, float(t), float(t))
    [series] = tsdb.select("g")
    assert min(series.ts) >= 400 - 61 - 100.0 - 1


def test_scraper_pulls_registry_into_tsdb():
    reg = pt.MetricRegistry()
    tsdb = pt.MetricTSDB()
    scraper = pt.Scraper(tsdb, interval_s=5.0)
    scraper.add_target("svc", reg)
    reg.counter_add("reqs_total", 3.0, route="/")
    assert scraper.maybe_scrape(0.0)
    assert not scraper.maybe_scrape(2.0)
    reg.counter_add("reqs_total", 2.0, route="/")
    assert scraper.maybe_scrape(5.0)
    [(labels, v)] = tsdb.instant("reqs_total", {"route": "/"}, at=5.0)
    assert v == 5.0 and labels["job"] == "svc"


def test_histogram_observe_exposition():
    texts = []
    for reg in (pt.MetricRegistry(), rt.MetricRegistry()):
        reg.histogram_observe("lat_ms", 3.0, (2.0, 5.0, 10.0), svc="a")
        reg.histogram_observe("lat_ms", 7.0, (2.0, 5.0, 10.0), svc="a")
        texts.append(reg.render())
    text = texts[0]
    assert 'lat_ms_bucket{le="10",svc="a"} 2.0' in text
    assert 'lat_ms_bucket{le="+Inf",svc="a"} 2.0' in text
    assert 'lat_ms_count{svc="a"} 2.0' in text
    assert 'lat_ms_sum{svc="a"} 10.0' in text
    assert texts[0] == texts[1]


# -- memory limiter / batcher ------------------------------------------------


def test_memory_limiter_refuses_above_budget():
    cols = []
    for mod, rec in ((pt, SpanRecord), (rt, RefSpanRecord)):
        col = mod.Collector(clock=lambda: 0.0, config=mod.CollectorConfig(
            memory_limit_spans=10, batch_max_spans=1000, batch_timeout_s=999.0,
        ))
        col.receive_spans([rec(service="s", duration_us=1.0, trace_id=i.to_bytes(16, "little")) for i in range(25)])
        cols.append(col)
    col = cols[0]
    assert col.dropped_spans == 15
    counters, _ = col.self_metrics.snapshot()
    assert sum(v for (n, _), v in counters.items() if n == "otelcol_processor_refused_spans") == 15.0
    assert counters == cols[1].self_metrics.snapshot()[0]


def test_batch_flush_on_size_and_timeout():
    t = [0.0]
    col = pt.Collector(clock=lambda: t[0], config=pt.CollectorConfig(batch_max_spans=4, batch_timeout_s=1.0))
    seen = []
    col.trace_exporters.append(lambda ts, batch: seen.append(len(batch)))
    mk = lambda i: SpanRecord(service="s", duration_us=1.0, trace_id=i.to_bytes(16, "little"))
    col.receive_spans([mk(0), mk(1)])
    assert seen == []
    col.receive_spans([mk(2), mk(3)])
    assert seen == [4]
    col.receive_spans([mk(4)])
    t[0] = 2.0
    col.pump()
    assert seen == [4, 1]


# -- logs pipeline (OpenSearch analogue) -------------------------------------


def test_logs_flow_to_otel_index(busy_pair):
    ref, port = busy_pair
    logs = port.collector.log_store
    assert "otel" in logs.indices()
    placed = logs.search(service="checkout", severity="INFO", query="order placed")
    assert placed
    assert placed[0].trace_id is not None and "order_id" in placed[0].attrs
    want = ref.collector.log_store.search(service="checkout", severity="INFO", query="order placed")
    assert [(d.ts, d.body, d.attrs, d.trace_id) for d in placed] == [(d.ts, d.body, d.attrs, d.trace_id) for d in want]


def test_log_search_by_trace_id(busy_pair):
    ref, port = busy_pair
    doc = port.collector.log_store.search(service="payment", severity="INFO", limit=1)[0]
    same_trace = port.collector.log_store.search(trace_id=doc.trace_id)
    assert any(d.service == "payment" for d in same_trace)
    want = ref.collector.log_store.search(trace_id=doc.trace_id)
    assert [(d.service, d.body) for d in same_trace] == [(d.service, d.body) for d in want]


def test_log_store_ring_bound():
    store = pt.LogStore(max_docs_per_index=5)
    for i in range(12):
        store.add(pt.LogDoc(ts=float(i), service="s", severity="INFO", body=f"m{i}"))
    assert store.count() == 5
    assert store.search(limit=10)[0].body == "m11"
    with pytest.raises(ValueError):
        store.add(pt.LogDoc(ts=0.0, service="s", severity="WARNING", body="bad"))


# -- exemplars (metric → trace click-through) --------------------------------


def test_exemplars_resolve_to_stored_traces(busy_pair):
    ref, port = busy_pair
    col = port.collector
    rows = col.slowest_exemplars(limit=10)
    assert rows
    values = [ex.value_ms for _, _, ex in rows]
    assert values == sorted(values, reverse=True)
    svc, name, ex = rows[0]
    trace = col.trace_store.get_trace(ex.trace_id)
    assert trace is not None
    assert any(s.record.service == svc and (s.record.name or "unknown") == name for s in trace.spans)
    want = ref.collector.slowest_exemplars(limit=10)
    assert [(s, n, e.trace_id, e.value_ms, e.ts) for s, n, e in rows] == [
        (s, n, e.trace_id, e.value_ms, e.ts) for s, n, e in want
    ]


# -- collector self-telemetry ------------------------------------------------


def test_collector_self_telemetry(busy_shop):
    tsdb, at = busy_shop.collector.tsdb, busy_shop.now
    accepted = tsdb.instant("otelcol_receiver_accepted_spans", at=at)
    sent = tsdb.instant("otelcol_exporter_sent_spans", at=at)
    assert accepted and sent
    assert sum(v for _, v in accepted) >= sum(v for _, v in sent) > 0


# -- hostmetrics and the other receivers -------------------------------------


def test_hostmetrics_scrape_real_proc():
    recv = pt.HostMetricsReceiver()
    recv.scrape()
    recv.scrape()
    _, gauges = recv.registry.snapshot()
    names = {n for (n, _) in gauges}
    assert "system_memory_usage_bytes" in names
    assert "system_cpu_load_average_1m" in names
    util = [v for (n, k), v in gauges.items() if n == "system_memory_utilization"]
    assert util and 0.0 <= util[0] <= 1.0


def test_hostmetrics_tolerates_missing_proc(tmp_path):
    recv = pt.HostMetricsReceiver(proc_root=str(tmp_path / "nope"))
    recv.scrape()
    assert recv.registry.snapshot()[1] == {}


def test_hostmetrics_flow_into_shop_tsdb(busy_pair):
    if not os.path.exists("/proc/meminfo"):
        pytest.skip("no /proc on this platform (the receiver degrades to a no-op)")
    ref, port = busy_pair
    rows = port.collector.tsdb.instant("system_memory_utilization", at=port.now)
    assert rows
    labels, v = rows[0]
    assert labels["job"] == "hostmetrics" and 0.0 <= v <= 1.0
    # the same series on the same scrape cadence, values the host's own
    def shape(shop):
        return sorted(
            (name, tuple(sorted(s.labels.items())), tuple(s.ts))
            for name in shop.collector.tsdb.series_names()
            for s in shop.collector.tsdb.select(name) if _own_process(name, s.labels)
        )
    assert shape(port) == shape(ref)


def test_receiver_family_metrics_in_tsdb(busy_shop):
    tsdb, at = busy_shop.collector.tsdb, busy_shop.now
    up = tsdb.instant("httpcheck_status", at=at)
    assert up and all(v == 1.0 for _, v in up)
    keys = tsdb.instant("store_db_keys", at=at)
    assert keys and keys[0][0]["job"] == "valkey-cart"


def test_container_stats_in_tsdb(busy_shop):
    tsdb, at = busy_shop.collector.tsdb, busy_shop.now
    cpu = tsdb.instant("container_cpu_usage_seconds_total", at=at)
    assert cpu, "no container cpu series scraped"
    labels, v = cpu[0]
    assert labels["container_name"] == "shop" and v > 0
    rss = tsdb.instant("container_memory_usage_bytes", at=at)
    assert rss and rss[0][1] > 1e6
    threads = tsdb.instant("container_threads", at=at)
    assert threads and threads[0][1] >= 1


def test_shop_metrics_scraped_into_tsdb(busy_shop):
    rows = busy_shop.collector.tsdb.instant("app_payment_transactions_total", at=busy_shop.now)
    assert rows and all(labels["job"] == "shop" for labels, _ in rows)


def test_force_flush_preserves_exporter_cadence():
    t = [0.0]
    col = pt.Collector(clock=lambda: t[0])
    fired = []
    col.metrics_exporters.append(lambda now, jobs: fired.append(now))
    col.pump()
    assert fired == [0.0]
    while t[0] < 6.0:
        t[0] += 0.5
        col.force_flush()
        col.pump()
    assert len(fired) == 2 and fired[1] >= 5.0


# -- tests/test_overload.py::TestCollectorBackpressure -----------------------


def test_receive_spans_returns_retryable_refusal():
    col = pt.Collector(clock=lambda: 0.0, config=pt.CollectorConfig(
        memory_limit_spans=5, batch_max_spans=1000, batch_timeout_s=0.25,
    ))
    records = [SpanRecord("svc", 1.0, bytes([i]) * 16) for i in range(8)]
    adm = col.receive_spans(records)
    assert (adm.accepted, adm.refused) == (5, 3)
    assert adm.retry_after_s == 0.25
    col.pump(1.0)
    adm2 = col.receive_spans(records[-adm.refused:])
    assert adm2.refused == 0
    assert int(col.self_metrics.snapshot()[0][("otelcol_receiver_accepted_spans", (("receiver", "otlp"),))]) == 8


def test_shop_exporter_backs_off_and_redelivers():
    shop = Shop(ShopConfig(users=0, minimal=True))
    shop.collector.config.memory_limit_spans = 5
    shop.collector.config.batch_max_spans = 1000
    shop.collector.config.batch_timeout_s = 0.5
    delivered = []

    def on_spans(t, spans):
        delivered.extend(spans)

    for i in range(8):
        shop.tracer.emit("svc", f"op-{i}", TraceContext.new(), 10.0)
    shop.pump(1.0, on_spans)
    assert len(delivered) == 5 and len(shop._span_buffer) == 3  # the refused 3 are held
    shop.pump(1.2, on_spans)  # before the hint: no re-send
    assert len(delivered) == 5
    shop.pump(1.6, on_spans)  # after it: the tail lands exactly once
    assert [r.name for r in delivered] == [f"op-{i}" for i in range(8)]
    assert shop._span_buffer == []
