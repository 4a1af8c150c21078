"""The port's exporters against the JAX reference: the metric registry and
its Prometheus exposition, the report exporters, the OTLP encoders for
spans, logs and metrics, and the background poster's delivery, retry and
``Retry-After`` behaviour against local servers.

Tolerance: exposition text, encoded bodies and counters compare exactly
(byte for byte); nothing here is a float computed differently by the two
packages. Every server and poster a test starts is stopped in a
``finally``; socket waits carry timeouts.
"""

from __future__ import annotations

import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

from opentelemetry_demo_tpu.runtime import otlp_export as jexport
from opentelemetry_demo_tpu.runtime import otlp_metrics as jmetrics
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu.telemetry import logstore as jlogstore
from opentelemetry_demo_tpu.telemetry import metrics as jtm
from opentelemetry_demo_tpu_torch.runtime import otlp, otlp_export, otlp_metrics, tensorize, wire
from opentelemetry_demo_tpu_torch.runtime.otlp_export import (
    BackgroundPoster,
    OtlpHttpLogsExporter,
    OtlpHttpSpanExporter,
    RetryLater,
)
from opentelemetry_demo_tpu_torch.telemetry import LogDoc, MetricRegistry, PrometheusExporter
from opentelemetry_demo_tpu_torch.telemetry import metrics as tm

RECORDS = [
    ("payment", 1500.0, b"\x01" * 16, True, "X1", "Charge", ()),
    ("payment", 900.0, b"\x02" * 16, False, None, "ok", ()),
    ("cart", 50.5, 7, False, None, None, ()),
    (
        "checkout", 5000.0, b"\x03" * 16, False, None, "PlaceOrder",
        (
            ("prepared", 1000.0, ()),
            ("charged", 2500.0, (("app.payment.transaction.id", "tx-9"),)),
        ),
    ),
    (
        "email", 700.0, b"\x04" * 16, False, None, "send",
        (("exception", 0.0, (("exception.type", "InvalidRecipientError"),)),),
    ),
]


def _records(mod):
    return [
        mod.SpanRecord(s, d, t, e, a, n, tuple(mod.SpanEvent(*ev) for ev in evs))
        for s, d, t, e, a, n, evs in RECORDS
    ]


DOCS = [
    (10.0, "checkout", "ERROR", "order failed: card declined", {"user": "u1"}, b"\x0a" * 16),
    (10.5, "payment", "WARN", "charge failed", {}, None),
    (9.0, "checkout", "INFO", "retrying", {"attempt": "2"}, b"\x0b" * 8),
    (11.0, "email", "DEBUG", "", {}, None),
]


def _docs(cls):
    return [cls(ts=ts, service=s, severity=sev, body=b, attrs=dict(a), trace_id=t) for ts, s, sev, b, a, t in DOCS]


def _registry_calls(reg):
    """One fixed sequence of registry calls, applied to either package's
    registry."""
    reg.describe("app_anomaly_z_score", "max |z| per service and signal")
    reg.counter_add("reqs_total", 2.0, route="/", code="200")
    reg.counter_add("reqs_total", 1.0, route="/a", code="500")
    reg.counter_add("reqs_total", 3.0, route="/", code="200")
    reg.gauge_set("app_anomaly_z_score", 4.25, service="cart", signal="latency")
    reg.gauge_set("app_anomaly_z_score", -1.0, service="ad", signal="throughput")
    reg.gauge_set("up", 1.0)
    for v in (0.0004, 0.003, 0.07, 2.5, 0.001):
        reg.histogram_observe("lat_s", v, (0.001, 0.01, 0.1, 1.0), phase="dispatch")
    reg.histogram_observe("lat_s", 0.2, (0.001, 0.01, 0.1, 1.0), zone="a", le_extra="x")
    reg.counter_add("odd_total", 0.1)
    reg.counter_add("odd_total", 0.2)


# --- registry and exposition ------------------------------------------


def test_exposition_text_equals_reference():
    ours, ref = MetricRegistry(), jtm.MetricRegistry()
    _registry_calls(ours)
    _registry_calls(ref)
    assert ours.render() == ref.render()
    assert ours.snapshot() == ref.snapshot()


def test_histogram_observe_exposition():
    reg = MetricRegistry()
    reg.histogram_observe("lat_ms", 3.0, (2.0, 5.0, 10.0), svc="a")
    reg.histogram_observe("lat_ms", 7.0, (2.0, 5.0, 10.0), svc="a")
    text = reg.render()
    assert 'lat_ms_bucket{le="10",svc="a"} 2.0' in text
    assert 'lat_ms_bucket{le="+Inf",svc="a"} 2.0' in text
    assert 'lat_ms_count{svc="a"} 2.0' in text
    assert 'lat_ms_sum{svc="a"} 10.0' in text
    ref = jtm.MetricRegistry()
    ref.histogram_observe("lat_ms", 3.0, (2.0, 5.0, 10.0), svc="a")
    ref.histogram_observe("lat_ms", 7.0, (2.0, 5.0, 10.0), svc="a")
    assert text == ref.render()


def test_metric_name_table_equals_reference():
    ours = {k: v for k, v in vars(tm).items() if k.startswith("ANOMALY_")}
    ref = {k: v for k, v in vars(jtm).items() if k.startswith("ANOMALY_")}
    assert ours == ref


def _fake_report(rng, s=8, t=3, w=3):
    return SimpleNamespace(
        lat_z=rng.normal(0, 3, (s, t)).astype(np.float32),
        err_z=rng.normal(0, 3, (s, t)).astype(np.float32),
        rate_z=rng.normal(0, 3, (s, t)).astype(np.float32),
        card_z=rng.normal(0, 3, (s, w)).astype(np.float32),
        card_est=rng.gamma(3.0, 40.0, (s, w)).astype(np.float32),
        hh_ratio=rng.random((s, w)).astype(np.float32),
        cusum=rng.gamma(1.0, 2.0, (s, 3)).astype(np.float32),
    )


@pytest.mark.parametrize("n_names", [3, 8, 11])
def test_export_report_text_equals_reference(n_names):
    """The same report and names through both exporters: the same text,
    including an intern table longer than the report's rows."""
    rng = np.random.default_rng(n_names)
    names = [f"svc-{i}" for i in range(n_names)]
    ours, ref = MetricRegistry(), jtm.MetricRegistry()
    for _ in range(3):
        rep = _fake_report(rng)
        flagged = names[:2]
        tm.export_report(ours, names, rep, flagged)
        jtm.export_report(ref, names, rep, flagged)
    assert ours.render() == ref.render()


def test_export_report_takes_tensor_reports():
    """A report straight from the step holds tensors: exported the same as
    its numpy twin."""
    import torch

    rng = np.random.default_rng(4)
    rep = _fake_report(rng)
    as_t = SimpleNamespace(**{k: torch.from_numpy(v) for k, v in vars(rep).items()})
    a, b = MetricRegistry(), MetricRegistry()
    tm.export_report(a, ["x", "y"], rep, ["x"])
    tm.export_report(b, ["x", "y"], as_t, ["x"])
    assert a.render() == b.render()


def test_export_metrics_report_text_equals_reference():
    rng = np.random.default_rng(5)
    svcs, mets = ["a", "b", "c"], ["m0", "m1"]
    ours, ref = MetricRegistry(), jtm.MetricRegistry()
    seen_o, seen_r = set(), set()
    for step in range(4):
        z = rng.normal(0, 2, (3, 2, 3)).astype(np.float32)
        if step == 3:
            z[:] = 0.0  # quiet: minted series keep updating to 0
        z[2] = 0.0  # a cell that never minted
        rep = SimpleNamespace(z=z, cell_flags=np.abs(z).max(axis=2) > 3.0)
        tm.export_metrics_report(ours, svcs, mets, rep, ["a"], seen_o)
        jtm.export_metrics_report(ref, svcs, mets, rep, ["a"], seen_r)
    assert ours.render() == ref.render()
    assert seen_o == seen_r


def _http_get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5.0) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_prometheus_exporter_serves_metrics_and_healthz():
    reg = MetricRegistry()
    _registry_calls(reg)
    state = {"status": "ok"}
    exp = PrometheusExporter(reg, host="127.0.0.1", port=0, health=lambda: (state["status"], {"n": 1}))
    exp.start()
    try:
        status, body = _http_get(exp.port, "/metrics")
        assert status == 200 and body.decode() == reg.render()
        status, body = _http_get(exp.port, "/healthz")
        assert status == 200 and b'"status": "ok"' in body
        state["status"] = "degraded"
        assert _http_get(exp.port, "/healthz")[0] == 503
        assert _http_get(exp.port, "/nope")[0] == 404
    finally:
        exp.stop()


def test_prometheus_exporter_stop_before_start():
    exp = PrometheusExporter(MetricRegistry(), host="127.0.0.1", port=0)
    exp.stop()  # must not wait on a serve loop that never ran


# --- encoders ---------------------------------------------------------


@pytest.mark.parametrize("t_ns", [10**18, 1_700_000_000_123_456_789])
def test_encode_export_request_bytes_equal(t_ns):
    ours = otlp_export.encode_export_request(_records(tensorize), t_ns=t_ns)
    ref = jexport.encode_export_request(_records(jtz), t_ns=t_ns)
    assert ours == ref
    back = otlp.decode_export_request(ours)
    assert [r.service for r in back] == [r[0] for r in RECORDS if r[0] == "payment"] + [
        r[0] for r in RECORDS if r[0] != "payment"
    ]


@pytest.mark.parametrize("t_ns", [10**18, 1_000_000_000_000])
def test_encode_logs_request_bytes_equal(t_ns):
    ours = otlp_export.encode_logs_request(_docs(LogDoc), t_ns=t_ns)
    ref = jexport.encode_logs_request(_docs(jlogstore.LogDoc), t_ns=t_ns)
    assert ours == ref
    back = otlp.decode_logs_request(ours)
    assert {(d.service, d.body) for d in back} == {(d[1], d[3]) for d in DOCS}


def test_logs_encode_severity_number_primary_field():
    body = otlp_export.encode_logs_request([
        LogDoc(ts=1.0, service="s", severity=sev, body="x", attrs=None, trace_id=None)
        for sev in ("DEBUG", "INFO", "WARN", "ERROR", "FATAL")
    ], t_ns=10**18)
    nums = []
    for rl_buf in wire.scan_fields(body)[1]:
        for sl_buf in wire.scan_fields(rl_buf)[2]:
            for lr_buf in wire.scan_fields(sl_buf)[2]:
                nums.append(int(wire.first(wire.scan_fields(lr_buf), 2, 0)))
    assert nums == [5, 9, 13, 17, 21]


def test_registry_to_request_bytes_equal():
    ours, ref = MetricRegistry(), jtm.MetricRegistry()
    _registry_calls(ours)
    _registry_calls(ref)
    other, other_ref = MetricRegistry(), jtm.MetricRegistry()
    for r in (other, other_ref):
        r.counter_add("orders_total", 9.0, region="eu")
        r.gauge_set("queue", 3.0)
    got = otlp_metrics.registry_to_request([("edge", ours), ("checkout", other)], t_ns=5, start_ns=1)
    want = jmetrics.registry_to_request([("edge", ref), ("checkout", other_ref)], t_ns=5, start_ns=1)
    assert got == want


def test_registry_folds_label_sets():
    reg = MetricRegistry()
    reg.counter_add("calls_total", 3.0, route="/a")
    reg.counter_add("calls_total", 4.0, route="/b")
    reg.gauge_set("up", 1.0, probe="x")
    reg.gauge_set("up", 0.0, probe="y")
    body = otlp_metrics.registry_to_request([("edge", reg)], t_ns=1)
    by_key = {(r.service, r.name): r for r in otlp_metrics.decode_metrics_request(body)}
    assert by_key[("edge", "calls_total")].value == 7.0  # summed
    assert by_key[("edge", "up")].value == 1.0  # max


@pytest.mark.parametrize("endpoint,scheme,target", [
    ("grpc://host:4317/", "grpc", "host:4317"),
    ("collector:4318", "http", "http://collector:4318"),
    ("https://c:4318/", "http", "https://c:4318/"),
])
def test_split_endpoint_equals_reference(endpoint, scheme, target):
    assert otlp_export.split_endpoint(endpoint) == (scheme, target)
    assert otlp_export.split_endpoint(endpoint) == jexport.split_endpoint(endpoint)


@pytest.mark.parametrize("raw,want", [(None, None), ("", None), ("2", 2.0), ("-1", 0.0), ("soon", None)])
def test_parse_retry_after(raw, want):
    assert otlp_export._parse_retry_after(raw) == want == jexport._parse_retry_after(raw)


def test_traces_poster_endpoints():
    p = otlp_export.make_traces_poster("http://127.0.0.1:9/")
    q = otlp_export.make_traces_poster("127.0.0.1:9/v1/traces")
    try:
        assert p.endpoint == q.endpoint == "http://127.0.0.1:9/v1/traces"
        assert p.content_type == "application/x-protobuf"
    finally:
        p.close()
        q.close()


# --- delivery ---------------------------------------------------------


def test_span_exporter_ships_to_receiver():
    got: list = []
    done = threading.Event()

    def on_records(records):
        got.extend(records)
        done.set()

    recv = otlp.OtlpHttpReceiver(on_records, host="127.0.0.1", port=0)
    recv.start()
    exporter = OtlpHttpSpanExporter(f"http://127.0.0.1:{recv.port}")
    try:
        exporter(0.0, _records(tensorize))
        assert exporter.flush(5.0)
        assert done.wait(5.0)
        assert exporter.sent == 1 and exporter.errors == 0
        assert sorted(r.service for r in got) == sorted(r[0] for r in RECORDS)
    finally:
        exporter.close()
        recv.stop()


def test_logs_exporter_ships_to_receiver():
    got: list = []
    rx = otlp.OtlpHttpReceiver(lambda recs: None, host="127.0.0.1", port=0, on_log_records=got.extend)
    rx.start()
    exporter = OtlpHttpLogsExporter(f"http://127.0.0.1:{rx.port}")
    try:
        exporter(0.0, [LogDoc(ts=1.0, service="email", severity="INFO", body="confirmation sent")])
        assert exporter.flush(timeout_s=10.0)
        assert exporter.sent == 1 and exporter.errors == 0
    finally:
        exporter.close()
        rx.stop()
    assert got and got[0].service == "email" and got[0].body == "confirmation sent"


def test_metrics_exporter_ships_to_receiver():
    got: list = []
    rx = otlp.OtlpHttpReceiver(lambda recs: None, host="127.0.0.1", port=0, on_metric_records=got.extend)
    rx.start()
    reg = MetricRegistry()
    reg.counter_add("orders_total", 9.0, region="eu")
    reg.counter_add("orders_total", 1.0, region="us")
    exporter = otlp_metrics.OtlpHttpMetricsExporter(f"http://127.0.0.1:{rx.port}")
    try:
        exporter(1.0, [("checkout", reg)])
        assert exporter.flush(10.0)
        assert exporter.sent == 1 and exporter.errors == 0
    finally:
        exporter.close()
        rx.stop()
    assert [(m.service, m.name, m.value) for m in got] == [("checkout", "orders_total", 10.0)]


def test_exporter_down_sink_counts_not_raises():
    exporter = OtlpHttpSpanExporter("http://127.0.0.1:9", timeout_s=0.3)
    try:
        exporter(0.0, _records(tensorize))  # discard port: refused
        exporter.flush(5.0)
        assert exporter.errors == 1 and exporter.sent == 0
    finally:
        exporter.close()


def test_submit_after_close_counts_dropped():
    exporter = OtlpHttpSpanExporter("http://127.0.0.1:9", timeout_s=0.3)
    exporter.close()
    exporter(0.0, _records(tensorize))
    assert exporter.dropped == 1
    assert exporter.sent == 0 and exporter.errors == 0
    assert exporter.flush(0.5)


def test_queue_drops_oldest():
    gate = threading.Event()
    seen: list[bytes] = []

    def slow(body):
        gate.wait(5.0)
        seen.append(body)

    poster = BackgroundPoster("sink", "x", queue_max=2, send=slow)
    try:
        for i in range(6):
            poster.submit(bytes([i]))
        time.sleep(0.05)
        gate.set()
        assert poster.flush(5.0)
        # The first body may already be in the sender's hands; the
        # queue itself kept only the newest two.
        assert seen[-2:] == [b"\x04", b"\x05"]
        assert poster.dropped == 6 - len(seen)
    finally:
        gate.set()
        poster.close()


class _FlakySink:
    """A send hook: refuses ``refusals`` times (RetryLater), then accepts."""

    def __init__(self, refusals, retry_after_s=None):
        self.refusals = refusals
        self.retry_after_s = retry_after_s
        self.accepted: list[bytes] = []

    def __call__(self, body: bytes) -> None:
        if self.refusals > 0:
            self.refusals -= 1
            raise RetryLater(self.retry_after_s)
        self.accepted.append(body)


def test_retrylater_is_not_an_error_and_body_survives():
    sink = _FlakySink(refusals=2, retry_after_s=0.01)
    poster = BackgroundPoster("sink", "x", queue_max=8, send=sink)
    poster.BACKOFF_BASE_S = 0.01
    poster.submit(b"payload")
    try:
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not sink.accepted:
            time.sleep(0.01)
        assert sink.accepted == [b"payload"]  # delivered once
        assert poster.retries == 2
        assert poster.errors == 0 and poster.dropped == 0
    finally:
        poster.close()


def test_http_429_honors_retry_after():
    """A sink answering 429 with ``Retry-After: 0.2`` twice: the body is
    delivered on the third POST and each retry waited at least the hint."""
    state = {"refusals": 2, "hits": []}

    class Sink(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            state["hits"].append(time.monotonic())
            if state["refusals"] > 0:
                state["refusals"] -= 1
                self.send_response(429)
                self.send_header("Retry-After", "0.2")
                self.end_headers()
                return
            self.send_response(200)
            self.end_headers()

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    exporter = OtlpHttpSpanExporter(f"http://127.0.0.1:{server.server_address[1]}")
    try:
        exporter(0.0, [tensorize.SpanRecord("svc", 10.0, b"\x01" * 16)])
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and exporter.sent < 1:
            time.sleep(0.01)
        assert exporter.sent == 1
        assert len(state["hits"]) == 3
        assert exporter.retries == 2 and exporter.errors == 0
        assert (np.diff(state["hits"]) >= 0.19).all(), state["hits"]
    finally:
        exporter.close()
        server.shutdown()
        server.server_close()
        th.join(timeout=5.0)


def test_retry_delay_is_bounded_and_floored():
    poster = BackgroundPoster("sink", "x", send=lambda b: None)
    try:
        delays = [poster._retry_delay(None) for _ in range(20)]
        assert all(0.0 < d <= poster.BACKOFF_CAP_S * 1.5 for d in delays)
        assert poster._retry_delay(3.0) >= 3.0  # the server's hint is a floor
        assert poster._retry_delay(60.0) <= poster.BACKOFF_CAP_S * 1.5
    finally:
        poster.close()


def test_stats_publish_into_registry():
    sink = _FlakySink(refusals=0)
    poster = BackgroundPoster("sink", "x", queue_max=2, send=sink)

    class Exporter(OtlpHttpSpanExporter):
        def __init__(self):  # no endpoint parsing
            self._poster = poster

    exporter = Exporter()
    reg = MetricRegistry()
    try:
        with poster._lock:
            poster._queue.extend([b"a", b"b", b"c"])
            while len(poster._queue) > 2:
                poster._queue.popleft()
                poster.dropped += 1
            poster.queue_high_water = 3
        exporter.publish_stats(reg, signal="traces")
        text = reg.render()
        assert 'anomaly_export_dropped_total{signal="traces"} 1.0' in text
        assert 'anomaly_export_queue_depth{signal="traces"} 3.0' in text
        exporter.publish_stats(reg, signal="traces")  # delta-tracked
        assert 'anomaly_export_dropped_total{signal="traces"} 1.0' in reg.render()
    finally:
        poster.close()


def test_grpc_endpoint_ships_all_signals():
    """``grpc://`` endpoints ride OTLP/gRPC through the same poster
    surface: spans, metrics and logs into the port's gRPC receiver."""
    pytest.importorskip("grpc")
    from opentelemetry_demo_tpu_torch.runtime.otlp_grpc import OtlpGrpcReceiver

    spans, metrics, logs = [], [], []
    recv = OtlpGrpcReceiver(
        spans.extend, host="127.0.0.1", port=0,
        on_metric_records=metrics.extend, on_log_records=logs.extend,
    )
    recv.start()
    exporters = []
    try:
        target = f"grpc://127.0.0.1:{recv.port}"
        span_exp = OtlpHttpSpanExporter(target)
        exporters.append(span_exp)
        span_exp(0.0, _records(tensorize)[:3])
        assert span_exp.flush(5.0)
        assert span_exp.sent == 1 and span_exp.errors == 0
        assert [r.service for r in spans] == ["payment", "payment", "cart"]

        reg = MetricRegistry()
        reg.counter_add("orders_total", 9.0)
        met_exp = otlp_metrics.OtlpHttpMetricsExporter(target)
        exporters.append(met_exp)
        met_exp(1.0, [("checkout", reg)])
        assert met_exp.flush(5.0)
        assert met_exp.sent == 1 and metrics[0].name == "orders_total"

        log_exp = OtlpHttpLogsExporter(target)
        exporters.append(log_exp)
        log_exp(0.0, _docs(LogDoc))
        assert log_exp.flush(5.0)
        assert log_exp.sent == 1 and {d.service for d in logs} == {"checkout", "payment", "email"}
    finally:
        for e in exporters:
            e.close()
        recv.stop()
