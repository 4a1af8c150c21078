"""The port's dashboards and observability UIs against the reference's.

The cases of ``tests/test_telemetry_backend.py`` that need the
dashboards, the Grafana export, the Jaeger UI or a live gateway: each
runs on the port, with the reference case's assertions, and against the
reference on the same input. Two shops, one per package, run the same
seeded load (``_shops``, the tracers' trace-id source seeded alike); the
provisioned dashboards evaluated over both collectors must give the same
rows and text, every Jaeger and Grafana route the same status, content
type and bytes, and ``write_grafana_dashboards`` the same files byte for
byte (written under a temporary directory).
"""

from __future__ import annotations

import json
import time

import pytest

from opentelemetry_demo_tpu.runtime.tensorize import SpanRecord as RefSpanRecord
from opentelemetry_demo_tpu.telemetry import dashboards as ref_dashboards
from opentelemetry_demo_tpu.telemetry.obsui import GrafanaUI as RefGrafanaUI
from opentelemetry_demo_tpu.telemetry.obsui import JaegerUI as RefJaegerUI
from opentelemetry_demo_tpu.telemetry.tracestore import TraceStore as RefTraceStore
from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanRecord
from opentelemetry_demo_tpu_torch.services.gateway import ShopGateway
from opentelemetry_demo_tpu_torch.services.shop import Shop, ShopConfig
from opentelemetry_demo_tpu_torch.telemetry import dashboards
from opentelemetry_demo_tpu_torch.telemetry.obsui import GrafanaUI, JaegerUI
from opentelemetry_demo_tpu_torch.telemetry.receivers import HttpCheckReceiver
from opentelemetry_demo_tpu_torch.telemetry.tracestore import TraceStore
from tests.test_torch_telemetry_backend import _own_process, _shops


@pytest.fixture(scope="module")
def busy_pair(tmp_path_factory):
    """60 virtual seconds of the default Locust-profile load, both packages."""
    return _shops(7, tmp_path_factory.mktemp("proc"))


def _both_boards():
    ref, port = ref_dashboards.provisioned_dashboards(), dashboards.provisioned_dashboards()
    assert [b.uid for b in port] == [b.uid for b in ref]
    return list(zip(ref, port))


def _own_panels(board) -> set[str]:
    """The panels that read this process's own CPU, memory and clock
    (``_own_process``): compared by title only."""
    return {p.title for p in board.panels if _own_process(p.query.metric, p.query.matchers)}


def _rows(board, result: dict) -> dict:
    own = _own_panels(board)
    return {title: rows for title, rows in result.items() if title not in own}


def test_exemplars_dashboard_panel(busy_pair):
    ref_shop, shop = busy_pair
    boards = {b.uid: b for b in dashboards.provisioned_dashboards()}
    assert "exemplars" in boards
    result = dashboards.evaluate(boards["exemplars"], shop.collector, shop.now)
    rows = result["Slowest recent spans (click-through to trace)"]
    assert rows and all(len(key) == 3 for key, _ in rows)
    ref_boards = {b.uid: b for b in ref_dashboards.provisioned_dashboards()}
    assert result == ref_dashboards.evaluate(ref_boards["exemplars"], ref_shop.collector, ref_shop.now)


def test_provisioned_dashboards_evaluate(busy_pair):
    ref_shop, shop = busy_pair
    at = shop.now
    boards = dashboards.provisioned_dashboards()
    assert {b.uid for b in boards} >= {"demo", "spanmetrics", "opentelemetry-collector", "anomaly"}
    by_uid = {b.uid: b for b in boards}
    demo = dashboards.evaluate(by_uid["demo"], shop.collector, at)
    assert demo["Requests by service"]
    span = dashboards.evaluate(by_uid["spanmetrics"], shop.collector, at)
    assert span["p95 latency by service"]
    text = dashboards.render_text(by_uid["spanmetrics"], shop.collector, at)
    assert "p95 latency by service" in text and "frontend" in text
    assert text == ref_dashboards.render_text(
        {b.uid: b for b in ref_dashboards.provisioned_dashboards()}["spanmetrics"], ref_shop.collector, at)


@pytest.mark.parametrize("uid", [b.uid for b in dashboards.provisioned_dashboards()])
def test_every_dashboard_evaluates_as_the_references(busy_pair, uid):
    ref_shop, shop = busy_pair
    ref_board, board = next((r, p) for r, p in _both_boards() if p.uid == uid)
    assert dashboards.to_grafana_json(board) == ref_dashboards.to_grafana_json(ref_board)
    got = dashboards.evaluate(board, shop.collector, shop.now)
    want = ref_dashboards.evaluate(ref_board, ref_shop.collector, ref_shop.now)
    assert sorted(got) == sorted(want)
    assert _rows(board, got) == _rows(ref_board, want)


def test_httpcheck_receiver_real_http():
    shop = Shop(ShopConfig(users=0, seed=1))
    gw = ShopGateway(shop, host="127.0.0.1", port=0)
    gw.start()
    try:
        recv = HttpCheckReceiver(timeout_s=2.0)
        recv.add_target("edge", f"http://127.0.0.1:{gw.port}/health")
        recv.add_target("missing", f"http://127.0.0.1:{gw.port}/no-such")
        status = {}
        deadline = time.monotonic() + 5.0
        while len(status) < 2 and time.monotonic() < deadline:
            recv.scrape()
            _, gauges = recv.registry.snapshot()
            status = {dict(k)["endpoint"]: v for (n, k), v in gauges.items() if n == "httpcheck_status"}
            time.sleep(0.02)
        assert status["edge"] == 1.0
        assert status["missing"] == 0.0
    finally:
        gw.stop()


def test_grafana_json_export(tmp_path):
    paths = dashboards.write_grafana_dashboards(str(tmp_path / "port"))
    ref_paths = ref_dashboards.write_grafana_dashboards(str(tmp_path / "ref"))
    assert len(paths) == 6
    assert [p.rsplit("/", 1)[1] for p in paths] == [p.rsplit("/", 1)[1] for p in ref_paths]
    for p, r in zip(paths, ref_paths):
        assert open(p, "rb").read() == open(r, "rb").read(), p
    by_uid = {}
    for p in paths:
        doc = json.load(open(p))
        by_uid[doc["uid"]] = doc
        assert doc["panels"], p
    live = by_uid["sketch-live"]
    for panel in live["panels"]:
        assert panel["datasource"]["uid"] == "anomaly-query"
        assert panel["targets"][0]["target"]
    assert any(panel["type"] == "timeseries" for panel in live["panels"])
    assert any(panel["type"] == "table" for panel in live["panels"])
    exprs = [t["expr"] for panel in by_uid["spanmetrics"]["panels"] for t in panel["targets"]]
    assert any(e.startswith("histogram_quantile(0.95,")
               and "traces_span_metrics_duration_milliseconds_bucket" in e for e in exprs)
    all_exprs = [t["expr"] for p in by_uid["demo"]["panels"] for t in p["targets"]]
    assert any('status_code="STATUS_CODE_ERROR"' in e for e in all_exprs)


def test_obsui_escapes_attribute_injection():
    bodies = []
    for store_cls, rec_cls, ui_cls in ((RefTraceStore, RefSpanRecord, RefJaegerUI),
                                       (TraceStore, SpanRecord, JaegerUI)):
        store = store_cls()
        evil = 'x" onmouseover="alert(1)'
        store.add_span(1.0, rec_cls(service=evil, duration_us=100.0, trace_id=b"\x01" * 16, name="op"))
        ui = ui_cls(store)
        status, ctype, body = ui.handle("GET", "/", {})
        assert status == 200
        store.add_span(2.0, rec_cls(service="a+b&c", duration_us=50.0, trace_id=b"\x02" * 16, name="op"))
        bodies.append((body, ui.handle("GET", "/", {})))
    (ref_first, ref_second), (body, second) = bodies
    assert body == ref_first and second == ref_second
    assert b'onmouseover="alert' not in body
    assert b"&quot;" in body
    assert b'href="/jaeger/?service=a%2Bb%26c"' in second[2]


def _trace_ids(shop) -> list[str]:
    return [t.trace_id.hex() for t in shop.collector.trace_store.find_traces(service="checkout")][:3]


JAEGER_ROUTES = [
    ("/", {}), ("/search", {"service": "checkout"}), ("/api/services", {}),
    ("/api/services/checkout/operations", {}), ("/api/traces", {"service": "checkout", "limit": "5"}),
    ("/api/traces", {"service": "payment", "operation": "Charge"}), ("/api/traces", {"minDuration": "100s"}),
    ("/api/traces", {"tags": '{"error":"true"}'}), ("/api/traces/zz-not-hex", {}), ("/nope", {}),
    ("/trace/{id}", {}), ("/api/traces/{id}", {}),
]


@pytest.mark.parametrize("path,query", JAEGER_ROUTES, ids=[f"{p}{sorted(q)}" for p, q in JAEGER_ROUTES])
def test_jaeger_routes_answer_as_the_references(busy_pair, path, query):
    ref_shop, shop = busy_pair
    ids = _trace_ids(shop)
    assert ids and ids == _trace_ids(ref_shop)
    path = path.replace("{id}", ids[0])
    got = JaegerUI(shop.collector.trace_store).handle("GET", path, query)
    want = RefJaegerUI(ref_shop.collector.trace_store).handle("GET", path, query)
    assert got == want
    assert JaegerUI(shop.collector.trace_store).handle("POST", path, query)[0] == 405


GRAFANA_ROUTES = ["/", "/api/search", "/api/dashboards/uid/spanmetrics", "/api/dashboards/uid/nope",
                  "/api/eval/demo", "/api/eval/spanmetrics", "/api/eval/exemplars", "/d/demo", "/d/spanmetrics",
                  "/d/exemplars", "/d/nope", "/nope"]


@pytest.mark.parametrize("path", GRAFANA_ROUTES)
def test_grafana_routes_answer_as_the_references(busy_pair, path):
    ref_shop, shop = busy_pair
    got = GrafanaUI(shop.collector).handle("GET", path, {})
    want = RefGrafanaUI(ref_shop.collector).handle("GET", path, {})
    assert got[:2] == want[:2]
    assert got[2] == want[2]
    assert GrafanaUI(shop.collector).handle("POST", path, {})[0] == 405

