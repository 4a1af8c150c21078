"""The port's HTTP edge against the reference's: the gateway, the web
storefront and the mobile client, and the span stream they feed.

Each case of ``tests/test_gateway.py``, ``tests/test_webui_e2e.py`` and
``tests/test_mobile.py`` runs here on both packages at once: a
reference ``ShopGateway`` and a port ``ShopGateway`` over shops of one
seed receive the same request sequence, and every answer must be equal
(status, content type, body, the session cookie and the redirect),
every record their ``on_spans`` receives must be equal field for field,
and the reference case's own assertions must hold on the port.

What would make two live gateways differ is pinned: both tracer modules
draw trace ids from one seeded source (``secrets``), both web UIs and
mobile clients draw session ids from one seeded ``uuid``, and both
gateway modules read one virtual ``time.monotonic`` that the twin
advances 0.05 s before each request (so the edge spans' durations and
the shops' clocks agree; ``time.sleep`` stays real). The load
generators run threads on the wall clock, so their cases hold the port
to the reference's assertions and, separately, hold one user's request
plan equal across packages for a seed.

The slice: the records a request sequence gives, fed to a JAX pipeline
and to a port pipeline on the CPU (the shop rig's geometry, B=512): the
flags of every report identical, integer state bit for bit, floats
within rtol 1e-4 / atol 1e-5.
"""

from __future__ import annotations

import json
import random
import re
import threading
import time
import types
import urllib.error
import urllib.request
from http.cookiejar import CookieJar
from urllib.parse import quote

import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import AnomalyDetector as RefDetector
from opentelemetry_demo_tpu.models import DetectorConfig as RefConfig
from opentelemetry_demo_tpu.runtime.pipeline import DetectorPipeline as RefPipeline
from opentelemetry_demo_tpu.services import Shop as RefShop
from opentelemetry_demo_tpu.services import ShopConfig as RefShopConfig
from opentelemetry_demo_tpu.services import ShopGateway as RefGateway
from opentelemetry_demo_tpu.services import gateway as ref_gateway
from opentelemetry_demo_tpu.services import http_load as ref_http_load
from opentelemetry_demo_tpu.services import mobile as ref_mobile
from opentelemetry_demo_tpu.services import webui as ref_webui
from opentelemetry_demo_tpu.telemetry import tracer as ref_tracer
from opentelemetry_demo_tpu_torch.models import AnomalyDetector
from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
from opentelemetry_demo_tpu_torch.services import Shop, ShopConfig, ShopGateway
from opentelemetry_demo_tpu_torch.services import gateway as port_gateway
from opentelemetry_demo_tpu_torch.services import http_load as port_http_load
from opentelemetry_demo_tpu_torch.services import mobile as port_mobile
from opentelemetry_demo_tpu_torch.services import webui as port_webui
from opentelemetry_demo_tpu_torch.services.http_load import (
    BrowserLoadGenerator,
    HttpLoadGenerator,
    browser_traffic_enabled,
)
from opentelemetry_demo_tpu_torch.services.load_control import LoadControl
from opentelemetry_demo_tpu_torch.services.rig import RIG_BATCH, RIG_CONFIG
from opentelemetry_demo_tpu_torch.telemetry import tracer as port_tracer
from opentelemetry_demo_tpu_torch.utils.flags import OfrepClient

RTOL, ATOL = 1e-4, 1e-5
STEP_S = 0.05  # virtual seconds the twin's clock advances before a request


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # torch's intra-op pool spins against XLA's in one process
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _SeededIds:
    """Stands in for ``secrets`` in a tracer module."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def token_bytes(self, n: int) -> bytes:
        return self._rng.randbytes(n)


class _SeededUuid:
    """Stands in for ``uuid`` in the web UI and mobile modules."""

    UUID = __import__("uuid").UUID

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def uuid4(self):
        return self.UUID(int=self._rng.getrandbits(128), version=4)


class _Side:
    """One package's shop behind its gateway, recording every flush."""

    def __init__(self, shop, gateway_cls, record: bool):
        self.shop = shop
        self.calls: list = []
        on_spans = (lambda t, spans: self.calls.append((t, list(spans)))) if record else None
        self.gw = gateway_cls(shop, host="127.0.0.1", port=0, on_spans=on_spans)
        self.base = f"http://127.0.0.1:{self.gw.port}"

    def pump(self) -> None:
        with self.gw._lock:
            self.gw._pump_locked()

    def records(self) -> list:
        return [(t, [(tuple(r), [tuple(e) for e in r.events]) for r in spans]) for t, spans in self.calls]


def _answer(base: str, method: str, path: str, body: bytes | None, headers: dict, opener=None):
    req = urllib.request.Request(base + path, data=body, method=method, headers=headers)
    try:
        with (opener.open if opener else urllib.request.urlopen)(req, timeout=30) as r:
            return (r.status, r.headers.get("Content-Type", ""), r.read(), r.headers.get("Set-Cookie"), r.url)
    except urllib.error.HTTPError as e:
        return (e.code, e.headers.get("Content-Type", ""), e.read(), e.headers.get("Set-Cookie"), e.url)


def _comparable(path: str, answer, base: str):
    """An answer as it is compared: the redirect target without the
    gateway's address, and ``/metrics`` without the series that read
    this process's own resources (``container_*``)."""
    status, ctype, body, cookie, url = answer
    if path == "/metrics":
        body = b"\n".join(ln for ln in body.split(b"\n") if b"container_" not in ln.split(b"{")[0])
    return status, ctype, body, cookie, url.replace(base, "")


class Twin:
    """A reference and a port gateway over shops of one seed, driven
    request for request with one virtual clock and seeded ids."""

    def __init__(self, monkeypatch, seed: int, record: bool = True):
        self.now = 0.0
        clock = types.SimpleNamespace(monotonic=lambda: self.now, sleep=time.sleep)
        for mod in (ref_gateway, port_gateway):
            monkeypatch.setattr(mod, "time", clock)
        for mod in (ref_tracer, port_tracer):
            monkeypatch.setattr(mod, "secrets", _SeededIds(seed))
        for mod in (ref_webui, port_webui, ref_mobile, port_mobile):
            monkeypatch.setattr(mod, "uuid", _SeededUuid(seed))
        self.ref = _Side(RefShop(RefShopConfig(users=0, seed=seed)), RefGateway, record)
        self.port = _Side(Shop(ShopConfig(users=0, seed=seed)), ShopGateway, record)
        self.sides = (self.ref, self.port)

    def start(self) -> None:
        for side in self.sides:
            side.gw.start()

    def stop(self) -> None:
        for side in self.sides:
            side.gw.stop()

    def request(self, method: str, path: str, body: bytes | None = None, headers: dict | None = None,
                openers=(None, None)):
        """The same request to both gateways; their answers must be
        equal. Returns the port's (status, content type, body)."""
        self.now += STEP_S
        got = [_answer(side.base, method, path, body, headers or {}, opener)
               for side, opener in zip(self.sides, openers)]
        ref, port = (_comparable(path, a, side.base) for a, side in zip(got, self.sides))
        assert port == ref, (path, port[:2], ref[:2])
        return got[1][:3]

    def get(self, path: str, headers: dict | None = None):
        return self.request("GET", path, headers=headers)

    def post(self, path: str, doc, headers: dict | None = None):
        return self.request("POST", path, json.dumps(doc).encode(),
                            {"Content-Type": "application/json", **(headers or {})})

    def pump(self) -> None:
        for side in self.sides:
            side.pump()

    def same_records(self) -> list:
        """Both sinks hold the same flushes; the port's records."""
        assert self.port.records() == self.ref.records()
        return [r for _, spans in self.port.calls for r in spans]


@pytest.fixture
def twin(monkeypatch):
    t = Twin(monkeypatch, seed=7)
    t.start()
    try:
        yield t
    finally:
        t.stop()


# -- tests/test_gateway.py ------------------------------------------------------


def test_products_and_detail(twin):
    status, ctype, body = twin.get("/api/products")
    assert status == 200 and "json" in ctype
    products = json.loads(body)["products"]
    assert len(products) >= 5
    pid = products[0]["id"]
    status, _, body = twin.get(f"/api/products/{pid}")
    assert json.loads(body)["id"] == pid
    twin.pump()
    assert twin.same_records()


def test_cart_roundtrip_and_checkout(twin):
    pid = json.loads(twin.get("/api/products")[2])["products"][0]["id"]
    twin.post("/api/cart", {"userId": "u1", "item": {"productId": pid, "quantity": 2}})
    items = json.loads(twin.get("/api/cart?sessionId=u1")[2])["items"]
    assert items == [{"productId": pid, "quantity": 2}]
    status, _, body = twin.post("/api/checkout", {"userId": "u1", "currencyCode": "EUR"})
    order = json.loads(body)
    assert order["orderId"] and order["total"]["currencyCode"] == "EUR"
    assert json.loads(twin.get("/api/cart?sessionId=u1")[2])["items"] == []
    twin.pump()
    assert any(r.service == "checkout" for r in twin.same_records())


def test_supporting_routes(twin):
    assert "USD" in json.loads(twin.get("/api/currency")[2])["currencyCodes"]
    assert len(json.loads(twin.get("/api/recommendations?productIds=")[2])["productIds"]) == 5
    assert isinstance(json.loads(twin.get("/api/data?contextKeys=telescopes")[2])["ads"], list)
    quote_doc = json.loads(twin.get("/api/shipping?itemCount=3&currencyCode=CAD")[2])
    assert quote_doc["costUsd"]["currencyCode"] == "CAD"
    assert twin.get("/health")[0] == 200
    assert twin.get("/")[0] == 200
    status, ctype, body = twin.get("/images/OLJCESPC7Z.svg")
    assert status == 200 and ctype == "image/svg+xml" and b"<svg" in body
    status, _, body = twin.get("/metrics")
    assert status == 200 and "app_frontend_requests_total" in body.decode()
    assert twin.get("/api/nope")[0] == 404
    twin.pump()
    twin.same_records()


def test_trace_headers_propagate_to_spans(twin):
    trace_id = "ab" * 16
    twin.get("/api/products", headers={
        "traceparent": f"00-{trace_id}-{'0' * 16}-01",
        "baggage": "session.id=sess-1,synthetic_request=true",
    })
    twin.pump()
    sink = twin.same_records()
    services = {s.service for s in sink}
    assert "frontend-proxy" in services and "product-catalog" in services
    assert all(s.trace_id == bytes.fromhex(trace_id) for s in sink)


def test_flagged_failure_maps_to_500_and_error_span(twin):
    for side in twin.sides:
        side.shop.set_flag("productCatalogFailure", True)
    bad_id = twin.port.shop.catalog.failure_product_id
    assert bad_id == twin.ref.shop.catalog.failure_product_id
    assert twin.get(f"/api/products/{bad_id}")[0] == 500
    twin.pump()
    errors = [s for s in twin.same_records() if s.is_error]
    assert any(s.service == "product-catalog" for s in errors)
    assert any(s.service == "frontend-proxy" for s in errors)


def test_email_failure_records_exception_event(twin):
    twin.post("/api/cart", {"userId": "bad-mail", "item": {"productId": "TEL-DOB-10", "quantity": 1}})
    status, _, body = twin.post("/api/checkout", {"userId": "bad-mail", "currencyCode": "USD",
                                                  "email": "not-an-address"})
    assert status == 200 and json.loads(body)["orderId"]
    twin.pump()
    sink = twin.same_records()
    email_errs = [s for s in sink if s.service == "email" and s.is_error]
    assert email_errs
    ev = email_errs[0].events[0]
    assert ev.name == "exception"
    assert ev.attr_dict["exception.type"] == "InvalidRecipientError"
    co = next(s for s in sink if s.service == "checkout" and s.name == "PlaceOrder")
    assert not co.is_error
    assert [e.name for e in co.events] == ["prepared", "charged", "shipped"]


def test_malformed_input_is_4xx_not_error_span(twin):
    status, _, _ = twin.request("POST", "/api/cart", b"not json", {"Content-Type": "application/json"})
    assert status == 400
    assert twin.get("/api/shipping?itemCount=abc")[0] == 400
    twin.pump()
    assert not any(s.is_error for s in twin.same_records() if s.service == "frontend-proxy")


def test_malformed_trace_header_is_400_with_edge_span(twin):
    assert twin.get("/health", headers={"traceparent": "00-nothex-0-01"})[0] == 400
    twin.pump()
    assert any(s.service == "frontend-proxy" for s in twin.same_records())


def test_cart_delete_goes_through_frontend(twin):
    assert twin.request("DELETE", "/api/cart?sessionId=u9")[0] == 200
    twin.pump()
    assert any(s.service == "frontend" for s in twin.same_records())


def test_svg_stable_and_escaped():
    for pid in ("OLJCESPC7Z", "x<script>alert(1)</script>", "TEL-DOB-10"):
        assert port_gateway._product_image_svg(pid) == ref_gateway._product_image_svg(pid)
    a, b = port_gateway._product_image_svg("OLJCESPC7Z"), port_gateway._product_image_svg("OLJCESPC7Z")
    assert a == b
    assert b"<script" not in port_gateway._product_image_svg("x<script>alert(1)</script>")


def test_fault_delay_header(twin):
    t0 = time.monotonic()
    status, _, _ = twin.get("/health", headers={"x-fault-delay-ms": "300"})
    # Both gateways slept 0.3 s in turn.
    assert status == 200 and time.monotonic() - t0 >= 0.6
    twin.pump()
    twin.same_records()


def test_otlp_http_browser_seam(twin):
    body = {"resourceSpans": [{
        "resource": {"attributes": [{"key": "service.name", "value": {"stringValue": "browser"}}]},
        "scopeSpans": [{"spans": [{"traceId": "cd" * 16, "name": "documentFetch",
                                   "startTimeUnixNano": 0, "endTimeUnixNano": 5_000_000}]}],
    }]}
    assert twin.post("/otlp-http/v1/traces", body)[0] == 200
    browser = [s for s in twin.same_records() if s.service == "browser"]
    assert browser and browser[0].duration_us == 5000.0
    for side in twin.sides:
        side.shop.collector.pump(side.shop.now + 1.0)
    assert twin.port.shop.collector.trace_store.find_traces(service="browser")
    assert [t.trace_id for t in twin.port.shop.collector.trace_store.find_traces(service="browser")] == [
        t.trace_id for t in twin.ref.shop.collector.trace_store.find_traces(service="browser")]


def test_ofrep_evaluate_round_trip(twin):
    for side in twin.sides:
        side.shop.set_flag("paymentFailure", 0.25)
    client = OfrepClient(twin.port.base)
    assert client.evaluate("paymentFailure", 0.0) == 0.25
    assert client.evaluate("noSuchFlag", "fallback") == "fallback"
    for path in ("/ofrep/v1/evaluate/flags/paymentFailure", "/ofrep/v1/evaluate/flags/noSuchFlag"):
        twin.post(path, {"context": {"targetingKey": "u"}})
    for side in twin.sides:
        doc = {"flags": dict(side.shop.flags._doc.get("flags", {}))}
        doc["flags"]["paymentFailure"]["state"] = "DISABLED"
        side.shop.flags.replace(doc)
    assert client.evaluate("paymentFailure", 0.125) == 0.125
    assert twin.post("/ofrep/v1/evaluate/flags/paymentFailure", {})[0] == 404
    assert twin.post("/ofrep/v1/evaluate/flags/paymentFailure", [1, 2])[0] == 400
    assert twin.request("GET", "/ofrep/v1/evaluate/flags/paymentFailure")[0] == 405


def test_ofrep_client_transient_retry_is_bounded(twin):
    dead = OfrepClient("http://127.0.0.1:1", timeout_s=0.2, retries=2)
    t0 = time.monotonic()
    assert dead.evaluate("anyFlag", "fallback") == "fallback"
    assert dead.transient_failures == 3
    assert time.monotonic() - t0 < 3.0
    live = OfrepClient(twin.port.base, timeout_s=1.0, retries=2)
    assert live.evaluate("noSuchFlag", "fb") == "fb"
    assert live.transient_failures == 0


def test_cart_latency_histogram_exported(twin):
    twin.post("/api/cart", {"userId": "u1", "item": {"productId": "TEL-DOB-10", "quantity": 1}})
    twin.get("/api/cart?sessionId=u1")
    text = twin.port.shop.metrics.render()
    assert "app_cart_add_item_latency_ms_bucket" in text
    assert "app_cart_get_cart_latency_ms_count" in text
    assert [ln for ln in text.splitlines() if ln.startswith("app_cart")] == [
        ln for ln in twin.ref.shop.metrics.render().splitlines() if ln.startswith("app_cart")]


# -- the load generators: wall-clock threads against the port's gateway -----------


@pytest.fixture
def rig():
    """The port's gateway on the wall clock (the reference test's rig)."""
    shop = Shop(ShopConfig(users=0, seed=7))
    sink = []
    sink_lock = threading.Lock()

    def on_spans(t, spans):
        with sink_lock:
            sink.extend(spans)

    gw = ShopGateway(shop, host="127.0.0.1", port=0, on_spans=on_spans)
    gw.start()
    try:
        yield shop, gw, sink
    finally:
        gw.stop()


class _Recorder:
    """Stands in for the network under one load user: records each
    request it would send and answers like the shop would."""

    def __init__(self, gen, products):
        self.sent = []
        self.products = products
        self.gen = gen

    def request(self, method, path, session_id, body=None):
        self.sent.append((method, path, session_id, json.dumps(body, sort_keys=True)))
        if len(self.sent) >= 40:
            self.stop.set()
        if path == "/api/products":
            return {"products": [{"id": p} for p in self.products]}
        return None

    def fetch(self, path, cookies, form=None):
        self.sent.append((path, dict(cookies), form))
        if len(self.sent) >= 40:
            self.stop.set()
        html = "".join(f'<a href="/product/{p}"><img src="/images/{p}.svg"></a>' for p in self.products[:3])
        return 200, html, 0.0

    def export(self, spans, cookies):
        self.sent.append(("export", [name for name, *_ in spans]))


@pytest.mark.parametrize("kind", ["http", "browser"])
def test_one_load_user_sends_the_references_requests(kind):
    """The request plan of user 0 under one seed, with the network
    replaced by a recorder: the same requests in the same order from
    both packages' generators (the wall clock only paces them)."""
    products = ["TEL-DOB-10", "EYE-PLO-25", "FIL-OIII-2", "MNT-EQ6-GT"]
    plans = []
    for mod in (ref_http_load, port_http_load):
        cls = mod.HttpLoadGenerator if kind == "http" else mod.BrowserLoadGenerator
        gen = cls("http://127.0.0.1:1", users=0, wait_range_s=(0.0, 0.0), seed=11)
        rec = _Recorder(gen, products)
        rec.stop = threading.Event()
        if kind == "http":
            gen._request = rec.request
        else:
            gen._fetch = rec.fetch
            gen._export_spans = rec.export
        gen._user_loop(0, rec.stop)
        plans.append(rec.sent)
    assert len(plans[1]) >= 40 and plans[1] == plans[0]


def test_browser_loadgen_drives_storefront(rig, monkeypatch):
    monkeypatch.delenv("LOCUST_BROWSER_TRAFFIC_ENABLED", raising=False)
    assert not browser_traffic_enabled()
    monkeypatch.setenv("LOCUST_BROWSER_TRAFFIC_ENABLED", "true")
    assert browser_traffic_enabled() and ref_http_load.browser_traffic_enabled()
    shop, gw, sink = rig
    lg = BrowserLoadGenerator(f"http://127.0.0.1:{gw.port}", users=2, wait_range_s=(0.01, 0.05), seed=3)
    lg.run_for(2.5)
    assert lg.pages_loaded >= 4
    assert lg.images_loaded >= 1
    assert lg.spans_exported >= lg.pages_loaded
    assert lg.errors == 0
    with gw._lock:
        gw._pump_locked()
    services = {s.service for s in sink}
    assert "frontend-web" in services
    assert {"frontend-proxy", "frontend"} <= services
    names = {s.name for s in sink if s.service == "frontend-web"}
    assert any(n and n.startswith("documentLoad") for n in names)
    assert any(n and n.startswith("resourceFetch /images/") for n in names)
    assert any(s.service == "cart" for s in sink)


def _loadgen_post(gw, path, doc):
    req = urllib.request.Request(f"http://127.0.0.1:{gw.port}{path}", data=json.dumps(doc).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _loadgen_status(gw):
    with urllib.request.urlopen(f"http://127.0.0.1:{gw.port}/loadgen/api/status", timeout=10) as r:
        return json.loads(r.read())


def test_loadgen_control_surface_runtime_resize(rig):
    shop, gw, sink = rig
    gw.loadgen_ui = LoadControl(f"http://127.0.0.1:{gw.port}", seed=3)
    gw.loadgen_ui.http = None
    out = _loadgen_post(gw, "/loadgen/api/start", {"users": 3})
    assert out["httpUsersTarget"] == 3
    gw.loadgen_ui.http.wait_range_s = (0.01, 0.05)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and _loadgen_status(gw)["requestsSent"] < 10:
        time.sleep(0.1)
    s = _loadgen_status(gw)
    assert s["requestsSent"] >= 10 and s["httpUsers"] == 3
    _loadgen_post(gw, "/loadgen/api/users", {"users": 1})
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and _loadgen_status(gw)["httpUsers"] != 1:
        time.sleep(0.1)
    assert _loadgen_status(gw)["httpUsers"] == 1
    _loadgen_post(gw, "/loadgen/api/stop", {})
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and _loadgen_status(gw)["httpUsers"] != 0:
        time.sleep(0.1)
    assert _loadgen_status(gw)["httpUsers"] == 0
    with urllib.request.urlopen(f"http://127.0.0.1:{gw.port}/loadgen", timeout=10) as r:
        html = r.read().decode()
    assert "Load generator" in html
    # The page and the verdicts are the reference's for the same status.
    from opentelemetry_demo_tpu.services.load_control import LoadControl as RefLoadControl

    ref = RefLoadControl(gw.loadgen_ui.target_url, seed=3)
    ref.status = gw.loadgen_ui.status
    for method, sub, body in (("GET", "/", b""), ("GET", "/api/status", b""), ("POST", "/api/users", b"[1]"),
                              ("POST", "/api/start", b'{"users": "x"}'), ("GET", "/nope", b"")):
        assert gw.loadgen_ui.handle(method, sub, body) == ref.handle(method, sub, body)


def test_loadgen_spawn_rate_ramps(rig):
    shop, gw, sink = rig
    control = LoadControl(f"http://127.0.0.1:{gw.port}", seed=5)
    gw.loadgen_ui = control
    control.set_users(4, spawn_rate=8.0)
    early = control.status()["httpUsers"]
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and control.status()["httpUsers"] < 4:
        time.sleep(0.05)
    assert control.status()["httpUsers"] == 4
    assert early <= 4
    control.stop()


def test_http_loadgen_drives_traffic(rig):
    shop, gw, sink = rig
    lg = HttpLoadGenerator(f"http://127.0.0.1:{gw.port}", users=3, wait_range_s=(0.01, 0.05), seed=1)
    lg.run_for(2.0)
    assert lg.requests_sent > 20
    assert lg.errors <= lg.requests_sent * 0.2
    with gw._lock:
        gw._pump_locked()
    assert {"frontend-proxy", "frontend", "product-catalog"} <= {s.service for s in sink}


# -- observability surfaces at the edge (/jaeger, /grafana) -------------------------


def _drive_checkout(twin, user="obs-user"):
    twin.post("/api/cart", {"userId": user, "item": {"productId": "TEL-DOB-10", "quantity": 1}})
    status, _, body = twin.post("/api/checkout", {"userId": user, "currencyCode": "USD",
                                                  "email": "obs@example.com"})
    assert status == 200
    return json.loads(body)


def _advance(twin, dt: float) -> None:
    for side in twin.sides:
        with side.gw._lock:
            side.shop.pump(side.shop.now + dt)


def test_jaeger_api_finds_checkout_trace(twin):
    _drive_checkout(twin)
    _advance(twin, 1.0)
    status, _, body = twin.get("/jaeger/api/services")
    assert status == 200 and "checkout" in json.loads(body)["data"]
    assert "PlaceOrder" in json.loads(twin.get("/jaeger/api/services/checkout/operations")[2])["data"]
    traces = json.loads(twin.get("/jaeger/api/traces?service=checkout&operation=PlaceOrder")[2])["data"]
    assert traces
    trace = traces[0]
    assert "PlaceOrder" in {s["operationName"] for s in trace["spans"]}
    assert "checkout" in {p["serviceName"] for p in trace["processes"].values()}
    status, _, body = twin.get(f"/jaeger/api/traces/{trace['traceID']}")
    assert status == 200 and json.loads(body)["data"][0]["traceID"] == trace["traceID"]
    status, ctype, body = twin.get(f"/jaeger/trace/{trace['traceID']}")
    assert status == 200 and "text/html" in ctype
    assert b"PlaceOrder" in body and b"<svg" in body
    place = next(s for s in trace["spans"] if s["operationName"] == "PlaceOrder")
    assert [log["fields"][0]["value"] for log in place["logs"]][:3] == ["prepared", "charged", "shipped"]
    assert any(f["key"] == "app.payment.transaction.id" and f["value"] for f in place["logs"][1]["fields"])
    times = [log["timestamp"] for log in place["logs"]]
    assert times == sorted(times)
    assert all(place["startTime"] <= t <= place["startTime"] + place["duration"] for t in times)
    assert b"charged" in body


def test_jaeger_search_page_and_filters(twin):
    _drive_checkout(twin)
    _advance(twin, 1.0)
    status, ctype, body = twin.get("/jaeger/")
    assert status == 200 and "text/html" in ctype and b"checkout" in body
    assert json.loads(twin.get("/jaeger/api/traces?minDuration=100s")[2])["data"] == []
    assert twin.get("/jaeger/api/traces/zz-not-hex")[0] == 404


def test_grafana_dashboards_render_live_numbers(twin):
    _drive_checkout(twin, "g1")
    _advance(twin, 6.0)
    _drive_checkout(twin, "g2")
    _advance(twin, 6.0)
    uids = {d["uid"] for d in json.loads(twin.get("/grafana/api/search")[2])}
    assert {"demo", "spanmetrics", "exemplars", "anomaly"} <= uids
    panels = {p["title"]: p["rows"] for p in json.loads(twin.get("/grafana/api/eval/demo")[2])["panels"]}
    assert panels["Requests by service"] and any(v > 0 for _, v in panels["Requests by service"])
    panels = {p["title"]: p["rows"] for p in json.loads(twin.get("/grafana/api/eval/spanmetrics")[2])["panels"]}
    assert any("checkout" in "/".join(map(str, k)) for k, _ in panels["Call rate by operation"])
    status, ctype, body = twin.get("/grafana/d/demo")
    assert status == 200 and "text/html" in ctype
    assert b"Requests by service" in body and b"<svg" in body
    model = json.loads(twin.get("/grafana/api/dashboards/uid/spanmetrics")[2])["dashboard"]
    assert model["uid"] == "spanmetrics" and model["panels"]
    assert twin.get("/grafana/d/nope")[0] == 404


# -- tests/test_webui_e2e.py: the storefront through a cookie jar on each side --------


class TwinBrowser:
    """One cookie-jar browser per package; each step goes to both."""

    def __init__(self, twin):
        self.twin = twin
        self.jars = (CookieJar(), CookieJar())
        self.openers = tuple(urllib.request.build_opener(urllib.request.HTTPCookieProcessor(j)) for j in self.jars)

    def get(self, path: str) -> tuple[int, str]:
        status, _, body = self.twin.request("GET", path, openers=self.openers)
        return status, body.decode()

    def post_form(self, path: str, **fields) -> tuple[int, str]:
        data = "&".join(f"{k}={v}" for k, v in fields.items()).encode()
        status, _, body = self.twin.request("POST", path, data,
                                            {"Content-Type": "application/x-www-form-urlencoded"},
                                            openers=self.openers)
        return status, body.decode()

    def cookies(self) -> dict:
        ref, port = ({c.name: c.value for c in jar} for jar in self.jars)
        assert port == ref
        return port


@pytest.fixture
def browser(monkeypatch):
    t = Twin(monkeypatch, seed=9, record=False)
    t.start()
    try:
        yield t, TwinBrowser(t)
    finally:
        t.stop()


def _first_product(html: str) -> str:
    return re.search(r'href="/product/([A-Z0-9-]+)', html).group(1)


class TestHomeSpec:
    def test_home_renders_product_grid(self, browser):
        _, b = browser
        status, html = b.get("/")
        assert status == 200
        assert html.count('class="card"') >= 10
        assert "/images/" in html and "currency" in html

    def test_session_cookie_set_once(self, browser):
        _, b = browser
        b.get("/")
        sid = b.cookies()["shop_session"]
        b.get("/")
        assert b.cookies()["shop_session"] == sid


class TestProductDetailSpec:
    def test_detail_shows_recommendations_and_form(self, browser):
        _, b = browser
        _, home = b.get("/")
        status, html = b.get(f"/product/{_first_product(home)}")
        assert status == 200
        assert "Add to cart" in html and "You may also like" in html
        assert html.count('href="/product/') >= 3


class TestCheckoutSpec:
    def test_full_purchase_journey(self, browser):
        twin, b = browser
        _, home = b.get("/")
        pid = _first_product(home)
        assert b.post_form("/cart/add", productId=pid, quantity=2)[0] == 200
        _, cart = b.get("/cart")
        assert pid in cart and "Place order" in cart
        status, conf = b.post_form("/cart/checkout", email="e2e@example.com", currencyCode="EUR",
                                   cardNumber="4432801561520454")
        assert status == 200 and "Order placed" in conf
        assert re.search(r"order id: <b>([0-9a-f-]+)</b>", conf).group(1)
        assert "EUR" in conf
        for side in twin.sides:
            side.shop.run(1.0)
        assert twin.port.shop.accounting.orders_seen == twin.ref.shop.accounting.orders_seen >= 1

    def test_cart_badge_counts_items(self, browser):
        _, b = browser
        _, home = b.get("/")
        b.post_form("/cart/add", productId=_first_product(home), quantity=3)
        assert "Cart (3)" in b.get("/")[1]

    def test_cart_page_escapes_stored_product_ids(self, browser):
        _, b = browser
        b.get("/")
        b.post_form("/cart/add", productId=quote("<img src=x onerror=alert(1)>"), quantity=1)
        _, html = b.get("/cart")
        assert "<img src=x" not in html and "&lt;img" in html

    def test_home_escapes_currency_param(self, browser):
        _, b = browser
        status, html = b.get("/?currency=%22%3E%3Cscript%3Ealert(1)%3C/script%3E")
        assert status == 200 and "<script>alert(1)</script>" not in html

    def test_ad_failure_degrades_banner_not_page(self, browser):
        twin, b = browser
        for side in twin.sides:
            side.shop.set_flag("adFailure", True)
        bannerless = 0
        for _ in range(40):
            status, html = b.get("/")
            assert status == 200 and html.count('class="card"') >= 10
            bannerless += 'class="ad"' not in html
        assert bannerless >= 1

    def test_payment_failure_renders_error_page(self, browser):
        twin, b = browser
        for side in twin.sides:
            side.shop.set_flag("paymentFailure", 1.0)
        _, home = b.get("/")
        b.post_form("/cart/add", productId=_first_product(home), quantity=1)
        status, html = b.post_form("/cart/checkout", email="x@example.com", currencyCode="USD")
        assert status == 500 and "Something went wrong" in html
        assert b.get("/")[0] == 200


# -- tests/test_mobile.py: the same app on each package --------------------------------


def _mobile_pair(monkeypatch, seed=5):
    """An in-process mobile app per package over shops of one seed."""
    for mod in (ref_tracer, port_tracer):
        monkeypatch.setattr(mod, "secrets", _SeededIds(seed))
    apps = []
    for mob, shop in ((ref_mobile, RefShop(RefShopConfig(users=0, seed=seed))),
                      (port_mobile, Shop(ShopConfig(users=0, seed=seed)))):
        app = mob.MobileApp(mob.InProcTransport(shop.frontend), tracer=shop.tracer,
                            session=mob.MobileSession("mobile-test-session"))
        apps.append((app, shop))
    return apps


def _both(apps, fn):
    """``fn(app, shop)`` on each package; the results must be equal."""
    ref, port = (fn(app, shop) for app, shop in apps)
    assert port == ref
    return port


class TestMobileInProc:
    def test_shopping_journey_places_order(self, monkeypatch):
        apps = _mobile_pair(monkeypatch)
        order = _both(apps, lambda app, shop: app.shopping_journey(np.random.default_rng(0), n_items=2))
        assert order["orderId"] and order["shippingTrackingId"]
        assert order["total"]["currencyCode"] == "USD"
        assert apps[1][0].orders == [order]
        seen = _both(apps, lambda app, shop: (shop.run(1.0), shop.accounting.orders_seen)[1])
        assert seen >= 1

    def test_client_spans_carry_session(self, monkeypatch):
        apps = _mobile_pair(monkeypatch)
        _both(apps, lambda app, shop: app.product_list_screen())

        def traces(app, shop):
            shop.pump(1.0)
            return [(t.trace_id, sorted(t.services)) for t in shop.collector.trace_store.find_traces(
                service="react-native-app", operation="GET /api/products")]

        found = _both(apps, traces)
        assert found and "frontend" in found[0][1]

    def test_cart_screen_renders_resolved_rows_and_badge(self, monkeypatch):
        apps = _mobile_pair(monkeypatch)
        products = _both(apps, lambda app, shop: app.product_list_screen())
        _both(apps, lambda app, shop: (app.add_to_cart(products[0]["id"], 3), app.add_to_cart(products[1]["id"], 1)))
        screen = _both(apps, lambda app, shop: app.cart_screen())
        assert not screen["empty"] and screen["badge"] == 4
        row = {r["productId"]: r for r in screen["rows"]}[products[0]["id"]]
        assert row["name"] == products[0]["name"] and row["quantity"] == 3
        assert row["lineTotalUsd"] == pytest.approx(products[0]["priceUsd"] * 3)
        assert screen["subtotalUsd"] == pytest.approx(sum(r["lineTotalUsd"] for r in screen["rows"]))

    def test_empty_cart_flow(self, monkeypatch):
        apps = _mobile_pair(monkeypatch)
        products = _both(apps, lambda app, shop: app.product_list_screen())
        _both(apps, lambda app, shop: app.add_to_cart(products[0]["id"], 2))
        assert _both(apps, lambda app, shop: app.cart_screen())["badge"] == 2
        assert _both(apps, lambda app, shop: app.empty_cart())["toast"] == "Your cart was emptied"
        screen = _both(apps, lambda app, shop: app.cart_screen())
        assert screen["empty"] and screen["badge"] == 0 and not screen["rows"]

    def test_checkout_confirmation_fields(self, monkeypatch):
        apps = _mobile_pair(monkeypatch)
        products = _both(apps, lambda app, shop: app.product_list_screen())
        _both(apps, lambda app, shop: app.add_to_cart(products[0]["id"], 2))
        forms = {ref_mobile: ref_mobile.CheckoutForm(email="rn@example.com"),
                 port_mobile: port_mobile.CheckoutForm(email="rn@example.com")}
        conf = _both(apps, lambda app, shop: app.checkout_flow(
            form=forms[ref_mobile if isinstance(app, ref_mobile.MobileApp) else port_mobile]))
        assert conf["toast"] == "Your order is Complete!"
        assert conf["toastDetail"] == "We've sent you a confirmation email."
        assert conf["orderId"] and conf["shippingTrackingId"]
        assert conf["itemCount"] == 2 and conf["currencyCode"] == "USD"
        assert conf["totalUsd"] > products[0]["priceUsd"]
        assert conf["redirect"] == "/"
        assert _both(apps, lambda app, shop: app.cart_screen())["empty"]

    def test_checkout_failure_emits_error_span(self, monkeypatch):
        apps = _mobile_pair(monkeypatch)
        for _, shop in apps:
            shop.set_flag("paymentFailure", 1.0)
        products = _both(apps, lambda app, shop: app.product_list_screen())
        _both(apps, lambda app, shop: app.add_to_cart(products[0]["id"], 1))

        def fail(app, shop):
            with pytest.raises(Exception) as exc:
                app.checkout_flow()
            shop.pump(1.0)
            return type(exc.value).__name__, [t.trace_id for t in shop.collector.trace_store.find_traces(
                service="react-native-app", error_only=True)]

        assert _both(apps, fail)[1]


class TestMobileHttp:
    def test_journey_over_live_gateway(self, twin):
        apps = [(mob.MobileApp(mob.HttpTransport(side.base)), side)
                for mob, side in ((ref_mobile, twin.ref), (port_mobile, twin.port))]
        order = _both(apps, lambda app, side: app.shopping_journey(np.random.default_rng(1), n_items=1))
        assert order["orderId"] and order["total"]["currencyCode"] == "USD"

    def test_screen_states_over_live_gateway(self, twin):
        apps = [(mob.MobileApp(mob.HttpTransport(side.base)), side)
                for mob, side in ((ref_mobile, twin.ref), (port_mobile, twin.port))]
        products = _both(apps, lambda app, side: app.product_list_screen())
        _both(apps, lambda app, side: app.add_to_cart(products[0]["id"], 3))
        screen = _both(apps, lambda app, side: app.cart_screen())
        assert screen["badge"] == 3 and screen["rows"][0]["name"] == products[0]["name"]
        assert screen["rows"][0]["lineTotalUsd"] == pytest.approx(products[0]["priceUsd"] * 3)
        conf = _both(apps, lambda app, side: app.checkout_flow())
        assert conf["orderId"] and conf["itemCount"] == 3
        assert conf["currencyCode"] == "USD" and conf["totalUsd"] > 0
        _both(apps, lambda app, side: app.add_to_cart(products[1]["id"], 1))
        assert _both(apps, lambda app, side: app.cart_screen())["badge"] == 1
        assert _both(apps, lambda app, side: app.empty_cart())["toast"] == "Your cart was emptied"
        assert _both(apps, lambda app, side: app.cart_screen())["empty"]


# -- the slice: the gateway's records into both packages' pipelines ------------------


def _drive_session(twin, rounds: int, flip_at: int) -> None:
    """A storefront session at the shop's request mix, with
    ``paymentFailure`` flipped at round ``flip_at``."""
    products = [p["id"] for p in json.loads(twin.get("/api/products")[2])["products"]]
    for k in range(rounds):
        if k == flip_at:
            for side in twin.sides:
                side.shop.set_flag("paymentFailure", 1.0)
        user = f"user-{k}"
        pid = products[k % len(products)]
        twin.get("/")
        twin.get(f"/api/products/{pid}")
        twin.get(f"/images/{pid}.svg")
        twin.post("/api/cart", {"userId": user, "item": {"productId": pid, "quantity": 1 + k % 3}})
        twin.get(f"/api/recommendations?productIds={pid}")
        twin.post("/api/checkout", {"userId": user, "currencyCode": "USD", "email": f"{user}@example.com"})
    twin.pump()


def test_gateway_records_give_the_references_flags_and_state(twin):
    _drive_session(twin, rounds=60, flip_at=45)
    twin.same_records()
    cfg = RIG_CONFIG
    ref_events, port_events = [], []
    ref_pipe = RefPipeline(
        RefDetector(RefConfig(num_services=cfg.num_services, warmup_batches=cfg.warmup_batches,
                              z_warmup_batches=cfg.z_warmup_batches, z_threshold=cfg.z_threshold)),
        flags=twin.ref.shop.flags, batch_size=RIG_BATCH,
        on_report=lambda t, rep, flagged: ref_events.append((t, sorted(flagged))),
    )
    port_pipe = DetectorPipeline(
        AnomalyDetector(cfg, device="cpu"), flags=twin.port.shop.flags, batch_size=RIG_BATCH,
        on_report=lambda t, rep, flagged: port_events.append((t, sorted(flagged))),
    )
    for pipe, side in ((ref_pipe, twin.ref), (port_pipe, twin.port)):
        for t, spans in side.calls:
            pipe.submit(spans)
            pipe.pump(t)
        pipe.drain()
    assert len(port_events) == len(ref_events) > 300
    assert port_events == ref_events
    # Flags identical and not vacuous: the failing checkouts flag checkout.
    assert any("checkout" in f for t, f in port_events)
    assert port_pipe.tensorizer.service_names == ref_pipe.tensorizer.service_names
    got = port_pipe.state_snapshot()[0]
    want = {k: np.asarray(v) for k, v in ref_pipe.detector.state._asdict().items()}
    assert sorted(got) == sorted(want)
    for name, y in want.items():
        x = got[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if x.dtype.kind in "iu":
            assert x.tobytes() == y.tobytes(), name
        else:
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL, err_msg=name)
