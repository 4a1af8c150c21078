"""HTTP edge: the Envoy frontend-proxy + Next.js API surface, over real sockets.

The reference exposes the whole shop through one Envoy listener
(the upstream demo's src/frontend-proxy/envoy.tmpl.yaml:39-54 routes ``/``,
``/images/``, ``/otlp-http/``, ``/feature``, ``/loadgen``, ``/metrics`` …)
in front of the Next.js API routes
(the upstream demo's src/frontend/pages/api/{products,cart,checkout,currency,
data,recommendations,shipping}.ts). :class:`ShopGateway` is both tiers in
one threaded server:

- the Envoy behaviours: route table, W3C trace-context extraction,
  an access-log span per request tagged ``frontend-proxy`` (the
  ``spawn_upstream_span`` analogue, envoy.tmpl.yaml:18-31), and the
  fault-injection HTTP filter — header-triggered delay
  (``x-fault-delay-ms``, envoy.tmpl.yaml:57-64) plus the
  ``imageSlowLoad`` flag on the image route;
- the frontend behaviours: JSON API routes fanning out to the business
  services, ``app_frontend_requests_total`` counting via
  :class:`~.frontend.Frontend`;
- the image-provider tier (the upstream demo's src/image-provider/
  nginx.conf.template): ``/images/<product-id>`` serves a deterministic
  per-product SVG with its own ``image-provider`` span;
- the browser-telemetry seam: ``POST /otlp-http/v1/traces`` accepts OTLP
  (protobuf or JSON) exactly like the collector route the reference
  rewrites for the browser tracer
  (the upstream demo's src/frontend/utils/telemetry/FrontendTracer.ts:36-41),
  feeding decoded spans into the same sink as the shop's own.

The wrapped :class:`~.shop.Shop` stays single-threaded: a lock
serializes service calls, and the gateway drives the shop's virtual
clock from wall time (``Shop.pump``) so bus consumers and span flushes
happen between requests, not inside them.
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse
from xml.sax.saxutils import escape as _xml_escape

from .base import ServiceError
from .checkout import money_json as _money_json, placed_order_json
from ..utils.concurrency import RWLock
from .frontend import FLAG_IMAGE_SLOW_LOAD
from .shop import Shop
from .webui import WebStorefront
from ..runtime import otlp
from ..telemetry.obsui import GrafanaUI, JaegerUI
from ..telemetry.tracer import TraceContext

MAX_FAULT_DELAY_S = 10.0  # cap on header-triggered fault delays

# HTTP/2 prior-knowledge connection preface — what a gRPC client sends
# first on an h2c (cleartext) channel. The reference exposes the flag
# gRPC service through the single :8080 entry ("/flagservice/" →
# flagd :8013, envoy.tmpl.yaml:50-51); this edge is an HTTP/1 server,
# so gRPC rides a TCP splice instead: a connection opening with this
# preface is piped verbatim to the gRPC edge (which serves
# flagd.evaluation.v1 AND the oteldemo services — a superset of the
# reference's /flagservice/ upstream).
_H2_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"


def _product_image_svg(product_id: str) -> bytes:
    """Deterministic placeholder artwork, one color per product id."""
    # crc32, not hash(): str hashes are salted per process, and the color
    # must be stable across server restarts.
    hue = zlib.crc32(product_id.encode()) % 360
    label = _xml_escape(product_id)
    return (
        '<svg xmlns="http://www.w3.org/2000/svg" width="320" height="320">'
        f'<rect width="320" height="320" fill="hsl({hue},45%,35%)"/>'
        f'<circle cx="160" cy="140" r="70" fill="hsl({hue},60%,70%)"/>'
        f'<text x="160" y="280" text-anchor="middle" fill="#fff" '
        f'font-family="monospace" font-size="20">{label}</text></svg>'
    ).encode()


class ShopGateway:
    """Threaded HTTP server exposing a Shop at one edge address."""

    def __init__(
        self,
        shop: Shop,
        host: str = "0.0.0.0",
        port: int = 8080,
        on_spans=None,
    ):
        self.shop = shop
        self.on_spans = on_spans  # Callable[[float, list[SpanRecord]], None]
        # Writer-preference RW lock: the gateway itself always takes
        # exclusive (every route pumps/flushes shared state), but the
        # gRPC edge shares this lock and runs its read-only RPCs
        # concurrently under .shared() (grpc_edge.READ_METHODS).
        self._lock = RWLock()
        self._t0 = time.monotonic()
        self.requests_served = 0
        # Mount point for the flag editor (flagd-ui analogue): an object
        # with handle(method, path, body) -> (status, content_type, bytes).
        self.feature_ui = None
        self.loadgen_ui = None  # LoadControl, mounted at /loadgen
        # ("host", port) of a GrpcShopEdge over the SAME shop: enables
        # the h2c passthrough (the /flagservice/-at-the-edge analogue).
        # None = h2 connections are refused, like Envoy with the route
        # absent.
        self.grpc_target = None
        # Observability backends at the edge — the reference's Envoy
        # routes /jaeger and /grafana to the query UIs
        # (envoy.tmpl.yaml:44-47); here the analogues are served over
        # the shop's own collector backends.
        self.jaeger_ui = JaegerUI(shop.collector.trace_store)
        self.grafana_ui = GrafanaUI(shop.collector)
        # Server-rendered storefront at "/" (the Next.js tier analogue);
        # HTML pages live beside the JSON /api routes.
        self.web_ui = WebStorefront(shop.frontend)

        gateway = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _respond(
                self,
                status: int,
                body: bytes,
                ctype: str = "application/json",
                extra: dict | None = None,
            ):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _handle(self, method: str):
                t_start = time.monotonic()
                parsed = urlparse(self.path)
                route = parsed.path
                ctx = None
                extra = None
                try:
                    # Header/body parsing is inside the guard: a
                    # malformed traceparent or Content-Length is client
                    # input too, and must produce a 400 + an access-log
                    # span, never a dropped connection.
                    query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                    length = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(length) if length else b""
                    ctx = TraceContext.from_headers(
                        {k.lower(): v for k, v in self.headers.items()}
                    )
                    # Envoy-style fault filter: header-triggered delay.
                    delay_ms = self.headers.get("x-fault-delay-ms")
                    if delay_ms:
                        try:
                            time.sleep(
                                min(max(float(delay_ms), 0.0) / 1000.0, MAX_FAULT_DELAY_S)
                            )
                        except ValueError:
                            pass
                    cookies = {}
                    for part in (self.headers.get("Cookie") or "").split(";"):
                        if "=" in part:
                            k, v = part.split("=", 1)
                            cookies[k.strip()] = v.strip()
                    result = gateway._route(
                        method, route, query, body, ctx,
                        self.headers.get("Content-Type") or "",
                        cookies,
                    )
                    status, ctype, payload = result[:3]
                    extra = result[3] if len(result) > 3 else None
                except ServiceError as e:
                    status, ctype = 500, "application/json"
                    payload = json.dumps({"error": str(e)}).encode()
                except (json.JSONDecodeError, ValueError, KeyError) as e:
                    # Malformed client input (bad JSON body, non-numeric
                    # query params) is the client's fault: 4xx, so it
                    # doesn't inflate the edge error rate the detector
                    # watches (is_error tracks status >= 500).
                    status, ctype = 400, "application/json"
                    payload = json.dumps({"error": f"bad request: {e}"}).encode()
                except Exception as e:  # route bug ≠ connection abort
                    status, ctype = 500, "application/json"
                    payload = json.dumps({"error": f"internal: {e}"}).encode()
                if ctx is None:  # header parse failed before extraction
                    ctx = TraceContext.new()
                # Log before writing the response: once the client sees
                # the reply, the edge span is already in the sink (tests
                # and the pipeline may pump immediately after).
                gateway._access_log(
                    method, route, ctx, status,
                    (time.monotonic() - t_start) * 1e6,
                )
                self._respond(status, payload, ctype, extra)

            def handle(self):
                # h2c prior-knowledge sniff BEFORE the HTTP/1 parser:
                # nothing has read from the socket yet (setup() only
                # wraps it), so MSG_PEEK is safe. A gRPC client's first
                # bytes are always the full 24-byte preface; loop while
                # we hold a strict prefix (TCP may fragment). The sniff
                # runs under a SHORT socket timeout: a blocking
                # MSG_PEEK against a half-open connection that never
                # sends a byte would otherwise pin this handler thread
                # forever. The previous timeout is restored before
                # either handoff — the h2 splice and the HTTP/1 parser
                # own their own read policies.
                import socket as _socket

                prev_timeout = self.connection.gettimeout()
                self.connection.settimeout(2.0)
                try:
                    deadline = time.monotonic() + 2.0
                    while True:
                        try:
                            head = self.connection.recv(
                                len(_H2_PREFACE), _socket.MSG_PEEK
                            )
                        except OSError:
                            # Timeout (half-open peer) or reset: either
                            # way no preface is coming.
                            head = b""
                        if head == _H2_PREFACE:
                            self.connection.settimeout(prev_timeout)
                            gateway._splice_h2(self.connection)
                            self.close_connection = True
                            return
                        if (head and _H2_PREFACE.startswith(head)
                                and time.monotonic() < deadline):
                            # Strict prefix: the rest of the preface is
                            # in flight. MSG_PEEK returns the same
                            # bytes immediately, so pace the re-peek.
                            time.sleep(0.005)
                            continue
                        break  # plain HTTP (or EOF): the normal parser
                finally:
                    # The splice path may have CLOSED the socket (e.g.
                    # no upstream): restoring a timeout on a closed fd
                    # raises EBADF, which must not escape handle().
                    try:
                        self.connection.settimeout(prev_timeout)
                    except OSError:
                        pass
                super().handle()

            def do_GET(self):  # noqa: N802 (http.server API)
                self._handle("GET")

            def do_POST(self):  # noqa: N802
                self._handle("POST")

            def do_DELETE(self):  # noqa: N802
                self._handle("DELETE")

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="shop-gateway", daemon=True
        )

    # -- lifecycle -----------------------------------------------------

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        # BaseServer.shutdown() blocks on an event only serve_forever
        # sets; calling it on a never-started server would wait forever.
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()

    # -- plumbing ------------------------------------------------------

    def _splice_h2(self, client_sock) -> None:
        """Bidirectional TCP splice: gRPC-over-h2c at the HTTP edge.

        The Envoy-route analogue of /flagservice/ (envoy.tmpl.yaml:50-51)
        — the whole connection is piped to the gRPC edge, so any
        flagd.evaluation.v1 / oteldemo call works against the single
        :8080 entry. No h2 frames are parsed here: prior-knowledge h2c
        means the preface identifies the protocol and the edge's job is
        transport, exactly what Envoy's TCP-proxying does for h2c
        upstreams. Runs on the handler's own thread (one per
        connection under ThreadingHTTPServer) plus one pump thread for
        the upstream→client direction.
        """
        import socket as _socket

        if self.grpc_target is None:
            client_sock.close()  # connection refused: route absent
            return
        try:
            upstream = _socket.create_connection(self.grpc_target, timeout=5)
        except OSError:
            client_sock.close()
            return
        upstream.settimeout(None)
        client_sock.settimeout(None)

        def pump(src, dst):
            try:
                while True:
                    data = src.recv(65536)
                    if not data:
                        break
                    dst.sendall(data)
            except OSError:
                pass
            finally:
                # Half-close so the peer's pump sees EOF and drains.
                try:
                    dst.shutdown(_socket.SHUT_WR)
                except OSError:
                    pass

        back = threading.Thread(
            target=pump, args=(upstream, client_sock),
            name="h2c-splice", daemon=True,
        )
        back.start()
        pump(client_sock, upstream)
        back.join(timeout=30)
        upstream.close()

    def _access_log(self, method, route, ctx, status, duration_us):
        """Edge span per request — Envoy's access-log/upstream span."""
        with self._lock:
            self.requests_served += 1
            self.shop.tracer.emit(
                "frontend-proxy",
                f"{method} {route}",
                ctx,
                duration_us,
                is_error=status >= 500,
            )

    def _pump_locked(self):
        """Advance the shop clock to wall elapsed; flush bus + spans."""
        self.shop.pump(time.monotonic() - self._t0, on_spans=self.on_spans)

    WEB_ROUTES = ("/", "/cart", "/cart/add", "/cart/checkout")

    def _route(self, method, route, query, body, ctx, req_ctype, cookies=None):
        """Dispatch one request; returns (status, content_type, bytes)
        or (status, content_type, bytes, extra_headers)."""
        if route == "/health":
            return 200, "application/json", b'{"status":"ok"}'

        if self.web_ui is not None and (
            route in self.WEB_ROUTES or route.startswith("/product/")
        ):
            # Server-rendered storefront (Next.js-page analogue).
            form = {}
            if body and "json" not in req_ctype:
                form = {k: v[0] for k, v in parse_qs(body.decode()).items()}
            with self._lock:
                self._pump_locked()
                return self.web_ui.handle(
                    method, route, query, form, cookies or {}, ctx
                )

        if route.startswith("/otlp-http/"):
            # Browser-telemetry seam. The decode is pure, but the fan-out
            # mutates the same Collector state and detector pipeline that
            # every other route touches under the lock — concurrent OTLP
            # POSTs (ThreadingHTTPServer) would otherwise race the
            # collector's flush-list swap and the pipeline's donated
            # device buffers.
            if "json" in req_ctype:
                records = otlp.decode_export_request_json(body)
            else:
                records = otlp.decode_export_request(body)
            if records:
                # Same fan-out as server-side spans: detector feed AND
                # the telemetry backend (trace store / spanmetrics).
                with self._lock:
                    if self.on_spans is not None:
                        self.on_spans(time.monotonic() - self._t0, records)
                    self.shop.collector.receive_spans(records)
            return 200, "application/json", b"{}"

        if route.startswith("/ofrep/v1/evaluate/flags/"):
            if method != "POST":  # OFREP evaluation is POST-only
                return 405, "application/json", b'{"error":"method not allowed"}'
            # OFREP surface: flagd serves OFREP over HTTP (:8016 in the
            # reference, consumed by the Python load generator via the
            # OpenFeature OFREP provider, locustfile.py:72-74). Shape
            # matches utils.flags.OfrepClient — client and server round
            # trip against each other.
            key = route.rsplit("/", 1)[1]
            doc = json.loads(body or b"{}")
            if not isinstance(doc, dict):
                raise ValueError("OFREP body must be a JSON object")
            context = doc.get("context") or {}
            if not isinstance(context, dict):
                raise ValueError("OFREP context must be a JSON object")
            targeting = context.get("targetingKey", "")
            flags = self.shop.flags
            # Sentinel default: a DISABLED or unresolvable flag must get
            # the FLAG_NOT_FOUND treatment so OFREP clients fall back to
            # their own defaults (returning 200 {"value": null} would
            # override the caller's default with None).
            missing = object()
            value = (
                flags.evaluate(key, missing, targeting)
                if key in flags.flag_keys()
                else missing
            )
            if value is missing:
                return 404, "application/json", json.dumps(
                    {"key": key, "errorCode": "FLAG_NOT_FOUND"}
                ).encode()
            return 200, "application/json", json.dumps(
                {"key": key, "value": value, "reason": "STATIC"}
            ).encode()

        if route == "/jaeger" or route.startswith("/jaeger/"):
            # Trace query surface (envoy.tmpl.yaml:44-45 analogue).
            # Pump first (exclusive, brief) so spans the client just
            # generated have had their batch-timeout chance to reach
            # the trace store; then query/render under the SHARED side
            # of the RW lock — observability polling must not serialize
            # the data plane, only exclude writers while reading
            # (same discipline as the gRPC edge's read-only RPCs).
            sub = route[len("/jaeger"):] or "/"
            with self._lock:
                self._pump_locked()
                self.shop.collector.force_flush(scrape=False)
            with self._lock.shared():
                return self.jaeger_ui.handle(method, sub, query)

        if route == "/grafana" or route.startswith("/grafana/"):
            # Dashboard surface (envoy.tmpl.yaml:46-47 analogue).
            sub = route[len("/grafana"):] or "/"
            # Only the routes that evaluate live panels need a fresh
            # TSDB sample; the dashboard list and static model JSON
            # never read the TSDB.
            live = sub.startswith(("/api/eval/", "/d/"))
            with self._lock:
                self._pump_locked()
                self.shop.collector.force_flush(scrape=live)
            with self._lock.shared():
                return self.grafana_ui.handle(method, sub, query)

        if route.startswith("/feature"):
            if self.feature_ui is None:
                return 503, "text/plain", b"flag UI not mounted"
            sub = route[len("/feature"):] or "/"
            return self.feature_ui.handle(method, sub, body)

        if route.startswith("/loadgen"):
            # The Locust web UI behind the edge (envoy.tmpl.yaml:46):
            # view/set users + spawn rate at runtime. Deliberately
            # OUTSIDE the shop lock — the control plane must answer
            # while the load it controls saturates the data plane.
            if self.loadgen_ui is None:
                return 503, "text/plain", b"loadgen UI not mounted"
            sub = route[len("/loadgen"):] or "/"
            return self.loadgen_ui.handle(method, sub, body)

        if route.startswith("/images/"):
            product_id = route[len("/images/"):].removesuffix(".svg")
            with self._lock:
                self._pump_locked()
                fe = self.shop.frontend
                fe.api_image(ctx, product_id)  # emits image-provider span
                slow = bool(fe.flag(FLAG_IMAGE_SLOW_LOAD, False, ctx))
            if slow:
                # The envoy fault filter delays the *real* response too;
                # the span already carries the full simulated 3-5s, so
                # cap the wall-clock stall at 1s — outside the shop lock,
                # other routes keep flowing (Envoy only stalls this one).
                time.sleep(1.0)
            return 200, "image/svg+xml", _product_image_svg(product_id)

        with self._lock:
            self._pump_locked()
            return self._route_shop(method, route, query, body, ctx)

    def _route_shop(self, method, route, query, body, ctx):
        fe = self.shop.frontend
        ok = 200, "application/json"

        if route == "/" or route == "/index":
            fe.index(ctx)
            return (*ok, b'{"page":"home"}')

        if route == "/metrics":
            return 200, "text/plain; version=0.0.4", self.shop.metrics.render().encode()

        if route == "/api/products" and method == "GET":
            return (*ok, json.dumps({"products": fe.api_products(ctx)}).encode())

        if route.startswith("/api/products/") and method == "GET":
            product_id = route[len("/api/products/"):]
            return (*ok, json.dumps(fe.api_product(ctx, product_id)).encode())

        if route == "/api/currency" and method == "GET":
            return (*ok, json.dumps({"currencyCodes": fe.api_currency(ctx)}).encode())

        if route == "/api/cart":
            user = query.get("sessionId") or ctx.baggage.get("session.id", "anon")
            if method == "GET":
                items = fe.api_cart_get(ctx, user)
                return (*ok, json.dumps({
                    "userId": user,
                    "items": [
                        {"productId": p, "quantity": q} for p, q in items.items()
                    ],
                }).encode())
            if method == "POST":
                doc = json.loads(body or b"{}")
                item = doc.get("item", {})
                fe.api_cart_add(
                    ctx,
                    doc.get("userId", user),
                    item.get("productId", ""),
                    int(item.get("quantity", 1)),
                )
                return (*ok, b'{"status":"ok"}')
            if method == "DELETE":
                fe.api_cart_empty(ctx, user)
                return (*ok, b'{"status":"ok"}')

        if route == "/api/recommendations" and method == "GET":
            exclude = [p for p in query.get("productIds", "").split(",") if p]
            recs = fe.api_recommendations(ctx, exclude)
            return (*ok, json.dumps({"productIds": recs}).encode())

        if route == "/api/data" and method == "GET":
            keys = [k for k in query.get("contextKeys", "").split(",") if k]
            ads = fe.api_ads(ctx, keys)
            return (*ok, json.dumps({"ads": ads}).encode())

        if route == "/api/shipping" and method == "GET":
            count = int(query.get("itemCount", 1))
            cost = fe.api_shipping(ctx, count, query.get("currencyCode", "USD"))
            return (*ok, json.dumps({"costUsd": _money_json(cost)}).encode())

        if route == "/api/checkout" and method == "POST":
            doc = json.loads(body or b"{}")
            user = doc.get("userId") or ctx.baggage.get("session.id", "anon")
            order = fe.api_checkout(
                ctx, user,
                doc.get("currencyCode", "USD"),
                doc.get("email", "someone@example.com"),
            )
            return (*ok, json.dumps(placed_order_json(order)).encode())

        return 404, "application/json", b'{"error":"no route"}'
