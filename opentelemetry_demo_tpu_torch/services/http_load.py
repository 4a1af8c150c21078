"""HTTP load generator: the Locust profile over real sockets.

Drives a :class:`~.gateway.ShopGateway` address with the reference's
Locust user model (the upstream demo's src/load-generator/locustfile.py:
107-220): N concurrent users, 1-10 s waits, the weighted task mix
(browse×10, recommendations×3, ads×3, view-cart×3, add-to-cart×2,
checkout×1, checkout-multi×1, flood-home×5 when enabled, index×1), and
``session.id`` + ``synthetic_request=true`` baggage attached per session
(:175-179) so payment/ad targeting sees the same keys.

The in-proc :class:`~.loadgen.LoadGenerator` is the deterministic
virtual-clock simulator for tests; this one exists to exercise the real
network edge (serialization, trace-header propagation, fault filters,
concurrent request interleaving) exactly as the reference's load
generator exercises Envoy.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
import uuid

import numpy as np

from .loadgen import TASK_WEIGHTS
from ..telemetry.tracer import TraceContext


class _UserPool:
    """Per-user threads with RUNTIME resize — the Locust web-UI contract
    (users / spawn rate editable while the swarm runs, the surface the
    reference exposes through Envoy at /loadgen, envoy.tmpl.yaml:46).

    Each user thread owns a stop event; ``set_users`` retires excess
    users (their event fires, they exit at the next wait) or spawns
    missing ones — immediately, or paced at ``spawn_rate`` users/s by a
    spawner thread (Locust's ramp). ``_user_loop(idx, stop_ev)`` is the
    subclass's task loop.
    """

    def _pool_init(self, thread_prefix: str) -> None:
        self._thread_prefix = thread_prefix
        self._pool_lock = threading.Lock()
        self._pool: list[tuple[threading.Thread, threading.Event]] = []
        self._next_user_idx = 0
        self._spawn_cancel = threading.Event()
        self._spawner: threading.Thread | None = None
        self._resume_users = 0  # stop() parks the target here for start()

    def _spawn_one_locked(self) -> None:
        ev = threading.Event()
        idx = self._next_user_idx
        self._next_user_idx += 1
        t = threading.Thread(
            target=self._user_loop, args=(idx, ev),
            name=f"{self._thread_prefix}-{idx}", daemon=True,
        )
        self._pool.append((t, ev))
        t.start()

    def running_users(self) -> int:
        with self._pool_lock:
            return sum(
                1 for t, ev in self._pool if t.is_alive() and not ev.is_set()
            )

    def set_users(self, n: int, spawn_rate: float = 0.0) -> None:
        """Resize the swarm to ``n`` users; growth paced at
        ``spawn_rate`` users/s when positive, immediate otherwise."""
        n = max(int(n), 0)
        # Cancel any in-flight ramp: the newest target wins.
        self._spawn_cancel.set()
        spawner = self._spawner
        if spawner is not None:
            spawner.join(timeout=5.0)
        self._spawn_cancel = threading.Event()
        with self._pool_lock:
            self._pool = [
                (t, ev) for t, ev in self._pool
                if t.is_alive() and not ev.is_set()
            ]
            current = len(self._pool)
            self.users = n
            if n <= current:
                for _t, ev in self._pool[n:]:
                    ev.set()
                self._pool = self._pool[:n]
                return
            missing = n - current
            if spawn_rate <= 0:
                for _ in range(missing):
                    self._spawn_one_locked()
                return
        cancel = self._spawn_cancel

        def ramp():
            for _ in range(missing):
                if cancel.wait(1.0 / spawn_rate):
                    return
                with self._pool_lock:
                    if cancel.is_set():
                        return
                    self._spawn_one_locked()

        self._spawner = threading.Thread(
            target=ramp, name=f"{self._thread_prefix}-spawner", daemon=True
        )
        self._spawner.start()

    def start(self) -> None:
        # Locust stop→start semantics: resume with the pre-stop target
        # (stop() zeroes the advertised target, parking it aside).
        self.set_users(self.users or self._resume_users)

    def stop(self, timeout_s: float = 15.0) -> None:
        self._spawn_cancel.set()
        spawner = self._spawner
        if spawner is not None:
            spawner.join(timeout=timeout_s)
        with self._pool_lock:
            pool = list(self._pool)
            self._pool = []
            # Status surfaces report this as the target — a stopped
            # pool with a stale nonzero target would read as "running".
            if self.users:
                self._resume_users = self.users
            self.users = 0
        for _t, ev in pool:
            ev.set()
        for t, _ev in pool:
            t.join(timeout=timeout_s)

    def run_for(self, seconds: float) -> None:
        self.start()
        time.sleep(seconds)
        self.stop()


class HttpLoadGenerator(_UserPool):
    """N user threads issuing the Locust task mix against a base URL."""

    def __init__(
        self,
        base_url: str,
        users: int = 5,
        wait_range_s: tuple[float, float] = (1.0, 10.0),
        seed: int = 0,
        flood_enabled: bool = False,
        timeout_s: float = 10.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.users = users
        self.wait_range_s = wait_range_s
        self.flood_enabled = flood_enabled
        self.timeout_s = timeout_s
        self._seed = seed
        self.requests_sent = 0
        self.errors = 0
        self._count_lock = threading.Lock()
        self._pool_init("http-loadgen")

    # -- plumbing ------------------------------------------------------

    def _headers(self, session_id: str) -> dict[str, str]:
        ctx = TraceContext.new({
            "session.id": session_id, "synthetic_request": "true",
        })
        return {**ctx.to_headers(), "Content-Type": "application/json"}

    def _request(self, method: str, path: str, session_id: str, body: dict | None = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base_url + path,
            data=data,
            headers=self._headers(session_id),
            method=method,
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                payload = resp.read()
            with self._count_lock:
                self.requests_sent += 1
            return json.loads(payload) if payload[:1] in (b"{", b"[") else None
        except Exception:
            with self._count_lock:
                self.requests_sent += 1
                self.errors += 1
            return None

    def _products(self, session_id: str) -> list[str]:
        doc = self._request("GET", "/api/products", session_id) or {}
        return [p["id"] for p in doc.get("products", [])]

    # -- the Locust tasks ----------------------------------------------

    def _run_task(self, rng: np.random.Generator, task: str, session_id: str, products: list[str]):
        pick = lambda: products[int(rng.integers(len(products)))]  # noqa: E731
        if task == "browse_product" and products:
            pid = pick()
            self._request("GET", f"/api/products/{pid}", session_id)
            self._request("GET", f"/images/{pid}.svg", session_id)
        elif task == "get_recommendations" and products:
            self._request("GET", f"/api/recommendations?productIds={pick()}", session_id)
        elif task == "get_ads":
            self._request("GET", "/api/data?contextKeys=telescopes", session_id)
        elif task == "view_cart":
            self._request("GET", f"/api/cart?sessionId={session_id}", session_id)
        elif task == "add_to_cart" and products:
            self._request("POST", "/api/cart", session_id, {
                "userId": session_id,
                "item": {"productId": pick(), "quantity": int(rng.integers(1, 4))},
            })
        elif task in ("checkout", "checkout_multi") and products:
            n = 1 if task == "checkout" else int(rng.integers(2, 5))
            for _ in range(n):
                self._request("POST", "/api/cart", session_id, {
                    "userId": session_id,
                    "item": {"productId": pick(), "quantity": 1},
                })
            self._request("POST", "/api/checkout", session_id, {
                "userId": session_id,
                "email": f"{session_id[:8]}@example.com",
                "currencyCode": "USD",
            })
        elif task == "flood_home":
            if self.flood_enabled:
                for _ in range(10):
                    self._request("GET", "/", session_id)
        else:  # index
            self._request("GET", "/", session_id)

    def _user_loop(self, user_idx: int, stop_ev: threading.Event):
        rng = np.random.default_rng(self._seed + user_idx)
        session_id = str(uuid.UUID(int=int(rng.integers(0, 2**63)) << 64))
        products = self._products(session_id)
        names = [n for n, _ in TASK_WEIGHTS]
        weights = np.array([w for _, w in TASK_WEIGHTS], dtype=np.float64)
        weights /= weights.sum()
        lo, hi = self.wait_range_s
        while not stop_ev.is_set():
            task = names[int(rng.choice(len(names), p=weights))]
            self._run_task(rng, task, session_id, products)
            stop_ev.wait(float(rng.uniform(lo, hi)))


def browser_traffic_enabled() -> bool:
    """The reference's gate, same env var (locustfile.py:180-181)."""
    import os

    return os.environ.get("LOCUST_BROWSER_TRAFFIC_ENABLED", "").lower() in (
        "true", "yes", "on",
    )


class BrowserLoadGenerator(_UserPool):
    """WebsiteBrowserUser analogue: drives the RENDERED storefront.

    The reference's browser users (locustfile.py:184-211, Playwright,
    gated by ``LOCUST_BROWSER_TRAFFIC_ENABLED``) differ from its HTTP
    users in three observable ways, all reproduced here without a real
    browser engine:

    - they load *pages* and then their referenced resources (images),
      carrying the session cookie a browser would;
    - they interact — change currency on the cart page, click a product,
      submit the add-to-cart form, follow the 303 redirect;
    - they emit *browser-side* spans (documentLoad + resource fetches,
      service ``frontend-web``) through the gateway's ``/otlp-http``
      seam, with ``synthetic_request=true`` baggage injected into every
      request (the add_baggage_header route hook).
    """

    SERVICE = "frontend-web"

    def __init__(
        self,
        base_url: str,
        users: int = 1,
        wait_range_s: tuple[float, float] = (1.0, 3.0),
        seed: int = 0,
        timeout_s: float = 10.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.users = users
        self.wait_range_s = wait_range_s
        self.timeout_s = timeout_s
        self._seed = seed
        self._count_lock = threading.Lock()
        self.pages_loaded = 0
        self.images_loaded = 0
        self.spans_exported = 0
        self.errors = 0
        self._pool_init("browser-loadgen")

    # -- a minimal browser ---------------------------------------------

    def _fetch(self, path: str, cookies: dict[str, str],
               form: dict[str, str] | None = None) -> tuple[int, str, float]:
        """One navigation: returns (status, html, duration_s); follows
        one 303 (the add-to-cart redirect) like a browser would."""
        headers = {
            "baggage": "synthetic_request=true",
            "Cookie": "; ".join(f"{k}={v}" for k, v in cookies.items()),
        }
        data = None
        if form is not None:
            from urllib.parse import urlencode

            data = urlencode(form).encode()
            headers["Content-Type"] = "application/x-www-form-urlencoded"
        req = urllib.request.Request(
            self.base_url + path, data=data, headers=headers,
            method="POST" if form is not None else "GET",
        )
        t0 = time.time()
        try:
            # A browser follows the 303 itself; urllib turns the POST
            # into a GET on redirect, which is exactly the behavior.
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                for header, value in resp.headers.items():
                    if header.lower() == "set-cookie":
                        name, _, rest = value.partition("=")
                        cookies[name.strip()] = rest.split(";", 1)[0]
                html = resp.read().decode("utf-8", "replace")
                return resp.status, html, time.time() - t0
        except Exception:
            with self._count_lock:
                self.errors += 1
            return 0, "", time.time() - t0

    def _load_page(self, path: str, cookies: dict[str, str],
                   form: dict[str, str] | None = None) -> str:
        """Navigate, then fetch every referenced image; export the
        documentLoad + resource spans the browser SDK would."""
        import re

        t_start = time.time()
        status, html, dur = self._fetch(path, cookies, form)
        spans = [("documentLoad " + path, t_start, dur, status == 0)]
        for src in re.findall(r'src="(/images/[^"]+)"', html):
            t_img = time.time()
            img_status, _, img_dur = self._fetch(src, cookies)
            spans.append(("resourceFetch " + src, t_img, img_dur, img_status == 0))
            with self._count_lock:
                self.images_loaded += 1
        with self._count_lock:
            self.pages_loaded += 1
        self._export_spans(spans, cookies)
        return html

    def _export_spans(self, spans, cookies: dict[str, str]) -> None:
        """Browser-side OTLP/JSON export through the /otlp-http seam."""
        session = cookies.get("shop_session", "")
        doc = {
            "resourceSpans": [{
                "resource": {"attributes": [
                    {"key": "service.name",
                     "value": {"stringValue": self.SERVICE}},
                ]},
                "scopeSpans": [{"spans": [
                    {
                        "traceId": uuid.uuid4().hex,
                        "name": name,
                        "startTimeUnixNano": str(int(t0 * 1e9)),
                        "endTimeUnixNano": str(int((t0 + dur) * 1e9)),
                        "status": {"code": 2 if failed else 0},
                        "attributes": [
                            {"key": "session.id",
                             "value": {"stringValue": session}},
                        ],
                    }
                    for name, t0, dur, failed in spans
                ]}],
            }]
        }
        req = urllib.request.Request(
            self.base_url + "/otlp-http/v1/traces",
            data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
            with self._count_lock:
                self.spans_exported += len(spans)
        except Exception:
            with self._count_lock:
                self.errors += 1

    # -- the two reference browser tasks --------------------------------

    def open_cart_page_and_change_currency(self, cookies) -> None:
        self._load_page("/cart", cookies)
        self._load_page("/cart?currency=CHF", cookies)

    def add_product_to_cart(self, rng, cookies) -> None:
        import re

        html = self._load_page("/", cookies)
        links = re.findall(r'href="/product/([^"]+)"', html)
        if not links:
            return
        pid = links[int(rng.integers(len(links)))]
        self._load_page(f"/product/{pid}", cookies)
        # Submitting the add-to-cart form 303s to /cart; _fetch follows.
        self._load_page("/cart/add", cookies,
                        form={"productId": pid, "quantity": "1"})

    def _user_loop(self, user_idx: int, stop_ev: threading.Event) -> None:
        rng = np.random.default_rng(self._seed + 1000 + user_idx)
        cookies: dict[str, str] = {}
        lo, hi = self.wait_range_s
        while not stop_ev.is_set():
            if int(rng.integers(2)):
                self.add_product_to_cart(rng, cookies)
            else:
                self.open_cart_page_and_change_currency(cookies)
            stop_ev.wait(float(rng.uniform(lo, hi)))
