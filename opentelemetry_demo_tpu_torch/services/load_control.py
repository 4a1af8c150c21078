"""Loadgen control surface: the Locust web UI behind the edge.

The reference routes ``/loadgen`` through Envoy to Locust's web UI
(the upstream demo's src/frontend-proxy/envoy.tmpl.yaml:46), where an
operator watches request counters and changes user count / spawn rate
at runtime (autostart defaults from ``.env:97-101``). This module is
that surface for the framework's load tiers: a JSON API + minimal HTML
page the gateway mounts at ``/loadgen``, controlling the HTTP-user tier
and the browser tier (``services.http_load``) live.

API (all JSON):
  GET  /loadgen/api/status           counters + current swarm state
  POST /loadgen/api/start            {"users": N, "spawnRate": R,
                                      "browserUsers": M}
  POST /loadgen/api/users            same body — runtime resize
  POST /loadgen/api/stop             retire every user
"""

from __future__ import annotations

import json
import threading

from .http_load import BrowserLoadGenerator, HttpLoadGenerator


class LoadControl:
    """Owns the load tiers for one target URL; thread-safe."""

    def __init__(self, target_url: str, seed: int = 0):
        self.target_url = target_url
        self.seed = seed
        self.http: HttpLoadGenerator | None = None
        self.browser: BrowserLoadGenerator | None = None
        self._lock = threading.Lock()

    # -- control -------------------------------------------------------

    def set_users(self, users: int, spawn_rate: float = 0.0,
                  browser_users: int | None = None) -> dict:
        with self._lock:
            if self.http is None:
                self.http = HttpLoadGenerator(
                    self.target_url, users=0, seed=self.seed
                )
            self.http.set_users(users, spawn_rate)
            if browser_users is not None:
                if self.browser is None:
                    self.browser = BrowserLoadGenerator(
                        self.target_url, users=0, seed=self.seed
                    )
                self.browser.set_users(browser_users, spawn_rate)
        return self.status()

    def stop(self) -> dict:
        with self._lock:
            for tier in (self.http, self.browser):
                if tier is not None:
                    tier.stop(timeout_s=0.0)  # signal; threads drain async
        return self.status()

    def status(self) -> dict:
        http, browser = self.http, self.browser
        return {
            "target": self.target_url,
            "httpUsers": http.running_users() if http else 0,
            "httpUsersTarget": http.users if http else 0,
            "requestsSent": http.requests_sent if http else 0,
            "requestErrors": http.errors if http else 0,
            "browserUsers": browser.running_users() if browser else 0,
            "pagesLoaded": browser.pages_loaded if browser else 0,
            "browserSpansExported": browser.spans_exported if browser else 0,
        }

    # -- HTTP surface (mounted by the gateway at /loadgen) --------------

    def handle(self, method: str, sub: str, body: bytes):
        """(status, content_type, payload) for a /loadgen request."""
        if sub in ("/", "") and method == "GET":
            return 200, "text/html; charset=utf-8", self._page().encode()
        if sub == "/api/status" and method == "GET":
            return 200, "application/json", json.dumps(self.status()).encode()
        if method == "POST" and sub in ("/api/start", "/api/users"):
            try:
                doc = json.loads(body or b"{}")
                if not isinstance(doc, dict):
                    raise TypeError("body must be a JSON object")
                users = int(doc.get("users", 0))
                spawn_rate = float(doc.get("spawnRate", 0.0))
                browser = doc.get("browserUsers")
                browser_users = None if browser is None else int(browser)
            except (ValueError, TypeError) as e:
                return 400, "application/json", json.dumps(
                    {"error": f"bad request: {e}"}
                ).encode()
            out = self.set_users(users, spawn_rate, browser_users)
            return 200, "application/json", json.dumps(out).encode()
        if method == "POST" and sub == "/api/stop":
            return 200, "application/json", json.dumps(self.stop()).encode()
        return 404, "application/json", b'{"error":"no such loadgen route"}'

    def _page(self) -> str:
        s = self.status()
        return f"""<!doctype html><html><head><title>Load generator</title>
<style>body{{font-family:monospace;margin:2rem}}input{{width:5rem}}</style>
</head><body>
<h1>Load generator</h1>
<p>target: {s['target']}</p>
<table border=1 cellpadding=6>
<tr><th>tier</th><th>running</th><th>counters</th></tr>
<tr><td>http users</td><td>{s['httpUsers']} / {s['httpUsersTarget']}</td>
<td>{s['requestsSent']} requests, {s['requestErrors']} errors</td></tr>
<tr><td>browser users</td><td>{s['browserUsers']}</td>
<td>{s['pagesLoaded']} pages, {s['browserSpansExported']} spans</td></tr>
</table>
<form onsubmit="event.preventDefault();
fetch('/loadgen/api/users',{{method:'POST',
body:JSON.stringify({{users:+u.value,spawnRate:+r.value,
browserUsers:+b.value}})}}).then(()=>location.reload())">
<p>users <input id=u value={s['httpUsersTarget']}>
spawn/s <input id=r value=1>
browser <input id=b value={s['browserUsers']}>
<button>apply</button>
<button type=button onclick="fetch('/loadgen/api/stop',
{{method:'POST'}}).then(()=>location.reload())">stop all</button></p>
</form></body></html>"""
