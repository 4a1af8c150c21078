"""Observability UI surfaces: Jaeger and Grafana served at the edge.

The reference exposes its observability backends THROUGH the front
proxy: Envoy routes ``/jaeger`` to the Jaeger all-in-one query UI and
``/grafana`` to Grafana
(the upstream demo's src/frontend-proxy/envoy.tmpl.yaml:39-54, the
``/jaeger`` and ``/grafana`` prefix routes at :44-47), so a person
watching the demo opens one port and can search traces or look at the
four provisioned dashboards
(the upstream demo's src/grafana/provisioning/dashboards/demo/
demo-dashboard.json and siblings). The in-proc data layers already
exist here (:class:`~.tracestore.TraceStore`,
:class:`~.tsdb.MetricTSDB`, :mod:`~.dashboards`); this module is the
*serving* tier over them:

- :class:`JaegerUI` — the Jaeger HTTP query API
  (``/api/services``, ``/api/services/<svc>/operations``,
  ``/api/traces`` search, ``/api/traces/<id>``) in Jaeger's response
  envelope (``{"data": [...]}``), plus server-rendered HTML: a search
  page and a per-trace waterfall view (inline SVG span bars).
- :class:`GrafanaUI` — dashboard listing (``/api/search``), the
  Grafana dashboard-model JSON (``/api/dashboards/uid/<uid>``), a
  machine-readable live evaluation (``/api/eval/<uid>``) and the
  server-rendered dashboard pages (``/d/<uid>``) where every panel is
  evaluated against the live TSDB/trace/log stores and drawn as a
  table + inline SVG bar chart.

Both classes follow the same ``handle(method, path, query)`` contract
as the other mounted UIs (flag editor, loadgen), returning
``(status, content_type, bytes)``; the gateway mounts them under
``/jaeger`` and ``/grafana`` and strips the prefix.

Rendering is server-side HTML on purpose: the capability being matched
is "a person can look at a trace / a dashboard through the edge", not
a JS bundle. Numbers shown are live — each page load re-evaluates the
panel queries at the current virtual-clock time.
"""

from __future__ import annotations

import json
from html import escape
from urllib.parse import quote

from .collector import Collector
from .dashboards import (
    Dashboard,
    evaluate_panel,
    provisioned_dashboards,
    to_grafana_json,
)
from .tracestore import Trace, TraceStore

_JSON = "application/json"
_HTML = "text/html; charset=utf-8"

_STYLE = """
body{font-family:monospace;background:#111;color:#ddd;margin:1.5em}
a{color:#7ab8ff} table{border-collapse:collapse;margin:.5em 0}
td,th{border:1px solid #444;padding:2px 8px;text-align:left}
th{background:#222} h1,h2{color:#fff} .err{color:#ff6b6b}
.bar{fill:#4a90d9} .barerr{fill:#d94a4a} svg{background:#1a1a1a}
.muted{color:#888}
"""


def _esc(text) -> str:
    # Service/operation names reach attribute context and are
    # client-controllable through the unauthenticated /otlp-http ingest;
    # html.escape covers quotes too.
    return escape(str(text))


def _page(title: str, body: str) -> bytes:
    return (
        f"<!doctype html><html><head><title>{_esc(title)}</title>"
        f"<style>{_STYLE}</style></head><body>{body}</body></html>"
    ).encode()


def _not_found(what: str) -> tuple[int, str, bytes]:
    return 404, _JSON, json.dumps({"error": f"{what} not found"}).encode()


# ---------------------------------------------------------------------------
# Jaeger
# ---------------------------------------------------------------------------


def _parse_duration_us(text: str) -> float:
    """Jaeger minDuration strings: '100ms', '1.5s', '250us' or bare µs."""
    text = text.strip().lower()
    for suffix, scale in (("us", 1.0), ("ms", 1e3), ("s", 1e6)):
        if text.endswith(suffix):
            return float(text[: -len(suffix)]) * scale
    return float(text)


def _trace_json(trace: Trace) -> dict:
    """One trace in the Jaeger HTTP API shape (data[i] of /api/traces)."""
    hex_id = trace.trace_id.hex()
    processes: dict[str, dict] = {}
    proc_ids: dict[str, str] = {}
    spans = []
    for i, stored in enumerate(trace.spans):
        r = stored.record
        pid = proc_ids.get(r.service)
        if pid is None:
            pid = f"p{len(proc_ids) + 1}"
            proc_ids[r.service] = pid
            processes[pid] = {"serviceName": r.service, "tags": []}
        tags = []
        if r.is_error:
            tags.append({"key": "error", "type": "bool", "value": True})
        if r.attr:
            tags.append({"key": "app.monitored_attr", "type": "string", "value": r.attr})
        # SpanRecords carry ingest time + duration, not a start
        # timestamp; render start = ingest - duration so waterfalls and
        # sort orders behave (ingest happens at span end in the shop).
        start_us = max(stored.ts * 1e6 - r.duration_us, 0.0)
        # Span events in Jaeger's shape: span.logs, each log a
        # timestamp + fields list whose first field is {key: "event"}
        # (exactly how Jaeger renders OTel span events).
        logs = [
            {
                "timestamp": int(start_us + ev.ts_offset_us),
                "fields": [
                    {"key": "event", "type": "string", "value": ev.name},
                    *(
                        {"key": k, "type": "string", "value": v}
                        for k, v in ev.attrs
                    ),
                ],
            }
            for ev in r.events
        ]
        spans.append({
            "traceID": hex_id,
            "spanID": f"{i:016x}",
            "operationName": r.name or "unknown",
            "startTime": int(start_us),
            "duration": int(r.duration_us),
            "processID": pid,
            "tags": tags,
            "logs": logs,
        })
    return {"traceID": hex_id, "spans": spans, "processes": processes}


class JaegerUI:
    """Jaeger query API + HTML search/trace views over a TraceStore."""

    def __init__(self, store: TraceStore):
        self.store = store

    # -- dispatch ------------------------------------------------------

    def handle(self, method: str, path: str, query: dict) -> tuple[int, str, bytes]:
        if method != "GET":
            return 405, _JSON, b'{"error":"method not allowed"}'
        if path in ("", "/", "/search"):
            return self._html_search(query)
        if path == "/api/services":
            names = self.store.services()
            return 200, _JSON, json.dumps(
                {"data": names, "total": len(names), "errors": None}
            ).encode()
        if path.startswith("/api/services/") and path.endswith("/operations"):
            service = path[len("/api/services/"):-len("/operations")]
            ops = self.store.operations(service)
            return 200, _JSON, json.dumps(
                {"data": ops, "total": len(ops), "errors": None}
            ).encode()
        if path == "/api/traces":
            traces = self._find(query)
            return 200, _JSON, json.dumps(
                {"data": [_trace_json(t) for t in traces], "errors": None}
            ).encode()
        if path.startswith("/api/traces/"):
            return self._api_trace(path[len("/api/traces/"):])
        if path.startswith("/trace/"):
            return self._html_trace(path[len("/trace/"):])
        return _not_found("route")

    def _find(self, query: dict) -> list[Trace]:
        min_duration = 0.0
        if query.get("minDuration"):
            min_duration = _parse_duration_us(query["minDuration"])
        return self.store.find_traces(
            service=query.get("service") or None,
            operation=query.get("operation") or None,
            min_duration_us=min_duration,
            error_only=query.get("error", "").lower() in ("1", "true"),
            limit=int(query.get("limit", 20)),
        )

    def _lookup(self, hex_id: str) -> Trace | None:
        try:
            trace_id = bytes.fromhex(hex_id)
        except ValueError:
            return None
        return self.store.get_trace(trace_id)

    def _api_trace(self, hex_id: str) -> tuple[int, str, bytes]:
        trace = self._lookup(hex_id)
        if trace is None:
            return _not_found("trace")
        return 200, _JSON, json.dumps(
            {"data": [_trace_json(trace)], "errors": None}
        ).encode()

    # -- HTML ----------------------------------------------------------

    def _html_search(self, query: dict) -> tuple[int, str, bytes]:
        services = self.store.services()
        traces = self._find(query)
        svc_links = " ".join(
            # quote() first (URL semantics: '+', '&', '#' in a service
            # name must not reshape the query), THEN html-escape.
            f'<a href="/jaeger/?service={_esc(quote(s))}">{_esc(s)}</a>'
            for s in services
        )
        rows = []
        for t in traces:
            hex_id = t.trace_id.hex()
            err = ' <span class="err">ERROR</span>' if t.has_error else ""
            rows.append(
                f'<tr><td><a href="/jaeger/trace/{hex_id}">{hex_id[:16]}…</a></td>'
                f"<td>{len(t.spans)}</td>"
                f"<td>{t.duration_us / 1e3:.2f} ms</td>"
                f"<td>{_esc(', '.join(sorted(t.services)))}{err}</td></tr>"
            )
        body = (
            f"<h1>Jaeger</h1><p>services: {svc_links or '<i>none yet</i>'}</p>"
            f"<p class='muted'>{len(self.store)} traces stored, "
            f"{self.store.evicted_traces} evicted</p>"
            f"<h2>traces{' — ' + _esc(query['service']) if query.get('service') else ''}</h2>"
            "<table><tr><th>trace</th><th>spans</th><th>duration</th>"
            "<th>services</th></tr>" + "".join(rows) + "</table>"
        )
        return 200, _HTML, _page("Jaeger", body)

    def _html_trace(self, hex_id: str) -> tuple[int, str, bytes]:
        trace = self._lookup(hex_id)
        if trace is None:
            return 404, _HTML, _page("Jaeger", "<h1>trace not found</h1>")
        doc = _trace_json(trace)
        spans = sorted(doc["spans"], key=lambda s: s["startTime"])
        t0 = spans[0]["startTime"] if spans else 0
        t1 = max((s["startTime"] + s["duration"] for s in spans), default=t0 + 1)
        span_total = max(t1 - t0, 1)
        width, row_h = 700, 18
        bars, rows = [], []
        for i, s in enumerate(spans):
            x = (s["startTime"] - t0) / span_total * width
            w = max(s["duration"] / span_total * width, 1.0)
            is_err = any(t["key"] == "error" for t in s["tags"])
            cls = "barerr" if is_err else "bar"
            svc = doc["processes"][s["processID"]]["serviceName"]
            bars.append(
                f'<rect class="{cls}" x="{x:.1f}" y="{i * row_h + 2}" '
                f'width="{w:.1f}" height="{row_h - 4}"/>'
                f'<text x="4" y="{i * row_h + row_h - 5}" fill="#aaa" '
                f'font-size="10">{_esc(svc)}: {_esc(s["operationName"])}</text>'
            )
            # Event ticks: one vertical marker per span event at its
            # timestamp (the Jaeger waterfall's log markers).
            for log in s.get("logs", []):
                ex = (log["timestamp"] - t0) / span_total * width
                bars.append(
                    f'<rect fill="#e8c547" x="{ex:.1f}" '
                    f'y="{i * row_h + 2}" width="2" height="{row_h - 4}"/>'
                )
            ev_names = ", ".join(
                f["value"]
                for log in s.get("logs", [])
                for f in log["fields"][:1]  # first field is the name
            )
            rows.append(
                f"<tr><td>{_esc(svc)}</td><td>{_esc(s['operationName'])}</td>"
                f"<td>{s['duration'] / 1e3:.3f} ms</td>"
                f"<td>{'<span class=err>error</span>' if is_err else 'ok'}</td>"
                f"<td class='muted'>{_esc(ev_names)}</td></tr>"
            )
        svg = (
            f'<svg width="{width}" height="{len(spans) * row_h + 4}">'
            + "".join(bars) + "</svg>"
        )
        body = (
            f'<h1>trace {hex_id[:16]}…</h1><p><a href="/jaeger/">← search</a> '
            f"| {len(spans)} spans | {trace.duration_us / 1e3:.2f} ms critical span</p>"
            + svg
            + "<table><tr><th>service</th><th>operation</th><th>duration</th>"
            "<th>status</th><th>events</th></tr>" + "".join(rows) + "</table>"
        )
        return 200, _HTML, _page(f"trace {hex_id[:8]}", body)


# ---------------------------------------------------------------------------
# Grafana
# ---------------------------------------------------------------------------


class GrafanaUI:
    """Dashboard listing/model/eval API + server-rendered dashboards."""

    def __init__(self, collector: Collector, boards: list[Dashboard] | None = None):
        self.collector = collector
        self.boards = boards if boards is not None else provisioned_dashboards()

    def _board(self, uid: str) -> Dashboard | None:
        for board in self.boards:
            if board.uid == uid:
                return board
        return None

    def handle(self, method: str, path: str, query: dict) -> tuple[int, str, bytes]:
        if method != "GET":
            return 405, _JSON, b'{"error":"method not allowed"}'
        if path in ("", "/"):
            return self._html_home()
        if path == "/api/search":
            return 200, _JSON, json.dumps([
                {"uid": b.uid, "title": b.title, "url": f"/grafana/d/{b.uid}"}
                for b in self.boards
            ]).encode()
        if path.startswith("/api/dashboards/uid/"):
            board = self._board(path[len("/api/dashboards/uid/"):])
            if board is None:
                return _not_found("dashboard")
            return 200, _JSON, json.dumps({
                "dashboard": to_grafana_json(board),
                "meta": {"provisioned": True, "slug": board.uid},
            }).encode()
        if path.startswith("/api/eval/"):
            board = self._board(path[len("/api/eval/"):])
            if board is None:
                return _not_found("dashboard")
            return 200, _JSON, json.dumps(self._eval(board)).encode()
        if path.startswith("/d/"):
            uid = path[len("/d/"):].split("/", 1)[0]
            board = self._board(uid)
            if board is None:
                return 404, _HTML, _page("Grafana", "<h1>dashboard not found</h1>")
            return self._html_board(board)
        return _not_found("route")

    def _eval(self, board: Dashboard) -> dict:
        """Evaluate every panel now; rows JSON-safe ([labels, value])."""
        at = self.collector.clock()
        panels = []
        for panel in board.panels:
            rows = evaluate_panel(panel, self.collector, at)
            panels.append({
                "title": panel.title,
                "unit": panel.unit,
                "rows": [[list(k), v] for k, v in rows],
            })
        return {"uid": board.uid, "title": board.title, "at": at, "panels": panels}

    # -- HTML ----------------------------------------------------------

    def _html_home(self) -> tuple[int, str, bytes]:
        items = "".join(
            f'<li><a href="/grafana/d/{b.uid}">{_esc(b.title)}</a> '
            f'<span class="muted">({len(b.panels)} panels, '
            f'<a href="/grafana/api/dashboards/uid/{b.uid}">json</a>)</span></li>'
            for b in self.boards
        )
        return 200, _HTML, _page(
            "Grafana", f"<h1>Grafana</h1><ul>{items}</ul>"
        )

    def _html_board(self, board: Dashboard) -> tuple[int, str, bytes]:
        at = self.collector.clock()
        sections = []
        for panel in board.panels:
            rows = evaluate_panel(panel, self.collector, at)
            sections.append(self._render_panel(panel.title, panel.unit, rows))
        body = (
            f"<h1>{_esc(board.title)}</h1>"
            f'<p><a href="/grafana/">← dashboards</a> '
            f'<span class="muted">evaluated at t={at:.1f}s</span></p>'
            + "".join(sections)
        )
        return 200, _HTML, _page(board.title, body)

    @staticmethod
    def _render_panel(title: str, unit: str, rows: list) -> str:
        head = f"<h2>{_esc(title)}" + (f" <span class='muted'>[{_esc(unit)}]</span>" if unit else "") + "</h2>"
        if not rows:
            return head + "<p class='muted'>(no data)</p>"
        numeric = [
            (k, v) for k, v in rows if isinstance(v, (int, float))
        ]
        parts = [head]
        if numeric:
            # Inline SVG horizontal bars, longest first — the panel chart.
            numeric.sort(key=lambda r: r[1], reverse=True)
            top = numeric[:12]
            vmax = max((v for _, v in top), default=1.0) or 1.0
            width, row_h = 640, 16
            bars = []
            for i, (key, value) in enumerate(top):
                label = "/".join(str(k) for k in key) if key else "total"
                w = max(value / vmax * (width - 260), 1.0)
                bars.append(
                    f'<rect class="bar" x="260" y="{i * row_h + 2}" '
                    f'width="{w:.1f}" height="{row_h - 4}"/>'
                    f'<text x="4" y="{i * row_h + row_h - 4}" fill="#aaa" '
                    f'font-size="10">{_esc(label[:40])}</text>'
                    f'<text x="{260 + w + 4:.1f}" y="{i * row_h + row_h - 4}" '
                    f'fill="#ddd" font-size="10">{value:,.3f}</text>'
                )
            parts.append(
                f'<svg width="{width}" height="{len(top) * row_h + 4}">'
                + "".join(bars) + "</svg>"
            )
        table_rows = "".join(
            "<tr><td>{}</td><td>{}</td></tr>".format(
                _esc("/".join(str(k) for k in key) if key else "total"),
                f"{value:,.3f}" if isinstance(value, (int, float)) else _esc(str(value)),
            )
            for key, value in rows[:20]
        )
        parts.append(f"<table><tr><th>series</th><th>value</th></tr>{table_rows}</table>")
        return "".join(parts)
