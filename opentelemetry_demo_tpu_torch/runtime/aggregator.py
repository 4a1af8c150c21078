"""Scatter-gather read tier over the sharded detector fleet.

The thin aggregator behind the EXISTING ``/query/*`` API: global reads
fan out to every shard's query plane (runtime.query over each shard's
own snapshot), the shard frames merge per endpoint, and the answer
comes back in one envelope labeled with
``shards_answered``/``shards_total`` — a blackholed, slow or dead
shard is ANNOTATED and the result degrades to a labeled PARTIAL
answer, never a crashed query and never a 5xx for a partial loss.

Merge semantics per endpoint:

- ``/query/services`` — union of the shard service lists (sorted);
- ``/query/topk`` / ``/query/cardinality`` / ``/query/zscore`` —
  service-keyed: the ring routes the read to the keyspace OWNER when a
  ring is wired (post-reshard that is the survivor that adopted the
  victim's frame); without a ring the fan-out keeps the shard that
  actually answered 200 (non-owners answer 404 for a service they
  never interned);
- ``/query/anomalies`` — events concatenated newest-first across
  shards, exemplar rings merged by service.

CONTRACT (the runtime.query discipline): this module NEVER touches
detector state — no detector
import, no dispatch-lock reference, no snapshot function. It speaks
only HTTP to shard query planes, so it can run anywhere (its own
container: the ``anomaly-aggregator`` compose/k8s service) and the
loss of any shard can never take the global read surface down with
it.

The standalone entry point, :func:`main` (the compose/k8s
``anomaly-aggregator`` service), reads ``FLEET_KNOBS`` through
``utils.config.fleet_config``:

    python -m opentelemetry_demo_tpu_torch.runtime.aggregator
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import NamedTuple
from urllib.parse import parse_qs, urlencode, urlparse

from ..telemetry import metrics as tele_metrics
from .fleet import HashRing, tenant_of

# The endpoints the aggregator understands (a strict subset of the
# shard query plane's vocabulary — the flight target stays a
# per-shard surface: a flight ring is process-local evidence).
AGG_ENDPOINTS = frozenset({
    "/", "/query/services", "/query/topk", "/query/cardinality",
    "/query/zscore", "/query/anomalies",
})

SERVICE_KEYED = frozenset({
    "/query/topk", "/query/cardinality", "/query/zscore",
})

# Grafana simple-JSON datasource surface (the same contract the shard
# query plane serves per-shard): dashboards point at the FLEET —
# service-keyed targets route to the keyspace owner, table targets
# merge across shards.
GRAFANA_ENDPOINTS = frozenset({"/search", "/query", "/annotations"})

# Query bodies are small Grafana target lists, never megabytes (the
# shard plane's 413 discipline, mirrored).
MAX_BODY_BYTES = 1 << 20

LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)


class ShardAnswer(NamedTuple):
    shard: str
    status: int | None     # None = transport failure/timeout
    doc: dict | list | None  # Grafana endpoints answer bare lists
    error: str | None
    elapsed_s: float


def _fetch(
    shard: str, base: str, path: str, params: dict, timeout_s: float,
    body: dict | None = None,
) -> ShardAnswer:
    """One shard GET (or POST when ``body`` rides along — the Grafana
    fan-out) with a hard per-shard deadline. Every failure shape
    (refused, blackholed, RST mid-body, torn JSON) collapses to an
    annotated miss — the fan-out's promise is that no shard fault
    becomes an aggregator fault."""
    import http.client

    host, _, port = base.rpartition(":")
    t0 = time.perf_counter()
    try:
        conn = http.client.HTTPConnection(
            host or "127.0.0.1", int(port), timeout=timeout_s
        )
        try:
            query = urlencode(
                {k: v for k, v in params.items() if v is not None}
            )
            target = path + ("?" + query if query else "")
            if body is not None:
                conn.request(
                    "POST", target, body=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"},
                )
            else:
                conn.request("GET", target)
            resp = conn.getresponse()
            raw = resp.read()
            doc = json.loads(raw.decode()) if raw else {}
            return ShardAnswer(
                shard, resp.status, doc, None,
                time.perf_counter() - t0,
            )
        finally:
            conn.close()
    except Exception as e:  # noqa: BLE001 — every transport/parse
        # failure is one annotated missing shard, never a crash
        return ShardAnswer(
            shard, None, None,
            f"{type(e).__name__}: {e}", time.perf_counter() - t0,
        )


class FleetAggregator:
    """Fans one query out to the shard query planes and merges.

    ``shards``: shard-id → query-plane base address (host:port).
    ``ring``/``tenant_map``: optional ownership routing for
    service-keyed endpoints (ring members must use the same shard
    ids). ``live_fn``: optional membership filter — shards it reports
    dead are skipped (annotated, not waited on).
    """

    def __init__(
        self,
        shards: dict[str, str],
        *,
        timeout_s: float = 1.0,
        ring: HashRing | None = None,
        tenant_map: dict[str, str] | None = None,
        live_fn=None,
        health_addrs: dict[str, str] | None = None,
    ):
        self.shards = dict(shards)
        self.timeout_s = float(timeout_s)
        self.ring = ring
        self.tenant_map = dict(tenant_map or {})
        self._live_fn = live_fn
        # Ring-staleness repair (``health_addrs``: shard-id → /healthz
        # address, the heartbeat list): a standalone aggregator pins a
        # boot-time ring, so after an adoption/resize it would route
        # service-keyed reads to a shard that no longer owns the key —
        # forever. When the owner misses, placement refreshes from the
        # shard /healthz fleet blocks (which publish members + the
        # adopted map — enough to rebuild the IDENTICAL ring) and the
        # read retries once against the new owner. The embedded
        # aggregator shares the live membership ring and passes None.
        self._health_addrs = dict(health_addrs or {})
        self._ring_refresh_t = 0.0
        self._ring_refreshes = 0

    def close(self) -> None:
        pass  # fan-out threads are per-request daemons; nothing held

    # -- fan-out --------------------------------------------------------

    def _targets(self) -> dict[str, str]:
        if self._live_fn is None:
            return dict(self.shards)
        try:
            live = set(self._live_fn())
        except Exception:  # noqa: BLE001 — a broken membership view
            return dict(self.shards)  # degrades to full fan-out
        return {s: a for s, a in self.shards.items() if s in live}

    def _scatter(
        self, path: str, params: dict,
        skip: frozenset[str] = frozenset(),
        body: dict | None = None,
    ) -> list[ShardAnswer]:
        """Fan out with a HARD wall-clock deadline.

        http.client's timeout bounds each socket operation, not the
        exchange: a shard trickling one byte per interval would keep
        every recv() under the limit and hang the query unboundedly.
        Dedicated daemon threads per request + a bounded join make the
        deadline real — a shard still mid-trickle at the deadline is
        annotated and abandoned (its thread dies with its next socket
        timeout), and no shared pool exists for a slow shard to clog."""
        targets = {
            s: a for s, a in self._targets().items() if s not in skip
        }
        results: dict[str, ShardAnswer] = {}

        def run(shard: str, base: str) -> None:
            results[shard] = _fetch(
                shard, base, path, params, self.timeout_s, body=body
            )

        threads = [
            threading.Thread(
                target=run, args=(shard, base),
                name=f"agg-fanout-{shard}", daemon=True,
            )
            for shard, base in targets.items()
        ]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 2.0 * self.timeout_s + 0.25
        for th in threads:
            th.join(max(deadline - time.monotonic(), 0.0))
        answers = []
        for shard in targets:
            got = results.get(shard)
            answers.append(got if got is not None else ShardAnswer(
                shard, None, None, "deadline exceeded", self.timeout_s,
            ))
        answers += [
            ShardAnswer(s, None, None, "membership: dead", 0.0)
            for s in self.shards
            if s not in targets and s not in skip
        ]
        return answers

    def _fetch_bounded(
        self, shard: str, base: str, path: str, params: dict,
        body: dict | None = None,
    ) -> ShardAnswer:
        """One shard fetch under the same hard deadline as _scatter —
        the owner-routed path must not be the one place a trickling
        shard can hang a query."""
        box: dict[str, ShardAnswer] = {}

        def run() -> None:
            box[shard] = _fetch(
                shard, base, path, params, self.timeout_s, body=body
            )

        th = threading.Thread(
            target=run, name=f"agg-fanout-{shard}", daemon=True
        )
        th.start()
        th.join(2.0 * self.timeout_s + 0.25)
        return box.get(shard) or ShardAnswer(
            shard, None, None, "deadline exceeded", self.timeout_s
        )

    # -- ring refresh ----------------------------------------------------

    def _refresh_ring(self) -> bool:
        """Rebuild placement from the shard /healthz fleet blocks;
        True when the ring actually CHANGED (the retry-once trigger).

        The fleet block publishes members + the adopted map, so the
        rebuilt ring is bit-identical to the shards' own (the
        zero-coordination property adoption relies on). Throttled: an
        owner-miss storm must not turn into a healthz-poll storm."""
        if self.ring is None or not self._health_addrs:
            return False
        now = time.monotonic()
        if now - self._ring_refresh_t < 0.5:
            return False
        self._ring_refresh_t = now
        current = self.ring.version()
        results: dict[str, ShardAnswer] = {}

        def run(shard: str, base: str) -> None:
            results[shard] = _fetch(
                shard, base, "/healthz", {}, self.timeout_s
            )

        threads = [
            threading.Thread(
                target=run, args=(s, a), name=f"agg-healthz-{s}",
                daemon=True,
            )
            for s, a in self._health_addrs.items()
        ]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 2.0 * self.timeout_s + 0.25
        for th in threads:
            th.join(max(deadline - time.monotonic(), 0.0))
        # Prefer the HIGHEST reshard count on a mismatching version:
        # mid-resize the laggard shards still publish the old ring,
        # and adopting a stale view would "refresh" into yesterday.
        best: dict | None = None
        for a in results.values():
            if a.status != 200 or not isinstance(a.doc, dict):
                continue
            fb = a.doc.get("fleet")
            if not isinstance(fb, dict) or not fb.get("members"):
                continue
            if fb.get("ring_version") == current:
                continue
            if (
                best is None
                or fb.get("reshards_total", 0)
                > best.get("reshards_total", 0)
            ):
                best = fb
        if best is None:
            return False
        self.ring = HashRing(
            [str(m) for m in best["members"]],
            vnodes=int(best.get("owned_vnodes") or self.ring.vnodes),
            adopted={
                str(v): str(h)
                for v, h in (best.get("adopted") or {}).items()
            },
        )
        self._ring_refreshes += 1
        return True

    # -- merge ----------------------------------------------------------

    def _fleet_meta(self, answers: list[ShardAnswer]) -> dict:
        ok = [a for a in answers if a.status == 200]
        per_shard = {}
        for a in sorted(answers):
            entry: dict = {"ok": a.status == 200}
            if a.status is not None:
                entry["status"] = a.status
            if a.error:
                entry["error"] = a.error
            if a.doc and isinstance(a.doc.get("meta"), dict):
                m = a.doc["meta"]
                for k in ("role", "epoch", "seq", "staleness_s"):
                    if k in m:
                        entry[k] = m[k]
            per_shard[a.shard] = entry
        meta = {
            "shards_total": len(self.shards),
            "shards_answered": len(ok),
            "partial": len(ok) < len(self.shards),
            "shards": per_shard,
        }
        if self.ring is not None:
            meta["ring_version"] = self.ring.version()
        return meta

    def dispatch(
        self, path: str, params: dict, body: dict | None = None,
    ) -> tuple[int, dict | list]:
        """Route + merge one fleet query; (status, document). Never
        raises; a partial fleet answers 200 with ``partial: true``.
        Grafana endpoints take the POST ``body`` and answer the bare
        lists the simple-JSON contract wants."""
        try:
            if path == "/":
                return 200, {
                    "status": "ok",
                    "tier": "aggregator",
                    "endpoints": sorted(
                        (AGG_ENDPOINTS | GRAFANA_ENDPOINTS) - {"/"}
                    ),
                    "shards": sorted(self.shards),
                }
            if path in GRAFANA_ENDPOINTS:
                return self._grafana(path, body or {})
            if path not in AGG_ENDPOINTS:
                return 404, {"error": f"no such endpoint {path!r}"}
            if path in SERVICE_KEYED:
                return self._service_keyed(path, params)
            answers = self._scatter(path, params)
            meta = self._fleet_meta(answers)
            ok = [a for a in answers if a.status == 200]
            if path == "/query/services":
                names: set = set()
                for a in ok:
                    names.update(
                        (a.doc.get("data") or {}).get("services") or []
                    )
                data = {"services": sorted(names)}
            else:  # /query/anomalies
                events: list = []
                rings: dict = {}
                for a in ok:
                    d = a.doc.get("data") or {}
                    events.extend(d.get("events") or [])
                    for svc, ring in (d.get("exemplars") or {}).items():
                        merged = rings.setdefault(svc, [])
                        for tid in ring:
                            if tid not in merged:
                                merged.append(tid)
                events.sort(key=lambda e: -(e.get("t") or 0.0))
                limit = _int_param(params, "limit", 20)
                data = {"events": events[:limit], "exemplars": rings}
            if not ok:
                # TOTAL loss is the one honest 503 (nothing answered);
                # any partial answer stays 200 + labeled.
                return 503, {
                    "error": "no shard answered", "meta": meta,
                }
            return 200, {"data": data, "meta": meta}
        except Exception:  # noqa: BLE001 — an aggregator bug must
            # answer 500 like the shard plane's dispatch() does,
            # never tear down the keep-alive thread
            return 500, {"error": "internal aggregator error"}

    def _service_keyed(self, path: str, params: dict) -> tuple[int, dict]:
        service = params.get("service")
        if not service:
            return 400, {"error": "service parameter required"}
        owner = None
        tenant = None
        if self.ring is not None:
            tenant = params.get("tenant") or tenant_of(
                service, self.tenant_map
            )
            try:
                owner = self.ring.owner_of(service, tenant)
            except RuntimeError:
                owner = None
        refreshed = False
        tried: set[str] = set()
        misses: list[ShardAnswer] = []
        if owner is not None and owner in self.shards:
            # Owner-routed: one shard holds this keyspace cell (after
            # a reshard, that is the survivor that adopted the
            # victim's frame). Fall through to fan-out if the owner
            # itself cannot answer — partial beats crashed.
            owner_answer = self._fetch_bounded(
                owner, self.shards[owner], path, params
            )
            tried.add(owner)
            if owner_answer.status == 200:
                meta = self._fleet_meta([owner_answer])
                meta["shards_total"] = len(self.shards)
                meta["partial"] = False
                meta["owner"] = owner
                return 200, {
                    "data": (owner_answer.doc or {}).get("data"),
                    "meta": meta,
                }
            misses.append(owner_answer)
            # The boot-time-ring staleness repair: an owner miss right
            # after an adoption/resize usually means OUR placement is
            # old, not that the key is gone. Refresh the ring from the
            # shard /healthz fleet blocks and retry ONCE against the
            # new owner — then (and only then) pay the full fan-out.
            if self._refresh_ring():
                refreshed = True
                try:
                    new_owner = self.ring.owner_of(service, tenant)
                except RuntimeError:
                    new_owner = None
                if (
                    new_owner is not None
                    and new_owner != owner
                    and new_owner in self.shards
                ):
                    retry = self._fetch_bounded(
                        new_owner, self.shards[new_owner], path, params
                    )
                    tried.add(new_owner)
                    if retry.status == 200:
                        meta = self._fleet_meta([retry])
                        meta["shards_total"] = len(self.shards)
                        meta["partial"] = False
                        meta["owner"] = new_owner
                        meta["ring_refreshed"] = True
                        return 200, {
                            "data": (retry.doc or {}).get("data"),
                            "meta": meta,
                        }
                    misses.append(retry)
                    owner = new_owner
        # Fallback fan-out: the tried owners already spent their
        # deadlines — carry their answers over instead of paying a
        # dead shard's timeout a second time.
        answers = self._scatter(path, params, skip=frozenset(tried))
        answers += misses
        meta = self._fleet_meta(answers)
        if owner is not None:
            meta["owner"] = owner
        if refreshed:
            meta["ring_refreshed"] = True
        ok = [a for a in answers if a.status == 200]
        if ok:
            # Deterministic pick: lowest shard id that answered (two
            # shards both answering a service happens transiently
            # right after a reshard merge — both hold the cell).
            best = sorted(ok)[0]
            return 200, {
                "data": (best.doc or {}).get("data"), "meta": meta,
            }
        not_found = [a for a in answers if a.status == 404]
        if len(not_found) == len(answers) and answers:
            return 404, {
                "error": f"unknown service {service!r}", "meta": meta,
            }
        # The owner (and everyone else) is unreachable/erroring: the
        # keyspace slice is browned out — a labeled partial answer
        # with no data, NOT a 5xx (the fleet contract: losing a shard
        # browns out its slice, it never crashes the read surface).
        return 200, {"data": None, "meta": meta}

    # -- Grafana simple-JSON (fleet-global datasource) -------------------

    def _grafana(self, path: str, body: dict) -> tuple[int, dict | list]:
        """Fleet-global Grafana surface: dashboards point at the
        FLEET, not a shard (the per-shard plane keeps serving its own
        copy — this tier merges). ``flight`` targets are deliberately
        absent: a flight ring is process-local evidence, and a merged
        one would interleave unrelated incident timelines."""
        if path == "/search":
            answers = self._scatter("/search", {}, body=body)
            targets: set = set()
            for a in answers:
                if a.status == 200 and isinstance(a.doc, list):
                    targets.update(
                        t for t in a.doc
                        if isinstance(t, str) and t != "flight"
                    )
            if not targets and not any(
                a.status == 200 for a in answers
            ):
                return 503, {"error": "no shard answered"}
            return 200, sorted(targets)
        if path == "/annotations":
            answers = self._scatter("/annotations", {}, body=body)
            merged: list = []
            answered = False
            for a in answers:
                if a.status == 200 and isinstance(a.doc, list):
                    answered = True
                    merged.extend(
                        e for e in a.doc if isinstance(e, dict)
                    )
            if not answered:
                return 503, {"error": "no shard answered"}
            merged.sort(key=lambda e: -(e.get("time") or 0.0))
            return 200, merged
        # /query: each target routes INDEPENDENTLY (a multi-target
        # body fanned out whole would 400 on every shard that never
        # interned one of the services), service-keyed targets to the
        # ring owner, table targets merged across the fleet.
        out: list = []
        for tgt in body.get("targets") or []:
            if not isinstance(tgt, dict):
                continue
            target = (tgt.get("target") or "").strip()
            single = {
                k: v for k, v in body.items() if k != "targets"
            }
            single["targets"] = [tgt]
            out.append(self._grafana_target(target, single))
        return 200, [f for f in out if f is not None]

    def _grafana_target(self, target: str, single: dict):
        """One target's merged frame (None = nobody answered — the
        frame is dropped, Grafana's convention for an empty result)."""
        kind, _, svc = target.partition(":")
        if svc and self.ring is not None:
            # Service-keyed series: the keyspace owner answers (post-
            # adoption, the heir). Owner miss → one refresh + retry,
            # then lowest-shard fan-out — the /query/* routing rules.
            tenant = tenant_of(svc, self.tenant_map)
            for attempt in range(2):
                try:
                    owner = self.ring.owner_of(svc, tenant)
                except RuntimeError:
                    break
                if owner not in self.shards:
                    break
                a = self._fetch_bounded(
                    owner, self.shards[owner], "/query", {}, body=single
                )
                if (
                    a.status == 200 and isinstance(a.doc, list)
                    and a.doc
                ):
                    return a.doc[0]
                if attempt == 0 and not self._refresh_ring():
                    break
        answers = self._scatter("/query", {}, body=single)
        frames = [
            a.doc[0] for a in sorted(answers)
            if a.status == 200 and isinstance(a.doc, list) and a.doc
            and isinstance(a.doc[0], dict)
        ]
        if not frames:
            return None
        if kind == "anomalies":
            # Table target: rows merge across shards (each shard flags
            # its own keyspace), newest first, columns from the first.
            rows: list = []
            for f in frames:
                rows.extend(f.get("rows") or [])
            rows.sort(key=lambda r: -(r[0] if r else 0.0))
            return {
                "type": "table",
                "columns": frames[0].get("columns") or [],
                "rows": rows,
            }
        # Timeseries (or a service-keyed target with no ring): first
        # shard with data wins — transiently-duplicated cells right
        # after an adoption pick deterministically, like /query/*.
        for f in frames:
            if f.get("datapoints") or f.get("rows"):
                return f
        return frames[0]


def _int_param(params: dict, key: str, default: int) -> int:
    try:
        return int(params.get(key, default))
    except (TypeError, ValueError):
        return default


# -- HTTP surface -------------------------------------------------------


class AggregatorService:
    """HTTP server for the aggregator tier: the /query/* family plus
    the Grafana simple-JSON datasource (POST /search /query
    /annotations) — dashboards point at the FLEET; the per-shard
    query planes keep serving their own copies."""

    def __init__(
        self,
        aggregator: FleetAggregator,
        registry=None,
        host: str = "0.0.0.0",
        port: int = 0,
    ):
        self.aggregator = aggregator
        self.registry = registry
        self._host = host
        self._port_req = port
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def _answer(self, path, params, body=None):
                t0 = time.perf_counter()
                status, doc = service.aggregator.dispatch(
                    path, params, body
                )
                try:
                    payload = json.dumps(doc).encode()
                except (TypeError, ValueError):
                    status = 500
                    payload = b'{"error": "internal aggregator error"}'
                try:
                    self.send_response(status)
                    self.send_header(
                        "Content-Type", "application/json"
                    )
                    self.send_header(
                        "Content-Length", str(len(payload))
                    )
                    self.send_header(
                        "Access-Control-Allow-Origin", "*"
                    )
                    self.end_headers()
                    self.wfile.write(payload)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away mid-answer
                service._observe(
                    path, status, time.perf_counter() - t0
                )

            def do_GET(self):  # noqa: N802 (http.server API)
                url = urlparse(self.path)
                params = {
                    k: v[0] for k, v in parse_qs(url.query).items()
                }
                self._answer(url.path, params)

            def do_POST(self):  # noqa: N802 — the Grafana surface
                # (the shard query plane's body discipline, mirrored:
                # unknowable framing closes, oversized refuses UNREAD)
                url = urlparse(self.path)
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    if n < 0:
                        raise ValueError("negative Content-Length")
                except ValueError:
                    self.close_connection = True
                    self._answer_error(400, "malformed Content-Length")
                    return
                if n > MAX_BODY_BYTES:
                    self.close_connection = True
                    self._answer_error(413, "body too large")
                    return
                try:
                    raw = self.rfile.read(n) if n else b""
                    doc = json.loads(raw.decode()) if raw else {}
                    if not isinstance(doc, dict):
                        raise ValueError("body must be a JSON object")
                except (ValueError, UnicodeDecodeError):
                    self._answer_error(400, "malformed JSON body")
                    return
                self._answer(url.path, {}, doc)

            def do_OPTIONS(self):  # noqa: N802 — Grafana CORS preflight
                self.send_response(204)
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header(
                    "Access-Control-Allow-Headers", "Content-Type"
                )
                self.send_header(
                    "Access-Control-Allow-Methods", "GET, POST, OPTIONS"
                )
                self.end_headers()

            def _answer_error(self, status: int, msg: str) -> None:
                body = json.dumps({"error": msg}).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Access-Control-Allow-Origin", "*")
                if self.close_connection:
                    self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)
                service._observe(
                    urlparse(self.path).path, status, 0.0
                )

            def log_message(self, *args):
                pass

        self._handler = Handler
        self._server = None
        self._thread = None
        self._started = False

    def _observe(self, endpoint: str, status: int, seconds: float) -> None:
        if self.registry is None:
            return
        label = (
            endpoint
            if endpoint in AGG_ENDPOINTS or endpoint in GRAFANA_ENDPOINTS
            else "other"
        )
        self.registry.counter_add(
            tele_metrics.ANOMALY_QUERY_REQUESTS, 1.0,
            endpoint=f"agg:{label}", code=str(status),
        )
        self.registry.histogram_observe(
            tele_metrics.ANOMALY_QUERY_LATENCY, seconds,
            LATENCY_BUCKETS,
        )

    @property
    def port(self) -> int:
        if self._server is not None:
            return self._server.server_address[1]
        return self._port_req

    def start(self) -> None:
        self._server = ThreadingHTTPServer(
            (self._host, self._port_req), self._handler
        )
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="aggregator-http",
            daemon=True,
        )
        self._thread.start()
        self._started = True

    def alive(self) -> bool:
        return not self._started or self._thread.is_alive()

    def stop(self) -> None:
        if self._server is None:
            return
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()
        self.aggregator.close()


def main() -> None:
    """Standalone aggregator tier (the compose/k8s
    ``anomaly-aggregator`` service entry point)."""
    from ..utils.config import fleet_config, fleet_tenant_map
    from .fleet import parse_peer_list

    fl = fleet_config()
    shards = int(fl["ANOMALY_FLEET_SHARDS"])
    port = int(fl["ANOMALY_AGGREGATOR_PORT"])
    if shards < 2 or port < 0:
        raise SystemExit(
            "aggregator needs ANOMALY_FLEET_SHARDS >= 2 and "
            "ANOMALY_AGGREGATOR_PORT >= 0"
        )
    # Index-aligned query addresses; the aggregator is NOT a shard, so
    # self_index=-1 keeps every slot.
    addrs = parse_peer_list(
        str(fl["ANOMALY_FLEET_QUERY_PEERS"]), shards, self_index=-1
    )
    # Heartbeat (/healthz) addresses feed the ring-staleness repair:
    # placement refreshes from the shard fleet blocks when the
    # boot-time ring routes a read to a shard that no longer owns it.
    health_addrs = parse_peer_list(
        str(fl["ANOMALY_FLEET_PEERS"]), shards, self_index=-1
    )
    ring = HashRing(
        [f"shard-{i}" for i in range(shards)],
        vnodes=int(fl["ANOMALY_FLEET_VNODES"]),
    )
    aggregator = FleetAggregator(
        addrs,
        timeout_s=float(fl["ANOMALY_AGGREGATOR_TIMEOUT_S"]),
        ring=ring,
        tenant_map=fleet_tenant_map(fl["ANOMALY_FLEET_TENANTS"]),
        health_addrs=health_addrs,
    )
    service = AggregatorService(aggregator, port=port)
    service.start()
    print(
        f"anomaly-aggregator: query :{service.port} "
        f"shards {sorted(addrs)} ring {ring.version():#x}",
        flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        service.stop()


if __name__ == "__main__":
    main()
