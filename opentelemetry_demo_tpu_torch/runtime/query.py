"""Live sketch query plane: the read path over the detector's state.

Answers, per service, from the live sketches:

- **top-k heavy hitters**: exact CMS point queries over the live bank
  for the candidate keys the pipeline remembers per service (a CMS
  cannot enumerate its keys; heavy hitters are recent by definition);
- **cardinality** estimates per window and a short timeline;
- **EWMA/CUSUM state**: the learned baselines, raw;
- **recent anomaly flags** with exemplar trace ids and evidence bundles
  (``runtime.provenance``).

One snapshot function, one numpy read path. :class:`QueryEngine` reads
state only through ``snapshot_fn() -> (arrays, meta)``. On the card the
step updates the state in place, so the snapshot function enqueues one
stream-ordered copy of the whole state under the pipeline's dispatch
lock and waits for it outside the lock
(``runtime.querybench.state_snapshot_fn``). Every answer is then the
same pure numpy over ``(arrays, meta)`` as in the reference package, so
the two packages, and a primary and a replica, return identical
documents for the same state.

Surfaces:

- HTTP/JSON (:class:`QueryService`): ``/query/services``, ``/query/topk``,
  ``/query/cardinality``, ``/query/zscore``, ``/query/anomalies``,
  ``/query/explain``, each wrapping ``data`` in a ``meta`` envelope
  (role, epoch, seq, staleness_s), and ``/query/flight``, the flight
  recorder's ring;
- the Grafana simple-JSON datasource on the same port: ``GET /``,
  ``POST /search``, ``/query``, ``/annotations``;
- gRPC (:class:`QueryGrpcService`, where grpcio is installed): one
  raw-bytes method carrying the same JSON documents.

Range parameters (``from``/``to``) select the time-travel tier, which
arrives with ``runtime.history``; until then a ranged query answers the
reference's 404 "history tier not configured", and a key missing from
the live intern table is a plain 404.

Self-observability: ``anomaly_query_requests_total{endpoint,code}``,
``anomaly_query_latency_seconds`` and ``anomaly_query_staleness_seconds``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..ops.cms import cms_indices_np, cms_query_np
from ..ops.hashing import split_hi_lo_np, splitmix64_np
from ..ops.hll import hll_estimate_np
from ..telemetry import metrics as tele_metrics
from .tensorize import EVICTED_SLOT

# DetectorConfig fields ride the meta block positionally
# (``list(config)``, the checkpoint/replication convention; appends go
# to the tuple END, so these indices are stable — see the NOTE in
# models.detector.DetectorConfig).
_CFG_WINDOWS = 4
_CFG_TAUS = 5
_CFG_Z_THRESHOLD = 6
_CFG_CUSUM_H = 13
_CFG_CUSUM_H_RATE = 17

# Latency histogram buckets (seconds): queries are host-side numpy over
# MB-scale snapshots — single-digit ms is the expected band.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)

# Per-answer staleness buckets (seconds): the histogram companion to
# the anomaly_query_staleness_seconds gauge — snapshot-cache age plus
# replica lag, so the p99 an operator alerts on comes from Prometheus
# instead of a bench artifact.
STALENESS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0,
)

# Endpoints whose answers never read the state snapshot ("/" is the
# datasource probe; /query/flight serves the process-local event
# ring): their responses carry no staleness bound, so observing the
# snapshot-cache age for them would report staleness no served answer
# actually had (a flight-only poller would inflate the p99 unbounded).
SNAPSHOT_FREE_ENDPOINTS = frozenset({"/", "/query/flight"})

GRPC_QUERY_METHOD = "/otdtpu.query.v1.QueryService/Query"

# POST bodies are Grafana target lists — a few KB at most. Anything
# bigger is refused unread (413), the OTLP receiver's discipline.
MAX_BODY_BYTES = 1 << 20

# The closed endpoint vocabulary — also the metric-label domain: the
# `endpoint` label on anomaly_query_requests_total comes from THIS set
# (anything else collapses to "other"), so a port scanner spraying
# bogus paths can never mint unbounded Prometheus series.
ENDPOINTS = frozenset({
    "/", "/query/services", "/query/topk", "/query/cardinality",
    "/query/zscore", "/query/anomalies", "/query/explain",
    "/query/flight", "/search", "/query", "/annotations",
})

# Jaeger deep-link shape: the gateway serves the Jaeger UI under
# /jaeger (envoy route parity), and the exemplar hex is the 8-byte
# trace-id prefix its search matches on. Relative by default so the
# link works behind whatever host/port the operator's edge sits on;
# a reverse proxy can rewrite the prefix.
JAEGER_TRACE_PATH = "/jaeger/trace/{trace_id}"


def jaeger_trace_url(trace_hex: str) -> str:
    """Ready-made Jaeger UI deep link for one exemplar trace id."""
    return JAEGER_TRACE_PATH.format(trace_id=trace_hex)


def endpoint_label(path: str) -> str:
    return path if path in ENDPOINTS else "other"


class QueryError(Exception):
    """A query that cannot be answered; carries the HTTP status."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


# -- pure read functions (arrays, meta) --------------------------------
#
# Everything below is deterministic numpy over the snapshot pair — the
# reason a primary and a read replica agree bit-exactly.


def _cfg(meta: dict, index: int, default):
    cfg = meta.get("config")
    if isinstance(cfg, (list, tuple)) and len(cfg) > index:
        return cfg[index]
    return default


def _windows_s(meta: dict, nw: int) -> list[float]:
    win = _cfg(meta, _CFG_WINDOWS, (1.0, 10.0, 60.0))
    win = list(win)[:nw]
    while len(win) < nw:
        win.append(float(len(win)))
    return [float(w) for w in win]


def service_names(meta: dict) -> list[str]:
    return list(meta.get("service_names") or [])


def _service_id(meta: dict, service: str) -> int:
    names = service_names(meta)
    if service in names:
        return names.index(service)
    # The tensorizer's overflow convention: unknown names share the
    # last id, and reports label rows past the intern table "svc-<i>".
    if service.startswith("svc-"):
        try:
            svc_id = int(service[4:])
            if svc_id >= 0:  # a negative id would wrap-index state
                return svc_id
        except ValueError:
            pass
    raise QueryError(404, f"unknown service {service!r}")


def _service_label(meta: dict, svc_id: int) -> str:
    names = service_names(meta)
    return names[svc_id] if svc_id < len(names) else f"svc-{svc_id}"


def _is_overflow(meta: dict, svc_id: int) -> bool:
    """True when svc_id is the tensorizer's reserved overflow bucket
    (the LAST id, num_services - 1 — config[0] positionally). Overflow
    rows aggregate EVERY unadmitted key, so serving one as if it were
    a single service mis-attributes; answers carry this flag instead
    of silently leaking the bucket."""
    ns = _cfg(meta, 0, 0)
    try:
        ns = int(ns)
    except (TypeError, ValueError):
        return False
    return ns > 0 and svc_id == ns - 1


def seq_of(arrays: dict) -> int:
    """The query plane's consistency cursor: the detector step index —
    replicated inside the state arrays, so primary and replica agree
    on 'which state version answered this query'."""
    return int(np.asarray(arrays.get("step_idx", 0)))


def topk_heavy_hitters(
    arrays: dict, meta: dict, service: str, k: int, window: int = -1
) -> dict:
    """Top-k heavy-hitter attribute keys for one service.

    Candidates come from the pipeline's recently-seen ring
    (``meta["query"]["hh_candidates"]``); counts are EXACT point
    queries against the full live CMS bank (min over rows, the
    standard CMS estimate) in every tumbling window. The fold +
    splitmix here mirrors ``tensorize.pack_arrays`` exactly — same
    key, same cells."""
    svc_id = _service_id(meta, service)
    bank = np.asarray(arrays["cms_bank"])  # [W#, 2, D, C]
    cur = bank[:, 0]
    nw, depth, width = cur.shape[0], cur.shape[-2], cur.shape[-1]
    if not -nw <= window < nw:
        raise QueryError(400, f"window {window} outside 0..{nw - 1}")
    span_total = np.asarray(arrays["span_total"])[:, 0]  # [W#]
    cands = (
        (meta.get("query") or {}).get("hh_candidates") or {}
    ).get(str(svc_id)) or []
    out = {
        "service": _service_label(meta, svc_id),
        "overflow": _is_overflow(meta, svc_id),
        "windows_s": _windows_s(meta, nw),
        "window": int(window % nw),
        "k": int(k),
        "candidates": len(cands),
        "top": [],
    }
    if not cands:
        return out
    crc = np.asarray(cands, dtype=np.uint64)
    key = crc | (np.uint64(svc_id) << np.uint64(32))
    hi, lo = split_hi_lo_np(splitmix64_np(key))
    idx = cms_indices_np(hi, lo, depth, width)
    counts = cms_query_np(cur, idx)  # [W#, B]
    sel = counts[window]
    # Deterministic order: count desc, then key — ties must not depend
    # on ring arrival order (primary and replica dedup identically, but
    # the contract should not hinge on it).
    order = sorted(
        range(len(cands)), key=lambda i: (-int(sel[i]), int(crc[i]))
    )[: max(int(k), 0)]
    denom = max(float(span_total[window]), 1.0)
    out["top"] = [
        {
            "attr_crc": f"0x{int(crc[i]):08x}",
            "counts": [int(c) for c in counts[:, i]],
            "count": int(sel[i]),
            "share": float(np.float32(int(sel[i]) / denom)),
        }
        for i in order
    ]
    return out


def cardinality(
    arrays: dict, meta: dict, service: str, svc_id: int | None = None
) -> dict:
    """Per-window distinct-trace estimates for one service (live,
    still-filling current banks — the same estimator the detector's
    cardinality head feeds on).

    ``svc_id``: a pre-resolved (already 404-checked) id — the engine's
    timeline path resolves once and shares it here."""
    if svc_id is None:
        svc_id = _service_id(meta, service)
    bank = np.asarray(arrays["hll_bank"])  # [W#, 2, S, R]
    est = hll_estimate_np(bank[:, 0])  # [W#, S]
    nw = est.shape[0]
    if svc_id >= est.shape[1]:
        raise QueryError(404, f"service id {svc_id} outside sketch axis")
    return {
        "service": _service_label(meta, svc_id),
        "overflow": _is_overflow(meta, svc_id),
        "windows_s": _windows_s(meta, nw),
        "estimate": [float(est[w, svc_id]) for w in range(nw)],
    }


def zscore_state(arrays: dict, meta: dict, service: str) -> dict:
    """The EWMA/CUSUM state block for one service — the detector's
    learned baselines, raw (a z needs a batch; the STATE is what an
    operator inspects between batches)."""
    svc_id = _service_id(meta, service)
    lat_mean = np.asarray(arrays["lat_mean"])
    if svc_id >= lat_mean.shape[0]:
        raise QueryError(404, f"service id {svc_id} outside sketch axis")

    def row(key: str) -> list[float]:
        return [float(x) for x in np.asarray(arrays[key])[svc_id]]

    cusum = np.asarray(arrays["cusum"])[svc_id]
    nw = np.asarray(arrays["card_mean"]).shape[1]
    return {
        "service": _service_label(meta, svc_id),
        "overflow": _is_overflow(meta, svc_id),
        "taus_s": [float(t) for t in _cfg(meta, _CFG_TAUS, (1.0, 10.0, 60.0))],
        "windows_s": _windows_s(meta, nw),
        "z_threshold": float(_cfg(meta, _CFG_Z_THRESHOLD, 6.0)),
        "latency": {"mean": row("lat_mean"), "var": row("lat_var")},
        "error_rate": {"mean": row("err_mean")},
        "throughput": {"mean": row("rate_mean"), "var": row("rate_var")},
        "cardinality": {"mean": row("card_mean"), "var": row("card_var")},
        "cusum": {
            "latency_up": float(cusum[0]),
            "error_up": float(cusum[1]),
            "rate_down": float(cusum[2]),
            "thresholds": [
                float(_cfg(meta, _CFG_CUSUM_H, 5.0)),
                float(_cfg(meta, _CFG_CUSUM_H, 5.0)),
                float(_cfg(meta, _CFG_CUSUM_H_RATE, 8.0)),
            ],
        },
        "obs_batches": float(np.asarray(arrays["obs_batches"])[svc_id]),
    }


def anomalies(meta: dict, limit: int, service: str | None = None) -> dict:
    """Recent anomaly flag events (newest first) with their exemplar
    trace ids, plus the current per-service exemplar rings."""
    q = meta.get("query") or {}
    events = list(q.get("anomalies") or [])
    events.reverse()  # newest first
    out_events = []
    for ev in events:
        if len(out_events) >= limit:  # before append: limit=0 means 0
            break
        name = _service_label(meta, int(ev.get("service", -1)))
        if service is not None and name != service:
            continue
        exemplars = list(ev.get("exemplars") or [])
        out_events.append({
            "t": ev.get("t"),
            "service": name,
            "signals": list(ev.get("signals") or []),
            "exemplars": exemplars,
            # Evidence bundle id (None pre-provenance / disabled):
            # resolve it at /query/explain?id=.
            "bundle": ev.get("bundle"),
            "trace_urls": [jaeger_trace_url(t) for t in exemplars],
        })
    rings = {}
    for svc, ring in (q.get("exemplars") or {}).items():
        name = _service_label(meta, int(svc))
        if service is not None and name != service:
            continue
        rings[name] = list(ring)
    return {"events": out_events, "exemplars": rings}


def explain(
    meta: dict, limit: int,
    service: str | None = None, bundle: str | None = None,
) -> dict:
    """Evidence bundles (newest first) from the replicated query-meta
    block — built ONCE at flag time on the primary, so primary and
    replica serve byte-identical bundles at a matched seq (the parity
    pin). ``trace_urls`` are derived per answer from the bundle's own
    exemplars: pure function of bundle content, so derivation cannot
    break parity."""
    q = meta.get("query") or {}
    bundles = list(q.get("explains") or [])
    bundles.reverse()  # newest first
    out = []
    for b in bundles:
        if len(out) >= limit:  # before append: limit=0 means 0
            break
        if service is not None and b.get("service") != service:
            continue
        if bundle is not None and b.get("id") != bundle:
            continue
        ent = dict(b)
        ent["trace_urls"] = [
            jaeger_trace_url(t) for t in (b.get("exemplars") or [])
        ]
        out.append(ent)
    return {
        "bundles": out,
        "built": int(q.get("explanations_built") or 0),
    }


# -- engine ------------------------------------------------------------


class QueryEngine:
    """Caches one state snapshot and answers queries from it.

    ``snapshot_fn() -> (arrays, meta)`` is the only state access (see
    the module docstring). ``lag_fn`` adds a replica's replication lag
    to the reported staleness (0 on a primary). ``refresh()`` appends to
    the timeline ring, one entry per new step index, which feeds Grafana
    timeseries targets and ``/query/cardinality`` timelines.
    ``flight_fn`` returns this process's flight-recorder ring.

    The reference engine's ``history`` tier (and its evicted-key
    fallback) arrives with ``runtime.history``; until then the range
    methods answer its 404.
    """

    def __init__(
        self,
        snapshot_fn: Callable[[], tuple[dict, dict]],
        role_fn: Callable[[], str] | None = None,
        epoch_fn: Callable[[], int] | None = None,
        lag_fn: Callable[[], float] | None = None,
        max_staleness_s: float = 2.0,
        timeline_depth: int = 120,
        topk_default: int = 10,
        flight_fn: Callable[[], list] | None = None,
    ):
        self._snapshot_fn = snapshot_fn
        self._flight_fn = flight_fn
        self._role_fn = role_fn or (lambda: "primary")
        self._epoch_fn = epoch_fn or (lambda: 0)
        self._lag_fn = lag_fn or (lambda: 0.0)
        self.max_staleness_s = float(max_staleness_s)
        self.topk_default = int(topk_default)
        self._lock = threading.Lock()
        self._arrays: dict | None = None
        self._meta: dict = {}
        self._snap_mono = 0.0
        self._last_seq: int | None = None
        self._timeline: deque = deque(maxlen=max(int(timeline_depth), 1))
        # Snapshot attempts that raised (the cached snapshot was served
        # instead): must stay 0 while refreshes race live dispatch.
        self.refresh_errors = 0
        # Single-flight gate for maybe_refresh.
        self._refresh_lock = threading.Lock()

    # -- snapshot lifecycle --------------------------------------------

    def refresh(self) -> bool:
        """Take a fresh snapshot; False when no state exists yet. The
        snapshot function owns the locking."""
        try:
            arrays, meta = self._snapshot_fn()
        except Exception:  # noqa: BLE001 — a failed refresh serves the
            self.refresh_errors += 1  # cached (stale, labeled)
            return False  # snapshot instead
        if not arrays:
            return False
        now_wall = time.time()
        seq = seq_of(arrays)
        with self._lock:
            self._arrays, self._meta = arrays, meta
            self._snap_mono = time.monotonic()
            if seq != self._last_seq:
                # The longest window only: the timeline keeps one row.
                est = hll_estimate_np(np.asarray(arrays["hll_bank"])[-1, 0])  # [S]
                self._timeline.append({
                    "t": now_wall,
                    "seq": seq,
                    "card": [float(x) for x in est],
                    "cusum_max": [
                        float(x) for x in np.asarray(arrays["cusum"]).max(axis=1)
                    ],
                })
                self._last_seq = seq
        return True

    def maybe_refresh(self) -> None:
        """Refresh when the cache is older than the staleness budget.

        Single-flight: of the query threads that find the cache stale,
        one refreshes (one dispatch-lock hold, one copy of the state)
        and the rest serve the cached snapshot. Before the first
        snapshot exists the rest wait for it instead of answering 503."""
        fresh = (
            self._arrays is not None
            and time.monotonic() - self._snap_mono < self.max_staleness_s
        )
        if fresh:
            return
        if self._arrays is None:
            with self._refresh_lock:
                if (
                    self._arrays is None
                    or time.monotonic() - self._snap_mono >= self.max_staleness_s
                ):
                    self.refresh()
            return
        if self._refresh_lock.acquire(blocking=False):
            try:
                if time.monotonic() - self._snap_mono >= self.max_staleness_s:
                    self.refresh()
            finally:
                self._refresh_lock.release()

    def staleness_s(self) -> float:
        """Snapshot age plus the role's replication lag: the bound on how
        old an answer can be."""
        with self._lock:
            if self._arrays is None:
                return float("inf")
            age = time.monotonic() - self._snap_mono
        try:
            lag = float(self._lag_fn())
        except Exception:  # noqa: BLE001 — lag source mid-teardown
            lag = 0.0
        return age + lag

    def _snapshot(self) -> tuple[dict, dict]:
        self.maybe_refresh()
        with self._lock:
            if self._arrays is None:
                raise QueryError(503, "no state yet (standby awaiting bootstrap?)")
            return self._arrays, self._meta

    def _envelope(self, data: dict, arrays: dict) -> dict:
        return {
            "data": data,
            "meta": {
                "role": self._role_fn(),
                "epoch": int(self._epoch_fn()),
                "seq": seq_of(arrays),
                "staleness_s": round(self.staleness_s(), 4),
                "source": "live",
            },
        }

    # -- endpoints ------------------------------------------------------

    def services(self) -> dict:
        arrays, meta = self._snapshot()
        return self._envelope(
            {"services": [n for n in service_names(meta) if n != EVICTED_SLOT]},
            arrays,
        )

    def topk(self, service: str, k: int | None = None, window: int = -1) -> dict:
        arrays, meta = self._snapshot()
        k = self.topk_default if k is None else k
        return self._envelope(topk_heavy_hitters(arrays, meta, service, k, window), arrays)

    def cardinality(self, service: str) -> dict:
        arrays, meta = self._snapshot()
        svc_id = _service_id(meta, service)
        data = cardinality(arrays, meta, service, svc_id=svc_id)
        with self._lock:
            data["timeline"] = [
                {"t": e["t"], "seq": e["seq"], "estimate": e["card"][svc_id]}
                for e in self._timeline
                if svc_id < len(e["card"])
            ]
        return self._envelope(data, arrays)

    def zscore(self, service: str) -> dict:
        arrays, meta = self._snapshot()
        return self._envelope(zscore_state(arrays, meta, service), arrays)

    def anomalies(self, limit: int = 20, service: str | None = None) -> dict:
        arrays, meta = self._snapshot()
        return self._envelope(anomalies(meta, limit, service), arrays)

    def explain(
        self, limit: int = 20,
        service: str | None = None, bundle: str | None = None,
    ) -> dict:
        arrays, meta = self._snapshot()
        return self._envelope(explain(meta, limit, service, bundle), arrays)

    def flight(self, limit: int = 200) -> dict:
        """The flight-recorder ring, newest last. No state snapshot is
        involved, so the envelope carries role and epoch only."""
        if self._flight_fn is None:
            raise QueryError(404, "flight recorder not wired")
        events = list(self._flight_fn())
        if limit >= 0:
            events = events[-limit:] if limit else []
        return {
            "data": {"events": events, "count": len(events)},
            "meta": {"role": self._role_fn(), "epoch": int(self._epoch_fn())},
        }

    # -- time-travel range answers --------------------------------------

    def _range_answer(self, t_from: float, t_to: float, resolution: float | None = None):
        """The history tier's range read: without ``runtime.history``
        every range answers 404, as the reference's does with no tier."""
        raise QueryError(404, "history tier not configured")

    def topk_range(
        self, service: str, t_from: float, t_to: float,
        k: int | None = None, resolution: float | None = None,
    ) -> dict:
        return self._range_answer(t_from, t_to, resolution)

    def cardinality_range(
        self, service: str, t_from: float, t_to: float,
        resolution: float | None = None,
    ) -> dict:
        return self._range_answer(t_from, t_to, resolution)

    def zscore_range(
        self, service: str, t_from: float, t_to: float,
        resolution: float | None = None,
    ) -> dict:
        return self._range_answer(t_from, t_to, resolution)

    def anomalies_range(
        self, t_from: float, t_to: float,
        limit: int = 20, service: str | None = None,
    ) -> dict:
        return self._range_answer(t_from, t_to)

    def explain_range(
        self, t_from: float, t_to: float,
        limit: int = 20, service: str | None = None,
        bundle: str | None = None,
    ) -> dict:
        return self._range_answer(t_from, t_to)

    # -- Grafana simple-JSON datasource --------------------------------

    def grafana_search(self) -> list[str]:
        _arrays, meta = self._snapshot()
        names = [n for n in service_names(meta) if n != EVICTED_SLOT]
        targets = ["anomalies"]
        if self._flight_fn is not None:
            targets.append("flight")
        for name in names:
            targets += [f"cardinality:{name}", f"cusum:{name}", f"topk:{name}"]
        return targets

    def grafana_query(self, body: dict) -> list[dict]:
        arrays, meta = self._snapshot()
        t_from, t_to = _grafana_range(body)
        out: list[dict] = []
        for tgt in body.get("targets") or []:
            target = (tgt.get("target") or "").strip()
            kind, _, svc = target.partition(":")
            if kind in ("cardinality", "cusum") and svc:
                svc_id = _service_id(meta, svc)
                field = "card" if kind == "cardinality" else "cusum_max"
                # Without a history tier the series is the live ring.
                with self._lock:
                    points = [
                        [e[field][svc_id], e["t"] * 1000.0]
                        for e in self._timeline
                        if svc_id < len(e[field])
                        and (t_from is None or e["t"] >= t_from)
                        and (t_to is None or e["t"] <= t_to)
                    ]
                out.append({"target": target, "datapoints": points})
            elif kind == "topk" and svc:
                data = topk_heavy_hitters(arrays, meta, svc, self.topk_default)
                out.append({
                    "type": "table",
                    "columns": [
                        {"text": "attr_crc", "type": "string"},
                        {"text": "count", "type": "number"},
                        {"text": "share", "type": "number"},
                    ],
                    "rows": [
                        [row["attr_crc"], row["count"], row["share"]]
                        for row in data["top"]
                    ],
                })
            elif kind == "flight":
                data = self.flight(limit=100)
                out.append({
                    "type": "table",
                    "columns": [
                        {"text": "time", "type": "time"},
                        {"text": "kind", "type": "string"},
                        {"text": "detail", "type": "string"},
                    ],
                    "rows": [
                        [
                            (ev.get("t") or 0.0) * 1000.0,
                            ev.get("kind", ""),
                            json.dumps({
                                k: v for k, v in ev.items()
                                if k not in ("t", "kind", "seq")
                            }, default=str),
                        ]
                        for ev in data["data"]["events"]
                        if (t_from is None or (ev.get("t") or 0) >= t_from)
                        and (t_to is None or (ev.get("t") or 0) <= t_to)
                    ],
                })
            elif kind == "anomalies":
                data = anomalies(meta, limit=100)
                out.append({
                    "type": "table",
                    "columns": [
                        {"text": "time", "type": "time"},
                        {"text": "service", "type": "string"},
                        {"text": "signals", "type": "string"},
                        {"text": "exemplar", "type": "string"},
                    ],
                    "rows": [
                        [
                            (ev["t"] or 0.0) * 1000.0,
                            ev["service"],
                            ",".join(ev["signals"]),
                            (ev["exemplars"] or [""])[0],
                        ]
                        for ev in data["events"]
                        if (t_from is None or (ev["t"] or 0) >= t_from)
                        and (t_to is None or (ev["t"] or 0) <= t_to)
                    ],
                })
            else:
                raise QueryError(400, f"unknown target {target!r}")
        return out

    def grafana_annotations(self, body: dict) -> list[dict]:
        _arrays, meta = self._snapshot()
        t_from, t_to = _grafana_range(body)
        ann = body.get("annotation") or {}
        data = anomalies(meta, limit=100)
        return [
            {
                "annotation": ann,
                "time": (ev["t"] or 0.0) * 1000.0,
                "title": f"anomaly: {ev['service']}",
                # The bundle id (resolve at /query/explain?id=) and
                # Jaeger deep links beside the raw trace prefixes.
                "text": " ".join(
                    ev["signals"]
                    + ([f"bundle:{ev['bundle']}"] if ev.get("bundle") else [])
                    + [f"trace:{t}" for t in ev["exemplars"][:3]]
                    + [jaeger_trace_url(t) for t in ev["exemplars"][:3]]
                ),
                "tags": ev["signals"],
            }
            for ev in data["events"]
            if (t_from is None or (ev["t"] or 0) >= t_from)
            and (t_to is None or (ev["t"] or 0) <= t_to)
        ]


def parse_ts(raw) -> float | None:
    """One timestamp → epoch SECONDS, or None.

    Accepts ISO-8601 strings (Grafana's simple-JSON range format,
    ``Z`` suffix included), numeric epoch seconds, numeric epoch
    MILLISECONDS (anything past year ~5138 in seconds is read as ms —
    Grafana's JSON datasources and its ``__from``/``__to`` variables
    send ms), and numeric strings of either."""
    if raw is None:
        return None
    if isinstance(raw, (int, float)) and not isinstance(raw, bool):
        value = float(raw)
        return value / 1000.0 if value > 1e11 else value
    if not isinstance(raw, str) or not raw:
        return None
    try:
        value = float(raw)
        return value / 1000.0 if value > 1e11 else value
    except ValueError:
        pass
    import datetime

    try:
        return datetime.datetime.fromisoformat(
            raw.replace("Z", "+00:00")
        ).timestamp()
    except ValueError:
        return None


def _grafana_range(body: dict) -> tuple[float | None, float | None]:
    """Parse the simple-JSON request range to epoch seconds (None =
    unbounded; a malformed range filters nothing rather than erroring —
    Grafana's own behavior for a datasource that ignores ranges)."""
    rng = body.get("range") or {}
    return parse_ts(rng.get("from")), parse_ts(rng.get("to"))


# -- shared dispatch (HTTP handler + gRPC method) ----------------------


def _param_int(params: dict, key: str, default: int | None) -> int | None:
    raw = params.get(key)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise QueryError(400, f"{key}={raw!r} is not an integer") from None


def _param_ts(params: dict, key: str) -> float | None:
    """Range parameter → epoch seconds (epoch s/ms or ISO-8601); a
    present-but-unparseable value is a 400, not a silent unbounded
    range."""
    raw = params.get(key)
    if raw is None or raw == "":
        return None
    ts = parse_ts(raw)
    if ts is None:
        raise QueryError(
            400, f"{key}={raw!r} is not a timestamp (epoch s/ms or ISO-8601)"
        )
    return ts


def _param_range(params: dict) -> tuple[float | None, float | None, float | None]:
    """(from, to, resolution) — `to` defaults to now when only `from`
    is given; both absent means a plain live query."""
    t_from = _param_ts(params, "from")
    t_to = _param_ts(params, "to")
    if t_from is not None and t_to is None:
        t_to = time.time()
    if t_to is not None and t_from is None:
        # A bare upper bound would otherwise be parsed and then
        # silently dropped (the answer would be live "now" — the same
        # silent-unbound trap _param_ts exists to close).
        raise QueryError(400, "to without from: range needs a start")
    resolution = params.get("resolution")
    if resolution not in (None, ""):
        try:
            resolution = float(resolution)
        except (TypeError, ValueError):
            raise QueryError(
                400, f"resolution={resolution!r} is not seconds"
            ) from None
    else:
        resolution = None
    return t_from, t_to, resolution


def dispatch(engine: QueryEngine, path: str, params: dict):
    """Route one query to the engine; (status, document). Both the
    HTTP handler and the gRPC method funnel through here, so the two
    transports can never answer differently. ``from``/``to`` range
    parameters (epoch s/ms or ISO-8601) on the sketch endpoints route
    to the time-travel tier."""
    try:
        if path == "/":
            # The Grafana simple-JSON "test connection" probe.
            return 200, {"status": "ok", "endpoints": [
                "/query/services", "/query/topk", "/query/cardinality",
                "/query/zscore", "/query/anomalies", "/query/explain",
                "/search", "/query", "/annotations",
            ]}
        if path == "/query/services":
            return 200, engine.services()
        if path == "/query/topk":
            service = params.get("service")
            if not service:
                raise QueryError(400, "service parameter required")
            t_from, t_to, res = _param_range(params)
            if t_from is not None:
                return 200, engine.topk_range(
                    service, t_from, t_to,
                    k=_param_int(params, "k", None), resolution=res,
                )
            return 200, engine.topk(
                service,
                k=_param_int(params, "k", None),
                window=_param_int(params, "window", -1),
            )
        if path == "/query/cardinality":
            service = params.get("service")
            if not service:
                raise QueryError(400, "service parameter required")
            t_from, t_to, res = _param_range(params)
            if t_from is not None:
                return 200, engine.cardinality_range(
                    service, t_from, t_to, resolution=res
                )
            return 200, engine.cardinality(service)
        if path == "/query/zscore":
            service = params.get("service")
            if not service:
                raise QueryError(400, "service parameter required")
            t_from, t_to, res = _param_range(params)
            if t_from is not None:
                return 200, engine.zscore_range(
                    service, t_from, t_to, resolution=res
                )
            return 200, engine.zscore(service)
        if path == "/query/anomalies":
            t_from, t_to, _res = _param_range(params)
            if t_from is not None:
                return 200, engine.anomalies_range(
                    t_from, t_to,
                    limit=_param_int(params, "limit", 20),
                    service=params.get("service") or None,
                )
            return 200, engine.anomalies(
                limit=_param_int(params, "limit", 20),
                service=params.get("service") or None,
            )
        if path == "/query/explain":
            t_from, t_to, _res = _param_range(params)
            if t_from is not None:
                return 200, engine.explain_range(
                    t_from, t_to,
                    limit=_param_int(params, "limit", 20),
                    service=params.get("service") or None,
                    bundle=params.get("id") or None,
                )
            return 200, engine.explain(
                limit=_param_int(params, "limit", 20),
                service=params.get("service") or None,
                bundle=params.get("id") or None,
            )
        if path == "/query/flight":
            return 200, engine.flight(
                limit=_param_int(params, "limit", 200)
            )
        if path == "/search":
            return 200, engine.grafana_search()
        if path == "/query":
            return 200, engine.grafana_query(params)
        if path == "/annotations":
            return 200, engine.grafana_annotations(params)
        raise QueryError(404, f"no such endpoint {path!r}")
    except QueryError as e:
        return e.status, {"error": str(e)}
    except Exception:  # noqa: BLE001 — a handler bug answers 500 on
        # BOTH transports (and gets counted): letting it escape here
        # would surface as a raw gRPC UNKNOWN with a traceback detail
        # while HTTP said 500 — the one thing this funnel exists to
        # prevent.
        return 500, {"error": "internal query error"}


# -- HTTP surface ------------------------------------------------------


class QueryService:
    """HTTP/JSON query server (plus the Grafana datasource contract).

    Binds AND serves from ``start()`` (resolved port in ``.port``
    afterwards): a constructed-
    but-unstarted service must not own the port, or a role that never
    serves (a plain standby pre-promotion) leaves clients hanging in
    the listen backlog instead of being refused. Instrumented
    against the passed registry:
    ``anomaly_query_requests_total{endpoint,code}``,
    ``anomaly_query_latency_seconds`` histogram,
    ``anomaly_query_staleness_seconds`` gauge refreshed per request.
    """

    def __init__(
        self,
        engine: QueryEngine,
        registry=None,
        host: str = "0.0.0.0",
        port: int = 0,
    ):
        self.engine = engine
        self.registry = registry
        self._host = host
        self._port_req = port
        service = self

        class Handler(BaseHTTPRequestHandler):
            # Keep-alive + no Nagle: every response carries an exact
            # Content-Length, so HTTP/1.1 lets dashboard clients reuse
            # one connection, and disabling Nagle stops the small
            # header/body writes from pairing with delayed ACKs
            # (measured: ~30 ms p50 per local query without these, ~1
            # ms with — the classic 40 ms write-write-read stall).
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def _answer(self, path: str, params: dict) -> None:
                t0 = time.perf_counter()
                status, doc = dispatch(service.engine, path, params)
                try:
                    body = json.dumps(doc).encode()
                except (TypeError, ValueError):
                    # dispatch() guarantees a (status, doc) answer even
                    # for handler bugs, but only the engine call sits
                    # under its guard — an un-JSON-able value in the doc
                    # (a stray numpy scalar) must answer 500 too, not
                    # kill the keep-alive thread mid-stream.
                    status = 500
                    body = b'{"error": "internal query error"}'
                try:
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("Access-Control-Allow-Origin", "*")
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away mid-answer
                service._observe(path, status, time.perf_counter() - t0)

            def do_GET(self):  # noqa: N802 (http.server API)
                url = urlparse(self.path)
                params = {
                    k: v[0] for k, v in parse_qs(url.query).items()
                }
                self._answer(url.path, params)

            def do_POST(self):  # noqa: N802
                url = urlparse(self.path)
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    if n < 0:
                        # read(-1) would block until peer-close and
                        # pin this handler thread forever.
                        raise ValueError("negative Content-Length")
                except ValueError:
                    # Unparseable framing: the body's extent is
                    # unknowable, so the keep-alive stream cannot be
                    # resynchronized — close after answering.
                    self.close_connection = True
                    self._answer_error(400, "malformed Content-Length")
                    return
                if n > MAX_BODY_BYTES:
                    # Oversized: refuse WITHOUT reading (the OTLP
                    # receiver's 413 discipline) — query bodies are
                    # small Grafana target lists, never megabytes, and
                    # draining an attacker-sized body into memory on a
                    # handler thread is the OOM it claims to be.
                    self.close_connection = True
                    self._answer_error(413, "body too large")
                    return
                try:
                    raw = self.rfile.read(n) if n else b""
                    params = json.loads(raw.decode()) if raw else {}
                    if not isinstance(params, dict):
                        raise ValueError("body must be a JSON object")
                except (ValueError, UnicodeDecodeError):
                    self._answer_error(400, "malformed JSON body")
                    return
                self._answer(url.path, params)

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
                    # Advertise the close (setting the flag alone
                    # drops the socket without telling the client).
                    self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)
                service._observe(urlparse(self.path).path, status, 0.0)

            def log_message(self, *args):
                pass

        self._handler = Handler
        self._server = None
        self._thread = None
        self._started = False

    def _observe(self, endpoint: str, status: int, seconds: float) -> None:
        if self.registry is None:
            return
        self.registry.counter_add(
            tele_metrics.ANOMALY_QUERY_REQUESTS, 1.0,
            endpoint=endpoint_label(endpoint), code=str(status),
        )
        self.registry.histogram_observe(
            tele_metrics.ANOMALY_QUERY_LATENCY, seconds, LATENCY_BUCKETS
        )
        staleness = self.engine.staleness_s()
        if staleness != float("inf"):
            self.registry.gauge_set(
                tele_metrics.ANOMALY_QUERY_STALENESS, staleness
            )
            # Histogram companion: per-ANSWER staleness, so the p99
            # bound comes from Prometheus (the gauge only shows the
            # latest sample a scrape happened to catch). Snapshot-free
            # endpoints are excluded — their answers carry no
            # staleness bound to observe.
            if endpoint not in SNAPSHOT_FREE_ENDPOINTS:
                self.registry.histogram_observe(
                    tele_metrics.ANOMALY_QUERY_STALENESS_HIST,
                    staleness, STALENESS_BUCKETS,
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
            target=self._server.serve_forever, name="query-http",
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


# -- gRPC surface (optional, grpcio-gated like the OTLP leg) -----------


class QueryGrpcService:
    """gRPC twin of :class:`QueryService`: ONE generic raw-bytes method
    (``/otdtpu.query.v1.QueryService/Query``) carrying the same JSON
    documents — request ``{"path": "/query/topk", "params": {...}}``,
    response the exact document HTTP would return. No generated stubs,
    the repo's OTLP/gRPC discipline. Non-200 dispatches map to
    NOT_FOUND / INVALID_ARGUMENT / UNAVAILABLE."""

    def __init__(
        self,
        engine: QueryEngine,
        registry=None,
        host: str = "0.0.0.0",
        port: int = 0,
        max_workers: int = 2,
    ):
        import grpc
        from concurrent import futures

        self.engine = engine
        self.registry = registry
        service = self

        def query(request: bytes, context) -> bytes:
            t0 = time.perf_counter()
            try:
                doc = json.loads(request.decode()) if request else {}
                path = doc.get("path", "/")
                params = doc.get("params") or {}
            except (ValueError, UnicodeDecodeError):
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT, "malformed JSON"
                )
            status, out = dispatch(service.engine, path, params)
            service._observe(path, status, time.perf_counter() - t0)
            if status == 404:
                context.abort(grpc.StatusCode.NOT_FOUND, out.get("error", ""))
            if status == 400:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT, out.get("error", "")
                )
            if status >= 500:
                context.abort(
                    grpc.StatusCode.UNAVAILABLE, out.get("error", "")
                )
            try:
                return json.dumps(out).encode()
            except (TypeError, ValueError):
                # Same serialization guard as the HTTP handler: an
                # un-JSON-able doc is the one failure dispatch() can't
                # catch, and it must look like a 500 on both transports.
                context.abort(
                    grpc.StatusCode.UNAVAILABLE, "internal query error"
                )

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                if details.method != GRPC_QUERY_METHOD:
                    return None
                return grpc.unary_unary_rpc_method_handler(
                    query, request_deserializer=None,
                    response_serializer=None,
                )

        self._server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=max_workers, thread_name_prefix="query-grpc"
            )
        )
        self._server.add_generic_rpc_handlers((Handler(),))
        # Bound at start(), same reason as the HTTP leg: an unstarted
        # service must not own the port.
        self._host = host
        self._port_req = port
        self.port = port
        self._stopped = False

    def _observe(self, endpoint: str, status: int, seconds: float) -> None:
        if self.registry is None:
            return
        self.registry.counter_add(
            tele_metrics.ANOMALY_QUERY_REQUESTS, 1.0,
            endpoint=f"grpc:{endpoint_label(endpoint)}", code=str(status),
        )
        self.registry.histogram_observe(
            tele_metrics.ANOMALY_QUERY_LATENCY, seconds, LATENCY_BUCKETS
        )
        staleness = self.engine.staleness_s()
        if staleness != float("inf") and (
            endpoint not in SNAPSHOT_FREE_ENDPOINTS
        ):
            # Same per-answer staleness observation as the HTTP leg —
            # the two transports must observe identically.
            self.registry.histogram_observe(
                tele_metrics.ANOMALY_QUERY_STALENESS_HIST, staleness,
                STALENESS_BUCKETS,
            )

    def start(self) -> None:
        self.port = self._server.add_insecure_port(
            f"{self._host}:{self._port_req}"
        )
        if self.port == 0:
            raise OSError(
                f"query gRPC failed to bind {self._host}:{self._port_req}"
            )
        self._server.start()

    def alive(self) -> bool:
        return not self._stopped

    def stop(self, grace: float = 0.5) -> None:
        self._stopped = True
        self._server.stop(grace).wait()


def grpc_query(target: str, path: str, params: dict | None = None) -> dict:
    """Client helper (tests/operators): one Query RPC → parsed doc."""
    import grpc

    with grpc.insecure_channel(target) as channel:
        call = channel.unary_unary(
            GRPC_QUERY_METHOD, request_serializer=None,
            response_deserializer=None,
        )
        raw = call(
            json.dumps({"path": path, "params": params or {}}).encode()
        )
    return json.loads(raw.decode())
