"""Metrics: counters, gauges and histograms with Prometheus text exposition.

The detector publishes its verdicts as the ``app_anomaly_*`` family the
shop's Grafana dashboards graph, plus the ``anomaly_*`` self-telemetry
families. :class:`MetricRegistry` holds the series; :class:`PrometheusExporter`
serves them on ``/metrics``. The exposition text is the reference
package's byte for byte for the same sequence of registry calls, so a
dashboard or alert rule reads either deployment unchanged.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable

import numpy as np
import torch


def _fmt_le(le: float) -> str:
    """Bucket bound rendering: integers without ``.0``."""
    return str(int(le)) if float(le).is_integer() else repr(float(le))


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class MetricRegistry:
    """Thread-safe counters and gauges with Prometheus text output."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple], float] = {}
        self._gauges: dict[tuple[str, tuple], float] = {}
        self._help: dict[str, str] = {}

    def describe(self, name: str, help_text: str) -> None:
        self._help[name] = help_text

    def counter_add(self, name: str, value: float = 1.0, **labels: str) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge_set(self, name: str, value: float, **labels: str) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key] = value

    def histogram_observe(
        self,
        name: str,
        value: float,
        buckets: tuple[float, ...],
        **labels: str,
    ) -> None:
        """Explicit-bucket histogram as Prometheus counter series:
        cumulative ``{name}_bucket{le=...}`` (``+Inf`` included),
        ``{name}_sum`` and ``{name}_count``."""
        # One sort per observation; bucket keys splice in the "le" pair.
        base = sorted(labels.items())
        i = 0
        while i < len(base) and base[i][0] < "le":
            i += 1

        def with_le(le_str: str) -> tuple:
            return tuple(base[:i] + [("le", le_str)] + base[i:])

        base_key = tuple(base)
        with self._lock:
            for le in buckets:
                if value <= le:
                    key = (name + "_bucket", with_le(_fmt_le(le)))
                    self._counters[key] = self._counters.get(key, 0.0) + 1.0
            key = (name + "_bucket", with_le("+Inf"))
            self._counters[key] = self._counters.get(key, 0.0) + 1.0
            key = (name + "_sum", base_key)
            self._counters[key] = self._counters.get(key, 0.0) + value
            key = (name + "_count", base_key)
            self._counters[key] = self._counters.get(key, 0.0) + 1.0

    def snapshot(self) -> tuple[dict, dict]:
        """Point-in-time copies of (counters, gauges)."""
        with self._lock:
            return dict(self._counters), dict(self._gauges)

    def render(self) -> str:
        lines: list[str] = []
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
        seen: set[str] = set()

        def emit(store: dict, kind: str) -> Iterable[str]:
            for (name, labels), value in sorted(store.items()):
                if name not in seen:
                    seen.add(name)
                    if name in self._help:
                        yield f"# HELP {name} {self._help[name]}"
                    yield f"# TYPE {name} {kind}"
                yield f"{name}{_fmt_labels(dict(labels))} {value}"

        lines.extend(emit(counters, "counter"))
        lines.extend(emit(gauges, "gauge"))
        return "\n".join(lines) + "\n"


class PrometheusExporter:
    """Serves a registry at ``/metrics`` from a thread of its own.

    With ``health`` (a callable returning ``(status, detail)``) it also
    serves ``GET /healthz``: JSON ``{"status": ..., **detail}``, 200 for
    ``ok``/``saturated`` (a shedding detector is alive) and 503 for
    ``degraded``.
    """

    def __init__(self, registry: MetricRegistry, host: str = "0.0.0.0",
                 port: int = 9464, health=None):
        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path == "/healthz" and health is not None:
                    try:
                        status, detail = health()
                    except Exception:  # noqa: BLE001 — health must answer
                        status, detail = "degraded", {"error": "health probe raised"}
                    body = json.dumps({"status": status, **detail}).encode()
                    self.send_response(503 if status == "degraded" else 200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path != "/metrics":
                    self.send_response(404)
                    self.end_headers()
                    return
                body = reg.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="prom-exporter", daemon=True
        )

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        # shutdown() waits for serve_forever, which never ran on a
        # server that was not started.
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()


# The metric names: the reference package's table, name for name, so a
# dashboard reads either deployment. Families whose modules the port
# does not carry yet keep their names here all the same.
ANOMALY_FLAG_TOTAL = "app_anomaly_flags_total"
ANOMALY_Z_SCORE = "app_anomaly_z_score"
ANOMALY_CARDINALITY = "app_anomaly_distinct_traces"
ANOMALY_HEAVY_HITTER = "app_anomaly_heavy_hitter_ratio"
ANOMALY_SPANS_TOTAL = "app_anomaly_spans_processed_total"
ANOMALY_LAG_P99 = "app_anomaly_detection_lag_p99_ms"
ANOMALY_CUSUM = "app_anomaly_cusum"
ANOMALY_METRIC_Z = "app_anomaly_metric_z_score"
ANOMALY_METRIC_FLAG_TOTAL = "app_anomaly_metric_flags_total"
ANOMALY_METRIC_POINTS_TOTAL = "app_anomaly_metric_points_processed_total"
ANOMALY_LOG_RECORDS_TOTAL = "app_anomaly_log_records_processed_total"
ANOMALY_PENDING_ROWS = "app_anomaly_pending_rows"
ANOMALY_BATCHES_DISPATCHED = "app_anomaly_batches_dispatched"
ANOMALY_SPANS_INGESTED = "app_anomaly_spans_ingested"
ANOMALY_LOG_DOCS_STORED = "app_anomaly_log_docs_stored"
ANOMALY_COMPONENT_RESTARTS = "anomaly_component_restarts_total"
ANOMALY_COMPONENT_UP = "anomaly_component_up"
ANOMALY_DEGRADED = "anomaly_degraded"
ANOMALY_QUARANTINE_TOTAL = "anomaly_quarantined_records_total"
ANOMALY_QUARANTINE_LAST_ERROR_TS = "anomaly_quarantine_last_error_ts_seconds"
ANOMALY_INGEST_REJECTED = "anomaly_ingest_rejected_total"
ANOMALY_CHECKPOINT_CORRUPT = "anomaly_checkpoint_corrupt_total"
ANOMALY_SHED_ROWS = "anomaly_shed_rows_total"  # {lane=, cause=} (+ tenant= on the per-tenant quota shed)
ANOMALY_QUEUE_ROWS = "anomaly_queue_rows"
ANOMALY_QUEUE_WATERMARK = "anomaly_queue_watermark_rows"  # {mark=high|low}
ANOMALY_BROWNOUT_LEVEL = "anomaly_brownout_level"
ANOMALY_SATURATED = "anomaly_saturated"
ANOMALY_KAFKA_PAUSED = "anomaly_kafka_paused"
ANOMALY_INGEST_POOL_DEPTH = "anomaly_ingest_pool_depth"
ANOMALY_INGEST_POOL_FLUSHES = "anomaly_ingest_pool_flushes_total"
ANOMALY_INGEST_POOL_SPANS = "anomaly_ingest_pool_spans_total"
ANOMALY_INGEST_POOL_REQUESTS = "anomaly_ingest_pool_requests_total"
ANOMALY_INGEST_POOL_UTILIZATION = "anomaly_ingest_pool_worker_utilization"
ANOMALY_SPINE_PUT_OVERLAP = "anomaly_spine_put_overlap_ratio"
ANOMALY_SPINE_RING_DEPTH = "anomaly_spine_ring_depth"
ANOMALY_EXPORT_DROPPED = "anomaly_export_dropped_total"  # {signal=}
ANOMALY_EXPORT_QUEUE_DEPTH = "anomaly_export_queue_depth"  # {signal=}
ANOMALY_ROLE = "anomaly_role"  # {role=primary|standby|promoting|fenced}
ANOMALY_EPOCH = "anomaly_epoch"
ANOMALY_REPLICATION_DELTAS = "anomaly_replication_deltas_total"  # {direction=}
ANOMALY_REPLICATION_SNAPSHOTS = "anomaly_replication_snapshots_total"  # {direction=}
ANOMALY_REPLICATION_LAG = "anomaly_replication_lag_seconds"
ANOMALY_REPLICATION_FENCED = "anomaly_replication_fenced_total"  # {path=}
ANOMALY_FAILOVERS = "anomaly_failovers_total"
ANOMALY_OFFSET_DEFER_DROPPED = "anomaly_offset_defer_dropped_total"
ANOMALY_RESTORE_PARTIAL = "anomaly_restore_partial_total"
ANOMALY_FRAME_CORRUPT = "anomaly_frame_corrupt_total"  # {hop=}
ANOMALY_FRAME_VERSION = "anomaly_frame_version"
ANOMALY_QUERY_REQUESTS = "anomaly_query_requests_total"  # {endpoint=, code=}
ANOMALY_QUERY_LATENCY = "anomaly_query_latency_seconds"  # histogram
ANOMALY_QUERY_STALENESS = "anomaly_query_staleness_seconds"
ANOMALY_EXEMPLARS_CAPTURED = "anomaly_exemplars_captured_total"
ANOMALY_PHASE_SECONDS = "anomaly_phase_seconds"  # histogram {phase=}
ANOMALY_SPINE_PUT_WAIT = "anomaly_spine_put_wait_seconds"  # histogram
ANOMALY_HARVEST_LAG = "anomaly_harvest_lag_seconds"  # histogram
ANOMALY_SPINE_OVERLAP_WINDOW = "anomaly_spine_put_overlap_window_ratio"
ANOMALY_QUERY_STALENESS_HIST = "anomaly_query_answer_staleness_seconds"
ANOMALY_HISTORY_SEGMENTS = "anomaly_history_segments"
ANOMALY_HISTORY_BYTES = "anomaly_history_bytes"
ANOMALY_HISTORY_COMPACTIONS = "anomaly_history_compactions_total"
ANOMALY_HISTORY_OLDEST = "anomaly_history_oldest_seconds"
ANOMALY_HISTORY_READ_LATENCY = "anomaly_history_read_latency_seconds"
ANOMALY_SELFTRACE_TRACES = "anomaly_selftrace_traces_total"
ANOMALY_SELFTRACE_SPANS = "anomaly_selftrace_spans_total"
ANOMALY_FLIGHT_EVENTS = "anomaly_flight_events_total"  # {kind=}
ANOMALY_FLIGHT_DUMPS = "anomaly_flight_dumps_total"  # {reason=}
ANOMALY_MITIGATION_ACTIONS = "anomaly_mitigation_actions_total"  # {actuator=}
ANOMALY_MITIGATION_ROLLBACKS = "anomaly_mitigation_rollbacks_total"
ANOMALY_MITIGATION_VERIFIED = "anomaly_mitigation_verified_total"
ANOMALY_MITIGATION_FAILED = "anomaly_mitigation_failed_total"
ANOMALY_MITIGATION_ACTIVE = "anomaly_mitigation_active"
ANOMALY_TIME_TO_MITIGATE = "anomaly_time_to_mitigate_seconds"  # histogram
ANOMALY_PREFLIGHT_VERDICTS = "anomaly_preflight_verdicts_total"  # {verdict=}
ANOMALY_PREFLIGHT_REFUSED = "anomaly_preflight_refused_total"  # {reason=}
ANOMALY_PREFLIGHT_SECONDS = "anomaly_preflight_seconds"  # histogram
ANOMALY_COLLECTOR_KEEP_RATIO = "anomaly_collector_keep_ratio"
ANOMALY_FLEET_SHARDS_LIVE = "anomaly_fleet_shards_live"
ANOMALY_FLEET_RING_VERSION = "anomaly_fleet_ring_version"
ANOMALY_FLEET_FROZEN = "anomaly_fleet_ring_frozen"
ANOMALY_RESHARDS = "anomaly_reshards_total"
ANOMALY_RESHARDS_REFUSED = "anomaly_reshards_refused_total"
ANOMALY_FLEET_SHARD_SPANS = "anomaly_fleet_shard_ingest_spans_total"  # {shard=}
ANOMALY_AUTOSCALE_PROPOSALS = "anomaly_autoscale_proposals_total"  # {action=}
ANOMALY_AUTOSCALE_REFUSED = "anomaly_autoscale_refused_total"  # {reason=}
ANOMALY_AUTOSCALE_TARGET = "anomaly_autoscale_target_shards"
ANOMALY_AUTOSCALE_SCORE = "anomaly_autoscale_saturation_score"
ANOMALY_FLEET_ADOPTIONS = "anomaly_fleet_adoptions_total"
ANOMALY_FLEET_ADOPTIONS_REFUSED = "anomaly_fleet_adoptions_refused_total"  # {reason=}
ANOMALY_FLEET_ADOPTION_TTA = "anomaly_fleet_adoption_seconds"

ANOMALY_EXPLANATIONS_BUILT = "anomaly_explanations_built_total"
ANOMALY_EXPLANATIONS_EXPORTED = "anomaly_explanations_exported_total"
ANOMALY_EXPLAIN_LATENCY = "anomaly_explain_latency_seconds"  # histogram
ANOMALY_BUILD_INFO = "anomaly_build_info"

ANOMALY_PROCESS_RSS = "anomaly_process_rss_bytes"
ANOMALY_KEYSPACE_ROWS = "anomaly_keyspace_rows"  # live interned keys
ANOMALY_KEYSPACE_CAPACITY = "anomaly_keyspace_capacity_rows"
ANOMALY_KEYSPACE_FILL = "anomaly_keyspace_fill_ratio"
ANOMALY_KEYSPACE_LEVEL = "anomaly_keyspace_level"
ANOMALY_KEYSPACE_GENERATION = "anomaly_keyspace_generation"
ANOMALY_KEYSPACE_EVICTED = "anomaly_keyspace_evicted_total"
ANOMALY_KEYSPACE_FREE_IDS = "anomaly_keyspace_free_ids"
ANOMALY_KEYSPACE_THROTTLED = "anomaly_keyspace_newkeys_throttled_total"  # {tenant=}
ANOMALY_KEYSPACE_OVERFLOW = "anomaly_keyspace_overflow_keys_total"  # {tenant=}


def _np(x) -> np.ndarray:
    """A report field as numpy: harvested reports are numpy already; a
    report straight from the step holds tensors, possibly on the card."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def export_metrics_report(
    registry: MetricRegistry,
    service_names: list[str],
    metric_names: list[str],
    report,
    flagged: list[str],
    seen: set | None = None,
) -> None:
    """Publish one metrics-head report into the registry.

    ``seen`` (caller-owned, kept across reports) holds the (service,
    metric) series ever exported: a quiet cell mints no series, but a
    minted one keeps updating (its z masks to 0 when the stream stops)
    rather than freezing on its last anomalous value.
    """
    z = _np(report.z)  # [S, M, T]
    cell = _np(report.cell_flags)  # [S, M]
    for i, sname in enumerate(service_names[: z.shape[0]]):
        zi = np.abs(z[i]).max(axis=1)  # [M]
        for j, mname in enumerate(metric_names[: z.shape[1]]):
            key = (sname, mname)
            minted = seen is not None and key in seen
            if zi[j] > 0.0 or cell[i, j] or minted:
                registry.gauge_set(
                    ANOMALY_METRIC_Z, float(zi[j]), service=sname, metric=mname
                )
                if seen is not None:
                    seen.add(key)
    for name in flagged:
        registry.counter_add(ANOMALY_METRIC_FLAG_TOTAL, 1.0, service=name)


def export_report(
    registry: MetricRegistry,
    service_names: list[str],
    report,
    flagged: list[str],
) -> None:
    """Publish one detector report into the registry (host side)."""
    lat_z = _np(report.lat_z)
    err_z = _np(report.err_z)
    rate_z = _np(report.rate_z)
    card_z = _np(report.card_z)
    card = _np(report.card_est)
    hh = _np(report.hh_ratio)
    cusum = _np(report.cusum)
    # Overflow names share the last id but keep their own intern-table
    # entries, so the table can outgrow the report's rows.
    for i, name in enumerate(service_names[: lat_z.shape[0]]):
        registry.gauge_set(ANOMALY_Z_SCORE, float(np.abs(lat_z[i]).max()),
                           service=name, signal="latency")
        registry.gauge_set(ANOMALY_Z_SCORE, float(np.abs(err_z[i]).max()),
                           service=name, signal="error_rate")
        registry.gauge_set(ANOMALY_Z_SCORE, float(np.abs(rate_z[i]).max()),
                           service=name, signal="throughput")
        registry.gauge_set(ANOMALY_Z_SCORE, float(np.abs(card_z[i]).max()),
                           service=name, signal="cardinality")
        registry.gauge_set(ANOMALY_CARDINALITY, float(card[i].max()), service=name)
        registry.gauge_set(ANOMALY_HEAVY_HITTER, float(hh[i].max()), service=name)
        for j, signal in enumerate(("latency_up", "error_up", "rate_down")):
            registry.gauge_set(
                ANOMALY_CUSUM, float(cusum[i, j]), service=name, signal=signal
            )
    for name in flagged:
        registry.counter_add(ANOMALY_FLAG_TOTAL, 1.0, service=name)
