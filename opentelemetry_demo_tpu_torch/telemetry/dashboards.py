"""Dashboards: the in-proc Grafana analogue.

The reference provisions four dashboards
(the upstream demo's src/grafana/provisioning/dashboards/demo/
{demo-dashboard,spanmetrics-dashboard,exemplars-dashboard,
opentelemetry-collector}.json) over three datasources
(provisioning/datasources/{default,jaeger,opensearch}.yaml). Here a
dashboard is data — panels carrying structured queries against the
:class:`~.tsdb.MetricTSDB` / :class:`~.tracestore.TraceStore` /
:class:`~.logstore.LogStore` — and evaluation returns the numbers the
reference's panels would plot, e.g. the spanmetrics p95 panel's
``histogram_quantile(0.95, sum by (service_name)
(rate(traces_span_metrics_duration_milliseconds_bucket[1m])))``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .collector import CALLS_TOTAL, DURATION_MS, Collector


@dataclass
class Query:
    kind: str                      # "rate" | "quantile" | "instant" | "traces" | "logs"
    metric: str = ""
    matchers: dict = field(default_factory=dict)
    by: tuple = ()
    q: float = 0.95
    window_s: float = 60.0
    # traces/logs query knobs
    service: str | None = None
    error_only: bool = False
    severity: str | None = None


@dataclass
class Panel:
    title: str
    query: Query
    unit: str = ""


@dataclass
class Dashboard:
    uid: str
    title: str
    panels: list[Panel]


def provisioned_dashboards() -> list[Dashboard]:
    """The four dashboards the reference provisions, re-expressed."""
    return [
        Dashboard(
            uid="demo",
            title="Demo Dashboard",
            panels=[
                Panel("Requests by service",
                      Query("rate", CALLS_TOTAL, by=("service_name",)), "req/s"),
                Panel("Error rate by service",
                      Query("rate", CALLS_TOTAL,
                            matchers={"status_code": "STATUS_CODE_ERROR"},
                            by=("service_name",)), "err/s"),
                Panel("Recent error traces",
                      Query("traces", error_only=True), "traces"),
            ],
        ),
        Dashboard(
            uid="spanmetrics",
            title="Span Metrics Demo Dashboard",
            panels=[
                Panel("p95 latency by service",
                      Query("quantile", DURATION_MS + "_bucket",
                            by=("service_name",), q=0.95), "ms"),
                Panel("p50 latency by service",
                      Query("quantile", DURATION_MS + "_bucket",
                            by=("service_name",), q=0.50), "ms"),
                Panel("Call rate by operation",
                      Query("rate", CALLS_TOTAL,
                            by=("service_name", "span_name")), "req/s"),
            ],
        ),
        Dashboard(
            uid="exemplars",
            title="Exemplars Demo Dashboard",
            panels=[
                Panel("Slowest recent spans (click-through to trace)",
                      Query("exemplars"), "ms"),
                Panel("p95 latency (exemplar source)",
                      Query("quantile", DURATION_MS + "_bucket",
                            by=("service_name",), q=0.95), "ms"),
            ],
        ),
        Dashboard(
            uid="opentelemetry-collector",
            title="OpenTelemetry Collector",
            panels=[
                Panel("Accepted spans",
                      Query("rate", "otelcol_receiver_accepted_spans"), "spans/s"),
                Panel("Exported spans",
                      Query("rate", "otelcol_exporter_sent_spans"), "spans/s"),
                Panel("Queue size",
                      Query("instant", "otelcol_exporter_queue_size"), "spans"),
                # docker_stats receiver analogue (otelcol-config.yml:18-19):
                # per-container resource breakdown across the topology.
                Panel("Container CPU",
                      Query("rate", "container_cpu_usage_seconds_total",
                            by=("container_name",)), "cores"),
                Panel("Container memory (RSS)",
                      Query("instant", "container_memory_usage_bytes",
                            by=("container_name",)), "bytes"),
                Panel("Container threads",
                      Query("instant", "container_threads",
                            by=("container_name",)), "threads"),
            ],
        ),
        Dashboard(
            uid="anomaly",
            title="TPU Anomaly Detector",
            panels=[
                Panel("Max |z| by service/signal",
                      Query("instant", "app_anomaly_z_score",
                            by=("service", "signal"))),
                Panel("Distinct traces (HLL)",
                      Query("instant", "app_anomaly_distinct_traces",
                            by=("service",))),
                Panel("Anomaly flags",
                      Query("rate", "app_anomaly_flags_total",
                            by=("service",)), "flags/s"),
                Panel("CUSUM accumulators",
                      Query("instant", "app_anomaly_cusum",
                            by=("service", "signal"))),
                Panel("Metric-stream |z| by service/metric",
                      Query("instant", "app_anomaly_metric_z_score",
                            by=("service", "metric"))),
                Panel("Metric-stream flags",
                      Query("rate", "app_anomaly_metric_flags_total",
                            by=("service",)), "flags/s"),
                # Overload protection: judge queue depth against the
                # watermark gauges; shed/brownout/export-drop counters
                # prove (or indict) the graceful-degradation story.
                Panel("Pending queue vs watermarks",
                      Query("instant", "anomaly_queue_rows"), "rows"),
                Panel("Shed rows by lane/cause",
                      Query("rate", "anomaly_shed_rows_total",
                            by=("lane", "cause")), "rows/s"),
                Panel("Brownout level",
                      Query("instant", "anomaly_brownout_level"), "level"),
                Panel("Exporter drops (sender queue)",
                      Query("rate", "anomaly_export_dropped_total",
                            by=("signal",)), "batches/s"),
                Panel("Exporter queue depth (high-water)",
                      Query("instant", "anomaly_export_queue_depth",
                            by=("signal",)), "batches"),
                # Parallel ingest engine: depth vs the bounded queue,
                # worker saturation, and the live coalescing rate —
                # the "is decode or the device feed the bottleneck"
                # triage panels.
                Panel("Ingest-pool queue depth",
                      Query("instant", "anomaly_ingest_pool_depth"),
                      "requests"),
                Panel("Ingest-pool worker utilization",
                      Query("instant",
                            "anomaly_ingest_pool_worker_utilization"),
                      "busy fraction"),
                Panel("Ingest-pool decoded spans",
                      Query("rate", "anomaly_ingest_pool_spans_total"),
                      "spans/s"),
                # Hot-standby replication: who is serving (role series
                # are 0/1 per process), at what epoch (a step up = a
                # failover happened), how far behind the standby is,
                # and every fenced write a stale primary attempted.
                Panel("Replication role",
                      Query("instant", "anomaly_role", by=("role",))),
                Panel("Fencing epoch",
                      Query("instant", "anomaly_epoch"), "epoch"),
                Panel("Replication lag",
                      Query("instant", "anomaly_replication_lag_seconds"),
                      "s"),
                Panel("Replication deltas",
                      Query("rate", "anomaly_replication_deltas_total",
                            by=("direction",)), "deltas/s"),
                Panel("Fenced writes (stale primary)",
                      Query("rate", "anomaly_replication_fenced_total",
                            by=("path",)), "writes/s"),
                # Verified wire format: every corrupt frame CAUGHT at a
                # hop boundary (quarantined, never merged) — a nonzero
                # rate here is bad hardware/link, not bad sketches —
                # and the frame version each process writes (mixed
                # values = a rolling upgrade in flight).
                Panel("Corrupt frames quarantined",
                      Query("rate", "anomaly_frame_corrupt_total",
                            by=("hop",)), "frames/s"),
                Panel("Frame format version",
                      Query("instant", "anomaly_frame_version"),
                      "version"),
                # Live query plane (runtime.query): the read path's own
                # health — request rate per endpoint/status, latency,
                # the staleness bound every answer carries, and the
                # exemplar trace ids captured at flag time.
                Panel("Query request rate",
                      Query("rate", "anomaly_query_requests_total",
                            by=("endpoint", "code")), "req/s"),
                Panel("Query latency p99",
                      Query("quantile",
                            "anomaly_query_latency_seconds_bucket",
                            q=0.99), "s"),
                Panel("Query answer staleness",
                      Query("instant", "anomaly_query_staleness_seconds"),
                      "s"),
                Panel("Anomaly exemplars captured",
                      Query("rate", "anomaly_exemplars_captured_total"),
                      "traces/s"),
                # Verdict provenance plane (runtime.provenance): how
                # many flags got an evidence bundle, what assembling
                # one costs on the harvester, how many shipped to the
                # history tier / OTLP logs, and which build is
                # running (restart forensics beside bundle times).
                Panel("Anomaly explanations built",
                      Query("rate", "anomaly_explanations_built_total"),
                      "bundles/s"),
                Panel("Anomaly explanations exported",
                      Query("rate", "anomaly_explanations_exported_total"),
                      "bundles/s"),
                Panel("Explain build latency p99",
                      Query("quantile",
                            "anomaly_explain_latency_seconds_bucket",
                            q=0.99), "s"),
                Panel("Build info",
                      Query("instant", "anomaly_build_info",
                            by=("version", "frame_version", "jax")),
                      "info"),
                # Detector self-telemetry (runtime.selftrace +
                # runtime.flightrec): where a batch's wall time goes
                # per lifecycle phase, whether the device put hid
                # behind compute THIS window, how far behind harvest
                # runs, and the tracer/recorder output rates — the
                # detector watching itself with the same rigor it
                # watches the shop.
                Panel("Batch phase latency p99",
                      Query("quantile", "anomaly_phase_seconds_bucket",
                            by=("phase",), q=0.99), "s"),
                Panel("Spine put-wait p99",
                      Query("quantile",
                            "anomaly_spine_put_wait_seconds_bucket",
                            q=0.99), "s"),
                Panel("Harvest lag p99 (Prometheus-owned)",
                      Query("quantile",
                            "anomaly_harvest_lag_seconds_bucket",
                            q=0.99), "s"),
                Panel("Put overlap ratio (windowed median)",
                      Query("quantile",
                            "anomaly_spine_put_overlap_window_ratio_bucket",
                            q=0.5), "ratio"),
                Panel("Query answer staleness p99",
                      Query("quantile",
                            "anomaly_query_answer_staleness_seconds_bucket",
                            q=0.99), "s"),
                Panel("Self-trace export rate",
                      Query("rate", "anomaly_selftrace_traces_total"),
                      "traces/s"),
                Panel("Self-trace spans exported",
                      Query("rate", "anomaly_selftrace_spans_total"),
                      "spans/s"),
                Panel("Flight-recorder events",
                      Query("rate", "anomaly_flight_events_total",
                            by=("kind",)), "events/s"),
                Panel("Flight evidence dumps",
                      Query("rate", "anomaly_flight_dumps_total",
                            by=("reason",)), "dumps/s"),
                # Time-travel history tier (runtime.history): how much
                # recorded past exists, how far back it reaches, how
                # often the retention ladder folds, and what a range
                # read costs — beside the shared corrupt-frame panel's
                # hop=history series.
                Panel("History segments on disk",
                      Query("instant", "anomaly_history_segments"),
                      "segments"),
                Panel("History bytes (retention-capped)",
                      Query("instant", "anomaly_history_bytes"),
                      "bytes"),
                Panel("Time-travel reach (oldest record age)",
                      Query("instant", "anomaly_history_oldest_seconds"),
                      "s"),
                Panel("Retention-ladder folds",
                      Query("rate", "anomaly_history_compactions_total"),
                      "folds/s"),
                Panel("History range-read p99",
                      Query("quantile",
                            "anomaly_history_read_latency_seconds_bucket",
                            q=0.99), "s"),
                # Closed-loop auto-mitigation (runtime.remediation):
                # what the controller DID (acts/verifies/rollbacks/
                # failures), what is mitigated right now, and the
                # loop's headline — time-to-mitigate p99 beside the
                # detector's time-to-detect.
                Panel("Mitigations actuated",
                      Query("rate", "anomaly_mitigation_actions_total",
                            by=("actuator",)), "acts/s"),
                Panel("Mitigations verified recovered",
                      Query("rate", "anomaly_mitigation_verified_total"),
                      "verified/s"),
                Panel("Mitigation rollbacks (deadline expired)",
                      Query("rate", "anomaly_mitigation_rollbacks_total"),
                      "rollbacks/s"),
                Panel("Mitigations FAILED",
                      Query("rate", "anomaly_mitigation_failed_total"),
                      "failures/s"),
                Panel("Active mitigations",
                      Query("instant", "anomaly_mitigation_active"),
                      "services"),
                Panel("Time-to-mitigate p99",
                      Query("quantile",
                            "anomaly_time_to_mitigate_seconds_bucket",
                            q=0.99), "s"),
                # Counterfactual pre-flight (runtime.shadow): verdicts
                # by direction (released vs refused), refusals by
                # reason (a deadline/insufficient burst = the gate is
                # starved, not the mitigations wrong), the shadow
                # replay's wall cost, and the collector-steering
                # storage fraction (1 - ratio = reduction bought).
                Panel("Pre-flight verdicts",
                      Query("rate", "anomaly_preflight_verdicts_total",
                            by=("verdict",)), "verdicts/s"),
                Panel("Pre-flight refusals by reason",
                      Query("rate", "anomaly_preflight_refused_total",
                            by=("reason",)), "refusals/s"),
                Panel("Pre-flight verdict p99",
                      Query("quantile",
                            "anomaly_preflight_seconds_bucket",
                            q=0.99), "s"),
                Panel("Collector keep ratio (steered sampling)",
                      Query("instant", "anomaly_collector_keep_ratio"),
                      "fraction"),
                # Sharded fleet (runtime.fleet + runtime.aggregator):
                # live member count vs N, the ring digest every shard
                # should agree on (disagreement = split), applied vs
                # REFUSED reshards (a refusal burst = a flapping shard
                # hitting the frozen-ring guardrail), each shard's own
                # ingest rate, and the per-tenant quota shed that
                # proves one noisy tenant browns out alone.
                Panel("Fleet shards live",
                      Query("instant", "anomaly_fleet_shards_live"),
                      "shards"),
                Panel("Fleet ring version (split check)",
                      Query("instant", "anomaly_fleet_ring_version"),
                      "digest"),
                Panel("Reshards applied",
                      Query("rate", "anomaly_reshards_total"),
                      "reshards/s"),
                Panel("Reshards refused (budget exhausted)",
                      Query("rate", "anomaly_reshards_refused_total"),
                      "refusals/s"),
                Panel("Fleet ring frozen",
                      Query("instant", "anomaly_fleet_ring_frozen"),
                      "bool"),
                Panel("Per-shard ingest rate",
                      Query("rate",
                            "anomaly_fleet_shard_ingest_spans_total",
                            by=("shard",)), "spans/s"),
                Panel("Tenant-quota shed by tenant",
                      Query("rate", "anomaly_shed_rows_total",
                            matchers={"cause": "tenant-quota"},
                            by=("tenant",)), "rows/s"),
                # Key lifecycle plane (runtime.keyspace): the
                # detector's OWN memory story under a cardinality
                # bomb — process RSS beside the intern-table fill and
                # the degradation-ladder rung; eviction/throttle/
                # overflow rates say what the ladder is doing about
                # it, and a generation step-up marks each sweep that
                # recycled intern ids.
                Panel("Process RSS (memory budget)",
                      Query("instant", "anomaly_process_rss_bytes"),
                      "bytes"),
                Panel("Intern-table fill fraction",
                      Query("instant", "anomaly_keyspace_fill_ratio"),
                      "fraction"),
                Panel("Live keys vs capacity",
                      Query("instant", "anomaly_keyspace_rows"),
                      "keys"),
                Panel("Keyspace ladder level",
                      Query("instant", "anomaly_keyspace_level"),
                      "level"),
                Panel("Keys evicted (idle, folded to history)",
                      Query("rate", "anomaly_keyspace_evicted_total"),
                      "keys/s"),
                Panel("Keyspace generation (eviction sweeps)",
                      Query("instant", "anomaly_keyspace_generation"),
                      "epoch"),
                Panel("New keys throttled by tenant",
                      Query("rate",
                            "anomaly_keyspace_newkeys_throttled_total",
                            by=("tenant",)), "keys/s"),
                Panel("Overflow-bucket folds by tenant",
                      Query("rate",
                            "anomaly_keyspace_overflow_keys_total",
                            by=("tenant",)), "keys/s"),
                Panel("Recent warnings",
                      Query("logs", severity="WARN"), "docs"),
            ],
        ),
        # Panels backed by the query plane ITSELF (the Grafana
        # simple-JSON datasource runtime.query serves): dashboards
        # query live sketches directly — estimates, accumulators and
        # anomaly+exemplar tables — instead of only scraping gauges.
        # The "sketch" query kind renders as a simple-JSON datasource
        # target (uid "anomaly-query"; point it at the detector's
        # ANOMALY_QUERY_PORT).
        Dashboard(
            uid="sketch-live",
            title="Live Sketch Queries (TPU detector read plane)",
            panels=[
                Panel("Distinct traces — frontend (live HLL)",
                      Query("sketch", "cardinality:frontend"), "traces"),
                Panel("CUSUM max — frontend (live accumulator)",
                      Query("sketch", "cusum:frontend"), "score"),
                Panel("Distinct traces — checkout (live HLL)",
                      Query("sketch", "cardinality:checkout"), "traces"),
                Panel("Top-k heavy hitters — frontend (live CMS)",
                      Query("sketch", "topk:frontend"), "count"),
                Panel("Recent anomalies with exemplar traces",
                      Query("sketch", "anomalies"), "events"),
                Panel("Flight recorder (live ring via /query/flight)",
                      Query("sketch", "flight"), "events"),
            ],
        ),
    ]


def evaluate_panel(panel: Panel, collector: Collector, at: float):
    """Run one panel's query against the backends; returns rows."""
    q = panel.query
    if q.kind == "rate":
        grouped = collector.tsdb.sum_rate(
            q.metric, q.matchers, q.window_s, at, by=q.by
        )
        return sorted(grouped.items())
    if q.kind == "quantile":
        grouped = collector.tsdb.histogram_quantile(
            q.q, q.metric, q.matchers, q.window_s, at, by=q.by
        )
        return sorted(grouped.items())
    if q.kind == "instant":
        rows = collector.tsdb.instant(q.metric, q.matchers, at)
        if q.by:
            return sorted(
                (tuple(labels.get(k, "") for k in q.by), v) for labels, v in rows
            )
        return [((), v) for _, v in rows]
    if q.kind == "traces":
        traces = collector.trace_store.find_traces(
            service=q.service, error_only=q.error_only, limit=20
        )
        return [((t.trace_id.hex(),), t.duration_us) for t in traces]
    if q.kind == "exemplars":
        return [
            ((svc, name, ex.trace_id.hex()), ex.value_ms)
            for svc, name, ex in collector.slowest_exemplars(limit=10)
        ]
    if q.kind == "logs":
        docs = collector.log_store.search(
            service=q.service, severity=q.severity, limit=20
        )
        return [((d.service, d.severity), d.body) for d in docs]
    if q.kind == "sketch":
        # Backed by the live query plane (runtime.query's simple-JSON
        # datasource), not the in-proc TSDB — nothing to evaluate here.
        return []
    raise ValueError(f"unknown query kind {q.kind!r}")


def evaluate(dashboard: Dashboard, collector: Collector, at: float) -> dict:
    return {p.title: evaluate_panel(p, collector, at) for p in dashboard.panels}


def to_grafana_json(dashboard: Dashboard) -> dict:
    """Export a dashboard as a real Grafana dashboard model.

    Bridges the in-proc definitions to the reference's deployment shape
    (provisioned JSON files under
    the upstream demo's src/grafana/provisioning/dashboards/demo/): each
    Query becomes the equivalent PromQL expression against the same
    metric names, so the file drops into a Grafana+Prometheus stack
    (deploy/ integration) unchanged.
    """
    panels = []
    for i, panel in enumerate(dashboard.panels):
        q = panel.query
        w = int(q.window_s)
        sketch_target = None
        if q.kind == "rate":
            by = f" by ({', '.join(q.by)})" if q.by else ""
            sel = _promql_selector(q.metric, q.matchers)
            expr = f"sum{by} (rate({sel}[{w}s]))"
        elif q.kind == "quantile":
            by_labels = ("le",) + tuple(q.by)
            sel = _promql_selector(q.metric, q.matchers)
            expr = (
                f"histogram_quantile({q.q}, sum by ({', '.join(by_labels)}) "
                f"(rate({sel}[{w}s])))"
            )
        elif q.kind == "instant":
            expr = _promql_selector(q.metric, q.matchers)
        elif q.kind == "sketch":
            # A live-sketch panel: the target goes to the simple-JSON
            # datasource runtime.query serves (uid "anomaly-query"),
            # not to Prometheus — dashboards read the sketches
            # themselves. q.metric carries the datasource target
            # ("cardinality:<svc>" | "cusum:<svc>" | "topk:<svc>" |
            # "anomalies" — the /search vocabulary).
            expr = ""
            sketch_target = q.metric
        else:  # traces/logs/exemplars panels target other datasources
            expr = ""
        kind_prefix = (sketch_target or "").partition(":")[0]
        panel_doc = {
            "id": i + 1,
            "title": panel.title,
            "type": (
                "timeseries" if expr or kind_prefix in (
                    "cardinality", "cusum",
                ) else "table"
            ),
            "gridPos": {"h": 8, "w": 12, "x": 12 * (i % 2), "y": 8 * (i // 2)},
            "fieldConfig": {"defaults": {"unit": panel.unit or "none"}},
            "targets": (
                [{"expr": expr, "refId": "A", "exemplar": q.kind == "quantile"}]
                if expr else []
            ),
        }
        if sketch_target is not None:
            panel_doc["datasource"] = {
                "type": "grafana-simple-json-datasource",
                "uid": "anomaly-query",
            }
            panel_doc["targets"] = [{
                "target": sketch_target,
                "refId": "A",
                "type": (
                    "timeseries"
                    if kind_prefix in ("cardinality", "cusum")
                    else "table"
                ),
            }]
        panels.append(panel_doc)
    return {
        "uid": dashboard.uid,
        "title": dashboard.title,
        "schemaVersion": 39,
        "tags": ["opentelemetry-demo-tpu"],
        "time": {"from": "now-1h", "to": "now"},
        "panels": panels,
    }


def _promql_selector(metric: str, matchers: dict) -> str:
    if not matchers:
        return metric
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(matchers.items()))
    return metric + "{" + inner + "}"


def write_grafana_dashboards(outdir: str) -> list[str]:
    """Write all provisioned dashboards as Grafana JSON (make gen-dashboards)."""
    import json
    import os

    os.makedirs(outdir, exist_ok=True)
    paths = []
    for board in provisioned_dashboards():
        path = os.path.join(outdir, f"{board.uid}-dashboard.json")
        with open(path, "w") as f:
            json.dump(to_grafana_json(board), f, indent=2)
            f.write("\n")
        paths.append(path)
    return paths


def render_text(dashboard: Dashboard, collector: Collector, at: float) -> str:
    """Plain-text dashboard render (the ops-console view)."""
    lines = [f"== {dashboard.title} ({dashboard.uid}) @ t={at:.1f}s =="]
    results = evaluate(dashboard, collector, at)
    for panel in dashboard.panels:
        lines.append(f"-- {panel.title}" + (f" [{panel.unit}]" if panel.unit else ""))
        rows = results[panel.title]
        if not rows:
            lines.append("   (no data)")
        for key, value in rows[:10]:
            label = "/".join(str(k) for k in key) if key else "total"
            if isinstance(value, float):
                lines.append(f"   {label:<40} {value:,.3f}")
            else:
                lines.append(f"   {label:<40} {value}")
    return "\n".join(lines)
