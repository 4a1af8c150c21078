"""Telemetry: in-proc tracing SDK, metrics, and the backend tier.

The reference instruments every service with an OTel SDK and ships
three signals through the collector into Jaeger / Prometheus /
OpenSearch (SURVEY.md §3.2). Here the tier exists as a library on a
virtual clock: tracer → :class:`Collector` (processors, spanmetrics
connector, exporter fan-out) → :class:`TraceStore` (Jaeger analogue),
:class:`MetricTSDB` + :class:`Scraper` (Prometheus analogue),
:class:`LogStore` (OpenSearch analogue). The log store is also where the
detector's OTLP logs leg lands, and the metric registry with its
Prometheus exporter is where the detector's verdicts surface; the
provisioned dashboards (the Grafana analogue, ``dashboards``) are
evaluated straight against the stores and served by ``obsui``.
"""

from .tracer import Baggage, Tracer, TraceContext
from .metrics import MetricRegistry, PrometheusExporter
from .collector import Collector, CollectorConfig, normalize_span_name
from .tracestore import TraceStore
from .tsdb import MetricTSDB, Scraper
from .logstore import LogDoc, LogStore, normalize_severity
from .hostmetrics import HostMetricsReceiver
from .receivers import HttpCheckReceiver, StoreStatsReceiver
from . import dashboards

__all__ = [
    "Baggage",
    "Tracer",
    "TraceContext",
    "MetricRegistry",
    "PrometheusExporter",
    "Collector",
    "CollectorConfig",
    "normalize_span_name",
    "TraceStore",
    "MetricTSDB",
    "Scraper",
    "LogDoc",
    "LogStore",
    "HostMetricsReceiver",
    "HttpCheckReceiver",
    "StoreStatsReceiver",
    "normalize_severity",
    "dashboards",
]
