"""Telemetry backends the runtime feeds: the log store, where the OTLP
logs leg lands, and the metric registry with its Prometheus exporter,
where the detector's verdicts surface."""

from .logstore import LogDoc, LogStore, normalize_severity
from .metrics import MetricRegistry, PrometheusExporter

__all__ = ["LogDoc", "LogStore", "MetricRegistry", "PrometheusExporter", "normalize_severity"]
