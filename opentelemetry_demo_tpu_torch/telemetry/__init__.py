"""Telemetry backends the runtime feeds: for now the log store, where
the OTLP logs leg lands."""

from .logstore import LogDoc, LogStore, normalize_severity

__all__ = ["LogDoc", "LogStore", "normalize_severity"]
