"""OTLP/HTTP metrics: ``ExportMetricsServiceRequest`` bodies ↔ records.

The collector exports metrics beside traces, and the detector consumes
both: spans go through ``runtime.otlp``, metric points through this
module into per-service rate/level observations for the metrics head
(``models.metrics_head``).

Field numbers follow the public OTLP protocol (opentelemetry-proto
metrics/v1): ExportMetricsServiceRequest{resource_metrics=1},
ResourceMetrics{resource=1, scope_metrics=2}, Resource{attributes=1},
ScopeMetrics{metrics=2}, Metric{name=1, unit=3, gauge=5, sum=7,
histogram=9}, Gauge{data_points=1}, Sum{data_points=1,
aggregation_temporality=2, is_monotonic=3}, Histogram{data_points=1,
aggregation_temporality=2}, NumberDataPoint{start_time_unix_nano=2,
time_unix_nano=3, as_double=4, as_int=6},
HistogramDataPoint{start_time_unix_nano=2, time_unix_nano=3, count=4,
sum=5, bucket_counts=6, explicit_bounds=7}.

:func:`encode_metrics_request` builds such a body (one resource per
service, the shape every OTLP SDK produces); :func:`registry_to_request`
folds a :class:`~..telemetry.metrics.MetricRegistry` into one, and
:class:`OtlpHttpMetricsExporter` POSTs it from a background sender.
"""

from __future__ import annotations

import json
import struct
from typing import Iterable, NamedTuple

from . import wire
from .otlp_export import BackgroundPoster, _ExporterBase, grpc_send, split_endpoint

# AggregationTemporality enum (metrics/v1).
TEMPORALITY_UNSPECIFIED = 0
TEMPORALITY_DELTA = 1
TEMPORALITY_CUMULATIVE = 2


class MetricRecord(NamedTuple):
    """One ingested metric data point.

    ``kind`` ∈ {"gauge", "sum"}; a histogram point becomes two sum
    records (``{name}_count``, ``{name}_sum``), the Prometheus naming.
    """

    service: str
    name: str
    value: float
    kind: str = "sum"
    monotonic: bool = True
    temporality: int = TEMPORALITY_CUMULATIVE
    time_unix_nano: int = 0


def _u64_to_double(raw: int) -> float:
    return struct.unpack("<d", raw.to_bytes(8, "little"))[0]


def _number_point_value(buf: bytes) -> tuple[float | None, int]:
    """NumberDataPoint → (value, time_unix_nano); value None if absent."""
    dp = wire.scan_fields(buf)
    t = int(wire.first(dp, 3, 0) or 0)
    raw_d = wire.first(dp, 4)
    if raw_d is not None:
        return _u64_to_double(int(raw_d)), t
    raw_i = wire.first(dp, 6)
    if raw_i is not None:
        return float(wire.to_int64(int(raw_i))), t
    return None, t


def _service_of_resource(rm: dict) -> str:
    res_buf = wire.first(rm, 1)
    if res_buf:
        res = wire.scan_fields(res_buf)
        for kv_buf in res.get(1, []):
            kv = wire.scan_fields(kv_buf)
            if wire.first(kv, 1) == b"service.name":
                val_buf = wire.first(kv, 2)
                if isinstance(val_buf, bytes):
                    sv = wire.first(wire.scan_fields(val_buf), 1)
                    if isinstance(sv, bytes):
                        return sv.decode("utf-8", "replace")
    return "unknown"


def decode_metrics_request(payload: bytes) -> list[MetricRecord]:
    """ExportMetricsServiceRequest protobuf → MetricRecords."""
    records: list[MetricRecord] = []
    req = wire.scan_fields(payload)
    for rm_buf in req.get(1, []):
        rm = wire.scan_fields(rm_buf)
        service = _service_of_resource(rm)
        for sm_buf in rm.get(2, []):
            sm = wire.scan_fields(sm_buf)
            for m_buf in sm.get(2, []):
                _decode_metric(m_buf, service, records)
    return records


def _decode_metric(m_buf: bytes, service: str, out: list[MetricRecord]) -> None:
    m = wire.scan_fields(m_buf)
    name_raw = wire.first(m, 1, b"")
    name = name_raw.decode("utf-8", "replace") if isinstance(name_raw, bytes) else ""
    gauge_buf = wire.first(m, 5)
    sum_buf = wire.first(m, 7)
    hist_buf = wire.first(m, 9)
    if gauge_buf:
        g = wire.scan_fields(gauge_buf)
        for dp_buf in g.get(1, []):
            val, t = _number_point_value(dp_buf)
            if val is not None:
                out.append(MetricRecord(service, name, val, kind="gauge", monotonic=False,
                                        temporality=TEMPORALITY_UNSPECIFIED, time_unix_nano=t))
    elif sum_buf:
        s = wire.scan_fields(sum_buf)
        temporality = int(wire.first(s, 2, 0) or 0)
        monotonic = bool(wire.first(s, 3, 0) or 0)
        for dp_buf in s.get(1, []):
            val, t = _number_point_value(dp_buf)
            if val is not None:
                out.append(MetricRecord(service, name, val, kind="sum", monotonic=monotonic,
                                        temporality=temporality, time_unix_nano=t))
    elif hist_buf:
        h = wire.scan_fields(hist_buf)
        temporality = int(wire.first(h, 2, 0) or 0)
        for dp_buf in h.get(1, []):
            dp = wire.scan_fields(dp_buf)
            t = int(wire.first(dp, 3, 0) or 0)
            count = wire.first(dp, 4)
            total = wire.first(dp, 5)
            if count is not None:
                out.append(MetricRecord(service, name + "_count", float(int(count)), kind="sum",
                                        monotonic=True, temporality=temporality, time_unix_nano=t))
            if total is not None:
                out.append(MetricRecord(service, name + "_sum", _u64_to_double(int(total)),
                                        kind="sum", monotonic=True, temporality=temporality,
                                        time_unix_nano=t))


_TEMPORALITY_NAMES = {
    "AGGREGATION_TEMPORALITY_DELTA": TEMPORALITY_DELTA,
    "AGGREGATION_TEMPORALITY_CUMULATIVE": TEMPORALITY_CUMULATIVE,
}


def _json_temporality(raw) -> int:
    return int(raw) if isinstance(raw, int) else _TEMPORALITY_NAMES.get(raw, 0)


def _json_point_value(dp: dict) -> float | None:
    if "asDouble" in dp:
        return float(dp["asDouble"])
    if "asInt" in dp:
        return float(int(dp["asInt"]))
    return None


def decode_metrics_request_json(payload: bytes) -> list[MetricRecord]:
    """JSON-encoded OTLP metrics (the collector's otlphttp json mode)."""
    doc = json.loads(payload)
    records: list[MetricRecord] = []
    for rm in doc.get("resourceMetrics", []):
        service = "unknown"
        for attr in rm.get("resource", {}).get("attributes", []):
            if attr.get("key") == "service.name":
                service = attr.get("value", {}).get("stringValue", service)
        for sm in rm.get("scopeMetrics", []):
            for m in sm.get("metrics", []):
                name = m.get("name", "")
                if "gauge" in m:
                    for dp in m["gauge"].get("dataPoints", []):
                        val = _json_point_value(dp)
                        if val is not None:
                            records.append(MetricRecord(
                                service, name, val, kind="gauge", monotonic=False,
                                temporality=TEMPORALITY_UNSPECIFIED,
                                time_unix_nano=int(dp.get("timeUnixNano", 0))))
                elif "sum" in m:
                    s = m["sum"]
                    temporality = _json_temporality(s.get("aggregationTemporality", 0))
                    for dp in s.get("dataPoints", []):
                        val = _json_point_value(dp)
                        if val is not None:
                            records.append(MetricRecord(
                                service, name, val, kind="sum",
                                monotonic=bool(s.get("isMonotonic", False)),
                                temporality=temporality,
                                time_unix_nano=int(dp.get("timeUnixNano", 0))))
                elif "histogram" in m:
                    h = m["histogram"]
                    temporality = _json_temporality(h.get("aggregationTemporality", 0))
                    for dp in h.get("dataPoints", []):
                        t = int(dp.get("timeUnixNano", 0))
                        if "count" in dp:
                            records.append(MetricRecord(
                                service, name + "_count", float(int(dp["count"])), kind="sum",
                                monotonic=True, temporality=temporality, time_unix_nano=t))
                        if "sum" in dp:
                            records.append(MetricRecord(
                                service, name + "_sum", float(dp["sum"]), kind="sum",
                                monotonic=True, temporality=temporality, time_unix_nano=t))
    return records


# -- encoding ----------------------------------------------------------


def _encode_string_attr(field_no: int, key: str, value: str) -> bytes:
    any_value = wire.encode_len(1, value.encode())
    kv = wire.encode_len(1, key.encode()) + wire.encode_len(2, any_value)
    return wire.encode_len(field_no, kv)


def _encode_number_point(value: float, t_ns: int, start_ns: int = 0) -> bytes:
    dp = b""
    if start_ns:
        dp += wire.encode_fixed64(2, start_ns)
    dp += wire.encode_fixed64(3, t_ns)
    dp += wire.encode_double(4, float(value))
    return dp


def encode_metrics_request(
    service_metrics: Iterable[tuple[str, Iterable[tuple[str, float, bool]]]],
    t_ns: int,
    start_ns: int = 0,
) -> bytes:
    """Build an ExportMetricsServiceRequest.

    ``service_metrics`` yields ``(service_name, [(metric_name, value,
    is_counter), ...])``; counters encode as cumulative monotonic Sums,
    the rest as Gauges. One resource per service, one scope per resource.
    """
    rms = b""
    for service, metrics in service_metrics:
        resource = _encode_string_attr(1, "service.name", service)
        ms = b""
        for name, value, is_counter in metrics:
            point = wire.encode_len(1, _encode_number_point(value, t_ns, start_ns))
            if is_counter:
                body = (
                    point
                    + wire.encode_int(2, TEMPORALITY_CUMULATIVE)
                    + wire.encode_int(3, 1)  # is_monotonic
                )
                metric = wire.encode_len(1, name.encode()) + wire.encode_len(7, body)
            else:
                metric = wire.encode_len(1, name.encode()) + wire.encode_len(5, point)
            ms += wire.encode_len(2, metric)
        rm = wire.encode_len(1, resource)
        if ms:
            # One ScopeMetrics whose repeated `metrics` fields are ``ms``.
            rm += wire.encode_len(2, ms)
        rms += wire.encode_len(1, rm)
    return rms


def registry_to_request(
    jobs: Iterable[tuple[str, "object"]], t_ns: int, start_ns: int = 0
) -> bytes:
    """Encode (job, MetricRegistry) pairs; label sets fold.

    A counter's per-label-set series sum into one per-service total (the
    metrics head consumes counter rates); gauges fold by max, the natural
    disjunction for up/status gauges.
    """
    payload = []
    for job, registry in jobs:
        counters, gauges = registry.snapshot()
        folded: dict[str, float] = {}
        for (name, _labels), value in counters.items():
            folded[name] = folded.get(name, 0.0) + value
        rows = [(name, value, True) for name, value in sorted(folded.items())]
        gfold: dict[str, float] = {}
        for (name, _labels), value in gauges.items():
            gfold[name] = max(gfold.get(name, float("-inf")), value)
        rows += [(name, value, False) for name, value in sorted(gfold.items())]
        payload.append((job, rows))
    return encode_metrics_request(payload, t_ns, start_ns)


class OtlpHttpMetricsExporter(_ExporterBase):
    """POSTs registry snapshots to an OTLP/HTTP ``/v1/metrics`` endpoint
    (``grpc://host:port`` ships over OTLP/gRPC instead).

    Called with ``(now, [(job, registry), ...])``, it encodes one
    ExportMetricsServiceRequest and queues it on a background poster, so
    the caller never waits on the network. Failures count, not raise.
    """

    def __init__(self, endpoint: str, timeout_s: float = 2.0, queue_max: int = 16):
        scheme, target = split_endpoint(endpoint)
        if scheme == "grpc":
            self._poster = BackgroundPoster(
                target, "application/grpc", timeout_s, queue_max,
                send=grpc_send(target, "metrics", timeout_s),
            )
        else:
            target = target.rstrip("/")
            if not target.endswith("/v1/metrics"):
                target += "/v1/metrics"
            self._poster = BackgroundPoster(
                target, "application/x-protobuf", timeout_s, queue_max
            )

    def __call__(self, now: float, jobs: list) -> None:
        self._poster.submit(registry_to_request(jobs, t_ns=int(now * 1e9)))
