"""OTLP span decoding: export bodies → :class:`SpanRecord` lists.

``decode_export_request`` reads ``ExportTraceServiceRequest`` protobuf
(``application/x-protobuf``) with the schema projection below;
``decode_export_request_json`` reads the JSON encoding.
``decode_export_request_columnar`` is the native decoder
(``runtime.native``) on one body: columns for
``DetectorPipeline.submit_columnar``. The record decoders are its plain
version (same columns, same verdicts) and the JSON path's decoder.
``encode_export_request`` is the protobuf inverse over the fields this
package carries (fixtures and the chip smoke run). The HTTP receiver
arrives with a later slice.

Field numbers follow the public OTLP protocol (opentelemetry-proto
trace/v1): ExportTraceServiceRequest{resource_spans=1},
ResourceSpans{resource=1, scope_spans=2}, Resource{attributes=1},
KeyValue{key=1, value=2}, AnyValue{string_value=1},
ScopeSpans{spans=2}, Span{trace_id=1, name=5, start_time_unix_nano=7,
end_time_unix_nano=8, attributes=9, events=11, status=15},
Span.Event{time_unix_nano=1, name=2, attributes=3}, Status{code=3}.
"""

from __future__ import annotations

import json

from . import native, wire
from .tensorize import SpanEvent, SpanRecord

_STATUS_ERROR = 2  # opentelemetry.proto.trace.v1.Status.StatusCode.ERROR

# Attribute keys monitored for heavy hitters, in priority order.
MONITORED_ATTR_KEYS = (
    "app.product.id",
    "app.order.id",
    "app.session.id",
    "session.id",
)


def _as_msg(val) -> bytes:
    """An embedded-message field must arrive length-delimited; a
    corrupted tag that flips its wire type is malformed wire data
    (WireError, a ValueError), not a TypeError."""
    if not isinstance(val, bytes):
        raise wire.WireError(
            f"embedded message field carries wire type of {type(val).__name__}"
        )
    return val


def _anyvalue_str(buf: bytes) -> str | None:
    sv = wire.first(wire.scan_fields(buf), 1)
    if isinstance(sv, bytes):
        return sv.decode("utf-8", "replace")
    return None


def _attrs_to_dict(attr_bufs: list[bytes]) -> dict[str, str]:
    out: dict[str, str] = {}
    for kv_buf in attr_bufs:
        kv = wire.scan_fields(_as_msg(kv_buf))
        key = wire.first(kv, 1, b"")
        val_buf = wire.first(kv, 2)
        if key and isinstance(key, bytes) and isinstance(val_buf, bytes):
            sval = _anyvalue_str(val_buf)
            if sval is not None:
                out[key.decode("utf-8", "replace")] = sval
    return out


def _pick_attr(attrs: dict[str, str]) -> str | None:
    for key in MONITORED_ATTR_KEYS:
        if key in attrs:
            return attrs[key]
    return None


def decode_export_request(payload: bytes) -> list[SpanRecord]:
    """ExportTraceServiceRequest protobuf → SpanRecords."""
    records: list[SpanRecord] = []
    req = wire.scan_fields(payload)
    for rs_buf in req.get(1, []):
        rs = wire.scan_fields(_as_msg(rs_buf))
        service = "unknown"
        res_buf = wire.first(rs, 1)
        if res_buf:
            res = wire.scan_fields(_as_msg(res_buf))
            service = _attrs_to_dict(res.get(1, [])).get("service.name", service)
        for ss_buf in rs.get(2, []):
            ss = wire.scan_fields(_as_msg(ss_buf))
            for span_buf in ss.get(2, []):
                records.append(_decode_span(_as_msg(span_buf), service))
    return records


def _decode_event(ev_buf: bytes, span_start_ns: int) -> SpanEvent:
    ev = wire.scan_fields(_as_msg(ev_buf))
    t_ns = int(wire.first(ev, 1, 0) or 0)
    name_raw = wire.first(ev, 2)
    name = name_raw.decode("utf-8", "replace") if isinstance(name_raw, bytes) else ""
    attrs = _attrs_to_dict(ev.get(3, []))
    return SpanEvent(
        name=name,
        ts_offset_us=max(t_ns - span_start_ns, 0) / 1000.0,
        attrs=tuple(attrs.items()),
    )


def _decode_span(span_buf: bytes, service: str) -> SpanRecord:
    sp = wire.scan_fields(span_buf)
    trace_id = wire.first(sp, 1, b"\0") or b"\0"
    start = int(wire.first(sp, 7, 0) or 0)
    end = int(wire.first(sp, 8, 0) or 0)
    attrs = _attrs_to_dict(sp.get(9, []))
    is_error = False
    status_buf = wire.first(sp, 15)
    if status_buf:
        st = wire.scan_fields(_as_msg(status_buf))
        is_error = int(wire.first(st, 3, 0) or 0) == _STATUS_ERROR
    name_raw = wire.first(sp, 5)
    return SpanRecord(
        service=service,
        duration_us=max(end - start, 0) / 1000.0,
        trace_id=trace_id,
        is_error=is_error,
        attr=_pick_attr(attrs),
        name=name_raw.decode("utf-8", "replace") if isinstance(name_raw, bytes) else None,
        events=tuple(_decode_event(ev_buf, start) for ev_buf in sp.get(11, [])),
    )


def decode_export_request_columnar(payload: bytes) -> native.ColumnarSpans:
    """Protobuf request → native columnar batch (feed it to
    ``DetectorPipeline.submit_columnar``). There is no fallback: when the
    native library cannot load this raises with its build error."""
    if not native.available():
        raise RuntimeError(f"native OTLP decoder unavailable: {native.load_error()}")
    return native.decode_otlp(payload, MONITORED_ATTR_KEYS)


def decode_export_request_json(payload: bytes) -> list[SpanRecord]:
    """JSON-encoded OTLP (the collector's otlphttp json mode)."""
    doc = json.loads(payload)
    records: list[SpanRecord] = []
    for rs in doc.get("resourceSpans", []):
        service = "unknown"
        for attr in rs.get("resource", {}).get("attributes", []):
            if attr.get("key") == "service.name":
                service = attr.get("value", {}).get("stringValue", service)
        for ss in rs.get("scopeSpans", []):
            for sp in ss.get("spans", []):
                attrs = {
                    a.get("key"): a.get("value", {}).get("stringValue")
                    for a in sp.get("attributes", [])
                }
                start = int(sp.get("startTimeUnixNano", 0))
                end = int(sp.get("endTimeUnixNano", 0))
                events = tuple(
                    SpanEvent(
                        # str() guard: an explicit null/non-string name
                        # must not poison downstream joins.
                        name=str(ev.get("name") or ""),
                        ts_offset_us=max(
                            int(ev.get("timeUnixNano", 0) or 0) - start, 0
                        ) / 1000.0,
                        attrs=tuple(
                            (a.get("key"), a.get("value", {}).get("stringValue"))
                            for a in ev.get("attributes", [])
                            if a.get("key")
                            and a.get("value", {}).get("stringValue") is not None
                        ),
                    )
                    for ev in sp.get("events", [])
                )
                records.append(
                    SpanRecord(
                        service=service,
                        duration_us=max(end - start, 0) / 1000.0,
                        trace_id=bytes.fromhex(sp.get("traceId", "00")),
                        is_error=sp.get("status", {}).get("code") in (2, "STATUS_CODE_ERROR"),
                        attr=_pick_attr({k: v for k, v in attrs.items() if v}),
                        name=sp.get("name"),
                        events=events,
                    )
                )
    return records


def _kv_str(key: str, value: str) -> bytes:
    any_value = wire.encode_len(1, value.encode())
    return wire.encode_len(1, key.encode()) + wire.encode_len(2, any_value)


def encode_export_request(records: list[SpanRecord], t_ns: int) -> bytes:
    """SpanRecords → ExportTraceServiceRequest protobuf, the inverse of
    :func:`decode_export_request` over service, trace id (padded to 16
    bytes), name, duration (spans end at ``t_ns``), the monitored attr
    (as ``app.product.id``), events and error status. One resource block
    per service, spans in input order within each."""
    by_service: dict[str, list[SpanRecord]] = {}
    for rec in records:
        by_service.setdefault(rec.service, []).append(rec)
    out = bytearray()
    for service, recs in by_service.items():
        resource = wire.encode_len(1, _kv_str("service.name", service))
        spans = bytearray()
        for rec in recs:
            start = t_ns - int(max(rec.duration_us, 0.0) * 1000.0)
            tid = rec.trace_id
            tid = (
                tid.to_bytes(16, "big") if isinstance(tid, int)
                else (bytes(tid) + b"\0" * 16)[:16]
            )
            span = (
                wire.encode_len(1, tid)
                + wire.encode_len(5, (rec.name or "span").encode())
                + wire.encode_fixed64(7, start)
                + wire.encode_fixed64(8, t_ns)
            )
            if rec.attr:
                span += wire.encode_len(9, _kv_str("app.product.id", rec.attr))
            for ev in rec.events:
                ev_body = wire.encode_fixed64(
                    1, start + int(max(ev.ts_offset_us, 0.0) * 1000.0)
                ) + wire.encode_len(2, ev.name.encode())
                for k, v in ev.attrs:
                    ev_body += wire.encode_len(3, _kv_str(k, str(v)))
                span += wire.encode_len(11, ev_body)
            if rec.is_error:
                span += wire.encode_len(15, wire.encode_int(3, _STATUS_ERROR))
            spans += wire.encode_len(2, span)
        rs = wire.encode_len(1, resource) + wire.encode_len(2, bytes(spans))
        out += wire.encode_len(1, rs)
    return bytes(out)
