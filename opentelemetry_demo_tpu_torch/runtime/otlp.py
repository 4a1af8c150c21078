"""OTLP span decoding: export bodies → :class:`SpanRecord` lists.

``decode_export_request`` reads ``ExportTraceServiceRequest`` protobuf
(``application/x-protobuf``) with the schema projection below;
``decode_export_request_json`` reads the JSON encoding.
``decode_export_request_columnar`` is the native decoder
(``runtime.native``) on one body: columns for
``DetectorPipeline.submit_columnar``. The record decoders are its plain
version (same columns, same verdicts) and the JSON path's decoder.
``encode_export_request`` is the protobuf inverse over the fields this
package carries (fixtures and the chip smoke run).
``decode_logs_request`` and ``decode_logs_request_json`` read the logs
signal (``ExportLogsServiceRequest``) into
:class:`~..telemetry.logstore.LogDoc` s.

:class:`OtlpHttpReceiver` is the collector-export seam: an ``otlphttp``
exporter pointed at it ``POST`` s ``/v1/traces``, ``/v1/metrics`` and
``/v1/logs``, and its answers (200, 400, 413, 429 with
``Retry-After``, 500, 503) are the backpressure contract exporters
retry by.

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
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from ..telemetry.logstore import LogDoc, normalize_severity
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


def _severity_from_number(num: int) -> str | None:
    """OTLP SeverityNumber → the store's scale (None if unset).

    Spec bands: 1-4 TRACE, 5-8 DEBUG, 9-12 INFO, 13-16 WARN,
    17-20 ERROR, 21-24 FATAL."""
    if num <= 0:
        return None
    if num <= 8:
        return "DEBUG"
    if num <= 12:
        return "INFO"
    if num <= 16:
        return "WARN"
    if num <= 20:
        return "ERROR"
    return "FATAL"


def decode_logs_request(payload: bytes) -> list[LogDoc]:
    """ExportLogsServiceRequest protobuf → LogDocs.

    Field numbers of the public opentelemetry-proto logs/v1:
    ResourceLogs{resource=1, scope_logs=2}, ScopeLogs{log_records=2},
    LogRecord{time_unix_nano=1, severity_number=2, severity_text=3,
    body=5, attributes=6, trace_id=9, observed_time_unix_nano=11}. The
    spec's fallbacks hold: severity text is optional (the number alone
    is valid), and time_unix_nano=0 means "use the observed time".
    """
    docs: list[LogDoc] = []
    req = wire.scan_fields(payload)
    for rl_buf in req.get(1, []):
        rl = wire.scan_fields(rl_buf)
        service = "unknown"
        res_buf = wire.first(rl, 1)
        if res_buf:
            res = wire.scan_fields(res_buf)
            service = _attrs_to_dict(res.get(1, [])).get("service.name", service)
        for sl_buf in rl.get(2, []):
            sl = wire.scan_fields(sl_buf)
            for lr_buf in sl.get(2, []):
                lr = wire.scan_fields(lr_buf)
                sev_raw = wire.first(lr, 3)
                sev_text = (
                    sev_raw.decode("utf-8", "replace")
                    if isinstance(sev_raw, bytes) and sev_raw else None
                )
                if sev_text is None:
                    sev_text = _severity_from_number(int(wire.first(lr, 2, 0) or 0))
                body_buf = wire.first(lr, 5)
                body = _anyvalue_str(body_buf) if isinstance(body_buf, bytes) else None
                trace_id = wire.first(lr, 9)
                t_ns = int(wire.first(lr, 1, 0) or 0)
                if t_ns == 0:
                    t_ns = int(wire.first(lr, 11, 0) or 0)
                docs.append(LogDoc(
                    ts=t_ns / 1e9,
                    service=service,
                    severity=normalize_severity(sev_text),
                    body=body or "",
                    attrs=_attrs_to_dict(lr.get(6, [])),
                    trace_id=trace_id if isinstance(trace_id, bytes) and trace_id else None,
                ))
    return docs


def decode_logs_request_json(payload: bytes) -> list[LogDoc]:
    """JSON-encoded OTLP logs (the collector's otlphttp json mode)."""
    doc = json.loads(payload)
    docs: list[LogDoc] = []
    for rl in doc.get("resourceLogs", []):
        service = "unknown"
        for attr in rl.get("resource", {}).get("attributes", []):
            if attr.get("key") == "service.name":
                service = attr.get("value", {}).get("stringValue", service)
        for sl in rl.get("scopeLogs", []):
            for lr in sl.get("logRecords", []):
                attrs = {
                    a.get("key"): a.get("value", {}).get("stringValue")
                    for a in lr.get("attributes", [])
                }
                trace_hex = lr.get("traceId") or ""
                sev_text = lr.get("severityText") or _severity_from_number(
                    int(lr.get("severityNumber", 0) or 0)
                )
                t_ns = int(lr.get("timeUnixNano", 0) or 0)
                if t_ns == 0:
                    t_ns = int(lr.get("observedTimeUnixNano", 0) or 0)
                docs.append(LogDoc(
                    ts=t_ns / 1e9,
                    service=service,
                    severity=normalize_severity(sev_text),
                    body=lr.get("body", {}).get("stringValue", ""),
                    attrs={k: v for k, v in attrs.items() if v is not None},
                    trace_id=bytes.fromhex(trace_hex) if trace_hex else None,
                ))
    return docs


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


def _retry_after_header(hint: float) -> str:
    """Integer delta-seconds (RFC 7231; OTLP SDKs parse an int), rounded
    up so the hint never undershoots the pace asked for."""
    return str(max(int(-(-hint // 1)), 1))


class _Server(ThreadingHTTPServer):
    # The answers are HTTP/1.0, so an exporter connects once a request:
    # socketserver's listen backlog of 5 would drop the SYNs of a few
    # concurrent exporters, which then wait out TCP's retry (1 s, 3 s, 7 s).
    request_queue_size = 128


def _is_traces(path: str) -> bool:
    """Every path but the metrics and logs routes carries traces."""
    return not (path.endswith("/v1/metrics") or path.endswith("/v1/logs"))


class OtlpHttpReceiver:
    """Threaded OTLP/HTTP receiver feeding one callback per signal.

    ``POST /v1/traces`` (and any unrecognised path) decodes spans.
    ``on_records`` is called from the handler thread with each request's
    SpanRecords. With ``on_columnar``, protobuf bodies go through the
    native decoder instead and ``on_columnar`` gets the columns (the
    pipeline's ``submit_columnar``). With ``on_payload`` (the decode
    pool's ``submit``, ``runtime.ingest_pool``) protobuf trace bodies go
    raw to the pool and the handler waits only on the request's
    ticket; a malformed body still answers 400 (the ticket carries its
    own decode error even when it was decoded in a batch), 200 still
    means the rows are enqueued, and a full pool queue answers the same
    retryable 429 as pipeline saturation.

    ``POST /v1/metrics`` decodes OTLP metrics into ``on_metric_records``
    and ``POST /v1/logs`` OTLP logs into ``on_log_records``. Without the
    callback a signal is acknowledged and dropped.

    Hardening: a malformed body answers 400, a truncated body 400, an
    oversized one 413 before a byte of it is read; each is tallied in
    ``rejects[reason]`` and reported through ``on_reject``. A client
    that stops mid-request releases its handler thread through the
    connection timeout. None of these stops the server.

    Backpressure (``retry_after``): while it returns a hint, trace
    exports answer 429 with an integer ``Retry-After``, tallied as
    ``rejects["saturated"]``. The body is read first (it is bounded by
    the oversized check): a 429 sent over unread bytes would reset a
    client still sending, which would then see a connection error
    instead of the retryable status. Metrics and logs stay admitted:
    they arrive at scrape cadence.
    """

    # StreamRequestHandler applies this to the connection, so a client
    # that stops sending frees its thread.
    CONNECTION_TIMEOUT_S = 10.0

    def __init__(
        self,
        on_records: Callable[[list[SpanRecord]], None],
        host: str = "0.0.0.0",
        port: int = 4318,
        on_columnar: Callable | None = None,
        on_metric_records: Callable | None = None,
        on_log_records: Callable | None = None,
        on_reject: Callable[[str], None] | None = None,
        max_body_bytes: int = 16 << 20,
        retry_after: Callable[[], float | None] | None = None,
        on_payload: Callable | None = None,
    ):
        if on_columnar is not None and not native.available():
            raise RuntimeError(f"native OTLP decoder unavailable: {native.load_error()}")
        receiver = self

        class Handler(BaseHTTPRequestHandler):
            timeout = receiver.CONNECTION_TIMEOUT_S

            def do_POST(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    receiver._reject("bad_length")
                    self._answer(400)
                    return
                if length > receiver.max_body_bytes:
                    # Refuse without reading, and close so the unread
                    # remainder is never parsed as a next request.
                    receiver._reject("oversized")
                    self.send_response(413)
                    self.send_header("Connection", "close")
                    self.end_headers()
                    self.close_connection = True
                    return
                traces = _is_traces(path)
                if traces and receiver.retry_after is not None:
                    hint = receiver.retry_after()
                    if hint is not None:
                        if self._read(length) is None:
                            return
                        receiver._reject("saturated")
                        self._answer(429, _retry_after_header(hint))
                        return
                body = self._read(length)
                if body is None:
                    return
                if len(body) < length:
                    # The client promised more bytes than it sent.
                    receiver._reject("truncated")
                    self._answer(400)
                    return
                is_json = "json" in (self.headers.get("Content-Type") or "")
                if traces and not is_json and receiver.on_payload is not None:
                    self._answer(*receiver._pool_verdict(body))
                    return
                try:
                    if path.endswith("/v1/logs"):
                        decoded = (decode_logs_request_json if is_json else decode_logs_request)(body)
                        sink = receiver.on_log_records
                    elif path.endswith("/v1/metrics"):
                        from . import otlp_metrics

                        decoded = (
                            otlp_metrics.decode_metrics_request_json if is_json
                            else otlp_metrics.decode_metrics_request
                        )(body)
                        sink = receiver.on_metric_records
                    elif is_json:
                        decoded, sink = decode_export_request_json(body), receiver.on_records
                    elif receiver.on_columnar is not None:
                        decoded = native.decode_otlp(body, MONITORED_ATTR_KEYS)
                        sink = receiver.on_columnar
                    else:
                        decoded, sink = decode_export_request(body), receiver.on_records
                except Exception:  # noqa: BLE001 — whatever the client's bytes raise
                    # (WireError, JSONDecodeError, TypeError from a wrong
                    # shape) is the client's fault. Only decoding is in
                    # scope: a failing callback below is a server bug and
                    # must surface, not pass as a 400.
                    receiver._reject("malformed")
                    self._answer(400)
                    return
                if sink is not None:
                    sink(decoded)
                self._answer(200)

            def _read(self, length: int) -> bytes | None:
                """The body, or None when the client went away."""
                try:
                    return self.rfile.read(length)
                except OSError:
                    receiver._reject("disconnect")
                    self.close_connection = True
                    return None

            def _answer(self, status: int, retry_after: str | None = None) -> None:
                try:
                    self.send_response(status)
                    if retry_after is not None:
                        self.send_header("Retry-After", retry_after)
                    if status == 200:
                        self.send_header("Content-Type", "application/x-protobuf")
                    self.end_headers()
                except OSError:
                    # Reset between upload and answer: the data is in
                    # (at least once), only the answer was lost.
                    receiver._reject("disconnect")
                    self.close_connection = True

            def log_message(self, *args):  # no per-request stderr line
                pass

        self.on_records = on_records
        self.on_columnar = on_columnar
        self.on_payload = on_payload
        self.on_metric_records = on_metric_records
        self.on_log_records = on_log_records
        self.on_reject = on_reject
        self.max_body_bytes = max_body_bytes
        self.retry_after = retry_after
        # reason → count.
        self.rejects: dict[str, int] = {}
        self._rejects_lock = threading.Lock()
        self._server = _Server((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="otlp-receiver", daemon=True
        )

    def _pool_verdict(self, body: bytes) -> tuple[int, str | None]:
        """Hand ``body`` to the decode pool and turn its ticket into a
        status and a Retry-After value."""
        from .ingest_pool import IngestPoolSaturated, IngestWorkerError

        try:
            ticket = self.on_payload(body)
        except IngestPoolSaturated:
            self._reject("saturated")
            return 429, "1"
        try:
            ticket.result()
        except TimeoutError:
            # A wedged flush: the rows may still land, but the client
            # must not count them as accepted. 503 is retryable.
            return 503, "1"
        except IngestWorkerError:
            # The flush failed on our side: 5xx, never a 400.
            return 500, None
        except Exception:  # noqa: BLE001 — the request's own decode verdict
            self._reject("malformed")
            return 400, None
        return 200, None

    def _reject(self, reason: str) -> None:
        with self._rejects_lock:
            self.rejects[reason] = self.rejects.get(reason, 0) + 1
        if self.on_reject is not None:
            try:
                self.on_reject(reason)
            except Exception:  # noqa: BLE001 — metrics must not stop ingest
                pass

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def alive(self) -> bool:
        """The serve thread is running."""
        return self._thread.is_alive()

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        # shutdown() waits on an event only serve_forever sets: on a
        # server never started it would wait for ever.
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()
