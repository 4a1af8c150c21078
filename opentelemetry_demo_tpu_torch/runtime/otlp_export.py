"""OTLP export: span and log bodies, and the shared background poster.

The detector ships its own telemetry to an OTLP collector: the sampled
batch self-traces (``runtime.selftrace``) as ``ExportTraceServiceRequest``
bodies and the verdicts' evidence bundles (``runtime.provenance``) as
``ExportLogsServiceRequest`` bodies. Encoding happens on the caller's
thread; the POST happens on a :class:`BackgroundPoster`'s sender thread,
so the pump and the harvester never wait on the network. The encoded
bodies are the reference package's bytes for the same inputs.
"""

from __future__ import annotations

import collections
import random
import threading
import time
import urllib.error
import urllib.request

from . import wire
from .tensorize import SpanRecord


class RetryLater(Exception):
    """The sink said "not now" — a RETRYABLE refusal, not an error.

    Raised by send hooks on HTTP 429 / gRPC ``RESOURCE_EXHAUSTED`` (the
    saturated receiver's refusal). The poster keeps the body, backs off
    (honoring ``retry_after_s`` when the server sent one), and retries —
    instead of counting an error and hammering a peer that just asked
    for air.
    """

    def __init__(self, retry_after_s: float | None = None):
        super().__init__(
            f"sink saturated (retry after {retry_after_s or 'unspecified'}s)"
        )
        self.retry_after_s = retry_after_s


def _parse_retry_after(value: str | None) -> float | None:
    """Retry-After header → seconds (delta-seconds form only; an
    HTTP-date from a saturated peer isn't worth a date parser here)."""
    if not value:
        return None
    try:
        return max(float(value), 0.0)
    except ValueError:
        return None


class BackgroundPoster:
    """Bounded queue + one sender thread; drop-OLDEST on overflow.

    Drop-oldest matches exporter semantics for both signals: metric
    snapshots are cumulative (a later export supersedes a lost one) and
    span batches are telemetry, where freshness beats completeness when
    the sink cannot keep up (an OTLP collector's sending queue drops the
    same way).

    A sink that answers 429/``RESOURCE_EXHAUSTED`` (see
    :class:`RetryLater`) is NOT an error: the body goes back to the
    queue head and the sender backs off — capped exponential with full
    jitter, floored at the server's Retry-After hint — while the
    bounded queue keeps absorbing (and drop-oldest keeps bounding)
    producer traffic. ``retries`` counts the refusals;
    ``queue_high_water`` records the deepest backlog since last read
    (``take_high_water``).
    """

    BACKOFF_BASE_S = 0.1
    BACKOFF_CAP_S = 5.0

    def __init__(self, endpoint: str, content_type: str,
                 timeout_s: float = 2.0, queue_max: int = 16,
                 send=None):
        """``send(body)`` overrides the default HTTP POST (e.g. a gRPC
        unary call); it runs on the sender thread and signals failure by
        raising (``RetryLater`` for a saturated sink)."""
        self.endpoint = endpoint
        self.content_type = content_type
        self.timeout_s = timeout_s
        self.sent = 0
        self.errors = 0
        self.dropped = 0
        self.retries = 0  # retryable refusals (429/RESOURCE_EXHAUSTED)
        self.queue_high_water = 0
        self._send = send or self._http_send
        self._queue: "collections.deque[bytes]" = collections.deque()
        self._queue_max = queue_max
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        # Backoff sleeps wait on THIS event (set by close()) so a
        # saturated sink never pins shutdown for a full backoff window.
        self._stop_event = threading.Event()
        self._consecutive_retries = 0
        self._thread: threading.Thread | None = None

    def _http_send(self, body: bytes) -> None:
        req = urllib.request.Request(
            self.endpoint,
            data=body,
            headers={"Content-Type": self.content_type},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
        except urllib.error.HTTPError as e:
            if e.code == 429:
                raise RetryLater(
                    _parse_retry_after(e.headers.get("Retry-After"))
                ) from e
            raise

    def submit(self, body: bytes) -> None:
        with self._lock:
            if self._stop:
                # After close() the sender thread has exited (or is
                # exiting); enqueueing would black-hole the body while
                # the counters report healthy. Count it as dropped so a
                # misused exporter is visible in its own stats.
                self.dropped += 1
                return
            self._queue.append(body)
            while len(self._queue) > self._queue_max:
                self._queue.popleft()
                self.dropped += 1
            self.queue_high_water = max(
                self.queue_high_water, len(self._queue)
            )
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._send_loop, name="otlp-export", daemon=True
                )
                self._thread.start()
        self._wake.set()

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def take_high_water(self) -> int:
        """Deepest backlog since the last call (window-reset read)."""
        with self._lock:
            peak = self.queue_high_water
            self.queue_high_water = len(self._queue)
            return peak

    def _retry_delay(self, hint: float | None) -> float:
        """Capped exponential with full jitter, floored at the server's
        Retry-After hint — never shorter than asked, never unbounded."""
        n = self._consecutive_retries
        self._consecutive_retries += 1
        base = min(self.BACKOFF_BASE_S * (2.0 ** min(n, 8)), self.BACKOFF_CAP_S)
        delay = base * (0.5 + random.random())  # jitter in [0.5, 1.5)
        if hint:
            delay = max(delay, min(hint, self.BACKOFF_CAP_S))
        return delay

    def _send_loop(self) -> None:
        while True:
            self._wake.wait(timeout=0.2)
            self._wake.clear()
            while True:
                with self._lock:
                    if not self._queue:
                        self._idle.set()
                        if self._stop:
                            return
                        break
                    self._idle.clear()
                    body = self._queue.popleft()
                try:
                    self._send(body)
                    self.sent += 1
                    self._consecutive_retries = 0
                except RetryLater as e:
                    self.retries += 1
                    with self._lock:
                        stop = self._stop
                        if stop or len(self._queue) >= self._queue_max:
                            # Shutting down, or the queue refilled while
                            # we were refused: the body has nowhere to
                            # wait — same drop-oldest outcome.
                            self.dropped += 1
                        else:
                            self._queue.appendleft(body)
                    if not stop:
                        self._stop_event.wait(
                            self._retry_delay(e.retry_after_s)
                        )
                except Exception:  # noqa: BLE001 — the sender loop is
                    # the only drain of the queue: any transport fault
                    # is counted and the next batch retried, never a
                    # dead exporter thread.
                    self.errors += 1

    def flush(self, timeout_s: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                empty = not self._queue
            if empty and self._idle.is_set():
                return True
            self._wake.set()
            time.sleep(0.005)
        return False

    def close(self) -> None:
        with self._lock:
            self._stop = True
            thread = self._thread
        self._wake.set()
        self._stop_event.set()  # abort any in-progress backoff sleep
        if thread is not None:
            thread.join(timeout=self.timeout_s + 1.0)
        closer = getattr(self._send, "close", None)
        if closer is not None:
            closer()


def _norm_trace_id(trace_id: bytes | int) -> bytes:
    if isinstance(trace_id, int):
        return trace_id.to_bytes(16, "big", signed=False)
    raw = bytes(trace_id)
    return (raw + b"\0" * 16)[:16]


def _kv_str(key: str, value: str) -> bytes:
    any_value = wire.encode_len(1, value.encode())
    return wire.encode_len(1, key.encode()) + wire.encode_len(2, any_value)


def encode_export_request(
    records: list[SpanRecord], t_ns: int | None = None
) -> bytes:
    """SpanRecords → ExportTraceServiceRequest protobuf.

    The inverse of ``otlp.decode_export_request`` over the fields this
    framework carries (service → resource attr, duration → start/end,
    error → status code 2, monitored attr → ``app.product.id``) —
    round-trip pinned by tests. One resource block per service, spans in
    input order within each.
    """
    if t_ns is None:
        t_ns = int(time.time() * 1e9)
    by_service: dict[str, list[SpanRecord]] = {}
    for rec in records:
        by_service.setdefault(rec.service, []).append(rec)
    out = b""
    for service, recs in by_service.items():
        resource = wire.encode_len(1, _kv_str("service.name", service))
        spans = b""
        for rec in recs:
            end = t_ns
            start = end - int(max(rec.duration_us, 0.0) * 1000.0)
            span = (
                wire.encode_len(1, _norm_trace_id(rec.trace_id))
                + wire.encode_len(5, (rec.name or "span").encode())
                + wire.encode_fixed64(7, start)
                + wire.encode_fixed64(8, end)
            )
            if rec.attr:
                span += wire.encode_len(9, _kv_str("app.product.id", rec.attr))
            # Span.events (field 11): Event{time_unix_nano=1, name=2,
            # attributes=3} per opentelemetry-proto trace/v1. Offsets
            # are span-start-relative in SpanRecord; the wire wants
            # absolute nanos.
            for ev in rec.events:
                ev_body = (
                    wire.encode_fixed64(
                        1, start + int(max(ev.ts_offset_us, 0.0) * 1000.0)
                    )
                    + wire.encode_len(2, ev.name.encode())
                )
                for k, v in ev.attrs:
                    ev_body += wire.encode_len(3, _kv_str(k, str(v)))
                span += wire.encode_len(11, ev_body)
            if rec.is_error:
                span += wire.encode_len(15, wire.encode_int(3, 2))  # ERROR
            spans += wire.encode_len(2, span)
        # One ScopeSpans submessage whose repeated `spans` fields are
        # ``spans`` (field 2 of ScopeSpans == field 2 of ResourceSpans'
        # entry — wrap ONCE).
        rs = wire.encode_len(1, resource) + wire.encode_len(2, spans)
        out += wire.encode_len(1, rs)
    return out


class grpc_send:
    """A ``send`` hook for :class:`BackgroundPoster` that ships bodies
    over OTLP/gRPC (the collector exporter default) instead of HTTP.
    ``signal`` ∈ {"traces", "metrics", "logs"}. Lazily opens the channel on the
    sender thread's first call; :meth:`close` (invoked by the poster's
    ``close``) shuts the channel down — grpcio channels are not
    reliably collected by GC and would leak sockets/poller threads."""

    def __init__(self, target: str, signal: str, timeout_s: float = 2.0):
        self._target = target
        self._signal = signal
        self._timeout_s = timeout_s
        self._channel = None
        self._fn = None

    def __call__(self, body: bytes) -> None:
        import grpc

        if self._fn is None:
            from .otlp_grpc import LOGS_EXPORT, METRICS_EXPORT, TRACE_EXPORT

            self._channel = grpc.insecure_channel(self._target)
            path = {
                "traces": TRACE_EXPORT,
                "metrics": METRICS_EXPORT,
                "logs": LOGS_EXPORT,
            }[self._signal]
            self._fn = self._channel.unary_unary(
                path, request_serializer=None, response_deserializer=None
            )
        try:
            self._fn(body, timeout=self._timeout_s)
        except grpc.RpcError as e:
            code = e.code() if callable(getattr(e, "code", None)) else None
            if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
                # The receiver's saturation refusal (otlp_grpc puts the
                # hint in trailing metadata): retryable, back off.
                hint = None
                md = getattr(e, "trailing_metadata", None)
                for key, value in (md() if callable(md) else ()) or ():
                    if key == "retry-after-s":
                        hint = _parse_retry_after(value)
                raise RetryLater(hint) from e
            raise

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None
            self._fn = None


def split_endpoint(endpoint: str) -> tuple[str, str]:
    """("grpc"|"http", target) from an exporter endpoint string.

    ``grpc://host:4317`` selects the gRPC transport; anything else is
    OTLP/HTTP (scheme defaulted to http:// when absent)."""
    if endpoint.startswith("grpc://"):
        # A gRPC channel target is host:port — tolerate the trailing
        # slash endpoint env vars commonly carry.
        return "grpc", endpoint[len("grpc://"):].rstrip("/")
    if "://" not in endpoint:
        endpoint = "http://" + endpoint
    return "http", endpoint


class _ExporterBase:
    """Counters/flush/close surface shared by the concrete exporters."""

    _poster: BackgroundPoster

    @property
    def sent(self) -> int:
        return self._poster.sent

    @property
    def errors(self) -> int:
        return self._poster.errors

    @property
    def dropped(self) -> int:
        return self._poster.dropped

    @property
    def retries(self) -> int:
        return self._poster.retries

    def queue_depth(self) -> int:
        return self._poster.queue_depth()

    def publish_stats(self, registry, signal: str = "traces") -> None:
        """Mirror the sender-queue counters into a MetricRegistry:
        ``anomaly_export_dropped_total{signal=}`` (drop-oldest losses) and
        ``anomaly_export_queue_depth{signal=}`` (the high-water mark of
        the backlog since the last publish, so a between-scrapes burst
        still shows). Call on any periodic cadence — delta tracking is
        internal, double publishing never double counts."""
        from ..telemetry import metrics as tm

        dropped = self._poster.dropped
        delta = dropped - getattr(self, "_dropped_published", 0)
        if delta:
            registry.counter_add(
                tm.ANOMALY_EXPORT_DROPPED, float(delta), signal=signal
            )
        self._dropped_published = dropped
        registry.gauge_set(
            tm.ANOMALY_EXPORT_QUEUE_DEPTH,
            float(self._poster.take_high_water()),
            signal=signal,
        )

    def flush(self, timeout_s: float = 5.0) -> bool:
        return self._poster.flush(timeout_s)

    def close(self) -> None:
        self._poster.close()


def make_traces_poster(
    endpoint: str, timeout_s: float = 2.0, queue_max: int = 64
) -> BackgroundPoster:
    """A BackgroundPoster shipping ExportTraceServiceRequest bodies to
    an OTLP endpoint — ``grpc://host:port`` selects the gRPC
    transport, anything else posts to ``/v1/traces``. The ONE
    trace-transport selection, shared by the shop-side span exporter
    and the detector's self-tracer (runtime.selftrace)."""
    scheme, target = split_endpoint(endpoint)
    if scheme == "grpc":
        return BackgroundPoster(
            target, "application/grpc", timeout_s, queue_max,
            send=grpc_send(target, "traces", timeout_s),
        )
    target = target.rstrip("/")
    if not target.endswith("/v1/traces"):
        target += "/v1/traces"
    return BackgroundPoster(
        target, "application/x-protobuf", timeout_s, queue_max
    )


class OtlpHttpSpanExporter(_ExporterBase):
    """A ``(now, records)`` span sink that ships each batch to an OTLP
    ``/v1/traces`` endpoint from the background sender. ``grpc://host:port`` endpoints
    ship over OTLP/gRPC instead (same callable surface)."""

    def __init__(self, endpoint: str, timeout_s: float = 2.0, queue_max: int = 64):
        self._poster = make_traces_poster(endpoint, timeout_s, queue_max)

    def __call__(self, now: float, records: list[SpanRecord]) -> None:
        if records:
            self._poster.submit(encode_export_request(records))


def encode_logs_request(docs, t_ns: int | None = None) -> bytes:
    """LogDocs → ExportLogsServiceRequest protobuf.

    The inverse of ``otlp.decode_logs_request`` over the fields the
    log pipeline carries: one ResourceLogs block per service,
    LogRecord{time_unix_nano=1, severity_number=2, severity_text=3,
    body=5, attributes=6, trace_id=9}. ``doc.ts`` is virtual-clock seconds; the wire wants
    wall nanos, so ``t_ns`` (default now) stamps the batch and per-doc
    ts rides as the relative offset from the newest doc.
    """
    if t_ns is None:
        t_ns = int(time.time() * 1e9)
    by_service: dict[str, list] = {}
    for doc in docs:
        by_service.setdefault(doc.service, []).append(doc)
    # One anchor across the whole batch (not per service): the newest
    # doc maps to t_ns and every other doc keeps its relative offset,
    # so cross-service ordering survives the wall-clock re-stamping.
    newest = max((d.ts for d in docs), default=0.0)
    # SeverityNumber (field 2) is the spec's PRIMARY severity field —
    # a backend keying on it must not see UNSPECIFIED; the store's
    # 5-level scale maps to the canonical band floors.
    sev_num = {"DEBUG": 5, "INFO": 9, "WARN": 13, "ERROR": 17, "FATAL": 21}
    out = b""
    for service, items in by_service.items():
        resource = wire.encode_len(1, _kv_str("service.name", service))
        records = b""
        for doc in items:
            sev = doc.severity or "INFO"
            rec = (
                wire.encode_fixed64(1, max(t_ns + int((doc.ts - newest) * 1e9), 0))
                + wire.encode_int(2, sev_num.get(sev, 9))
                + wire.encode_len(3, sev.encode())
                + wire.encode_len(
                    5, wire.encode_len(1, (doc.body or "").encode())
                )
            )
            for k, v in (doc.attrs or {}).items():
                rec += wire.encode_len(6, _kv_str(k, str(v)))
            if doc.trace_id:
                rec += wire.encode_len(9, _norm_trace_id(doc.trace_id))
            records += wire.encode_len(2, rec)
        rl = wire.encode_len(1, resource) + wire.encode_len(2, records)
        out += wire.encode_len(1, rl)
    return out


class OtlpHttpLogsExporter(_ExporterBase):
    """A ``(now, docs)`` log sink that ships each batch to an OTLP
    ``/v1/logs`` endpoint from the background sender; the evidence
    bundles leave the detector this way (``provenance.log_doc``).
    ``grpc://`` endpoints ship over OTLP/gRPC."""

    def __init__(self, endpoint: str, timeout_s: float = 2.0, queue_max: int = 64):
        scheme, target = split_endpoint(endpoint)
        if scheme == "grpc":
            self._poster = BackgroundPoster(
                target, "application/grpc", timeout_s, queue_max,
                send=grpc_send(target, "logs", timeout_s),
            )
        else:
            target = target.rstrip("/")
            if not target.endswith("/v1/logs"):
                target += "/v1/logs"
            self._poster = BackgroundPoster(
                target, "application/x-protobuf", timeout_s, queue_max
            )

    def __call__(self, now: float, docs: list) -> None:
        if docs:
            self._poster.submit(encode_logs_request(docs))
