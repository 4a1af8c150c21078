"""OTLP/gRPC receiver (:4317): the collector's primary telemetry ingress.

grpcio with generic raw-bytes handlers: no generated stubs, no proto
runtime. Request bytes go to the same wire decoders the HTTP receiver
uses (``runtime.otlp``, ``runtime.otlp_metrics``), and the answer is the
empty Export*ServiceResponse (zero bytes is a valid empty proto3
message). Service and method names are the public OTLP protocol's
(``opentelemetry.proto.collector.{trace,metrics,logs}.v1``), so any
OTLP gRPC exporter talks to it unchanged.

``grpc`` is imported inside the functions, so the package imports
without it.
"""

from __future__ import annotations

import threading
from typing import Callable

from . import native, otlp, otlp_metrics
from .grpc_health import HealthService
from .tensorize import SpanRecord

TRACE_EXPORT = "/opentelemetry.proto.collector.trace.v1.TraceService/Export"
METRICS_EXPORT = "/opentelemetry.proto.collector.metrics.v1.MetricsService/Export"
LOGS_EXPORT = "/opentelemetry.proto.collector.logs.v1.LogsService/Export"


class OtlpGrpcReceiver:
    """The gRPC twin of :class:`~.otlp.OtlpHttpReceiver`, with the same
    callbacks.

    ``on_records`` gets decoded SpanRecords per Export call;
    ``on_columnar`` the native decoder's columns; ``on_payload`` (the
    decode pool's ``submit``) the raw request bytes, the call waiting
    only on its ticket. A malformed payload answers ``INVALID_ARGUMENT``
    and is tallied in ``rejects``/``on_reject``; an oversized message is
    refused by grpc itself (``RESOURCE_EXHAUSTED`` through
    ``max_receive_message_length``) before a handler runs. A failing
    callback surfaces as ``INTERNAL``.

    Backpressure (``retry_after``): while the pipeline is saturated,
    trace Exports abort with ``RESOURCE_EXHAUSTED`` (OTLP's retryable
    status) and a ``retry-after-s`` trailing-metadata hint, tallied as
    ``rejects["saturated"]``; a full pool queue answers the same with a
    hint of 1 s. Metrics and logs Exports stay admitted.

    ``component_status`` lets the attached grpc.health.v1 service answer
    per-component Check requests beside the server-wide status.
    """

    def __init__(
        self,
        on_records: Callable[[list[SpanRecord]], None],
        host: str = "0.0.0.0",
        port: int = 4317,
        on_columnar: Callable | None = None,
        on_metric_records: Callable | None = None,
        on_log_records: Callable | None = None,
        max_workers: int = 4,
        on_reject: Callable[[str], None] | None = None,
        max_body_bytes: int = 16 << 20,
        component_status: Callable[[str], int | None] | None = None,
        retry_after: Callable[[], float | None] | None = None,
        on_payload: Callable | None = None,
    ):
        import grpc
        from concurrent import futures

        if on_columnar is not None and not native.available():
            raise RuntimeError(f"native OTLP decoder unavailable: {native.load_error()}")
        self.on_records = on_records
        self.on_columnar = on_columnar
        self.on_payload = on_payload
        self.on_metric_records = on_metric_records
        self.on_log_records = on_log_records
        self.on_reject = on_reject
        self.retry_after = retry_after
        self.rejects: dict[str, int] = {}
        self._rejects_lock = threading.Lock()
        receiver = self

        def _reject(reason: str) -> None:
            with receiver._rejects_lock:
                receiver.rejects[reason] = receiver.rejects.get(reason, 0) + 1
            if receiver.on_reject is not None:
                try:
                    receiver.on_reject(reason)
                except Exception:  # noqa: BLE001 — metrics must not stop ingest
                    pass

        def _malformed(context) -> None:
            _reject("malformed")
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "malformed OTLP payload")

        def export_traces(request: bytes, context) -> bytes:
            if receiver.retry_after is not None:
                hint = receiver.retry_after()
                if hint is not None:
                    _reject("saturated")
                    context.set_trailing_metadata((("retry-after-s", f"{hint:g}"),))
                    context.abort(
                        grpc.StatusCode.RESOURCE_EXHAUSTED,
                        f"pipeline saturated; retry after {hint:g}s",
                    )
            if receiver.on_payload is not None:
                from .ingest_pool import IngestPoolSaturated, IngestWorkerError

                try:
                    ticket = receiver.on_payload(request)
                except IngestPoolSaturated:
                    _reject("saturated")
                    context.set_trailing_metadata((("retry-after-s", "1"),))
                    context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, "ingest pool saturated; retry")
                try:
                    ticket.result()
                except TimeoutError:
                    # A wedged flush: retryable, never the client's fault.
                    context.abort(grpc.StatusCode.UNAVAILABLE, "ingest flush timed out; retry")
                except IngestWorkerError:
                    raise  # our fault: INTERNAL, never INVALID_ARGUMENT
                except Exception:  # noqa: BLE001 — the request's decode verdict
                    _malformed(context)
                return b""
            try:
                if receiver.on_columnar is not None:
                    decoded = native.decode_otlp(request, otlp.MONITORED_ATTR_KEYS)
                else:
                    decoded = otlp.decode_export_request(request)
            except Exception:  # noqa: BLE001 — whatever the client's bytes raise
                _malformed(context)
            (receiver.on_columnar or receiver.on_records)(decoded)
            return b""

        def export_metrics(request: bytes, context) -> bytes:
            try:
                records = otlp_metrics.decode_metrics_request(request)
            except Exception:  # noqa: BLE001 — whatever the client's bytes raise
                _malformed(context)
            if receiver.on_metric_records is not None:
                receiver.on_metric_records(records)
            return b""

        def export_logs(request: bytes, context) -> bytes:
            try:
                docs = otlp.decode_logs_request(request)
            except Exception:  # noqa: BLE001 — whatever the client's bytes raise
                _malformed(context)
            if receiver.on_log_records is not None:
                receiver.on_log_records(docs)
            return b""

        # grpc.health.v1 beside the ingress. One watcher slot: the
        # ingress pool is small and Exports must not queue behind
        # parked watchers.
        self._stop_event = threading.Event()
        self._health = HealthService(
            {m.split("/")[1] for m in (TRACE_EXPORT, METRICS_EXPORT, LOGS_EXPORT)},
            self._stop_event,
            watcher_slots=1,
            component_status=component_status,
        )
        handlers = {
            TRACE_EXPORT: export_traces,
            METRICS_EXPORT: export_metrics,
            LOGS_EXPORT: export_logs,
        }

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                health = receiver._health.add_to_generic_handlers(grpc, details.method)
                if health is not None:
                    return health
                fn = handlers.get(details.method)
                if fn is None:
                    return None
                return grpc.unary_unary_rpc_method_handler(
                    fn, request_deserializer=None, response_serializer=None
                )

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="otlp-grpc"),
            # Oversized exports are refused at the transport (the HTTP
            # leg's 413) before they reach the decoder.
            options=[("grpc.max_receive_message_length", max_body_bytes)],
        )
        self._server.add_generic_rpc_handlers((Handler(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            # grpc reports a failed bind as port 0 instead of raising.
            raise OSError(f"OTLP/gRPC receiver failed to bind {host}:{port}")

    def start(self) -> None:
        self._server.start()

    def alive(self) -> bool:
        """Started and not stopped (grpc owns its threads)."""
        return not self._stop_event.is_set()

    def stop(self, grace: float = 1.0) -> None:
        # NOT_SERVING reaches health watchers before the teardown.
        self._stop_event.set()
        self._server.stop(grace).wait()


def export_client(target: str):
    """(traces, metrics) raw-bytes unary callables on a new channel:
    each takes a serialized request and returns the (empty) response
    bytes."""
    import grpc

    channel = grpc.insecure_channel(target)
    traces = channel.unary_unary(TRACE_EXPORT, request_serializer=None, response_deserializer=None)
    metrics = channel.unary_unary(METRICS_EXPORT, request_serializer=None, response_deserializer=None)
    return traces, metrics
