"""grpc.health.v1: one implementation for every gRPC server of the port.

The OTLP/gRPC receiver attaches these handlers, and the container probe
(``runtime.health_probe``) shares the constants. Raw-bytes handlers, no
generated stubs: HealthCheckRequest{service=1},
HealthCheckResponse{status=1} with SERVING/NOT_SERVING.

A sync gRPC server pins one executor thread per open server stream, so
unbounded Watch clients could starve the pool. ``watcher_slots`` bounds
concurrent watchers; past it a Watch answers with the current status
and ends the stream (spec-legal: clients watch again), instead of
parking Export calls behind watchers.

``grpc`` is imported inside the handlers, so this module imports
without it.
"""

from __future__ import annotations

import threading
from typing import Iterable

from . import wire

SERVING = 1
NOT_SERVING = 2

CHECK_METHOD = "/grpc.health.v1.Health/Check"
WATCH_METHOD = "/grpc.health.v1.Health/Watch"


class HealthService:
    """Check/Watch handlers over a stop event and a known-service set."""

    def __init__(
        self,
        known_services: Iterable[str],
        stop_event: threading.Event,
        watcher_slots: int = 2,
        component_status=None,
    ):
        self.known = set(known_services)
        self.stop_event = stop_event
        self._watchers = threading.Semaphore(max(watcher_slots, 0))
        # Optional per-service status (``name -> SERVING/NOT_SERVING``,
        # or None for names it does not own), asked before the
        # known-set rule.
        self.component_status = component_status

    def _status_response(self, request: bytes) -> bytes | None:
        """Response bytes, or None for an unknown service name."""
        raw = wire.first(wire.scan_fields(request), 1, b"")
        service = raw.decode("utf-8", "replace") if isinstance(raw, bytes) else ""
        if service and self.component_status is not None:
            status = self.component_status(service)
            if status is not None:
                return wire.encode_int(1, status)
        if service and service not in self.known:
            return None
        status = NOT_SERVING if self.stop_event.is_set() else SERVING
        return wire.encode_int(1, status)

    # -- grpc handler callables ----------------------------------------

    def check(self, request: bytes, context) -> bytes:
        import grpc

        # Outside any application lock: health must answer while the
        # server is busy.
        resp = self._status_response(request)
        if resp is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "unknown service")
        return resp

    def watch(self, request: bytes, context):
        import grpc

        resp = self._status_response(request)
        if resp is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "unknown service")
            return
        yield resp
        if not self._watchers.acquire(blocking=False):
            return  # slots exhausted: status delivered, stream ends
        try:
            # Stream the SERVING → NOT_SERVING transition at shutdown; a
            # cancelled watcher leaves the loop.
            while context.is_active() and not self.stop_event.wait(0.2):
                pass
            if context.is_active():
                yield wire.encode_int(1, NOT_SERVING)
        finally:
            self._watchers.release()

    def add_to_generic_handlers(self, grpc_module, method: str):
        """The grpc method handler for ``method``, or None (for a
        ``GenericRpcHandler.service``)."""
        if method == CHECK_METHOD:
            return grpc_module.unary_unary_rpc_method_handler(
                self.check, request_deserializer=None, response_serializer=None,
            )
        if method == WATCH_METHOD:
            return grpc_module.unary_stream_rpc_method_handler(
                self.watch, request_deserializer=None, response_serializer=None,
            )
        return None
