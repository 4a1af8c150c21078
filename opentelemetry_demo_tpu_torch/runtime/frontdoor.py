"""Python control plane of the native OTLP front door.

The data plane is ``csrc/host/frontdoor.cc``: accept → HTTP/1.1 framing
→ body bytes received straight into a recycled native buffer → an
(id, kind, ptr, len) ticket → verdict → canned response, with no Python
in the per-payload loop. What stays here needs pipeline state:

- the pumps, which drain tickets in batches (one GIL-released
  ``native.frontdoor_next`` call per batch) and route them: trace
  bodies to the decode pool as a zero-copy view of the native buffer
  (``pool.submit``; ``decode_otlp_many`` scans it in place), metrics
  and logs through the Python decoders;
- the verdicts, the same as ``runtime.otlp.OtlpHttpReceiver``'s:
  pipeline saturation → 429 with an integer ``Retry-After`` (rounded
  up), pool saturation → 429 with ``Retry-After: 1``, a flush that
  failed on our side → 500, and the request's own decode verdict → 400
  for exactly the bad request. A **wedged** flush is not answered 503
  early: the pool still holds a view of the ticket's native buffer, and
  answering is what hands that buffer back to its connection for
  reuse. The ticket waits on a stalled list the pump polls after each
  drain, and its real verdict goes out when its flush lands. Metrics
  and logs are exempt from the saturation gate, as in the receiver;
- the rejects the native side decides (bad_length, oversized, chunked,
  truncated, disconnect), counted by frontdoor.cc and mirrored into
  ``rejects``/``on_reject`` here;
- the graceful drain: quiesce, wait for the verdicts in flight, stop
  the native side, join the pumps.

This module imports no Python HTTP machinery (``http.server``,
``socketserver``): the test suite pins that.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Callable

from . import native
from .ingest_pool import IngestPool, IngestPoolSaturated, IngestWorkerError
from .otlp import decode_logs_request
from .otlp_metrics import decode_metrics_request

# Native reject counters mirrored into ``rejects``, spelled as the
# receiver spells them ("chunked" exists only here: the receiver never
# sees a chunked body as such).
_NATIVE_REJECT_REASONS = ("bad_length", "oversized", "chunked", "truncated", "disconnect")


class FrontDoorServer:
    """One native front door and its pump threads.

    ``pool`` is the shared :class:`~.ingest_pool.IngestPool`: the front
    door is one more producer into its bounded queue, so nothing
    unbounded forms ahead of the pipeline here either.
    """

    def __init__(
        self,
        pool: IngestPool,
        port: int = 0,
        max_body_bytes: int = 16 << 20,
        pumps: int = 1,
        batch_max: int = 64,
        max_conns: int = 64,
        header_timeout_ms: int = 10000,
        retry_after: Callable[[], float | None] | None = None,
        on_reject: Callable[[str], None] | None = None,
        on_metric_records: Callable | None = None,
        on_log_records: Callable | None = None,
        ticket_timeout_s: float = 30.0,
        host: str = "0.0.0.0",
    ):
        self._pool = pool
        self._retry_after = retry_after
        self._on_reject = on_reject
        self._on_metric_records = on_metric_records
        self._on_log_records = on_log_records
        self._ticket_timeout_s = ticket_timeout_s
        self.max_body_bytes = max_body_bytes
        self.rejects: dict[str, int] = {}
        self._rejects_lock = threading.Lock()
        self._native_seen = {r: 0 for r in _NATIVE_REJECT_REASONS}
        self._handle = native.frontdoor_start(port, max_body_bytes, max_conns, header_timeout_ms, host)
        self.port = native.frontdoor_port(self._handle)
        self._batch_max = max(int(batch_max), 1)
        self._stopped = False
        self._pumps = [
            threading.Thread(target=self._pump, name=f"frontdoor-pump-{i}", daemon=True)
            for i in range(max(int(pumps), 1))
        ]
        for t in self._pumps:
            t.start()

    # -- reject bookkeeping --------------------------------------------

    def _reject(self, reason: str, n: int = 1) -> None:
        with self._rejects_lock:
            self.rejects[reason] = self.rejects.get(reason, 0) + n
        if self._on_reject is not None:
            for _ in range(n):
                self._on_reject(reason)

    def _sync_native_rejects(self) -> None:
        """Fold frontdoor.cc's reject counters into ``rejects`` (the
        delta since the last fold, so the pump and ``stats()`` can both
        call it)."""
        raw = native.frontdoor_stats(self._handle)
        with self._rejects_lock:
            deltas = {r: raw[r] - self._native_seen[r] for r in _NATIVE_REJECT_REASONS}
            for r, d in deltas.items():
                if d > 0:
                    self._native_seen[r] = raw[r]
        for r, d in deltas.items():
            if d > 0:
                self._reject(r, d)

    # -- the pump -------------------------------------------------------

    def _pump(self) -> None:
        batch = native.frontdoor_alloc_batch(self._batch_max)
        pending: list[tuple[int, object]] = []
        # Tickets whose flush outlived _ticket_timeout_s: the pool still
        # holds a view of their native buffers, so their verdicts wait
        # for the flush (_sweep_stalled).
        stalled: list[tuple[int, object]] = []
        h = self._handle
        while True:
            n = native.frontdoor_next(h, batch, timeout_ms=100)
            if n < 0:
                # Stopping, queue drained: give a stalled flush one last
                # bounded wait, so its buffer is released before exit.
                self._sweep_stalled(stalled, final=True)
                return
            for i in range(n):
                rid, kind = int(batch.ids[i]), int(batch.kinds[i])
                ptr, ln = int(batch.ptrs[i]), int(batch.lens[i])
                if kind == native.FD_KIND_TRACES:
                    self._admit_trace(rid, ptr, ln, pending)
                else:
                    self._serve_signal(rid, kind, ptr, ln)
            # This drain's tickets in order, each with its own verdict.
            for rid, ticket in pending:
                verdict = self._verdict(ticket, self._ticket_timeout_s)
                if verdict is None:
                    # Answering now would hand the buffer back while the
                    # decode may still scan it: park the ticket.
                    stalled.append((rid, ticket))
                    continue
                native.frontdoor_respond(h, rid, *verdict)
            pending.clear()
            if stalled:
                self._sweep_stalled(stalled)
            if n > 0:
                self._sync_native_rejects()

    def _verdict(self, ticket, timeout: float) -> tuple[int, int] | None:
        """(status, retry_after) of a resolved ticket; None while its
        flush has not landed within ``timeout``."""
        try:
            ticket.result(timeout=timeout)
        except TimeoutError:
            return None
        except IngestWorkerError:
            return 500, 0
        except Exception:  # noqa: BLE001 — the request's decode verdict
            self._reject("malformed")
            return 400, 0
        return 200, 0

    def _sweep_stalled(self, stalled: list[tuple[int, object]], final: bool = False) -> None:
        """Answer parked tickets whose flush has landed since (a
        non-blocking poll each; ``final`` waits one ticket timeout each,
        on the pump's way out). An unresolved ticket stays parked: its
        buffer is still borrowed, and the native ``pending`` count keeps
        ``stop()``'s drain waiting for it. Past the final wait nothing
        is answered: dropping the answer keeps our side of the rule that
        a borrowed buffer is never released."""
        kept: list[tuple[int, object]] = []
        for rid, ticket in stalled:
            if not final and not ticket.done():
                kept.append((rid, ticket))
                continue
            verdict = self._verdict(ticket, self._ticket_timeout_s if final else 0.0)
            if verdict is None:
                if not final:
                    kept.append((rid, ticket))
                continue
            native.frontdoor_respond(self._handle, rid, *verdict)
        stalled[:] = kept

    def _admit_trace(self, rid: int, ptr: int, ln: int, pending: list) -> None:
        # The saturation gate first. The native side has read the whole
        # body already, so a 429 never resets a client mid-send.
        if self._retry_after is not None:
            hint = self._retry_after()
            if hint is not None:
                self._reject("saturated")
                native.frontdoor_respond(self._handle, rid, 429, max(int(-(-hint // 1)), 1))
                return
        try:
            ticket = self._pool.submit(native.frontdoor_body(ptr, ln))
        except IngestPoolSaturated:
            self._reject("saturated")
            native.frontdoor_respond(self._handle, rid, 429, 1)
            return
        pending.append((rid, ticket))

    def _serve_signal(self, rid: int, kind: int, ptr: int, ln: int) -> None:
        # Metrics and logs arrive at scrape cadence: one bytes copy is
        # noise, and the Python decoders are the one decoder of each.
        data = ctypes.string_at(ptr, ln) if ln else b""
        try:
            if kind == native.FD_KIND_METRICS:
                if self._on_metric_records is not None:
                    self._on_metric_records(decode_metrics_request(data))
            elif kind == native.FD_KIND_LOGS:
                if self._on_log_records is not None:
                    self._on_log_records(decode_logs_request(data))
        except Exception:  # noqa: BLE001 — a malformed export answers 400
            self._reject("malformed")
            native.frontdoor_respond(self._handle, rid, 400, 0)
            return
        native.frontdoor_respond(self._handle, rid, 200, 0)

    # -- observability --------------------------------------------------

    def stats(self) -> dict:
        self._sync_native_rejects()
        raw = native.frontdoor_stats(self._handle)
        with self._rejects_lock:
            rejects = dict(self.rejects)
        return {**raw, "rejects": rejects, "port": self.port}

    # -- lifecycle ------------------------------------------------------

    def stop(self, drain_timeout_s: float = 5.0) -> None:
        """Graceful drain: quiesce, let the verdicts in flight land,
        stop the native side, join the pumps. Idempotent."""
        if self._stopped:
            return
        self._stopped = True
        native.frontdoor_quiesce(self._handle)
        # "pending" counts every ticket whose connection has no verdict
        # yet, parked wedged tickets included, so the hard stop (which
        # frees connection buffers) waits for them within the budget.
        deadline = time.monotonic() + drain_timeout_s
        while time.monotonic() < deadline:
            if native.frontdoor_stats(self._handle)["pending"] == 0:
                break
            time.sleep(0.02)
        native.frontdoor_stop(self._handle)
        for t in self._pumps:
            t.join(timeout=5.0)
        self._sync_native_rejects()
