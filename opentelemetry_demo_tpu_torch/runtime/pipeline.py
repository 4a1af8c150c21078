"""Streaming pipeline: records → batches → device, without host syncs.

The device runs asynchronously, so the pipeline keeps one report in
flight: batch *k* is dispatched before batch *k-1*'s report is read,
overlapping host tensorization, the host→device copy and the step.

Harvest: each dispatched step's packed report is copied with
``non_blocking=True`` into pinned host memory and a CUDA event is
recorded behind the copy. Reading a report waits on that event only;
nothing on the dispatch path reads a device value on the host.

Overload shedding, the device-put spine, self-tracing, provenance, the
keyspace ladder, adaptive batching and flagd gating of the reference
pipeline arrive with later slices.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch

from ..models.detector import AnomalyDetector, DetectorReport, report_unpack
from .tensorize import SpanColumns, SpanRecord, SpanTensorizer


@dataclass
class PipelineStats:
    batches: int = 0
    spans: int = 0
    # Bounded window of submit→harvest lag, so the p99 tracks current lag.
    lag_ms: deque = field(default_factory=lambda: deque(maxlen=2048))

    def lag_p99_ms(self) -> float:
        if not self.lag_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.lag_ms), 99))


class DetectorPipeline:
    """Drives an :class:`AnomalyDetector` from a span-record source.

    ``on_report(t, report, flagged_names)`` fires for every harvested
    report, with ``report`` unpacked to numpy.
    """

    def __init__(
        self,
        detector: AnomalyDetector,
        on_report: Callable[[float, DetectorReport, list[str]], None] | None = None,
        batch_size: int = 2048,
    ):
        self.detector = detector
        self.on_report = on_report
        self.tensorizer = SpanTensorizer(
            num_services=detector.config.num_services, batch_size=batch_size
        )
        self.stats = PipelineStats()
        # Pending work: (SpanColumns, enqueue clock) chunks plus a row
        # count, guarded together — producers are receiver threads, the
        # consumer is the pump.
        self._pending: deque = deque()
        self._pending_rows = 0
        self._pending_lock = threading.Lock()
        # (t_batch, t_oldest_row, host report, ready event); pump thread only.
        self._inflight: deque = deque()
        self._last_t: float | None = None

    # -- ingestion -----------------------------------------------------

    def submit(self, records: Iterable[SpanRecord]) -> None:
        """Queue records; called from receiver/consumer threads."""
        records = list(records)
        if records:
            self.submit_columns(self.tensorizer.columns_from_records(records))

    def submit_columns(self, cols: SpanColumns) -> None:
        if not cols.rows:
            return
        with self._pending_lock:
            self._pending.append((cols, time.monotonic()))
            self._pending_rows += cols.rows

    def pending_rows(self) -> int:
        with self._pending_lock:
            return self._pending_rows

    # -- dispatch ------------------------------------------------------

    def pump(self, t_now: float | None = None) -> None:
        """Form at most one batch and dispatch it (non-blocking).

        Callers drive wall time or a virtual clock; without ``t_now`` the
        caller's last timebase is reused, so a virtual-time stream never
        mixes in ``time.monotonic()``.
        """
        if t_now is None:
            t_now = self._last_t if self._last_t is not None else time.monotonic()
        self._last_t = t_now
        width = self.tensorizer.batch_size
        with self._pending_lock:
            budget = width
            parts: list[SpanColumns] = []
            t_oldest = None
            while self._pending and budget:
                head, t_enq = self._pending.popleft()
                if t_oldest is None:
                    t_oldest = t_enq  # FIFO: the head is the oldest
                if head.rows > budget:
                    parts.append(head.slice(0, budget))
                    # The requeued tail keeps its original enqueue time.
                    self._pending.appendleft((head.slice(budget, head.rows), t_enq))
                    budget = 0
                else:
                    parts.append(head)
                    budget -= head.rows
            self._pending_rows -= sum(p.rows for p in parts)
            more = bool(self._pending)
        if not parts:
            # Nothing to dispatch; an idle pump still reads due reports.
            while self._harvest_one(keep=0):
                pass
            return
        cols = SpanColumns.concat(parts)
        self._dispatch_batch(self.tensorizer.pack_columns(cols, width=width), t_now, t_oldest)
        # With more batches queued, leave the newest step in flight (its
        # compute overlaps the next pack); with the queue drained, read
        # everything now.
        self._harvest_one(keep=1 if more else 0)

    def _dispatch_batch(self, batch, t_now: float, t_oldest: float) -> None:
        flat = self.detector.observe_packed(batch, t_now)
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = flat, None
        self.stats.batches += 1
        self.stats.spans += batch.num_valid
        self._inflight.append((t_now, t_oldest, host, ready))

    def drain(self) -> None:
        """Dispatch everything queued and harvest every report."""
        while self.pending_rows():
            self.pump()
        while self._harvest_one(keep=0):
            pass

    # -- report handling -----------------------------------------------

    def _harvest_one(self, keep: int = 1) -> bool:
        """Read the oldest in-flight report beyond ``keep``."""
        if len(self._inflight) <= keep:
            return False
        self._process_report(self._inflight.popleft())
        return True

    def _process_report(self, item) -> None:
        t_batch, t_oldest, host, ready = item
        if ready is not None:
            ready.synchronize()
        report = report_unpack(host.numpy(), self.detector.config)
        self.stats.lag_ms.append((time.monotonic() - t_oldest) * 1e3)
        flagged: list[str] = []
        if report.flags.any():
            names = self.tensorizer.service_names
            flagged = [
                names[i] if i < len(names) else f"svc-{i}"
                for i in np.nonzero(report.flags)[0]
            ]
        if self.on_report is not None:
            self.on_report(t_batch, report, flagged)
