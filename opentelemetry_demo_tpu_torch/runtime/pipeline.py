"""Streaming pipeline: records → batches → device, without host syncs.

The device runs asynchronously, so the pipeline keeps one report in
flight: batch *k* is dispatched before batch *k-1*'s report is read,
overlapping host tensorization, the host→device copy and the step.

Harvest: each dispatched step's packed report is copied with
``non_blocking=True`` into pinned host memory and a CUDA event is
recorded behind the copy. Reading a report waits on that event only;
nothing on the dispatch path reads a device value on the host.

Detector state is written only under ``_dispatch_lock``: dispatch, a
checkpoint's copy-out (``runtime.checkpoint.save``) and the keyspace
evictor (``runtime.keyspace``) all take it, and all enqueue their work on
the one stream the steps run on, so each sees the state between two
steps.

The keyspace ladder (``keyspace_update``) degrades NEW-key admission
under sustained intern-table pressure, one rung per ``keyspace_hold_s``
with two-edge hysteresis: 0 normal · 1 evict idle keys · 2 per-tenant
new-key throttle · 3 fold all new keys to overflow · 4 shed ingest. The
shed rung's 429 answer arrives with the receivers; the level is
reported now.

Overload shedding, the device-put spine, self-tracing, provenance,
adaptive batching and flagd gating of the reference pipeline arrive
with later slices.
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

KEYSPACE_LEVEL_EVICT = 1
KEYSPACE_LEVEL_THROTTLE = 2
KEYSPACE_LEVEL_COLLAPSE = 3
KEYSPACE_LEVEL_SHED = 4
KEYSPACE_MAX_LEVEL = KEYSPACE_LEVEL_SHED


@dataclass
class PipelineStats:
    batches: int = 0
    spans: int = 0
    # Bounded window of submit→harvest lag, so the p99 tracks current lag.
    lag_ms: deque = field(default_factory=lambda: deque(maxlen=2048))
    # Keyspace ladder accounting, keyed by tenant: new keys a tenant's
    # token bucket deferred to overflow at the throttle rung, and new
    # keys folded to overflow at the collapse rung.
    newkey_throttled_tenant: dict = field(default_factory=dict)
    overflow_keys_tenant: dict = field(default_factory=dict)
    # Times keyspace pressure crossed its high watermark.
    keyspace_pressure_events: int = 0

    def lag_p99_ms(self) -> float:
        if not self.lag_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.lag_ms), 99))


class DetectorPipeline:
    """Drives an :class:`AnomalyDetector` from a span-record source.

    ``on_report(t, report, flagged_names)`` fires for every harvested
    report, with ``report`` unpacked to numpy. ``tenant_of`` maps a
    service name to its tenant for the new-key throttle (None: one
    tenant).
    """

    def __init__(
        self,
        detector: AnomalyDetector,
        on_report: Callable[[float, DetectorReport, list[str]], None] | None = None,
        batch_size: int = 2048,
        *,
        tenant_of: Callable[[str], str] | None = None,
        keyspace_enable: bool = False,
        keyspace_high_watermark: float = 0.85,
        keyspace_low_watermark: float = 0.70,
        keyspace_hold_s: float = 5.0,
        keyspace_newkey_rate: float = 64.0,
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
        self._dispatch_lock = threading.Lock()
        self._tenant_of = tenant_of
        # Key lifecycle: per-id last-seen clock, the ladder's state, and
        # the new-key gate the tensorizer consults on a genuine miss.
        self.keyspace_enable = bool(keyspace_enable)
        self.keyspace_high_watermark = float(keyspace_high_watermark)
        self.keyspace_low_watermark = float(keyspace_low_watermark)
        self.keyspace_hold_s = float(keyspace_hold_s)
        self.keyspace_newkey_rate = float(keyspace_newkey_rate)
        self._keyspace_lock = threading.Lock()
        self._keyspace_level = 0
        self._ks_saturated = False
        self._ks_sat_since = 0.0
        self._ks_unsat_since = time.monotonic()
        self._ks_level_changed_at = 0.0
        self._ks_newkey_buckets: dict[str, tuple[float, float]] = {}
        self._last_seen = np.zeros(detector.config.num_services, np.float64)
        if self.keyspace_enable:
            self.tensorizer.new_key_gate = self.keyspace_newkey_gate

    # -- ingestion -----------------------------------------------------

    def submit(self, records: Iterable[SpanRecord]) -> None:
        """Queue records; called from receiver/consumer threads."""
        records = list(records)
        if records:
            self.submit_columns(self.tensorizer.columns_from_records(records))

    def submit_columns(self, cols: SpanColumns) -> None:
        if not cols.rows:
            return
        # A key is "seen" when rows arrive for it. Ids past the table clip
        # to the overflow slot, as the device scatter does.
        self._last_seen[np.minimum(cols.svc, self._last_seen.shape[0] - 1)] = time.monotonic()
        with self._pending_lock:
            self._pending.append((cols, time.monotonic()))
            self._pending_rows += cols.rows

    def pending_rows(self) -> int:
        with self._pending_lock:
            return self._pending_rows

    # -- keyspace ladder -----------------------------------------------

    def keyspace_update(self, fill: float, rss_over: bool = False, now: float | None = None) -> int:
        """Clock the keyspace ladder with the live-key fill fraction and
        the RSS-budget verdict; returns the level.

        Pressure starts at the high watermark (or any RSS breach) and
        clears only at the low one; the ladder moves one rung per
        ``keyspace_hold_s`` of sustained state in either direction, so
        one fill spike never staircases to the top.
        """
        now = time.monotonic() if now is None else now
        with self._keyspace_lock:
            if not self._ks_saturated:
                if fill >= self.keyspace_high_watermark or rss_over:
                    self._ks_saturated = True
                    self._ks_sat_since = now
                    self.stats.keyspace_pressure_events += 1
            elif fill <= self.keyspace_low_watermark and not rss_over:
                self._ks_saturated = False
                self._ks_unsat_since = now
            if self._ks_saturated:
                if (
                    self._keyspace_level < KEYSPACE_MAX_LEVEL
                    and now - max(self._ks_sat_since, self._ks_level_changed_at)
                    >= self.keyspace_hold_s
                ):
                    self._keyspace_level += 1
                    self._ks_level_changed_at = now
            elif self._keyspace_level and (
                now - max(self._ks_unsat_since, self._ks_level_changed_at) >= self.keyspace_hold_s
            ):
                self._keyspace_level -= 1
                self._ks_level_changed_at = now
            return self._keyspace_level

    @property
    def keyspace_level(self) -> int:
        """Current keyspace ladder rung (0 = normal; KEYSPACE_LEVEL_*)."""
        return self._keyspace_level

    def keyspace_newkey_gate(self, name: str) -> bool:
        """New-key admission, consulted by the tensorizer under its intern
        lock on a genuine miss. Below the throttle rung every new key
        gets a slot; at the throttle rung each tenant spends a token
        bucket refilled at ``keyspace_newkey_rate`` keys/s; at the
        collapse rung and above every new key folds to overflow. Refused
        keys' rows are still admitted, into the overflow bucket."""
        level = self._keyspace_level
        if level < KEYSPACE_LEVEL_THROTTLE:
            return True
        tenant = self._tenant_of(name) if self._tenant_of is not None else "default"
        if level >= KEYSPACE_LEVEL_COLLAPSE:
            with self._keyspace_lock:
                d = self.stats.overflow_keys_tenant
                d[tenant] = d.get(tenant, 0) + 1
            return False
        rate = self.keyspace_newkey_rate
        if rate <= 0:
            return True
        now = time.monotonic()
        with self._keyspace_lock:
            tokens, t_last = self._ks_newkey_buckets.get(tenant, (rate, now))
            tokens = min(tokens + (now - t_last) * rate, rate)
            if tokens >= 1.0:
                self._ks_newkey_buckets[tenant] = (tokens - 1.0, now)
                return True
            self._ks_newkey_buckets[tenant] = (tokens, now)
            d = self.stats.newkey_throttled_tenant
            d[tenant] = d.get(tenant, 0) + 1
        return False

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
        with self._dispatch_lock:
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
