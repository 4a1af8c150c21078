"""Streaming pipeline: records → batches → device, without host syncs.

The latency budget (<100 ms p99 detection lag) shapes this module. The
card runs asynchronously, so the pipeline keeps one report in flight:
batch *k* is dispatched before batch *k-1*'s report is read, overlapping
host tensorization, the host→device copy and the step.

Harvest: each dispatched step's packed report is copied with
``non_blocking=True`` into pinned host memory and a CUDA event is
recorded behind the copy. Reading a report waits on that event only;
nothing on the dispatch path reads a device value on the host. At most
two reports are in flight; an older one is dropped unread
(``reports_skipped``: its batch still updated the state). With
``harvest_async`` a harvester thread reads them.

Ingest seam: ``submit_columns`` is the one admission gate; the record
path (``submit``) and the native decoder's columns (``submit_columnar``)
both merge through it.

Overload protection (``queue_max_rows`` > 0): the pending queue is
row-budgeted with high and low watermarks. Over budget, the oldest
OK-lane rows are shed first and error-lane rows never (``SHED_LANES``);
between the watermarks a saturation flag (hysteresis) tells receivers to
answer a retryable refusal (``admission_retry_after``); and under
sustained saturation a deterministic brownout ladder head-samples
OK-lane rows (1/2, 1/4, …) so detection stays live. A per-tenant token
bucket (``tenant_quota_rows_s``) clips a noisy tenant ahead of all that.

Device-put spine (``spine_ring`` > 0, ``runtime.spine``): pack and copy
move off the pump thread onto a stager working a ring of pinned slots,
so batch *k+1*'s copy overlaps batch *k*'s step. Adaptive batching
widens the dispatch width along a power-of-two ladder while reports are
being skipped, and narrows it back once they are not.

Detector state is written only under ``_dispatch_lock``: dispatch, a
checkpoint's copy-out (``runtime.checkpoint.save``) and the keyspace
evictor (``runtime.keyspace``) all take it, and all enqueue their work on
the one stream the steps run on, so each sees the state between two
steps.

The keyspace ladder (``keyspace_update``) degrades NEW-key admission
under sustained intern-table pressure, one rung per ``keyspace_hold_s``
with two-edge hysteresis: 0 normal · 1 evict idle keys · 2 per-tenant
new-key throttle · 3 fold all new keys to overflow · 4 shed ingest
(``admission_retry_after`` answers ``keyspace_retry_after_s``).

Query capture: per-service rings of exemplar trace ids taken at flag
time from the batch that flagged, recent attribute-CRC candidates for a
CMS top-k, and recent anomaly events, all JSON-able (``query_meta``).

flagd gating (``flags``): while ``anomalyDetectorEnabled`` evaluates
false, each pump drops the pending queue and the spine's staged batches
(``stats.dropped_disabled``) and dispatches nothing, so the state holds.
``anomalyDetectorZThreshold`` re-derives each harvested report's flags
from its z-scores when it differs from the config's ``z_threshold``; the
CUSUM alarms keep their own thresholds.

Self-tracing, provenance bundles and history capture of the reference
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

from ..models.detector import (
    AnomalyDetector,
    DetectorReport,
    detector_step,
    report_pack,
    report_unpack,
)
from ..ops.hashing import splitmix64_np
from ..utils.flags import FlagEvaluator
from .spine import DevicePutSpine, pinned_device
from .tensorize import SpanColumns, SpanRecord, SpanTensorizer

FLAG_ENABLED = "anomalyDetectorEnabled"
FLAG_THRESHOLD = "anomalyDetectorZThreshold"

# The lanes the shed policy may drop. The error lane is absent: under any
# overload the rows that explain an incident are the last a detector may
# throw away.
SHED_LANES = ("ok",)

KEYSPACE_LEVEL_EVICT = 1
KEYSPACE_LEVEL_THROTTLE = 2
KEYSPACE_LEVEL_COLLAPSE = 3
KEYSPACE_LEVEL_SHED = 4
KEYSPACE_MAX_LEVEL = KEYSPACE_LEVEL_SHED

# Signal names of a flag, the evidence vocabulary anomaly events speak.
REASON_LATENCY = "latency"
REASON_ERROR_RATE = "error_rate"
REASON_THROUGHPUT = "throughput"
REASON_CARDINALITY = "cardinality"
REASON_CUSUM = "cusum"


def _pow2_ceil(n: int) -> int:
    """Smallest power of two ≥ n: the width ladder's rounding rule."""
    return 1 << max(n - 1, 0).bit_length()


@dataclass
class PipelineStats:
    batches: int = 0
    spans: int = 0
    # Rows dropped while the detector was switched off by its flag.
    dropped_disabled: int = 0
    flag_events: int = 0
    # Reports dropped unread (their batches still updated the state).
    reports_skipped: int = 0
    # Reports whose host-side processing raised (async harvester only).
    harvest_errors: int = 0
    # Bounded window of submit→harvest lag, so the p99 tracks current lag.
    lag_ms: deque = field(default_factory=lambda: deque(maxlen=2048))
    # Paired RTT probes (rtt_probe=True): sample i was fetched beside lag
    # sample i's report.
    rtt_ms: deque = field(default_factory=lambda: deque(maxlen=2048))
    # Rows dropped by the overflow shed, per lane; "error" must stay 0.
    shed_rows: dict = field(default_factory=lambda: {"ok": 0, "error": 0})
    # OK-lane rows a tenant lost to its own quota bucket, by tenant.
    shed_rows_tenant: dict = field(default_factory=dict)
    # OK-lane rows dropped by the brownout head-sampler.
    brownout_rows: int = 0
    # Times the queue crossed the high watermark.
    saturation_events: int = 0
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

    def lag_net_samples(self) -> np.ndarray:
        """Elementwise lag − RTT over the paired tail (empty without
        probes): the lag less each harvest's own device→host round trip."""
        n = min(len(self.lag_ms), len(self.rtt_ms))
        if n == 0:
            return np.empty(0, np.float64)
        lag = np.asarray(self.lag_ms, dtype=np.float64)[-n:]
        rtt = np.asarray(self.rtt_ms, dtype=np.float64)[-n:]
        net = lag - rtt
        return net[~np.isnan(net)]


class DetectorPipeline:
    """Drives an :class:`AnomalyDetector` from a span source.

    ``on_report(t, report, flagged_names)`` fires for every harvested
    report, with ``report`` unpacked to numpy. ``tenant_of`` maps a
    service name to its tenant (None: one tenant). The keyword arguments
    carry the reference pipeline's names and defaults.
    """

    def __init__(
        self,
        detector: AnomalyDetector,
        on_report: Callable[[float, DetectorReport, list[str]], None] | None = None,
        batch_size: int = 2048,
        *,
        max_wait_s: float = 0.05,
        harvest_interval_s: float = 0.0,
        harvest_async: bool = False,
        rtt_probe: bool = False,
        adaptive_batching: bool = False,
        max_batch_growth: int = 8,
        queue_max_rows: int = 0,
        high_watermark: float = 0.85,
        low_watermark: float = 0.5,
        brownout_hold_s: float = 2.0,
        brownout_max_level: int = 4,
        retry_after_s: float = 1.0,
        exemplar_ring: int = 8,
        hh_candidates: int = 64,
        spine_ring: int = 0,
        spine_chunk_rows: int = 0,
        tenant_of: Callable[[str], str] | None = None,
        tenant_quota_rows_s: float = 0.0,
        keyspace_enable: bool = False,
        keyspace_high_watermark: float = 0.85,
        keyspace_low_watermark: float = 0.70,
        keyspace_hold_s: float = 5.0,
        keyspace_newkey_rate: float = 64.0,
        keyspace_retry_after_s: float = 2.0,
        flags: FlagEvaluator | None = None,
    ):
        self.detector = detector
        self.flags = flags or FlagEvaluator()
        # The detector's device with its index: worker threads set it.
        self._device = pinned_device(detector.device)
        self.on_report = on_report
        self.tensorizer = SpanTensorizer(
            num_services=detector.config.num_services, batch_size=batch_size
        )
        if queue_max_rows:
            if not 0.0 < low_watermark < high_watermark <= 1.0:
                raise ValueError(
                    "watermarks must satisfy 0 < low < high <= 1 "
                    f"(got low={low_watermark}, high={high_watermark})"
                )
            if queue_max_rows < batch_size:
                raise ValueError(
                    f"queue_max_rows={queue_max_rows} below one batch "
                    f"({batch_size}): the pipeline could never dispatch"
                )
        self._spine = None
        if spine_ring > 0:
            self._spine = DevicePutSpine(
                self.tensorizer,
                self._device,
                depth=spine_ring,
                chunk_rows=spine_chunk_rows,
            )
        self.max_wait_s = max_wait_s
        # Report readback cadence: 0 reads a report every pump; a
        # positive interval reads the newest report once per interval.
        self.harvest_interval_s = harvest_interval_s
        self._last_harvest = time.monotonic()
        self.rtt_probe = rtt_probe
        self._rtt_state: torch.Tensor | None = None
        # Adaptive batch growth: powers of two up to max_batch_growth×
        # while reports are skipped; warm_widths() runs each width once.
        self.adaptive_batching = adaptive_batching
        self._width = batch_size
        self._max_width = batch_size * _pow2_ceil(max(int(max_batch_growth), 1))
        self._adapt_lock = threading.Lock()
        self._adapt_events = 0
        self._adapt_skips = 0
        self._adapt_clean = 0
        # Each decay that promptly re-escalates doubles the clean windows
        # the next decay needs.
        self._adapt_clean_needed = 2
        self._last_decay = 0.0
        self._last_dispatch = time.monotonic()
        self.stats = PipelineStats()
        # Pending work: (SpanColumns, enqueue clock) chunks plus a row
        # count, guarded together — producers are receiver threads, the
        # consumer is the pump. Lag runs from the oldest row's enqueue.
        self._pending: deque = deque()
        self._pending_rows = 0
        self._pending_lock = threading.Lock()
        self.queue_max_rows = int(queue_max_rows)
        self._high_rows = int(queue_max_rows * high_watermark)
        self._low_rows = int(queue_max_rows * low_watermark)
        self.brownout_hold_s = brownout_hold_s
        self.brownout_max_level = int(brownout_max_level)
        self.retry_after_s = retry_after_s
        self._saturated = False
        self._brownout_level = 0
        self._sat_since = 0.0
        self._unsat_since = time.monotonic()
        self._level_changed_at = 0.0
        # Guards the watermark, ladder and bucket read-modify-writes:
        # they come from every receiver thread and the pump.
        self._admission_lock = threading.Lock()
        # (t_batch, t_oldest, host report, ready event, host columns);
        # the columns feed flag-time exemplar capture.
        self._inflight: deque = deque()
        self._inflight_lock = threading.Lock()
        self._dispatch_lock = threading.Lock()
        self._last_t: float | None = None
        self._tenant_of = tenant_of
        self.tenant_quota_rows_s = float(tenant_quota_rows_s)
        self._tenant_buckets: dict[str, tuple[float, float]] = {}
        # Key lifecycle: per-id last-seen clock, the ladder's state, and
        # the new-key gate the tensorizer consults on a genuine miss.
        self.keyspace_enable = bool(keyspace_enable)
        self.keyspace_high_watermark = float(keyspace_high_watermark)
        self.keyspace_low_watermark = float(keyspace_low_watermark)
        self.keyspace_hold_s = float(keyspace_hold_s)
        self.keyspace_newkey_rate = float(keyspace_newkey_rate)
        self.keyspace_retry_after_s = float(keyspace_retry_after_s)
        self._keyspace_level = 0
        self._ks_saturated = False
        self._ks_sat_since = 0.0
        self._ks_unsat_since = time.monotonic()
        self._ks_level_changed_at = 0.0
        self._ks_newkey_buckets: dict[str, tuple[float, float]] = {}
        self._last_seen = np.zeros(detector.config.num_services, np.float64)
        if self.keyspace_enable:
            self.tensorizer.new_key_gate = self.keyspace_newkey_gate
        # Query-plane capture, under its own lock: writers are the pump
        # (candidates) and the harvester (exemplars), readers snapshots.
        self._exemplar_ring = int(exemplar_ring)
        self._hh_cand_max = int(hh_candidates)
        self._query_lock = threading.Lock()
        self._exemplars: dict[int, deque] = {}
        self._hh_cands: dict[int, deque] = {}
        self._anomaly_ring: deque = deque(maxlen=64)
        self.exemplars_captured = 0
        # The async harvester: reads reports off the pump thread.
        self.harvest_async = harvest_async
        self._harvest_wake = threading.Event()
        self._harvest_idle = threading.Event()
        self._harvest_idle.set()
        self._harvest_stop = False
        self._harvest_flush = False  # drain() bypasses the cadence
        self._harvest_thread: threading.Thread | None = None
        if harvest_async:
            self._start_harvester()

    # -- ingestion -----------------------------------------------------

    def submit(self, records: Iterable[SpanRecord]) -> None:
        """Queue records; called from receiver/consumer threads."""
        records = list(records)
        if records:
            self.submit_columns(self.tensorizer.columns_from_records(records))

    def submit_columnar(self, columnar, copy: bool = False) -> None:
        """Queue a native-decoder batch (``runtime.native.ColumnarSpans``).
        ``copy=True`` when ``columnar`` views a decode scratch that will
        be reused."""
        self.submit_columns(self.tensorizer.columns_from_columnar(columnar, copy=copy))

    def submit_columns(self, cols: SpanColumns) -> None:
        if not cols.rows:
            return
        # A key is "seen" when rows arrive for it, before any shed thins
        # them. Ids past the table clip to the overflow slot, as the
        # device scatter does.
        self._last_seen[np.minimum(cols.svc, self._last_seen.shape[0] - 1)] = time.monotonic()
        if self.tenant_quota_rows_s > 0:
            cols = self._tenant_quota_sample(cols)
            if not cols.rows:
                return
        level = self._brownout_level
        if level:
            cols = self._brownout_sample(cols, level)
            if not cols.rows:
                return
        with self._pending_lock:
            self._pending.append((cols, time.monotonic()))
            self._pending_rows += cols.rows
            if self.queue_max_rows and self._pending_rows > self.queue_max_rows:
                self._shed_locked()
            rows = self._pending_rows
        self._admission_update(rows)

    def pending_rows(self) -> int:
        with self._pending_lock:
            return self._pending_rows

    # -- bounded admission / brownout ----------------------------------

    def _tenant_quota_sample(self, cols: SpanColumns) -> SpanColumns:
        """Per-tenant admission quota (token bucket, 1 s burst), ahead of
        the row budget and the brownout ladder. Within a tenant's quota
        the oldest OK rows are kept; error-lane rows always pass."""
        quota = self.tenant_quota_rows_s
        now = time.monotonic()
        names = self.tensorizer.service_names
        svc = cols.svc
        ok = ~(cols.is_error > 0.0)
        by_tenant: dict[str, list[int]] = {}
        for sid in np.unique(svc):
            sid = int(sid)
            name = names[sid] if sid < len(names) else f"svc-{sid}"
            tenant = self._tenant_of(name) if self._tenant_of is not None else "default"
            by_tenant.setdefault(tenant, []).append(sid)
        drop = np.zeros(cols.rows, dtype=bool)
        with self._admission_lock:
            for tenant, sids in by_tenant.items():
                tokens, t_last = self._tenant_buckets.get(tenant, (quota, now))
                tokens = min(tokens + (now - t_last) * quota, quota)
                mask = np.isin(svc, np.asarray(sids, svc.dtype)) & ok
                n = int(mask.sum())
                allow = min(n, int(tokens))
                if allow < n:
                    rank = np.cumsum(mask)
                    drop |= mask & (rank > allow)
                    shed = self.stats.shed_rows_tenant
                    shed[tenant] = shed.get(tenant, 0) + (n - allow)
                self._tenant_buckets[tenant] = (tokens - allow, now)
        if not drop.any():
            return cols
        return cols.compress(~drop)

    def _brownout_sample(self, cols: SpanColumns, level: int) -> SpanColumns:
        """Deterministic head sampling: keep 1/2^level of OK-lane rows.
        The decision hashes the trace key (splitmix64), so it is uniform
        for structured keys and the same trace is kept at every level
        crossing and on every replica. Error-lane rows always pass."""
        mask = np.uint64((1 << level) - 1)
        keep = (cols.is_error > 0.0) | ((splitmix64_np(cols.trace_key) & mask) == np.uint64(0))
        dropped = int(cols.rows - keep.sum())
        if dropped == 0:
            return cols
        with self._admission_lock:
            self.stats.brownout_rows += dropped
        return cols.compress(keep)

    def _shed_locked(self) -> None:
        """Drop the oldest OK-lane rows until the queue fits its budget
        (under ``_pending_lock``). Error-lane rows are never shed; a chunk
        keeps them, and its enqueue clock, when its OK rows go."""
        need = self._pending_rows - self.queue_max_rows
        idx = 0
        shed = 0
        while need > 0 and idx < len(self._pending):
            cols, t_enq = self._pending[idx]
            err = cols.is_error > 0.0
            n_ok = int(cols.rows - err.sum())
            if n_ok == 0:
                idx += 1  # pure error-lane chunk: untouchable
                continue
            if n_ok <= need:
                kept = cols.compress(err)
                dropped = n_ok
            else:
                ok_rank = np.cumsum(~err)
                kept = cols.compress(err | (ok_rank > need))
                dropped = need
            if kept.rows:
                self._pending[idx] = (kept, t_enq)
                idx += 1
            else:
                del self._pending[idx]
            self._pending_rows -= dropped
            need -= dropped
            shed += dropped
        if shed:
            self.stats.shed_rows["ok"] += shed

    def _admission_update(self, rows: int, now: float | None = None) -> None:
        """Watermark hysteresis + brownout ladder (host clock): saturated
        from the high watermark until the low one; the ladder moves one
        level per ``brownout_hold_s`` of sustained state either way."""
        if not self.queue_max_rows:
            return
        now = time.monotonic() if now is None else now
        with self._admission_lock:
            if not self._saturated:
                if rows >= self._high_rows:
                    self._saturated = True
                    self._sat_since = now
                    self.stats.saturation_events += 1
            elif rows <= self._low_rows:
                self._saturated = False
                self._unsat_since = now
            if self._saturated:
                if (
                    self._brownout_level < self.brownout_max_level
                    and now - max(self._sat_since, self._level_changed_at) >= self.brownout_hold_s
                ):
                    self._brownout_level += 1
                    self._level_changed_at = now
            elif self._brownout_level and (
                now - max(self._unsat_since, self._level_changed_at) >= self.brownout_hold_s
            ):
                self._brownout_level -= 1
                self._level_changed_at = now

    @property
    def saturated(self) -> bool:
        """True between the high-watermark crossing and the low one."""
        return self._saturated

    @property
    def brownout_level(self) -> int:
        """Head-sampling level (0 keeps everything; L keeps 1/2^L of the
        OK lane)."""
        return self._brownout_level

    def admission_retry_after(self) -> float | None:
        """None while admitting; a Retry-After hint (seconds) while the
        queue is saturated or the keyspace ladder is at its shed rung."""
        if self._saturated:
            return self.retry_after_s
        if self._keyspace_level >= KEYSPACE_LEVEL_SHED:
            return self.keyspace_retry_after_s
        return None

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
        with self._admission_lock:
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
            with self._admission_lock:
                d = self.stats.overflow_keys_tenant
                d[tenant] = d.get(tenant, 0) + 1
            return False
        rate = self.keyspace_newkey_rate
        if rate <= 0:
            return True
        now = time.monotonic()
        with self._admission_lock:
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
        if not self.flags.evaluate(FLAG_ENABLED, True):
            with self._pending_lock:
                self.stats.dropped_disabled += self._pending_rows
                self._pending.clear()
                self._pending_rows = 0
            if self._spine is not None:
                # Staged batches not yet dispatched are pending work
                # too: the off switch drops them with the queue.
                self.stats.dropped_disabled += self._spine.discard_pending()
            self._admission_update(0)
            return
        width = self.batch_width
        with self._pending_lock:
            rows_avail = self._pending_rows
        # Draining below the low watermark reopens the gate, and an idle
        # pump ticks the brownout ladder's relaxation clock.
        self._admission_update(rows_avail)
        # Once the controller has widened the batch, hold a sub-width
        # dispatch up to max_wait_s × the growth so the batch fills.
        hold_s = self.max_wait_s * (width / self.tensorizer.batch_size)
        if (
            self.adaptive_batching
            and width > self.tensorizer.batch_size
            and not self._harvest_flush
            and 0 < rows_avail < width
            and time.monotonic() - self._last_dispatch < hold_s
        ):
            self._maybe_sync_harvest(keep=0)
            return
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
            rows_after = self._pending_rows
        self._admission_update(rows_after)
        if not parts:
            # A batch staged on an earlier pump may be ready now;
            # otherwise an idle pump still reads a due report.
            if self._spine is None or not self._pump_spine():
                self._maybe_sync_harvest(keep=0)
                return
        else:
            cols = SpanColumns.concat(parts)
            self._capture_candidates(cols)
            if self._spine is not None:
                # The ring is the backpressure: past ``depth`` staged
                # batches the pump dispatches the head, waiting for it.
                while self._spine.pending() >= self._spine.depth:
                    self._pump_spine(force_wait=True)
                self._spine.stage(cols, width, t_now, t_oldest)
                self._pump_spine()
            else:
                batch = self.tensorizer.pack_columns(cols, width=width)
                self._dispatch_batch(
                    lambda: self.detector.observe_packed(batch, t_now),
                    t_now, t_oldest, cols, batch.num_valid,
                )
        if self.harvest_async:
            self._harvest_wake.set()
        else:
            # With more batches queued, leave the newest step in flight
            # (its compute overlaps the next pack); with the queue
            # drained, read now.
            with self._pending_lock:
                keep = 1 if self._pending else 0
            self._maybe_sync_harvest(keep=keep)

    def _dispatch_batch(self, step: Callable[[], torch.Tensor], t_now, t_oldest, cols, n_valid: int) -> None:
        """Run ``step`` (one detector step, returning the flat report)
        under ``_dispatch_lock`` — the one place the pump advances the
        state — and start the report's copy to pinned host memory."""
        self._last_dispatch = time.monotonic()
        with self._dispatch_lock:
            flat = step()
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = flat, None
        self.stats.batches += 1
        self.stats.spans += n_valid
        with self._inflight_lock:
            self._inflight.append((t_now, t_oldest, host, ready, cols))
            # At most two in flight: an older report is dropped unread.
            while len(self._inflight) > 2:
                self._inflight.popleft()
                self.stats.reports_skipped += 1
                self._note_outcome(skipped=True)

    def _pump_spine(self, force_wait: bool = False) -> bool:
        """Dispatch the oldest staged batch if it can go now.

        With a step in flight only a batch whose copy is done is taken (a
        batch still copying goes on the next pump); with the card idle,
        under drain or at the ring bound the pump waits for it."""
        with self._inflight_lock:
            idle = not self._inflight
        must_wait = force_wait or self._harvest_flush or idle
        staged = self._spine.take(wait=must_wait)
        if staged is None:
            return False
        device = self._device

        def step() -> torch.Tensor:
            try:
                if staged.copied is not None:
                    torch.cuda.current_stream(device).wait_event(staged.copied)
                return self.detector.observe_staged_packed(staged.lanes, staged.t_now)
            finally:
                self._spine.release(staged)

        self._dispatch_batch(step, staged.t_now, staged.t_oldest, staged.cols, staged.cols.rows)
        return True

    def _maybe_sync_harvest(self, keep: int) -> None:
        """One due-cadence synchronous harvest (no-op in async mode)."""
        if self.harvest_async:
            return
        if time.monotonic() - self._last_harvest >= self.harvest_interval_s:
            if self._harvest_one(keep=keep):
                self._last_harvest = time.monotonic()

    def drain(self) -> None:
        """Dispatch everything queued and harvest every report."""
        # Raise the flush flag first: the async harvester must not skip
        # reports dispatched during the drain itself.
        self._harvest_flush = True
        try:
            while self._pending or (self._spine is not None and self._spine.pending()):
                self.pump()
            if self.harvest_async:
                self._drain_async()
            else:
                while self._harvest_one(keep=0):
                    pass
        finally:
            self._harvest_flush = False

    def _drain_async(self) -> None:
        while True:
            with self._inflight_lock:
                empty = not self._inflight
            if empty and self._harvest_idle.is_set():
                break
            if self._harvest_thread is None or not self._harvest_thread.is_alive():
                # A dead harvester: never spin against it.
                while self._harvest_one(keep=0):
                    pass
                break
            self._harvest_wake.set()
            time.sleep(0.005)

    def close(self) -> None:
        """Drain, then stop the spine and the harvester."""
        self.drain()
        if self._spine is not None:
            self._spine.close()
        if self._harvest_thread is not None:
            self._harvest_stop = True
            self._harvest_wake.set()
            self._harvest_thread.join(timeout=5.0)
            self._harvest_thread = None

    def spine_stats(self) -> dict | None:
        """The spine's put and overlap counters (None with the spine off)."""
        return None if self._spine is None else self._spine.stats()

    # -- supervision hooks --------------------------------------------

    def harvester_alive(self) -> bool:
        """True while the async harvester runs (or is not configured)."""
        if not self.harvest_async:
            return True
        return self._harvest_thread is not None and self._harvest_thread.is_alive()

    def restart_harvester(self) -> None:
        """Respawn a dead async harvester; a no-op while it is alive."""
        if not self.harvest_async or self.harvester_alive():
            return
        self._harvest_stop = False
        self._harvest_idle.set()
        self._start_harvester()

    def _start_harvester(self) -> None:
        self._harvest_thread = threading.Thread(
            target=self._harvest_loop, name="report-harvester", daemon=True
        )
        self._harvest_thread.start()

    # -- adaptive width controller ------------------------------------

    @property
    def batch_width(self) -> int:
        """Current dispatch width (batch_size unless adaptive grew it)."""
        return self._width if self.adaptive_batching else self.tensorizer.batch_size

    def warm_widths(self) -> None:
        """Run one step at every ladder width (adaptive mode only), so an
        escalation mid-incident meets warm caches. Each step is
        all-invalid (every lane hits the monoid identities) and runs on a
        clone of the state with ``dt`` 0 and no rotation: neither the
        state nor the window clock moves."""
        if not self.adaptive_batching:
            return
        det = self.detector
        no_rotate = np.zeros(len(det.config.windows_s), bool)
        width = self.tensorizer.batch_size
        while width <= self._max_width:
            empty = SpanColumns(
                svc=np.zeros(0, np.int32),
                lat_us=np.zeros(0, np.float32),
                is_error=np.zeros(0, np.float32),
                trace_key=np.zeros(0, np.uint64),
                attr_crc=np.zeros(0, np.uint64),
            )
            batch = self.tensorizer.pack_columns(empty, width=width)
            with self._dispatch_lock:
                clone = type(det.state)(*(t.clone() for t in det.state))
            _, report = detector_step(det.config, clone, *det.pack_args(batch, 0.0, no_rotate))
            report_pack(report).cpu()
            width *= 2

    def _note_outcome(self, skipped: bool) -> None:
        """Feed the width controller one report outcome.

        Escalation jumps to target: over a 4-outcome window
        dispatched/harvested is the width factor that balances the two.
        Two all-clean 8-outcome windows halve the width (lock order:
        ``_inflight_lock`` → ``_adapt_lock``)."""
        if not self.adaptive_batching:
            return
        with self._adapt_lock:
            self._adapt_events += 1
            if skipped:
                self._adapt_skips += 1
            window = 4 if self._adapt_skips else 8
            if self._adapt_events < window:
                return
            skips = self._adapt_skips
            events = self._adapt_events
            self._adapt_events = 0
            self._adapt_skips = 0
            if (
                skips == 0
                and self._adapt_clean_needed > 2
                and time.monotonic() - self._last_decay >= 10.0
            ):
                # The last decay held for 10 s: earn the hysteresis back.
                self._adapt_clean_needed = max(self._adapt_clean_needed // 2, 2)
            if skips > events // 4:
                self._adapt_clean = 0
                if time.monotonic() - self._last_decay < 10.0:
                    # The decay just made re-skipped: make the next one
                    # much harder to earn.
                    self._adapt_clean_needed = min(self._adapt_clean_needed * 2, 32)
                harvested = max(events - skips, 1)
                factor = max(2, -(-events // harvested))  # ceil div
                self._width = min(self._width * _pow2_ceil(factor), self._max_width)
            elif skips == 0 and self._width > self.tensorizer.batch_size:
                self._adapt_clean += 1
                if self._adapt_clean >= self._adapt_clean_needed:
                    self._width = max(self._width // 2, self.tensorizer.batch_size)
                    self._adapt_clean = 0
                    self._last_decay = time.monotonic()
            else:
                self._adapt_clean = 0

    # -- report handling -----------------------------------------------

    def _harvest_loop(self) -> None:
        """Background harvester. On the cadence path it reads the newest
        report, and an older one only if its copy is already done
        (``event.query()``); a report still copying is dropped as
        superseded. Under drain it reads every report oldest first."""
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            self._harvest_wake.wait(timeout=0.05)
            self._harvest_wake.clear()
            if (
                not self._harvest_stop
                and not self._harvest_flush
                and time.monotonic() - self._last_harvest < self.harvest_interval_s
            ):
                continue
            with self._inflight_lock:
                if not self._inflight:
                    if self._harvest_stop:
                        return
                    continue
                if not self._harvest_flush:
                    while len(self._inflight) > 1:
                        ready = self._inflight[0][3]
                        if ready is None or ready.query():
                            break  # the oldest is free to read
                        self._inflight.popleft()
                        self.stats.reports_skipped += 1
                        self._note_outcome(skipped=True)
                item = self._inflight.popleft()
                self._harvest_idle.clear()
            self._last_harvest = time.monotonic()
            try:
                self._process_report(item)
            except Exception:  # noqa: BLE001 — a raising on_report must
                # not kill the only consumer of _inflight.
                self.stats.harvest_errors += 1
            finally:
                # Drop the batch's columns now, not at the next report:
                # they may view a decode scratch the pool waits to recycle.
                item = None
                self._harvest_idle.set()

    def _start_rtt_probe(self) -> dict:
        """Bump a one-scalar counter on the card and copy it back on a
        thread, beside the report fetch it pairs with; the copy's time is
        the round trip that harvest paid."""
        device = self._device
        if self._rtt_state is None:
            self._rtt_state = torch.zeros((), dtype=torch.int32, device=device)
        self._rtt_state = self._rtt_state + 1
        arr = self._rtt_state
        res: dict = {}

        def run():
            if device.type == "cuda":
                torch.cuda.set_device(device)
            t0 = time.perf_counter()
            int(arr.cpu())
            res["rtt"] = (time.perf_counter() - t0) * 1e3

        th = threading.Thread(target=run, name="rtt-probe", daemon=True)
        th.start()
        return {"thread": th, "res": res}

    def _harvest_one(self, keep: int = 1) -> bool:
        """Read the oldest in-flight report beyond ``keep``."""
        with self._inflight_lock:
            if len(self._inflight) <= keep:
                return False
            item = self._inflight.popleft()
        self._process_report(item)
        return True

    # -- query-plane capture ------------------------------------------

    def _capture_candidates(self, cols: SpanColumns) -> None:
        """Remember recent distinct attribute CRCs per service (pump
        thread): the candidate set a CMS top-k query needs."""
        if not self._hh_cand_max:
            return
        tails = []
        for s in np.unique(cols.svc):
            vals = cols.attr_crc[cols.svc == s]
            # Distinct values in arrival order, then the tail.
            _u, first = np.unique(vals, return_index=True)
            ordered = vals[np.sort(first)]
            tails.append((int(s), [int(v) for v in ordered[-self._hh_cand_max:]]))
        with self._query_lock:
            for s, tail in tails:
                ring = self._hh_cands.get(s)
                if ring is None:
                    ring = self._hh_cands[s] = deque(maxlen=self._hh_cand_max)
                ring.extend(tail)

    def _capture_exemplars(self, t_batch, cols, report, flags_np, threshold) -> list[str]:
        """At flag time: link each flagged service to trace ids from the
        batch that flagged it (the first 8 bytes of the trace id as hex,
        a Jaeger search prefix), and record one anomaly event each.
        ``exemplar_ring=0`` stops only the trace-id capture. Returns the
        trace ids captured."""
        if not flags_np.any():
            return []
        captured: list[str] = []
        cusum_thr = np.asarray(self.detector.config.cusum_thresholds, np.float32)
        now = time.time()
        with self._query_lock:
            for i in np.nonzero(flags_np)[0]:
                i = int(i)
                signals = [
                    name
                    for name, z in (
                        (REASON_LATENCY, report.lat_z[i]),
                        (REASON_ERROR_RATE, report.err_z[i]),
                        (REASON_THROUGHPUT, report.rate_z[i]),
                        (REASON_CARDINALITY, report.card_z[i]),
                    )
                    if np.abs(z).max() > threshold
                ] + ([REASON_CUSUM] if (report.cusum[i] > cusum_thr).any() else [])
                traces: list[str] = []
                if self._exemplar_ring and cols is not None:
                    keys = cols.trace_key[cols.svc == i]
                    for v in keys[-self._exemplar_ring:]:
                        traces.append(int(v).to_bytes(8, "little").hex())
                if self._exemplar_ring:
                    ring = self._exemplars.get(i)
                    if ring is None:
                        ring = self._exemplars[i] = deque(maxlen=self._exemplar_ring)
                    sig = signals[0] if signals else "flag"
                    for tid in traces:
                        ring.append({"trace_id": tid, "t": now, "signal": sig})
                self.exemplars_captured += len(traces)
                captured.extend(traces)
                self._anomaly_ring.append({
                    "t": now,
                    "t_batch": float(t_batch),
                    "service": i,
                    "signals": signals,
                    "exemplars": traces,
                    "bundle": None,
                })
        return captured

    def query_meta(self) -> dict:
        """JSON-able query-plane block: exemplar rings, recent anomaly
        events and top-k candidate keys (most recent first)."""
        with self._query_lock:
            return {
                "exemplars": {
                    str(svc): [dict(e) for e in ring] for svc, ring in self._exemplars.items()
                },
                "anomalies": [dict(ev) for ev in self._anomaly_ring],
                "hh_candidates": {
                    str(svc): list(dict.fromkeys(reversed(ring)))[: self._hh_cand_max]
                    for svc, ring in self._hh_cands.items()
                },
                "exemplars_captured": self.exemplars_captured,
            }

    def restore_query_meta(self, block: dict) -> None:
        """Refill the query-plane rings from a :meth:`query_meta` block.
        ``exemplars_captured`` is this process's own counter and is not
        restored."""
        if not block:
            return
        with self._query_lock:
            if self._exemplar_ring:
                for svc, events in (block.get("exemplars") or {}).items():
                    ring = self._exemplars.get(int(svc))
                    if ring is None:
                        ring = self._exemplars[int(svc)] = deque(maxlen=self._exemplar_ring)
                    ring.extend(dict(e) for e in events[-self._exemplar_ring:])
            for ev in (block.get("anomalies") or [])[-self._anomaly_ring.maxlen:]:
                self._anomaly_ring.append(dict(ev))
            if self._hh_cand_max:
                for svc, crcs in (block.get("hh_candidates") or {}).items():
                    ring = self._hh_cands.get(int(svc))
                    if ring is None:
                        ring = self._hh_cands[int(svc)] = deque(maxlen=self._hh_cand_max)
                    # query_meta lists most recent first; rings keep
                    # arrival order.
                    ring.extend(int(c) for c in reversed(crcs))

    # -- report processing --------------------------------------------

    def _process_report(self, item) -> None:
        t_batch, t_oldest, host, ready, cols = item
        self._note_outcome(skipped=False)
        probe = self._start_rtt_probe() if self.rtt_probe else None
        if ready is not None:
            ready.synchronize()
        report = report_unpack(host.numpy(), self.detector.config)
        self.stats.lag_ms.append((time.monotonic() - t_oldest) * 1e3)
        if probe is not None:
            probe["thread"].join(timeout=10.0)
            self.stats.rtt_ms.append(probe["res"].get("rtt", float("nan")))
        flags_np = report.flags
        z_threshold = self.detector.config.z_threshold
        threshold = float(self.flags.evaluate(FLAG_THRESHOLD, z_threshold))
        if threshold != z_threshold:
            # Re-derive the flags from the report's z-scores at the
            # flag's threshold; the CUSUM alarms keep their own.
            z = np.maximum.reduce([
                np.abs(report.lat_z).max(axis=1),
                np.abs(report.err_z).max(axis=1),
                np.abs(report.rate_z).max(axis=1),
                np.abs(report.card_z).max(axis=1),
            ])
            cusum_thr = np.asarray(self.detector.config.cusum_thresholds, np.float32)
            cusum_alarm = (report.cusum > cusum_thr[None, :]).any(axis=1)
            flags_np = (z > threshold) | cusum_alarm
        flagged: list[str] = []
        if flags_np.any():
            self.stats.flag_events += 1
            names = self.tensorizer.service_names
            flagged = [
                names[i] if i < len(names) else f"svc-{i}"
                for i in np.nonzero(flags_np)[0]
            ]
            self._capture_exemplars(t_batch, cols, report, flags_np, threshold)
        if self.on_report is not None:
            self.on_report(t_batch, report, flagged)
