"""The decode pool: N workers between the OTLP receivers and the pipeline.

Every per-request cost of the serial path (one foreign call, eight
fresh output arrays, an intern pass and a pipeline-lock round trip per
request, all on the receiver's thread) becomes a per-flush cost here:

- **Workers** pull raw payloads off one bounded queue. ``ctypes.CDLL``
  releases the GIL for the whole native call (``runtime.native``), so
  workers decode in parallel.
- **Coalesced decode**: a worker drains up to ``coalesce_max`` queued
  requests and decodes them with one ``native.decode_otlp_many`` call.
  Each request's verdict rides back in ``payload_rows``, so a malformed
  request still gets its own 400 while its batchmates land.
- **Pooled scratch, ticketed release**: the decode writes into a
  :class:`ScratchPool` freelist sized by high watermark, and the flush
  hands the pipeline VIEWS into that scratch, with no copy. A scratch
  whose views went out is parked, and goes back to the freelist only
  once no reference to its memory remains outside the pool (CPython
  refcounts). Its decode-time CRC manifest (``frame.span_column_crcs``)
  is checked again then: a buffer scribbled while its rows were live is
  counted (``frames_corrupt``) and quarantined instead of recycled.
  The pipeline copies pending rows into a pinned spine slot or a packed
  batch on the host before any host-to-device copy, so a refcount of
  zero does mean the memory is free.
- **One tensorize and one merge per flush**: one intern pass over the
  flush's service list (a per-worker :class:`InternArena`), one
  ``SpanColumns`` and one ``submit_columns`` call.

Admission stays where it was: ``submit_columns`` is the pipeline's one
gate (shed, brownout and saturation act as before), and the pool's own
queue is bounded: a full queue raises :class:`IngestPoolSaturated`,
which the receivers answer as the same retryable 429. Tickets resolve
only after their rows reached ``submit_columns``, so a 200 still means
"enqueued".

Coalescing is opportunistic: a worker takes what is queued now, so an
idle deployment sees single-request latency and a loaded one deep
batches.

There is no Python decode path: the pool raises at construction when
the native decoder cannot build, with its build error.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from collections import deque
from typing import Callable, NamedTuple, Sequence

from . import frame, native
from .otlp import MONITORED_ATTR_KEYS
from .selftrace import (
    PHASE_DECODE,
    PHASE_EXTRACT,
    PHASE_SCAN,
    PHASE_SUBMIT,
    PHASE_TENSORIZE,
    PHASE_VERIFY,
)
from .tensorize import InternArena, SpanColumns, SpanRecord, SpanTensorizer

# Phases whose durations partition a flush's wall time. PHASE_SCAN and
# PHASE_EXTRACT are sub-phases inside PHASE_DECODE (the native two-pass
# split): a share taken over TOP_PHASES must not count them again.
TOP_PHASES = (PHASE_DECODE, PHASE_VERIFY, PHASE_TENSORIZE, PHASE_SUBMIT)


class IngestPoolSaturated(RuntimeError):
    """The bounded request queue ahead of the pool is full: the
    receivers answer a retryable 429."""


class IngestWorkerError(RuntimeError):
    """A flush failed on the server's side (the pipeline sink raised)
    after decode. Distinct from a per-payload decode verdict, so the
    receivers answer 5xx for our faults and 400 only for the client's
    bytes."""


class DecodeTicket:
    """One request's verdict: the receiver waits on ``result()`` to
    answer 400 (malformed) or 200 (decoded and enqueued).

    The Event is made only when a waiter arrives before the verdict, so
    fire-and-forget submitters pay one flag write. The resolver
    publishes ``_done`` before it reads ``_event``, and the waiter
    stores ``_event`` before it reads ``_done`` again: under the GIL
    whichever happens second sees the other's write.
    """

    __slots__ = ("_done", "_error", "_event")

    def __init__(self) -> None:
        self._done = False
        self._error: BaseException | None = None
        self._event: threading.Event | None = None

    def _resolve(self, error: BaseException | None = None) -> None:
        self._error = error
        self._done = True  # publish before looking for a waiter
        ev = self._event
        if ev is not None:
            ev.set()

    def done(self) -> bool:
        """Has the request's flush landed (either way)? Non-blocking,
        from any thread: the front door's pump polls it to defer a
        wedged flush's verdict."""
        return self._done

    def result(self, timeout: float = 30.0) -> None:
        """Wait for the request's flush; raise its decode error
        (``ValueError`` for malformed wire data), if any."""
        if not self._done:
            ev = self._event
            if ev is None:
                ev = threading.Event()
                self._event = ev
                if self._done:  # the resolver ran before our store
                    ev.set()
            if not ev.wait(timeout):
                raise TimeoutError("ingest pool did not resolve the request")
        if self._error is not None:
            raise self._error


class _ParkedScratch(NamedTuple):
    """A scratch held out of the freelist until no pipeline view
    references its memory, then CRC-checked and recycled."""

    scratch: object  # native.DecodeScratch
    cols: object  # native.ColumnarSpans — the decode views, retained
    crcs: dict  # frame.span_column_crcs manifest from decode time


class ScratchPool:
    """Freelist of :class:`native.DecodeScratch` buffer sets, sized by
    high watermark: after the first flushes every acquire is a pop.

    **Ticketed release.** A flush that handed scratch views to the
    pipeline parks its scratch instead of releasing it. A parked scratch
    is recycled only once nothing outside the parked entry can reach its
    memory, checked by refcount under the GIL: each retained decode view
    holds one reference to its backing array, and every pipeline slice
    holds one more (numpy collapses ``view.base`` to the owning array).
    Before recycling, the decode-time CRC manifest is checked against
    the memory: a mismatch means something wrote into the buffer while
    its rows were live, and the scratch is discarded, its evidence
    queued for the owner to count and quarantine. A scratch whose views
    outlive demand stays parked, and ``acquire`` allocates a fresh one
    (``allocations``) rather than ever reuse live memory.

    The freelist keeps ``keep`` sets, or as many as were ever parked at
    once if that is more: a pipeline that holds a batch's flushes until
    its pump needs that many in turn, and dropping them would allocate
    again every batch. That is the peak the process already held.
    """

    def __init__(self, keep: int = 4):
        self._free: list = []
        self._lock = threading.Lock()
        self._keep = keep
        self._peak_parked = 0
        self._hw = (0, 0, 0)
        self._parked: list[_ParkedScratch] = []
        self.allocations = 0  # acquires that had to allocate
        self.tickets_parked = 0  # flushes that handed out scratch views
        self.tickets_recycled = 0  # parked scratches returned to the freelist
        # (cols, bad column names) of scavenged entries whose memory no
        # longer matched the manifest, for the owner to quarantine. The
        # deque bounds the evidence kept; corrupt_total counts them all.
        self.corrupt: deque = deque(maxlen=16)
        self.corrupt_total = 0

    @staticmethod
    def _quiescent(entry: _ParkedScratch) -> bool:
        """True when nothing outside the parked entry can reach the
        scratch memory (CPython refcounts, under the GIL).

        Per retained view: the entry's cols tuple and this frame's local
        are the only holders (3 with getrefcount's own); per backing
        array: the scratch tuple, the view's ``.base`` and this frame's
        local (4). Any slice the pipeline holds raises one of them.
        Another thread mid-read only delays the recycle by a round.
        Every array field of the ColumnarSpans is checked (the trailing
        service list has no ``dtype``)."""
        for i in range(len(entry.cols)):
            view = entry.cols[i]
            if not hasattr(view, "dtype"):
                continue
            if sys.getrefcount(view) > 3:
                return False
            base = view.base
            if base is not None and sys.getrefcount(base) > 4:
                return False
        return True

    def _retain_locked(self, scratch) -> None:
        if len(self._free) < max(self._keep, self._peak_parked):
            self._free.append(scratch)

    def _scavenge_locked(self) -> None:
        still: list[_ParkedScratch] = []
        for entry in self._parked:
            if not self._quiescent(entry):
                still.append(entry)
                continue
            bad = frame.verify_span_columns(entry.cols, entry.crcs)
            if bad:
                # Written into while parked: never recycle the buffer.
                self.corrupt_total += 1
                self.corrupt.append((entry.cols, bad))
            else:
                self.tickets_recycled += 1
                self._retain_locked(entry.scratch)
        self._parked = still

    def scavenge(self) -> None:
        """Verify and recycle every parked scratch nobody holds now
        (``acquire`` does this on its own)."""
        with self._lock:
            self._scavenge_locked()

    def parked(self) -> int:
        with self._lock:
            return len(self._parked)

    def park(self, scratch, cols, crcs: dict) -> None:
        """Hold ``scratch`` until the pipeline drops every view into it,
        then verify and recycle it."""
        with self._lock:
            self._parked.append(_ParkedScratch(scratch, cols, crcs))
            self._peak_parked = max(self._peak_parked, len(self._parked))
            self.tickets_parked += 1

    def acquire(self, cap: int, svc_cap: int, rs_cap: int):
        with self._lock:
            self._scavenge_locked()
            self._hw = (max(self._hw[0], cap), max(self._hw[1], svc_cap), max(self._hw[2], rs_cap))
            for i, s in enumerate(self._free):
                if s.cap >= cap and s.svc_cap >= svc_cap and s.rs_cap >= rs_cap:
                    return self._free.pop(i)
            hw = self._hw
            self.allocations += 1
        return native.alloc_scratch(*hw)

    def release(self, scratch) -> None:
        with self._lock:
            self._retain_locked(scratch)


_STOP = object()


class _JobQueue:
    """Bounded MPMC queue with batched consume.

    ``get_batch`` pops a whole coalesce window under one lock
    acquisition (``queue.Queue`` takes the lock once per item). ``put``
    waits up to ``timeout`` for space and then raises ``queue.Full``.
    """

    def __init__(self, maxsize: int):
        self._d: deque = deque()
        self._max = int(maxsize)
        lock = threading.Lock()
        self._not_empty = threading.Condition(lock)
        self._not_full = threading.Condition(lock)

    def put(self, item, timeout: float) -> None:
        with self._not_full:
            if len(self._d) >= self._max:
                deadline = time.monotonic() + timeout
                while len(self._d) >= self._max:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise queue.Full
                    self._not_full.wait(remaining)
            self._d.append(item)
            self._not_empty.notify()

    def put_unbounded(self, item) -> None:
        """Past the bound: shutdown sentinels only."""
        with self._not_empty:
            self._d.append(item)
            self._not_empty.notify()

    def get_batch(self, max_n: int) -> list:
        with self._not_empty:
            while not self._d:
                self._not_empty.wait()
            n = min(len(self._d), max_n)
            batch = [self._d.popleft() for _ in range(n)]
            self._not_full.notify(n)
            return batch

    def qsize(self) -> int:
        return len(self._d)


class IngestPool:
    """N decode workers between the receivers and the pipeline.

    ``submit(payload)`` (protobuf trace bodies: ``bytes``, or a front
    door's borrowed ctypes buffer) returns a :class:`DecodeTicket`;
    ``submit_records(records)`` folds already-decoded record batches
    into the same flushes. A pool always has at least one worker: a
    deployment without a pool keeps its receivers' serial path.
    """

    SUBMIT_TIMEOUT_S = 1.0  # bounded wait for queue space before 429

    def __init__(
        self,
        submit_columns: Callable[[SpanColumns], None],
        tensorizer: SpanTensorizer,
        workers: int = 2,
        coalesce_max: int = 64,
        max_pending: int = 512,
        attr_keys: Sequence[str] = MONITORED_ATTR_KEYS,
        native_threads: int = 2,
        shard_min_bytes: int = native.SHARD_MIN_BYTES_DEFAULT,
    ):
        if workers <= 0:
            raise ValueError("IngestPool needs workers >= 1 (0 = no pool)")
        if not native.available():
            raise RuntimeError(f"native ingest unavailable: {native.load_error()}")
        self.submit_columns = submit_columns
        self.tensorizer = tensorizer
        self.workers = int(workers)
        self.coalesce_max = max(int(coalesce_max), 1)
        # A flush of at least shard_min_bytes splits its extraction pass
        # across up to native_threads OS threads at span boundaries, so
        # one oversized export does not serialise on one core.
        self.native_threads = int(native_threads)
        self.shard_min_bytes = int(shard_min_bytes)
        self.attr_keys = tuple(attr_keys)
        self._q = _JobQueue(max_pending)
        self._scratch = ScratchPool(keep=self.workers + 1)
        # Counters, under _stats_lock.
        self._stats_lock = threading.Lock()
        self.submitted = 0
        self.flushes = 0
        self.flushed_spans = 0
        self.coalesced_requests = 0
        self.decode_errors = 0
        self.worker_failures = 0  # server-side flush failures (per flush)
        self.frames_corrupt = 0  # parked scratches that failed their CRCs
        # Flush wall time by phase.
        self.phase_s = {
            PHASE_DECODE: 0.0, PHASE_SCAN: 0.0, PHASE_EXTRACT: 0.0,
            PHASE_VERIFY: 0.0, PHASE_TENSORIZE: 0.0, PHASE_SUBMIT: 0.0,
        }
        self._scratch_corrupt_seen = 0
        self.busy_s = 0.0  # summed across workers
        self._started = time.monotonic()
        # Jobs submitted and not yet processed (drain waits on it).
        self._inflight = 0
        self._idle = threading.Condition(self._stats_lock)
        self._stop = False
        self._threads: list[threading.Thread] = []
        for i in range(self.workers):
            self._spawn(i)

    def _spawn(self, idx: int) -> None:
        t = threading.Thread(target=self._run, name=f"ingest-pool-{idx}", daemon=True)
        t.start()
        if idx < len(self._threads):
            self._threads[idx] = t
        else:
            self._threads.append(t)

    # -- producer side -------------------------------------------------

    def submit(self, payload) -> DecodeTicket:
        """Enqueue one protobuf ExportTraceServiceRequest body.

        Waits briefly for queue space; a queue still full raises
        :class:`IngestPoolSaturated`. A borrowed buffer must stay valid
        until the ticket resolves.
        """
        ticket = DecodeTicket()
        self._enqueue(("payload", payload, ticket))
        return ticket

    def submit_records(self, records: list[SpanRecord]) -> DecodeTicket | None:
        """Enqueue already-decoded records for the same coalesced
        tensorize and merge. The ticket resolves once the batch reached
        the pipeline; None for an empty batch."""
        if not records:
            return None
        ticket = DecodeTicket()
        self._enqueue(("records", records, ticket))
        return ticket

    def _enqueue(self, item) -> None:
        with self._stats_lock:
            self.submitted += 1
            self._inflight += 1
        try:
            self._q.put(item, timeout=self.SUBMIT_TIMEOUT_S)
        except queue.Full:
            with self._stats_lock:
                self.submitted -= 1
                self._inflight -= 1
                if self._inflight == 0:
                    self._idle.notify_all()
            raise IngestPoolSaturated(
                f"ingest queue full ({self._q._max} pending requests)"
            ) from None

    def depth(self) -> int:
        return self._q.qsize()

    # -- worker side ---------------------------------------------------

    def _run(self) -> None:
        # The worker's own intern cache: only a name it has never seen
        # reconciles with the shared table. Ids equal the serial path's.
        arena = InternArena(self.tensorizer)
        while True:
            batch = self._q.get_batch(self.coalesce_max)
            jobs = [b for b in batch if b is not _STOP]
            n_stop = len(batch) - len(jobs)
            # A batched pop can take sentinels meant for sibling workers:
            # hand the extras back before exiting.
            for _ in range(n_stop - 1):
                self._q.put_unbounded(_STOP)
            if jobs:
                t0 = time.perf_counter()
                try:
                    self._process(jobs, arena)
                except Exception as e:  # noqa: BLE001 — the worker survives
                    # Not a decode verdict: every ticket gets a server-side
                    # error, so no receiver waits for ever and none takes
                    # our fault for the client's bytes.
                    err = IngestWorkerError(f"{type(e).__name__}: {e}")
                    err.__cause__ = e
                    for _kind, _data, ticket in jobs:
                        if ticket is not None and not ticket._done:
                            ticket._resolve(err)
                    with self._stats_lock:
                        self.worker_failures += 1
                finally:
                    dt = time.perf_counter() - t0
                    with self._stats_lock:
                        self.busy_s += dt
                        self._inflight -= len(jobs)
                        if self._inflight == 0:
                            self._idle.notify_all()
            if n_stop:
                return

    def _process(self, batch: list, arena: InternArena | None = None) -> None:
        payload_jobs = [(d, t) for kind, d, t in batch if kind == "payload"]
        record_jobs = [(d, t) for kind, d, t in batch if kind == "records"]
        parts: list[SpanColumns] = []
        errors: dict[int, BaseException] = {}  # job index → decode error
        if payload_jobs:
            parts += self._decode_native(payload_jobs, errors, arena)
        if record_jobs:
            t0 = time.perf_counter()
            merged: list[SpanRecord] = []
            for records, _t in record_jobs:
                merged.extend(records)
            parts.append(self.tensorizer.columns_from_records(merged))
            self._phase(PHASE_TENSORIZE, time.perf_counter() - t0)
        cols = SpanColumns.concat(parts) if parts else None
        n_rows = cols.rows if cols is not None else 0
        if n_rows:
            t0 = time.perf_counter()
            self.submit_columns(cols)
            self._phase(PHASE_SUBMIT, time.perf_counter() - t0)
        # Drop this frame's views: the rows now live exactly as long as
        # the pipeline holds them, which is what the scavenge checks.
        del parts, cols
        self._drain_scratch_corruption()
        with self._stats_lock:
            self.flushes += 1
            self.coalesced_requests += len(batch)
            self.flushed_spans += n_rows
            self.decode_errors += len(errors)
        # Tickets resolve after submit_columns: a 200 means enqueued.
        for i, (_payload, ticket) in enumerate(payload_jobs):
            if ticket is not None:
                ticket._resolve(errors.get(i))
        for _records, ticket in record_jobs:
            if ticket is not None:
                ticket._resolve(None)

    def _decode_native(self, payload_jobs, errors, arena=None) -> list[SpanColumns]:
        payloads = [p for p, _t in payload_jobs]
        total = sum(len(p) for p in payloads)
        t0 = time.perf_counter()
        scratch = self._scratch.acquire(*native.scratch_dims(total, len(payloads)))
        parked = False
        native_phases: dict[str, float] = {}
        try:
            cols, payload_rows = native.decode_otlp_many(
                payloads, self.attr_keys, scratch,
                threads=self.native_threads,
                shard_min_bytes=self.shard_min_bytes,
                phases=native_phases,
            )
            for i, rows in enumerate(payload_rows):
                if rows < 0:
                    errors[i] = ValueError("malformed OTLP payload")
            # Timed before the empty return: an all-malformed flood
            # spends real decode time too.
            self._phase(PHASE_DECODE, time.perf_counter() - t0)
            self._phase(PHASE_SCAN, native_phases.get("scan", 0.0))
            self._phase(PHASE_EXTRACT, native_phases.get("extract", 0.0))
            if not cols.duration_us.shape[0]:
                return []
            # The pipeline gets views into the scratch. The manifest
            # taken now is checked again when the scratch is recycled.
            t0 = time.perf_counter()
            crcs = frame.span_column_crcs(cols)
            self._phase(PHASE_VERIFY, time.perf_counter() - t0)
            t0 = time.perf_counter()
            out = self.tensorizer.columns_from_columnar(cols, copy=False, arena=arena)
            self._phase(PHASE_TENSORIZE, time.perf_counter() - t0)
            if cols.duration_us.base is scratch.duration:
                self._scratch.park(scratch, cols, crcs)
                parked = True
            # Otherwise the decode outgrew the pooled scratch and
            # returned views into a private buffer: plain GC owns that
            # memory, and our scratch saw no views.
            return [out]
        finally:
            if not parked:
                self._scratch.release(scratch)

    def _phase(self, name: str, dt: float) -> None:
        with self._stats_lock:
            self.phase_s[name] += dt

    def _drain_scratch_corruption(self) -> None:
        """Count parked-scratch CRC mismatches into ``frames_corrupt``
        and write the rows aside (frame-encoded) as quarantine evidence.
        Detection is at recycle time, after the rows were consumed: an
        audit trail for a lifecycle fault, not an admission gate."""
        total = self._scratch.corrupt_total  # an int read: GIL-atomic
        with self._stats_lock:  # workers and drain() both fold
            if total > self._scratch_corrupt_seen:
                self.frames_corrupt += total - self._scratch_corrupt_seen
                self._scratch_corrupt_seen = total
        while True:
            try:
                cols, _bad = self._scratch.corrupt.popleft()
            except IndexError:
                return
            try:
                frame.quarantine(frame.encode_spans(cols), "ingest")
            except Exception:  # noqa: BLE001 — forensics must not add a fault
                pass

    # -- lifecycle -----------------------------------------------------

    def alive(self) -> bool:
        """Every worker thread is running."""
        return not self._stop and all(t.is_alive() for t in self._threads)

    def restart_workers(self) -> None:
        """Respawn dead workers."""
        if self._stop:
            return
        for i, t in enumerate(self._threads):
            if not t.is_alive():
                self._spawn(i)

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until every submitted job has been processed, then
        recycle the scratch the pipeline has let go of (without a next
        flush nothing else would)."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
        self._scratch.scavenge()
        self._drain_scratch_corruption()
        return True

    def close(self) -> None:
        """Flush everything, then stop the workers."""
        self.drain()
        self._stop = True
        for _ in self._threads:
            self._q.put_unbounded(_STOP)
        for t in self._threads:
            t.join(timeout=5.0)

    # -- telemetry -----------------------------------------------------

    def stats(self) -> dict:
        """Point-in-time counters."""
        with self._stats_lock:
            wall = max(time.monotonic() - self._started, 1e-9)
            return {
                "depth": self._q.qsize(),
                "submitted": self.submitted,
                "flushes": self.flushes,
                "flushed_spans": self.flushed_spans,
                "coalesced_requests": self.coalesced_requests,
                "decode_errors": self.decode_errors,
                "worker_failures": self.worker_failures,
                "frames_corrupt": self.frames_corrupt,
                "busy_s": self.busy_s,
                "phase_s": dict(self.phase_s),
                "tickets_parked": self._scratch.tickets_parked,
                "tickets_recycled": self._scratch.tickets_recycled,
                "scratch_parked": self._scratch.parked(),
                "scratch_allocations": self._scratch.allocations,
                "corrupt_total": self._scratch.corrupt_total,
                "workers": self.workers,
                "utilization": min(self.busy_s / (wall * self.workers), 1.0),
            }
