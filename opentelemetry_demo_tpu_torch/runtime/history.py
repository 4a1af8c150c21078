"""Time-travel tier: frame-native history store + retention ladder.

The query plane (``runtime.query``) answers "now"; this module answers
"last Tuesday 3am" and keeps a replay corpus of recorded incidents. The
verified columnar frame (``runtime.frame``) makes both cheap: history is
append + monoid merge + seek, with the same CRC and fencing guarantees
the live path enforces. A copy of the reference package's module with
its imports switched to this package; the segment files are byte for
byte the reference's, so either package reads a store the other wrote.

Three pieces:

- :class:`HistoryStore` — an on-disk **segment log** of v2 frames with a
  header-only time index. Each record is a fixed 36+4-byte header (kind,
  rung, epoch, time bounds, frame length, header CRC32C) followed by one
  ``runtime.frame`` blob, so index builds read headers only and a range
  read is seek + read + :func:`frame.decode` + merge. Segments seal by
  flush + fsync + ``os.replace``; the writer is **epoch-fenced**: every
  append checks the process fence and stamps its epoch, and opening a
  store observes the largest epoch already on disk, so a resurrected
  stale primary sharing the volume cannot append.

- :class:`HistoryWriter` — the compaction thread. Each tick it snapshots
  state through ``snapshot_fn`` (on the card: the whole state copied off
  the device in stream order, ``DetectorPipeline.state_snapshot``) and,
  when the shortest tumbling window has rotated, folds the expiring bank
  into a **retention ladder**: rung 0 records each completed
  shortest-window bank; rung k folds rung k-1 records by the sketch
  monoids (HLL max-merge, CMS add-merge, span totals add) while the
  EWMA/CUSUM heads keep last-value-per-rung. Optionally the writer also
  captures every dispatched span batch as a frame: the replay corpus
  ``runtime.replaybench`` and ``runtime.shadow`` re-feed through a real
  pipeline.

- :class:`HistoryReader` — the query plane's range backend:
  ``range_state(t_from, t_to)`` picks the finest rung that covers the
  range in a bounded record count, merges the in-range records into one
  (arrays, meta) pair shaped for ``runtime.query``'s numpy read
  functions, and collects the anomaly events and top-k candidates the
  record metas carried. A corrupt record is quarantined with evidence
  and skipped; the reader is disk-only and never touches live state.

Corruption contract: the frame trailer/column CRCs catch payload rot
(skip one record); a record HEADER that fails its own CRC means the scan
cannot resync, so the remainder of that segment is quarantined and
scanning stops there. A torn tail from a crash looks identical and is
simply where the log ends.
"""

from __future__ import annotations

import logging
import math
import os
import struct
import threading
import time
from collections import deque
from typing import Callable, NamedTuple

import numpy as np

from . import frame

log = logging.getLogger(__name__)

RECORD_MAGIC = b"OTDH"
KIND_BANK = 0    # one retention-ladder rung record (sketch banks + heads)
KIND_SPANS = 1   # one dispatched span batch (the replay corpus)
KIND_EXPLAIN = 2  # one evidence bundle (runtime.provenance, meta-only frame)

# Record header: magic, kind, rung, reserved, epoch, t_start, t_end,
# frame length — then a CRC32C over those 36 bytes. The header is the
# TIME INDEX: building it never touches a frame payload.
_REC = struct.Struct("<4sBBHQddI")
_REC_CRC = struct.Struct("<I")
HEADER_SIZE = _REC.size + _REC_CRC.size  # 40

_OPEN_SUFFIX = ".open"
_SEG_SUFFIX = ".seg"

# Bounded index scan cache entries per store (segments are few; this
# caps pathological dirs, not normal operation).
_SCAN_CACHE_MAX = 512

# Default cap on records merged per range answer: the finest rung whose
# record count over [from, to] stays under this is chosen, so a month
# query reads hundreds of 1h records instead of millions of 1s ones.
RANGE_MAX_RECORDS = 720

# Fold semantics per state array (the DetectorState names): sketch
# banks merge by their monoids, span totals add, everything else —
# EWMA/CUSUM heads, observation counters, step_idx — is
# last-value-per-rung (decayed statistics have no merge; the newest
# value IS the rung's value).
MERGE_MAX = frozenset({"hll_bank"})
MERGE_ADD = frozenset({"cms_bank", "span_total"})

# The state arrays a bank record carries beside the two banks.
HEAD_ARRAYS = (
    "lat_mean", "lat_var", "err_mean", "rate_mean", "rate_var",
    "card_mean", "card_var", "obs_batches", "obs_windows", "cusum",
    "step_idx",
)

# The span-capture column set (tensorize.SpanColumns fields): enough to
# rebuild the exact batch the pipeline dispatched.
SPAN_CAPTURE_COLUMNS = ("svc", "lat_us", "is_error", "trace_key", "attr_crc")


class HistoryRecord(NamedTuple):
    """One time-index entry: everything the header knows, plus where
    the frame bytes live."""

    path: str
    offset: int  # of the frame payload
    length: int  # frame payload bytes
    kind: int
    rung: int
    epoch: int
    t_start: float
    t_end: float


def merge_record_arrays(acc: dict | None, arrays: dict) -> dict:
    """Fold one record's arrays into an accumulator (monoid merge).

    HLL registers max-merge, CMS counters and span totals add —
    bit-identical to the device merges (integer monoids; pinned by the
    ladder property test) — and every head/counter array replaces
    (last value wins). ``acc=None`` starts a fresh accumulator with
    copies, so record views (possibly into an mmap) never escape."""
    if acc is None:
        return {k: np.array(v, copy=True) for k, v in arrays.items()}
    for k, v in arrays.items():
        if k in MERGE_MAX and k in acc:
            np.maximum(acc[k], v, out=acc[k])
        elif k in MERGE_ADD and k in acc:
            # In place: acc is already a private copy, and a range read
            # folds up to RANGE_MAX_RECORDS banks — one allocation per
            # record would dominate the read-latency histogram.
            np.add(acc[k], v, out=acc[k])
        else:
            acc[k] = np.array(v, copy=True)
    return acc


class HistoryStore:
    """The on-disk segment log: append, seal, scan, read, retire.

    One instance owns a directory. Writers and readers share it (the
    reader side is pure seeks over sealed + active segments); cross-
    process safety comes from the epoch fence, not file locks — the
    same single-writer-per-epoch discipline as the checkpoint volume.
    """

    def __init__(
        self,
        directory: str,
        segment_bytes: int = 8 << 20,
        fence=None,
        retention_s: tuple[float, ...] = (),
    ):
        self.directory = directory
        self.segment_bytes = int(segment_bytes)
        self.fence = fence
        self.retention_s = tuple(float(r) for r in retention_s)
        self._lock = threading.Lock()
        self._active: dict[tuple[int, int], tuple[str, object, int]] = {}
        self._next_seq = 0
        # Counters the daemon exports (monotonic; read via stats()).
        self.appends = 0
        self.sealed = 0
        self.frames_corrupt = 0
        self.segments_retired = 0
        self._scan_cache: dict[str, tuple[int, list[HistoryRecord]]] = {}
        os.makedirs(directory, exist_ok=True)
        self._recover()
        if self.fence is not None:
            observed = self.max_epoch()
            if observed is not None:
                # The log is fencing evidence like the checkpoint
                # volume: records stamped by a later epoch outrank this
                # process before its first append.
                self.fence.observe(observed)

    # -- file naming ----------------------------------------------------

    @staticmethod
    def _basename(kind: int, rung: int, seq: int) -> str:
        prefix = (
            "b" if kind == KIND_BANK
            else "e" if kind == KIND_EXPLAIN
            else "s"
        )
        return f"{prefix}{rung}-{seq:010d}"

    def _recover(self) -> None:
        """Adopt an existing directory: seal stray ``.open`` segments a
        crashed writer left (their torn tail, if any, is where the
        scan stops) and resume the segment sequence past everything
        present."""
        max_seq = -1
        for name in os.listdir(self.directory):
            stem, ext = os.path.splitext(name)
            if ext not in (_OPEN_SUFFIX, _SEG_SUFFIX):
                continue
            try:
                max_seq = max(max_seq, int(stem.rsplit("-", 1)[1]))
            except (IndexError, ValueError):
                continue
            if ext == _OPEN_SUFFIX:
                src = os.path.join(self.directory, name)
                os.replace(src, os.path.join(self.directory, stem + _SEG_SUFFIX))
        self._next_seq = max_seq + 1

    def _segment_files(self) -> list[str]:
        try:
            names = sorted(
                n for n in os.listdir(self.directory)
                if n.endswith((_SEG_SUFFIX, _OPEN_SUFFIX))
            )
        except OSError:
            return []
        return [os.path.join(self.directory, n) for n in names]

    # -- append side ----------------------------------------------------

    def append(
        self,
        kind: int,
        rung: int,
        t_start: float,
        t_end: float,
        payload: bytes,
    ) -> None:
        """Append one frame blob under a header; epoch-fenced.

        Raises :class:`checkpoint.StaleEpochError` (via the fence) when
        a newer epoch has been observed on any channel — a stale
        ex-primary cannot extend the log its successor now owns."""
        epoch = 0
        if self.fence is not None:
            self.fence.check(path="history")
            epoch = int(self.fence.epoch)
        header = _REC.pack(
            RECORD_MAGIC, kind, rung, 0, epoch,
            float(t_start), float(t_end), len(payload),
        )
        header += _REC_CRC.pack(frame.crc32c(header))
        with self._lock:
            key = (kind, rung)
            entry = self._active.get(key)
            if entry is None:
                path = os.path.join(
                    self.directory,
                    self._basename(kind, rung, self._next_seq) + _OPEN_SUFFIX,
                )
                self._next_seq += 1
                entry = (path, open(path, "ab"), 0)
            path, fh, written = entry
            fh.write(header)
            fh.write(payload)
            fh.flush()  # visible to readers; durable only at seal
            written += len(header) + len(payload)
            self.appends += 1
            self._scan_cache.pop(path, None)
            if written >= self.segment_bytes:
                self._seal_locked(key, (path, fh, written))
            else:
                self._active[key] = (path, fh, written)

    def _seal_locked(self, key, entry) -> None:
        path, fh, _written = entry
        fh.flush()
        os.fsync(fh.fileno())
        fh.close()
        sealed = path[: -len(_OPEN_SUFFIX)] + _SEG_SUFFIX
        os.replace(path, sealed)
        self._scan_cache.pop(path, None)
        self.sealed += 1
        self._active.pop(key, None)

    def seal_all(self) -> None:
        """fsync + rename every active segment (shutdown / barrier)."""
        with self._lock:
            for key, entry in list(self._active.items()):
                self._seal_locked(key, entry)

    def close(self) -> None:
        self.seal_all()

    # -- index / read side ----------------------------------------------

    def _scan(self, path: str) -> list[HistoryRecord]:
        """Header-only index of one segment (cached by file size).

        Stops at a torn tail silently; a header whose own CRC fails
        mid-file is corruption — the remainder cannot be resynced, so
        it is quarantined with evidence and the scan ends there."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return []
        cached = self._scan_cache.get(path)
        if cached is not None and cached[0] == size:
            return cached[1]
        records: list[HistoryRecord] = []
        try:
            with open(path, "rb") as f:
                pos = 0
                while pos + HEADER_SIZE <= size:
                    raw = f.read(HEADER_SIZE)
                    if len(raw) < HEADER_SIZE:
                        break  # torn tail: the log simply ends here
                    header, stored = raw[: _REC.size], raw[_REC.size:]
                    (magic, kind, rung, _resv, epoch, t_start, t_end,
                     flen) = _REC.unpack(header)
                    if (
                        magic != RECORD_MAGIC
                        or _REC_CRC.unpack(stored)[0] != frame.crc32c(header)
                    ):
                        self.frames_corrupt += 1
                        rest = header + stored + f.read()
                        frame.quarantine(rest, hop="history")
                        log.error(
                            "history segment %s: unresyncable record "
                            "header at %d — remainder quarantined",
                            path, pos,
                        )
                        break
                    if pos + HEADER_SIZE + flen > size:
                        break  # record body torn mid-write: end of log
                    records.append(HistoryRecord(
                        path, pos + HEADER_SIZE, flen, kind, rung,
                        epoch, t_start, t_end,
                    ))
                    f.seek(flen, os.SEEK_CUR)
                    pos += HEADER_SIZE + flen
        except OSError:
            return []
        if len(self._scan_cache) >= _SCAN_CACHE_MAX:
            self._scan_cache.clear()
        self._scan_cache[path] = (size, records)
        return records

    def records(
        self,
        kind: int = KIND_BANK,
        rung: int | None = None,
        t_from: float | None = None,
        t_to: float | None = None,
    ) -> list[HistoryRecord]:
        """Time-index lookup: matching records across all segments, in
        append (= time) order — built from headers only."""
        out: list[HistoryRecord] = []
        for path in self._segment_files():
            for rec in self._scan(path):
                if rec.kind != kind:
                    continue
                if rung is not None and rec.rung != rung:
                    continue
                if t_to is not None and rec.t_start > t_to:
                    continue
                if t_from is not None and rec.t_end < t_from:
                    continue
                out.append(rec)
        out.sort(key=lambda r: (r.t_start, r.t_end))
        return out

    def read_frame(self, rec: HistoryRecord) -> frame.Frame:
        """seek + memcpy + verified decode of ONE record's frame.

        A failed trailer/column CRC counts, quarantines the bytes with
        evidence, and re-raises :class:`frame.FrameCorrupt` — callers
        skip the record; nothing here can touch live state."""
        with open(rec.path, "rb") as f:
            f.seek(rec.offset)
            buf = f.read(rec.length)
        try:
            return frame.decode(buf)
        except frame.FrameCorrupt:
            self.frames_corrupt += 1
            frame.quarantine(buf, hop="history")
            raise

    def read_meta(self, rec: HistoryRecord) -> dict:
        """Meta-only read of one record's frame (seek + header JSON —
        frame.peek_stream_meta, never the columns): how annotation/
        anomaly range queries walk hours of records without decoding
        megabytes of sketch banks per record. Unreadable = {} (peek
        callers treat any failure as 'no evidence')."""
        try:
            with open(rec.path, "rb") as f:
                f.seek(rec.offset)
                return frame.peek_stream_meta(f).meta
        except (OSError, frame.FrameError):
            return {}

    def max_epoch(self) -> int | None:
        """Largest epoch stamped on any record (fencing evidence), or
        None for an empty log — a header-only scan."""
        best: int | None = None
        for path in self._segment_files():
            for rec in self._scan(path):
                best = rec.epoch if best is None else max(best, rec.epoch)
        return best

    # -- retention ------------------------------------------------------

    def enforce_retention(self, now: float | None = None) -> int:
        """Delete sealed segments every record of which has aged past
        its rung's cap (span-capture records share rung 0's cap).
        Returns the number of files retired."""
        if not self.retention_s:
            return 0
        now = time.time() if now is None else now
        retired = 0
        with self._lock:
            active_paths = {e[0] for e in self._active.values()}
        for path in self._segment_files():
            if path.endswith(_OPEN_SUFFIX) or path in active_paths:
                continue
            recs = self._scan(path)
            if not recs:
                continue
            expired = True
            for rec in recs:
                idx = rec.rung if rec.kind == KIND_BANK else 0
                cap = self.retention_s[min(idx, len(self.retention_s) - 1)]
                if rec.t_end >= now - cap:
                    expired = False
                    break
            if expired:
                try:
                    os.remove(path)
                except OSError:
                    continue
                self._scan_cache.pop(path, None)
                self.segments_retired += 1
                retired += 1
        return retired

    # -- observability ---------------------------------------------------

    def stats(self) -> dict:
        files = self._segment_files()
        total = 0
        oldest: float | None = None
        for path in files:
            try:
                total += os.path.getsize(path)
            except OSError:
                continue
            recs = self._scan(path)
            if recs:
                first = recs[0].t_start
                oldest = first if oldest is None else min(oldest, first)
        return {
            "segments": len(files),
            "bytes": total,
            "oldest_t": oldest,
            "appends": self.appends,
            "sealed": self.sealed,
            "frames_corrupt": self.frames_corrupt,
            "segments_retired": self.segments_retired,
        }


class HistoryWriter:
    """The supervised compaction thread: window banks → ladder → log.

    ``snapshot_fn() -> (arrays, meta)`` is the state snapshot helper
    (``runtime.timetravel.snapshot_fn``): the copy is ordered against
    the steps under the pipeline's dispatch lock, never here, so the
    writer can never race a step. Rung 0 captures each completed
    shortest-window bank as it expires (detected by the window clock's
    boundary advancing between ticks); rung k folds
    ``rungs[k]/rungs[k-1]`` child records into one parent by
    :func:`merge_record_arrays`.
    """

    def __init__(
        self,
        store: HistoryStore,
        snapshot_fn: Callable[[], tuple[dict, dict]],
        rungs: tuple[float, ...] = (1.0, 60.0, 3600.0),
        interval_s: float = 0.5,
        now_fn: Callable[[], float] = time.time,
        capture_spans: bool = False,
        span_queue_max: int = 64,
        retention_every: int = 60,
        span_sample: dict[str, float] | None = None,
        service_names_fn: Callable[[], list[str]] | None = None,
    ):
        self.store = store
        self._snapshot_fn = snapshot_fn
        self.rungs = tuple(float(r) for r in rungs)
        self.interval_s = float(interval_s)
        self.now_fn = now_fn
        self.capture_spans = bool(capture_spans)
        # Per-service capture policy ({name: rate, '*': default-rate};
        # None/{'*': 1.0} = record everything, today's behavior). Set
        # at boot from ANOMALY_HISTORY_SPANS' map form and re-published
        # live by the remediation sampling actuator (flagged service →
        # 1.0) — swapped atomically under the span lock.
        self._span_sample = dict(span_sample) if span_sample else None
        self._service_names_fn = service_names_fn
        self._span_queue: deque = deque(maxlen=max(int(span_queue_max), 1))
        self._span_lock = threading.Lock()
        self.spans_dropped = 0
        self.spans_recorded = 0
        self.spans_sampled_out = 0
        # Evidence bundles (runtime.provenance) awaiting persistence:
        # same bounded drop-oldest handoff as the span queue — the
        # harvester enqueues a JSON-able dict, the compaction thread
        # encodes it as a META-ONLY frame (no columns) so ranged
        # explain reads stay header-only. Flags are rare; the span
        # queue's cap is plenty.
        self._explain_queue: deque = deque(
            maxlen=max(int(span_queue_max), 1)
        )
        self.explains_recorded = 0
        self.explains_dropped = 0
        # Ladder state: per coarse rung, an (accumulator, t_start,
        # child count) triple; rung 0 feeds from the window clock.
        self._acc: list[dict | None] = [None] * len(self.rungs)
        self._acc_start: list[float | None] = [None] * len(self.rungs)
        self._acc_children: list[int] = [0] * len(self.rungs)
        self._last_boundary: float | None = None
        self._clock_offset: float | None = None  # window clock → wall
        self._last_anomaly_t = 0.0
        self.compactions = 0
        self.windows_recorded = 0
        self.windows_missed = 0
        self.evictions_recorded = 0
        self.fenced = False
        self._ticks = 0
        self._retention_every = max(int(retention_every), 1)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        """Spawn the compaction thread (idempotent while it lives)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="history-writer", daemon=True
        )
        self._thread.start()

    def alive(self) -> bool:
        return self._thread is None or self._thread.is_alive()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # Final drain outside the dead thread, then seal: shutdown must
        # not strand captured batches in the queue.
        try:
            self.tick()
        except Exception:  # noqa: BLE001 — teardown races (a snapshot
            pass  # source mid-stop) must not block close
        self.store.close()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — one bad tick (disk
                # hiccup, snapshot raced teardown) is a skipped
                # compaction, never a dead thread; fencing sets its own
                # flag below and real crash loops surface through the
                # supervisor's probe on the daemon side.
                log.exception("history compaction tick failed")

    # -- span capture (the replay corpus) --------------------------------

    def set_span_sample(self, policy: dict[str, float] | None) -> None:
        """Swap the per-service capture policy live (the remediation
        sampling actuator's publish target; any thread)."""
        with self._span_lock:
            self._span_sample = dict(policy) if policy else None

    def span_sample_policy(self) -> dict[str, float] | None:
        with self._span_lock:
            return dict(self._span_sample) if self._span_sample else None

    def _sample_mask(self, cols, policy: dict[str, float]):
        """Per-row keep mask under the per-service policy. Rows sample
        DETERMINISTICALLY by trace key (splitmix64 threshold — the
        selftrace head-sampling trick), so a replayed recording and a
        rerun recording keep the same spans, and all spans of one
        trace land or drop together."""
        svc = np.asarray(cols.svc)
        names = (
            self._service_names_fn()
            if self._service_names_fn is not None else []
        )
        default = float(policy.get("*", 0.0))
        rates = np.full(max(len(names), int(svc.max(initial=-1)) + 1, 1),
                        default, np.float64)
        for i, name in enumerate(names[: rates.shape[0]]):
            rates[i] = float(policy.get(name, default))
        row_rate = rates[np.clip(svc, 0, rates.shape[0] - 1)]
        # splitmix64 finalizer over the trace key → uniform in [0, 2^64).
        x = (np.asarray(cols.trace_key, np.uint64)
             + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
        threshold = (np.clip(row_rate, 0.0, 1.0) * float(2**64)).astype(
            np.float64
        )
        return x.astype(np.float64) < threshold

    def capture(self, cols, t_batch: float) -> None:
        """Remember one dispatched batch (pump thread; bounded, never
        blocks). Columns are COPIED here: in the zero-copy ingest path
        they are views into pooled decode scratch that recycles the
        moment the pipeline drops them. A per-service sample policy
        (``set_span_sample``) keeps only the sampled rows — the
        mitigation-drill recorder that skips the quiet firehose."""
        if not self.capture_spans:
            return
        with self._span_lock:
            policy = self._span_sample
        mask = None
        if policy is not None and policy != {"*": 1.0}:
            mask = self._sample_mask(cols, policy)
            if not mask.any():
                with self._span_lock:
                    self.spans_sampled_out += int(mask.shape[0])
                return
        arrays = {}
        for name in SPAN_CAPTURE_COLUMNS:
            col = np.asarray(getattr(cols, name))
            arrays[name] = (
                np.array(col[mask], copy=True) if mask is not None
                else np.array(col, copy=True)
            )
        with self._span_lock:
            if mask is not None:
                self.spans_sampled_out += int(
                    mask.shape[0] - mask.sum()
                )
            if len(self._span_queue) == self._span_queue.maxlen:
                self.spans_dropped += 1
            self._span_queue.append((arrays, float(t_batch)))

    def _drain_spans(self, now: float) -> None:
        while True:
            with self._span_lock:
                if not self._span_queue:
                    return
                arrays, t_batch = self._span_queue.popleft()
            blob = frame.encode(arrays, meta={"t_batch": t_batch})
            self.store.append(KIND_SPANS, 0, now, now, blob)
            self.spans_recorded += 1

    # -- evidence-bundle capture (runtime.provenance) --------------------

    def capture_explain(self, bundle: dict) -> None:
        """Remember one evidence bundle (harvester thread; bounded,
        never blocks). The bundle is already a plain JSON-able dict —
        no copy-out needed, it is never mutated after build."""
        with self._span_lock:
            if len(self._explain_queue) == self._explain_queue.maxlen:
                self.explains_dropped += 1
            self._explain_queue.append(bundle)

    def _drain_explains(self, now: float) -> None:
        while True:
            with self._span_lock:
                if not self._explain_queue:
                    return
                bundle = self._explain_queue.popleft()
            # Meta-only frame: the bundle IS the header JSON, so the
            # ranged explain read (read_meta) never decodes columns.
            blob = frame.encode({}, meta=dict(bundle))
            t = float(bundle.get("t") or now)
            self.store.append(KIND_EXPLAIN, 0, t, t, blob)
            self.explains_recorded += 1

    # -- compaction ------------------------------------------------------

    def tick(self, now: float | None = None) -> None:
        """One compaction step (the thread's body; callable directly
        with a virtual clock from tests and replaybench)."""
        from .checkpoint import StaleEpochError

        now = self.now_fn() if now is None else now
        if self.fenced:
            return  # a stale writer stays quiet until restart/redeploy
        try:
            self._drain_spans(now)
            self._drain_explains(now)
            self._tick_banks(now)
        except StaleEpochError as e:
            # Fourth fencing path: the epoch moved past us — stop
            # appending (visibly: anomaly_replication_fenced_total
            # {path=history} counts every refused write).
            self.fenced = True
            log.error("history writer fenced: %s", e)
            return
        self._ticks += 1
        if self._ticks % self._retention_every == 0:
            self.store.enforce_retention(now)

    def _tick_banks(self, now: float) -> None:
        try:
            arrays, meta = self._snapshot_fn()
        except Exception:  # noqa: BLE001 — snapshot source mid-restart:
            return  # skip the tick, the next one retries
        if not arrays:
            return
        t_clock = meta.get("clock_t_prev")
        if t_clock is None:
            return
        w0 = self.rungs[0]
        boundary = math.floor(float(t_clock) / w0) * w0
        if self._last_boundary is None:
            # First observation: remember the phase and the window-
            # clock→wall offset; the current prev bank's provenance is
            # unknown (it may predate this writer), so don't record it.
            self._last_boundary = boundary
            self._clock_offset = now - float(t_clock)
            return
        if boundary <= self._last_boundary:
            return
        missed = int(round((boundary - self._last_boundary) / w0)) - 1
        if missed > 0:
            # Rotations we never saw (a stalled tick, a long GC): the
            # banks for those windows are gone — count, never fake.
            self.windows_missed += missed
        self._last_boundary = boundary
        offset = self._clock_offset if self._clock_offset is not None else 0.0
        t_end = boundary + offset
        t_start = t_end - w0
        record = self._bank_record(arrays)
        rec_meta = self._record_meta(arrays, meta, t_start, t_end)
        self._emit(0, t_start, t_end, record, rec_meta)
        self.windows_recorded += 1

    @staticmethod
    def _bank_record(arrays: dict) -> dict:
        """The rung-record array set from one state snapshot: the
        EXPIRING shortest-window banks (slot [0, 1] — just rotated to
        'previous') plus the head/counter arrays as-of now."""
        record = {
            "hll_bank": np.array(arrays["hll_bank"][0, 1], copy=True),
            "cms_bank": np.array(arrays["cms_bank"][0, 1], copy=True),
            "span_total": np.array(arrays["span_total"][0, 1], copy=True),
        }
        for name in HEAD_ARRAYS:
            if name in arrays:
                record[name] = np.array(arrays[name], copy=True)
        return record

    def _record_meta(
        self, arrays: dict, meta: dict, t_start: float, t_end: float
    ) -> dict:
        """JSON meta block for a rung record: identity (seq/epoch via
        the header too — these ride where peek_meta sees them), the
        intern table + config the query fns need, and the query-plane
        evidence captured during this window (anomaly events new since
        the last record, the current top-k candidate rings)."""
        q = meta.get("query") or {}
        events = [
            dict(ev) for ev in (q.get("anomalies") or [])
            if float(ev.get("t") or 0.0) > self._last_anomaly_t
        ]
        if events:
            self._last_anomaly_t = max(float(e["t"]) for e in events)
        return {
            "seq": int(np.asarray(arrays.get("step_idx", 0))),
            "t_start": t_start,
            "t_end": t_end,
            "service_names": list(meta.get("service_names") or []),
            "config": list(meta.get("config") or []),
            # Keyspace generation at capture time: range reads refuse
            # to merge records across an eviction sweep's id recycling
            # (the drift-refusal contract, runtime/keyspace.py).
            "generation": int(meta.get("generation") or 0),
            "query": {
                "anomalies": events,
                "hh_candidates": dict(q.get("hh_candidates") or {}),
            },
        }

    # -- eviction folds (runtime/keyspace.py) ----------------------------

    def record_eviction(
        self, record: dict, rec_meta: dict, now: float | None = None
    ) -> None:
        """Append one eviction fold record: the evicted keys' final
        head rows + in-progress window bank, captured by the keyspace
        evictor UNDER the dispatch lock before it zeroed them. Rung 0,
        appended directly (no upward cascade — the ladder accumulators
        count window children, and this record is not a window). The
        record carries the PRE-bump generation: its rows are
        attributed under the OLD id assignment, exactly the records it
        may merge with."""
        from .checkpoint import StaleEpochError

        if self.fenced:
            return
        now = self.now_fn() if now is None else now
        t_start = now - self.rungs[0]
        blob = frame.encode(
            record,
            meta=dict(rec_meta, rung=0, t_start=t_start, t_end=now),
        )
        try:
            self.store.append(KIND_BANK, 0, t_start, now, blob)
        except StaleEpochError as e:
            self.fenced = True
            log.error("history writer fenced: %s", e)
            return
        self.evictions_recorded += 1

    def _emit(
        self, rung_idx: int, t_start: float, t_end: float,
        record: dict, rec_meta: dict,
    ) -> None:
        """Append one rung record, then fold it upward: when a coarse
        rung's accumulator has absorbed a full span of children it
        emits its own record and cascades."""
        blob = frame.encode(
            record,
            meta=dict(
                rec_meta, rung=rung_idx, t_start=t_start, t_end=t_end
            ),
        )
        self.store.append(KIND_BANK, rung_idx, t_start, t_end, blob)
        parent = rung_idx + 1
        if parent >= len(self.rungs):
            return
        if self._acc[parent] is None:
            self._acc_start[parent] = t_start
            self._acc_children[parent] = 0
        self._acc[parent] = merge_record_arrays(self._acc[parent], record)
        self._acc_children[parent] += 1
        fanout = int(round(self.rungs[parent] / self.rungs[rung_idx]))
        if self._acc_children[parent] >= fanout:
            acc = self._acc[parent]
            start = self._acc_start[parent]
            self._acc[parent] = None
            self.compactions += 1
            self._emit(parent, start, t_end, acc, rec_meta)

    def stats(self) -> dict:
        return {
            "compactions": self.compactions,
            "windows_recorded": self.windows_recorded,
            "windows_missed": self.windows_missed,
            "evictions_recorded": self.evictions_recorded,
            "spans_recorded": self.spans_recorded,
            "spans_dropped": self.spans_dropped,
            "explains_recorded": self.explains_recorded,
            "explains_dropped": self.explains_dropped,
            "fenced": self.fenced,
        }


# DetectorConfig's windows tuple rides positionally in the persisted
# config list (the checkpoint/replication convention runtime.query also
# relies on).
_CFG_WINDOWS = 4


class HistoryReader:
    """Range reads over a :class:`HistoryStore` for the query plane.

    Every answer is (arrays, meta) shaped for runtime.query's pure
    read functions — the SAME numpy path live answers take, so a
    historical top-k and a live top-k are the same arithmetic over
    different banks. Disk-only: no reference to any live object."""

    def __init__(
        self,
        store: HistoryStore,
        rungs: tuple[float, ...] = (1.0, 60.0, 3600.0),
        max_records: int = RANGE_MAX_RECORDS,
    ):
        self.store = store
        self.rungs = tuple(float(r) for r in rungs)
        self.max_records = int(max_records)

    def pick_rung(
        self, t_from: float, t_to: float, resolution: float | None = None
    ) -> int:
        """Finest rung that answers the range in a bounded record
        count (or the rung matching an explicit resolution)."""
        if resolution is not None:
            for i, r in enumerate(self.rungs):
                if r >= float(resolution):
                    return i
            return len(self.rungs) - 1
        span = max(t_to - t_from, 0.0)
        for i, r in enumerate(self.rungs):
            if span / r <= self.max_records:
                return i
        return len(self.rungs) - 1

    def range_state(
        self,
        t_from: float,
        t_to: float,
        resolution: float | None = None,
        generation: int | None = None,
    ) -> tuple[dict, dict] | None:
        """Merged (arrays, meta) over [t_from, t_to], or None when no
        record overlaps. Corrupt records are skipped (counted +
        quarantined by the store) — the merge is over what survives.

        Records are merged within ONE keyspace generation only: an
        eviction sweep recycles intern ids, so two records across a
        generation bump may attribute the same row to different
        services — refused, never mis-merged (the ShardMergeError
        discipline applied to disk). ``generation=None`` merges the
        NEWEST generation in range (header-only pre-scan) and counts
        the rest in ``skipped_generation``."""
        rung_idx = self.pick_rung(t_from, t_to, resolution)
        recs = self.store.records(
            kind=KIND_BANK, rung=rung_idx, t_from=t_from, t_to=t_to
        )
        target_gen = generation
        if target_gen is None:
            for rec in reversed(recs):
                m = self.store.read_meta(rec)
                if m is not None:
                    target_gen = int(m.get("generation") or 0)
                    break
        merged: dict | None = None
        last_meta: dict = {}
        anomalies: list = []
        candidates: dict[str, list] = {}
        skipped = 0
        skipped_gen = 0
        cover_from: float | None = None
        cover_to: float | None = None
        for rec in recs:
            try:
                fr = self.store.read_frame(rec)
            except frame.FrameCorrupt:
                skipped += 1
                continue
            if int(fr.meta.get("generation") or 0) != (target_gen or 0):
                skipped_gen += 1
                continue
            merged = merge_record_arrays(merged, fr.arrays)
            last_meta = fr.meta
            for ev in (fr.meta.get("query") or {}).get("anomalies") or []:
                t = float(ev.get("t") or 0.0)
                if t_from <= t <= t_to:
                    anomalies.append(dict(ev))
            for svc, crcs in (
                (fr.meta.get("query") or {}).get("hh_candidates") or {}
            ).items():
                seen = candidates.setdefault(svc, [])
                for c in crcs:
                    if c not in seen:
                        seen.append(c)
            cover_from = rec.t_start if cover_from is None else min(
                cover_from, rec.t_start
            )
            cover_to = rec.t_end if cover_to is None else max(
                cover_to, rec.t_end
            )
        if merged is None:
            return None
        arrays = self._as_query_arrays(merged)
        span = (
            (cover_to - cover_from)
            if cover_from is not None and cover_to is not None
            else self.rungs[rung_idx]
        )
        native_config = list(last_meta.get("config") or [])
        config = list(native_config)
        if len(config) > _CFG_WINDOWS:
            # The merged bank is ONE window spanning the covered range;
            # the read fns take windows_s from this positional slot.
            # The untouched original rides beside it ("native_config")
            # for answers about the head state, whose window axis keeps
            # the detector's own geometry.
            config[_CFG_WINDOWS] = (float(span),)
        meta = {
            "service_names": list(last_meta.get("service_names") or []),
            "config": config,
            "native_config": native_config,
            "query": {
                "anomalies": anomalies,
                "hh_candidates": candidates,
                "exemplars": {},
            },
            "seq": int(last_meta.get("seq") or 0),
            "generation": int(target_gen or 0),
            "resolution_s": self.rungs[rung_idx],
            "records": len(recs) - skipped - skipped_gen,
            "skipped_corrupt": skipped,
            "skipped_generation": skipped_gen,
            "coverage": [cover_from, cover_to],
        }
        return arrays, meta

    def service_range_state(
        self,
        name: str,
        t_from: float,
        t_to: float,
        resolution: float | None = None,
    ) -> tuple[dict, dict] | None:
        """Merged state for the NEWEST generation that still knows
        ``name`` — the evicted-key query fallback: a key retired from
        the live table answers from the records minted while it owned
        its id (the eviction fold rode in with the same generation, so
        its final head rows are the last-value winners). Header-only
        scans locate the generation; None when no record in range ever
        interned the name."""
        for rung_idx in (
            self.pick_rung(t_from, t_to, resolution), 0
        ):
            found = None
            for rec in reversed(self.store.records(
                kind=KIND_BANK, rung=rung_idx, t_from=t_from, t_to=t_to
            )):
                m = self.store.read_meta(rec)
                if m and name in (m.get("service_names") or []):
                    found = int(m.get("generation") or 0)
                    break
            if found is not None:
                return self.range_state(
                    t_from, t_to,
                    resolution=self.rungs[rung_idx],
                    generation=found,
                )
        return None

    @staticmethod
    def _as_query_arrays(merged: dict) -> dict:
        """Shape a merged record like the live state snapshot the
        query read fns expect: one-window banks in the [W#, 2, ...]
        bank layout (slot 0 = the merged 'current', slot 1 zeroed),
        heads at their native shapes."""
        arrays = dict(merged)
        hll = np.asarray(merged["hll_bank"])
        cms_t = np.asarray(merged["cms_bank"])
        total = np.asarray(merged["span_total"], dtype=np.float32)
        arrays["hll_bank"] = np.stack(
            [hll, np.zeros_like(hll)], axis=0
        )[None]
        arrays["cms_bank"] = np.stack(
            [cms_t, np.zeros_like(cms_t)], axis=0
        )[None]
        arrays["span_total"] = np.asarray(
            [[float(total), 0.0]], dtype=np.float32
        )
        return arrays

    def timeline(
        self,
        t_from: float,
        t_to: float,
        resolution: float | None = None,
    ) -> list[dict]:
        """Per-record datapoints over the range (the Grafana true-range
        backend): one entry per surviving record with its per-service
        HLL estimate and max CUSUM — seek + decode + estimate, live
        state untouched."""
        from ..ops.hll import hll_estimate_np

        rung_idx = self.pick_rung(t_from, t_to, resolution)
        points: list[dict] = []
        for rec in self.store.records(
            kind=KIND_BANK, rung=rung_idx, t_from=t_from, t_to=t_to
        ):
            try:
                fr = self.store.read_frame(rec)
            except frame.FrameCorrupt:
                continue
            est = hll_estimate_np(np.asarray(fr.arrays["hll_bank"]))
            cusum = np.asarray(fr.arrays.get("cusum"))
            points.append({
                "t": rec.t_end,
                "seq": int(fr.meta.get("seq") or 0),
                "card": [float(x) for x in est],
                "cusum_max": (
                    [float(x) for x in cusum.max(axis=1)]
                    if cusum is not None and cusum.ndim == 2 else []
                ),
                "service_names": list(
                    fr.meta.get("service_names") or []
                ),
                "resolution_s": self.rungs[rung_idx],
            })
        return points

    def anomaly_events(
        self, t_from: float, t_to: float
    ) -> tuple[list[dict], list[str]]:
        """(events, service_names) over the range from record META
        blocks alone — header-only reads (peek_stream_meta), no bank
        decode: the /query/anomalies and Grafana annotation range
        backend. Finest rung only (events are recorded once, at
        rung 0; coarser rungs carry the same fold's meta)."""
        events: list[dict] = []
        names: list[str] = []
        for rec in self.store.records(
            kind=KIND_BANK, rung=0, t_from=t_from, t_to=t_to
        ):
            meta = self.store.read_meta(rec)
            if not meta:
                continue
            if meta.get("service_names"):
                names = list(meta["service_names"])
            for ev in (meta.get("query") or {}).get("anomalies") or []:
                t = float(ev.get("t") or 0.0)
                if t_from <= t <= t_to:
                    events.append(dict(ev))
        return events, names

    def explain_events(self, t_from: float, t_to: float) -> list[dict]:
        """Evidence bundles over the range, oldest first — meta-only
        reads over the KIND_EXPLAIN log (the bundle IS the frame's
        header JSON; no columns exist to decode). The ranged
        /query/explain backend, and the restart-survival half of the
        provenance contract: a bundle recorded before a daemon restart
        answers from disk here."""
        bundles: list[dict] = []
        for rec in self.store.records(
            kind=KIND_EXPLAIN, t_from=t_from, t_to=t_to
        ):
            meta = self.store.read_meta(rec)
            if not meta:
                continue
            t = float(meta.get("t") or rec.t_start)
            if t_from <= t <= t_to:
                bundles.append(meta)
        return bundles

    def span_records(
        self,
        from_ts: float | None = None,
        to_ts: float | None = None,
    ) -> list[HistoryRecord]:
        """The explicit "recent window" read API over the span-capture
        log: KIND_SPANS record headers whose [t_start, t_end] overlaps
        [from_ts, to_ts], in log order — a header-only time filter (no
        frame decode), so the shadow pre-flight and other windowed
        consumers stop re-scanning whole segments. Decode each record
        with :meth:`read_span_record`."""
        return self.store.records(
            kind=KIND_SPANS, t_from=from_ts, t_to=to_ts
        )

    def read_span_record(self, rec: HistoryRecord):
        """Decode ONE span-capture record: (arrays, t_batch), or
        (None, None) when corrupt — counted + quarantined by the store
        per the existing hop contract, skipped by the caller."""
        try:
            fr = self.store.read_frame(rec)
        except frame.FrameCorrupt:
            return None, None
        t_batch = fr.meta.get("t_batch")
        # 0.0 is a legitimate virtual timebase — only ABSENT falls
        # back to the record's wall stamp.
        return fr.arrays, float(
            rec.t_start if t_batch is None else t_batch
        )

    def span_batches(
        self, t_from: float | None = None, t_to: float | None = None
    ):
        """The replay corpus: (arrays, t_batch) per recorded span
        batch in log order; corrupt records are skipped (counted)."""
        for rec in self.span_records(t_from, t_to):
            arrays, t_batch = self.read_span_record(rec)
            if arrays is None:
                continue
            yield arrays, t_batch
