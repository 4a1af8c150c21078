"""Span records → fixed-width batches (the host hot path).

A span record here is the minimal tuple the detector consumes:
``(service, duration_us, trace_id, is_error, attr)``. Strings die at
this boundary:

- ``service`` → a small int id via a bounded intern table; the last id
  is the overflow bucket, so shapes never change.
- ``trace_id`` → its first 8 bytes as a little-endian uint64, then
  splitmix64 → (hi, lo) uint32 lanes.
- ``attr`` → CRC32 of the string, folded with the service id, then
  splitmix64: the (service, attr) CMS key.
- ``duration_us``, ``is_error`` → float32 lanes.

Batches are fixed width ``B`` with a validity mask. The arrays stay
numpy (the hash lanes ``uint32``); the detector moves them to the device
in one copy and reinterprets the hash lanes as ``int32``.

The intern table is bounded and has a key lifecycle (driven by
``runtime.keyspace``): ids of idle keys retire into a free list behind a
generation bump and are reused lowest first, and a new-key gate lets the
keyspace ladder park new keys in the overflow bucket. An
:class:`InternArena` caches ids for one decode worker and drops its cache
when the generation moves.

Both decode paths produce :class:`SpanColumns`: the per-record Python
loop (``columns_from_records``) and the native decoder's columns
(``columns_from_columnar``), bit for bit. ``pack_columns_into`` packs
into preallocated arrays (a spine ring slot) with the bits of
``pack_columns``.
"""

from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass
from typing import Callable, Iterable, NamedTuple

import numpy as np

from ..ops.hashing import split_hi_lo_np, splitmix64_np

# Positional placeholder for an id slot the keyspace evictor freed and
# nothing has reclaimed yet. It round-trips through every surface that
# carries the name table positionally (checkpoint meta) and cannot
# collide with a real service name: OTLP service.name values are
# printable, so a NUL-prefixed sentinel cannot be interned from the wire.
EVICTED_SLOT = "\x00evicted"


class SpanEvent(NamedTuple):
    """One span event. ``ts_offset_us`` is relative to span START;
    ``attrs`` is a tuple of (key, value) pairs so the record stays
    hashable."""

    name: str
    ts_offset_us: float = 0.0
    attrs: tuple = ()


# Event names that carry error-cause evidence: the OTel semconv
# record_exception name, and the "error"/"Error" events some services
# emit instead. Spans carrying one feed the error lane even when their
# status is unset.
EXCEPTION_EVENT_NAMES = ("exception", "error", "Error")


def has_exception_event(events) -> bool:
    return any(e.name in EXCEPTION_EVENT_NAMES for e in events)


class SpanRecord(NamedTuple):
    """One ingested span."""

    service: str
    duration_us: float
    trace_id: bytes | int
    is_error: bool = False
    attr: str | None = None
    name: str | None = None  # operation name; the tensorizer ignores it
    events: tuple = ()  # SpanEvent tuple; exception events → error lane


class SpanColumns(NamedTuple):
    """Interned columnar records — the pipeline's pending currency."""

    svc: np.ndarray  # int32 — interned service ids
    lat_us: np.ndarray  # float32
    is_error: np.ndarray  # float32
    trace_key: np.ndarray  # uint64 — first 8 bytes of trace id, LE
    attr_crc: np.ndarray  # uint64 — CRC32 of the monitored attr value

    @property
    def rows(self) -> int:
        return self.svc.shape[0]

    def slice(self, start: int, stop: int) -> "SpanColumns":
        return SpanColumns(*(a[start:stop] for a in self))

    def compress(self, keep: np.ndarray) -> "SpanColumns":
        """Rows where ``keep`` (bool mask) is True, order preserved — the
        shed and brownout paths' row selection."""
        return SpanColumns(*(a[keep] for a in self))

    @staticmethod
    def concat(parts: list["SpanColumns"]) -> "SpanColumns":
        if len(parts) == 1:
            return parts[0]
        return SpanColumns(*(np.concatenate(cols) for cols in zip(*parts)))


class TensorBatch(NamedTuple):
    """Fixed-width batch; all arrays length ``B``."""

    svc: np.ndarray  # int32 — service id
    lat_us: np.ndarray  # float32 — span duration
    is_error: np.ndarray  # float32 — 0/1 status flag
    trace_hi: np.ndarray  # uint32 — trace-id hash hi lane
    trace_lo: np.ndarray  # uint32
    attr_hi: np.ndarray  # uint32 — folded (service, attr) key hash
    attr_lo: np.ndarray  # uint32
    valid: np.ndarray  # bool

    @property
    def batch_size(self) -> int:
        return self.svc.shape[0]

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())


class InternArena:
    """Per-worker intern cache over a shared :class:`SpanTensorizer`.

    Lookups resolve against the arena's private dict; only a batch that
    carries a name this arena has never seen reconciles with the shared
    table, through one ``intern_many`` call. Ids are global and stay put
    until the evictor retires them, which bumps the tensorizer's
    generation: the arena then drops its whole cache, since a cached id
    may have been recycled to another service.
    """

    __slots__ = ("_tz", "_local", "_gen")

    def __init__(self, tensorizer: "SpanTensorizer"):
        self._tz = tensorizer
        self._local: dict[str, int] = {}
        self._gen = tensorizer.generation

    def lookup(self, names: list[str]) -> list[int]:
        """Resolve ``names`` (first-appearance order) to ids."""
        if self._gen != self._tz.generation:
            self._local = {}
            self._gen = self._tz.generation
        local = self._local
        try:
            return [local[n] for n in names]
        except KeyError:
            pass
        ids = self._tz.intern_many(names)
        ov = self._tz.num_services - 1
        for n, sid in zip(names, ids):
            # Never cache the overflow id: a key parked there must ask
            # the shared table again once a slot frees.
            if sid != ov:
                local[n] = sid
        return ids


@dataclass
class SpanTensorizer:
    """Stateful bounded interner + vectorised hasher; one per stream.

    ``num_services`` bounds the service axis of every sketch; the last id
    is the overflow ("other") bucket. A name that cannot get a slot (the
    table is full, or ``new_key_gate`` refused it) folds into the bucket
    and is not memorised, so memory stays bounded.
    """

    num_services: int = 32
    batch_size: int = 2048

    def __post_init__(self) -> None:
        self._svc_ids: dict[str, int] = {}
        # Receivers intern on their own threads; the lock makes
        # check-then-assign atomic. Hits read an immutable snapshot dict
        # without the lock; a miss republishes a fresh snapshot.
        self._intern_lock = threading.Lock()
        self._svc_snapshot: dict[str, int] = {}
        # Id-ordered mirror of _svc_ids (None = never assigned,
        # EVICTED_SLOT = freed, awaiting reuse): positional order
        # survives id recycling, which dict insertion order does not.
        self._names_by_id: list[str | None] = []
        self._free_ids: list[int] = []  # retired ids, ascending reuse
        self._next_id = 0  # next never-used dense slot
        # Bumped once per retirement sweep; checkpoints carry it so a
        # restored process knows which ids were recycled.
        self.generation = 0
        # Consulted under the intern lock on a genuine miss only: False
        # parks the new key in the overflow bucket (the keyspace
        # ladder's throttle and collapse rungs). Known keys never reach it.
        self.new_key_gate: Callable[[str], bool] | None = None
        self.evicted_total = 0  # ids retired over the process lifetime
        self.overflow_assigns_total = 0  # misses parked in overflow

    @property
    def service_names(self) -> list[str]:
        """Positional name table: index i is the name owning id i
        (EVICTED_SLOT marks freed slots)."""
        return [EVICTED_SLOT if n is None else n for n in self._names_by_id]

    @property
    def capacity(self) -> int:
        """Real (non-overflow) id slots."""
        return self.num_services - 1

    @property
    def live_keys(self) -> int:
        return len(self._svc_ids)

    @property
    def free_ids(self) -> int:
        return len(self._free_ids)

    def service_id(self, name: str) -> int:
        sid = self._svc_snapshot.get(name)
        if sid is None:
            with self._intern_lock:
                sid = self._assign_locked(name)
        return sid

    def _assign_locked(self, name: str, publish: bool = True) -> int:
        """Assign (or find) ``name``'s id under the intern lock: recycled
        ids first (ascending), then dense first-appearance ranks, the
        last id reserved as overflow. ``publish=False`` leaves the
        snapshot publication to the caller (one per batch)."""
        sid = self._svc_ids.get(name)
        if sid is None:
            gate = self.new_key_gate
            if gate is not None and not gate(name):
                # Refused: overflow, and not memorised, so the key
                # applies again on its next sighting.
                self.overflow_assigns_total += 1
                return self.num_services - 1
            if self._free_ids:
                sid = self._free_ids.pop(0)
            elif self._next_id < self.num_services - 1:
                sid = self._next_id
                self._next_id += 1
            else:
                self.overflow_assigns_total += 1
                return self.num_services - 1
            self._svc_ids[name] = sid
            while len(self._names_by_id) <= sid:
                self._names_by_id.append(None)
            self._names_by_id[sid] = name
            if publish:
                self._svc_snapshot = dict(self._svc_ids)
        return sid

    def intern_many(self, names: list[str]) -> list[int]:
        """Batched intern with at most one lock acquisition. Misses are
        assigned in first-appearance order of ``names``, so ids equal a
        serial :meth:`service_id` loop's; names the table refused resolve
        to the overflow id without being memorised."""
        snap = self._svc_snapshot
        if all(n in snap for n in names):
            return [snap[n] for n in names]
        ov = self.num_services - 1
        with self._intern_lock:
            before = len(self._svc_ids)
            for n in names:
                if n not in self._svc_ids:
                    self._assign_locked(n, publish=False)
            if len(self._svc_ids) != before:
                self._svc_snapshot = dict(self._svc_ids)
            snap = self._svc_snapshot
        return [snap.get(n, ov) for n in names]

    def retire_services(self, names: list[str]) -> list[int]:
        """Retire ``names``: their ids join the free list (ascending) and
        the generation bumps once for the sweep. Returns the freed ids.

        The caller holds the pipeline's dispatch lock and has zeroed the
        retired rows of the detector state first: a freed id can go to a
        new service on the very next flush.
        """
        freed: list[int] = []
        with self._intern_lock:
            for name in names:
                sid = self._svc_ids.pop(name, None)
                if sid is None or sid >= self.num_services - 1:
                    continue  # unknown, or the overflow bucket
                self._names_by_id[sid] = EVICTED_SLOT
                freed.append(sid)
            if freed:
                self._free_ids.extend(freed)
                self._free_ids.sort()
                self.evicted_total += len(freed)
                self.generation += 1
                self._svc_snapshot = dict(self._svc_ids)
        return freed

    def adopt_names(self, names: list[str]) -> None:
        """Rebuild the table positionally from a checkpoint's name list
        (index = id), EVICTED_SLOT tombstones as free slots. A plain
        :meth:`service_id` replay would re-densify around the holes and
        shift every id after the first tombstone."""
        with self._intern_lock:
            self._svc_ids = {}
            self._names_by_id = []
            self._free_ids = []
            for sid, name in enumerate(names[: self.num_services - 1]):
                if name is None or name == EVICTED_SLOT:
                    self._names_by_id.append(EVICTED_SLOT)
                    self._free_ids.append(sid)
                else:
                    self._names_by_id.append(name)
                    self._svc_ids[name] = sid
            self._next_id = len(self._names_by_id)
            self._svc_snapshot = dict(self._svc_ids)

    def tensorize(self, records: Iterable[SpanRecord]) -> list[TensorBatch]:
        """Pack records into one or more fixed-width batches."""
        cols = self.columns_from_records(list(records))
        return [
            self.pack_columns(cols.slice(start, start + self.batch_size))
            for start in range(0, max(cols.rows, 1), self.batch_size)
        ]

    def columns_from_records(self, records: list[SpanRecord]) -> SpanColumns:
        """Records → interned columns, one ``np.fromiter`` per lane and
        all trace ids through one ``np.frombuffer``."""
        n = len(records)
        svc = np.fromiter(
            (self.service_id(r.service) for r in records), np.int32, count=n
        )
        lat = np.fromiter((r.duration_us for r in records), np.float32, count=n)
        err = np.fromiter(
            (
                1.0 if (r.is_error or has_exception_event(r.events)) else 0.0
                for r in records
            ),
            np.float32, count=n,
        )
        # Trace ids: first 8 bytes little-endian, zero-padded (int ids go
        # through the same 8-byte LE layout).
        joined = b"".join(
            bytes(r.trace_id[:8]).ljust(8, b"\0")
            if isinstance(r.trace_id, (bytes, bytearray))
            else (r.trace_id & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
            for r in records
        )
        tid = np.frombuffer(joined, dtype=np.uint64, count=n).copy()
        crc = np.fromiter(
            (
                zlib.crc32((r.attr if r.attr is not None else "").encode())
                for r in records
            ),
            np.uint64, count=n,
        )
        return SpanColumns(svc, lat, err, tid, crc)

    def columns_from_columnar(
        self, cols, copy: bool = False, arena: InternArena | None = None
    ) -> SpanColumns:
        """Adopt a native-decoder batch (``runtime.native.ColumnarSpans``).

        Interns the batch's service names (``None``, a resource without
        service.name, becomes the record decoder's "unknown"; an empty
        name interns as ``""``) and maps the per-row resource indices
        through. Only names some span references are interned, in
        first-appearance order (``svc_idx`` is monotone in document
        order), so ids equal the record path's. ``arena`` resolves names
        against a worker's own cache first; ids are the same either way.

        ``copy=True`` makes every lane own its memory: required when
        ``cols`` are views into a decode scratch that the next decode
        will overwrite.
        """
        ids = np.zeros(max(len(cols.services), 1), np.int32)
        seen = np.zeros(max(len(cols.services), 1), bool)
        seen[cols.svc_idx] = True
        live = np.nonzero(seen)[0]
        if arena is not None:
            names = ["unknown" if cols.services[i] is None else cols.services[i] for i in live]
            ids[live] = arena.lookup(names)
        else:
            for i in live:
                name = cols.services[i]
                ids[i] = self.service_id("unknown" if name is None else name)
        return SpanColumns(
            svc=ids[cols.svc_idx],
            lat_us=cols.duration_us.astype(np.float32, copy=copy),
            # The record path's exception-event fold: the decoder flags
            # spans that carry an exception/error event.
            is_error=np.maximum(cols.is_error, cols.has_exception).astype(np.float32),
            trace_key=cols.trace_key.copy() if copy else cols.trace_key,
            attr_crc=cols.attr_crc.astype(np.uint64),
        )

    def pack_columns(self, cols: SpanColumns, width: int | None = None) -> TensorBatch:
        """Columns → one padded, hashed batch."""
        return self.pack_arrays(
            cols.svc, cols.lat_us, cols.trace_key, cols.is_error, cols.attr_crc,
            width=width,
        )

    def alloc_batch(self, width: int | None = None) -> TensorBatch:
        """Width-sized host arrays for :meth:`pack_columns_into`."""
        b = width if width is not None else self.batch_size
        return TensorBatch(
            np.zeros(b, np.int32),
            np.zeros(b, np.float32),
            np.zeros(b, np.float32),
            np.zeros(b, np.uint32),
            np.zeros(b, np.uint32),
            np.zeros(b, np.uint32),
            np.zeros(b, np.uint32),
            np.zeros(b, bool),
        )

    def pack_columns_into(
        self, out: TensorBatch, cols: SpanColumns, chunk_rows: int = 0
    ) -> TensorBatch:
        """:meth:`pack_columns` into preallocated arrays, bit for bit.

        ``out`` is any eight same-length arrays that take the lanes'
        values (a spine ring slot holds int32 views of one pinned buffer,
        its ``valid`` lane as 0/1). Rows are hashed and copied in
        ``chunk_rows`` blocks (0: one block); the tail is padded as
        :meth:`pack_arrays` pads it: numeric lanes zero, hash lanes the
        hash of the zero key, ``valid`` False. No width-sized array is
        allocated.
        """
        n = cols.rows
        b = out.svc.shape[0]
        if n > b:
            raise ValueError(f"chunk of {n} exceeds batch width {b}")
        step = int(chunk_rows) if chunk_rows and chunk_rows > 0 else max(n, 1)
        for s0 in range(0, n, step):
            sl = slice(s0, min(s0 + step, n))
            out.svc[sl] = cols.svc[sl]
            out.lat_us[sl] = cols.lat_us[sl]
            out.is_error[sl] = cols.is_error[sl]
            key = cols.attr_crc[sl].astype(np.uint64) | (
                cols.svc[sl].astype(np.uint64) << np.uint64(32)
            )
            t_hi, t_lo = split_hi_lo_np(splitmix64_np(cols.trace_key[sl]))
            a_hi, a_lo = split_hi_lo_np(splitmix64_np(key))
            out.trace_hi[sl] = t_hi
            out.trace_lo[sl] = t_lo
            out.attr_hi[sl] = a_hi
            out.attr_lo[sl] = a_lo
            out.valid[sl] = True
        tail = slice(n, b)
        out.svc[tail] = 0
        out.lat_us[tail] = 0.0
        out.is_error[tail] = 0.0
        z_hi, z_lo = split_hi_lo_np(splitmix64_np(np.zeros(1, np.uint64)))
        out.trace_hi[tail] = z_hi[0]
        out.trace_lo[tail] = z_lo[0]
        out.attr_hi[tail] = z_hi[0]
        out.attr_lo[tail] = z_lo[0]
        out.valid[tail] = False
        return out

    def pack_arrays(
        self,
        svc: np.ndarray,
        lat_us: np.ndarray,
        trace_id: np.ndarray,
        is_error: np.ndarray | None = None,
        attr_key: np.ndarray | None = None,
        width: int | None = None,
    ) -> TensorBatch:
        """Vectorised packing of columnar data. ``svc`` must already be
        int ids; ``trace_id``/``attr_key`` uint64 keys. Pads to (or
        rejects rows beyond) ``width``, by default ``batch_size``. Padded
        lanes carry the hash of the zero key and ``valid=False``."""
        n = svc.shape[0]
        b = width if width is not None else self.batch_size
        if n > b:
            raise ValueError(f"chunk of {n} exceeds batch width {b}")

        def pad(x, dtype):
            out = np.zeros(b, dtype)
            out[:n] = x
            return out

        if is_error is None:
            is_error = np.zeros(n, np.float32)
        if attr_key is None:
            attr_key = trace_id
        attr_key = attr_key.astype(np.uint64) | (
            svc.astype(np.uint64) << np.uint64(32)
        )
        t_hi, t_lo = split_hi_lo_np(splitmix64_np(pad(trace_id, np.uint64)))
        a_hi, a_lo = split_hi_lo_np(splitmix64_np(pad(attr_key, np.uint64)))
        valid = np.zeros(b, bool)
        valid[:n] = True
        return TensorBatch(
            pad(svc, np.int32),
            pad(lat_us, np.float32),
            pad(is_error, np.float32),
            t_hi,
            t_lo,
            a_hi,
            a_lo,
            valid,
        )
