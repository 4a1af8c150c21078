"""Detector self-telemetry: batch-lifecycle traces and the phase vocabulary.

The detector emits its own traces into the telemetry pipeline it
watches:

- **One trace per sampled batch**, spanning its lifecycle: decode →
  CRC verify → tensorize → spine stage → device put → dispatch →
  harvest → flag. The ingest phases arrive as *flush segments* the
  decode pool records (a bounded ring); a sampled batch absorbs the
  segments of the flushes since the last sampled batch, so ingest
  attribution is per flush, not per batch.
- **The flag span links the exemplar trace ids** the pipeline captures
  at flag time, so the detector's trace of a batch leads to the shop
  traces it flagged.
- **Head sampling is a deterministic splitmix64** of the batch sequence
  number: every replica and restart samples the same batches, and an
  unsampled batch costs one integer hash and a compare. Trace and span
  ids come from the same hash, so they equal the reference package's.
- **Export rides** ``otlp_export.BackgroundPoster``: the body is encoded
  on the harvester thread and POSTed on the poster's thread.

The same table names the phases of ``anomaly_phase_seconds{phase=}``
and of the decode pool's ``phase_s``, so span names, histogram labels
and dashboards cannot drift apart.

**The phase contract.** Every ``phase_observe(phase, seconds)`` call is
made on the thread that ran the phase, at the moment the phase ends:
the observer's ``time.perf_counter()`` at the call is the span's end,
and that minus ``seconds`` is its start. So a log of the calls is a
timeline of every thread on one clock. Work phases time host work
(decode … flag, ``report``, ``pump``); the wait phases time how long
work sat between two layers (``queue_wait``, ``pending_wait``,
``spine_wait``, ``inflight``) and feed ``phase_observe`` only: never the
pool's ``phase_s`` (a split of a flush's working time) nor a batch
trace.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Callable

from . import wire
from .otlp_export import _kv_str, make_traces_poster

# Service name the detector's own traces carry (the resource attr the
# collector/Jaeger group by — the sidecar appears beside the shop's
# services in the same UI).
SELF_SERVICE = "anomaly-detector"

# -- span-name table ---------------------------------------------------
# Every span a detector batch trace may carry; call sites use these
# constants, never inline literals, so the vocabulary cannot fork.
SPAN_BATCH = "detector.batch"
SPAN_DECODE = "detector.decode"
SPAN_DECODE_SCAN = "detector.decode_scan"
SPAN_DECODE_EXTRACT = "detector.decode_extract"
SPAN_VERIFY = "detector.crc_verify"
SPAN_TENSORIZE = "detector.tensorize"
SPAN_SUBMIT = "detector.submit"
SPAN_STAGE = "detector.spine_stage"
SPAN_PUT = "detector.device_put"
SPAN_DISPATCH = "detector.dispatch"
SPAN_HARVEST = "detector.harvest"
SPAN_FLAG = "detector.flag"

# -- phase-label table (anomaly_phase_seconds{phase=} vocabulary) ------
PHASE_DECODE = "decode"
# Sub-phases of the native decode (the two-pass scanner,
# csrc/host/ingest.cc):
# pass-1 structural scan vs pass-2 column extraction. They overlap
# PHASE_DECODE (which stays the whole-call envelope), so phase SHARE
# computations must not sum them into the denominator — see
# ingest_pool.TOP_PHASES.
PHASE_SCAN = "scan"
PHASE_EXTRACT = "extract"
PHASE_VERIFY = "verify"
PHASE_TENSORIZE = "tensorize"
PHASE_SUBMIT = "submit"
PHASE_STAGE = "stage"
PHASE_PUT_WAIT = "put_wait"
PHASE_DISPATCH = "dispatch"
PHASE_HARVEST = "harvest"
PHASE_HARVEST_LAG = "harvest_lag"
PHASE_FLAG = "flag"
# Waits between layers, each observed where the wait ends:
# a request in the decode pool's queue (enqueue → a worker's take);
PHASE_QUEUE_WAIT = "queue_wait"
# a batch's oldest rows in the pipeline's pending queue (enqueue → the
# pump's take);
PHASE_PENDING_WAIT = "pending_wait"
# a batch's put on the spine (the put's start → the dispatch's start;
# ``put_wait`` is the part the put blocked on a copy, ``stage`` its pack
# and copy issue);
PHASE_SPINE_WAIT = "spine_wait"
# a dispatched batch's report in flight (dispatch's end → its harvest).
PHASE_INFLIGHT = "inflight"
# The pipeline's ``on_report`` callback, and one whole ``pump`` call.
PHASE_REPORT = "report"
PHASE_PUMP = "pump"

# Phase → span-name projection (the flush segments arrive keyed by
# phase label; the trace renders them as spans).
SPAN_FOR_PHASE = {
    PHASE_DECODE: SPAN_DECODE,
    PHASE_SCAN: SPAN_DECODE_SCAN,
    PHASE_EXTRACT: SPAN_DECODE_EXTRACT,
    PHASE_VERIFY: SPAN_VERIFY,
    PHASE_TENSORIZE: SPAN_TENSORIZE,
    PHASE_SUBMIT: SPAN_SUBMIT,
    PHASE_STAGE: SPAN_STAGE,
    PHASE_PUT_WAIT: SPAN_PUT,
    PHASE_DISPATCH: SPAN_DISPATCH,
    PHASE_HARVEST: SPAN_HARVEST,
    PHASE_FLAG: SPAN_FLAG,
}

# Histogram buckets (seconds) for the phase/put-wait/harvest-lag
# histograms: phases are µs-to-ms host work, harvest lag stretches to
# a second under overload — one ladder covers both ends.
PHASE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0,
)

_MASK64 = (1 << 64) - 1
_SPLIT_GAMMA = 0x9E3779B97F4A7C15
_SPLIT_M1 = 0xBF58476D1CE4E5B9
_SPLIT_M2 = 0x94D049BB133111EB


def splitmix64(x: int) -> int:
    """Scalar splitmix64, bit-identical to ``ops.hashing.splitmix64_np``
    (pinned by tests) — pure-int so the per-batch sampling decision
    never pays numpy scalar overhead on the pump thread."""
    x = (x + _SPLIT_GAMMA) & _MASK64
    z = x
    z ^= z >> 30
    z = (z * _SPLIT_M1) & _MASK64
    z ^= z >> 27
    z = (z * _SPLIT_M2) & _MASK64
    z ^= z >> 31
    return z


def sampled(seq: int, rate: float) -> bool:
    """Deterministic head-sampling decision for batch ``seq``.

    The hash (not the raw counter) drives the decision so rate=1/N
    doesn't degenerate to strided sampling that aliases against any
    periodic load shape; determinism means every replica and every
    restart agrees about which batches carry traces."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return splitmix64(seq) < int(rate * float(1 << 64))


class BatchTrace:
    """One sampled batch's lifecycle: spans accumulated across the
    pump and harvester threads (handed off through the pipeline's
    in-flight deque — never concurrently mutated), exported once at
    finish."""

    __slots__ = ("seq", "trace_id", "t0_wall", "t0_perf", "spans", "attrs")

    def __init__(self, seq: int):
        self.seq = int(seq)
        # Deterministic ids: two halves of the splitmix stream, so a
        # test (or an operator replaying a drive) can predict the
        # Jaeger trace id of batch N.
        self.trace_id = (
            splitmix64(2 * self.seq).to_bytes(8, "big")
            + splitmix64(2 * self.seq + 1).to_bytes(8, "big")
        )
        self.t0_wall = time.time()
        self.t0_perf = time.perf_counter()
        # (name, start_offset_s, duration_s, attrs tuple, links tuple)
        self.spans: list[tuple] = []
        self.attrs: list[tuple[str, str]] = []

    def span(
        self,
        name: str,
        duration_s: float,
        end_perf: float | None = None,
        attrs: tuple = (),
        links: tuple = (),
    ) -> None:
        """Record one phase span. ``end_perf`` defaults to now; the
        span's start is derived (end − duration). Offsets may predate
        the trace object (ingest segments recorded before the batch
        assembled) — only start<end matters on the wire."""
        end = (
            time.perf_counter() if end_perf is None else end_perf
        ) - self.t0_perf
        self.spans.append(
            (name, end - max(duration_s, 0.0), max(duration_s, 0.0),
             tuple(attrs), tuple(links))
        )


def _span_id(trace_id: bytes, index: int) -> bytes:
    seed = int.from_bytes(trace_id[:8], "big") ^ index
    return splitmix64(seed).to_bytes(8, "big")


def _kv(key: str, value: str) -> bytes:
    return _kv_str(key, str(value))


def encode_selftrace_request(
    trace: BatchTrace, service: str = SELF_SERVICE
) -> bytes:
    """BatchTrace → ExportTraceServiceRequest protobuf.

    One ResourceSpans block (service.name = the detector), one root
    ``detector.batch`` span parenting every phase span. Span links
    (Link: trace_id=1, span_id=2, attributes=4 — trace/v1 field 13 on
    Span) carry the flagged shop traces: the link's trace id is the
    exemplar's 8-byte prefix zero-padded to 16, exactly the id prefix
    a Jaeger search matches. Inverse: :func:`decode_selftrace_request`
    (the round trip is pinned by the tests).
    """
    t0_ns = int(trace.t0_wall * 1e9)
    root_sid = _span_id(trace.trace_id, 0)
    offsets = [s[1] for s in trace.spans] or [0.0]
    ends = [s[1] + s[2] for s in trace.spans] or [0.0]
    root_start = t0_ns + int(min(min(offsets), 0.0) * 1e9)
    root_end = t0_ns + int(max(max(ends), 0.0) * 1e9)
    spans_out = b""
    for i, (name, start_off, dur, attrs, links) in enumerate(trace.spans):
        start = t0_ns + int(start_off * 1e9)
        end = start + int(dur * 1e9)
        span = (
            wire.encode_len(1, trace.trace_id)
            + wire.encode_len(2, _span_id(trace.trace_id, i + 1))
            + wire.encode_len(4, root_sid)
            + wire.encode_len(5, name.encode())
            + wire.encode_int(6, 1)  # SPAN_KIND_INTERNAL
            + wire.encode_fixed64(7, max(start, 0))
            + wire.encode_fixed64(8, max(end, 0))
        )
        for k, v in attrs:
            span += wire.encode_len(9, _kv(k, v))
        for link_hex in links:
            raw = bytes.fromhex(link_hex)
            link = (
                wire.encode_len(1, (raw + b"\0" * 16)[:16])
                + wire.encode_len(2, raw[:8].ljust(8, b"\0"))
                + wire.encode_len(4, _kv("exemplar.trace_prefix", link_hex))
            )
            span += wire.encode_len(13, link)
        spans_out += wire.encode_len(2, span)
    root = (
        wire.encode_len(1, trace.trace_id)
        + wire.encode_len(2, root_sid)
        + wire.encode_len(5, SPAN_BATCH.encode())
        + wire.encode_int(6, 1)
        + wire.encode_fixed64(7, max(root_start, 0))
        + wire.encode_fixed64(8, max(root_end, root_start, 0))
    )
    for k, v in [("batch.seq", str(trace.seq))] + list(trace.attrs):
        root += wire.encode_len(9, _kv(k, v))
    spans_out += wire.encode_len(2, root)
    resource = wire.encode_len(1, _kv("service.name", service))
    rs = wire.encode_len(1, resource) + wire.encode_len(2, spans_out)
    return wire.encode_len(1, rs)


def _decode_kv(buf: bytes) -> tuple[str, str]:
    f = wire.scan_fields(buf)
    key = wire.first(f, 1, b"").decode()
    val = b""
    any_val = wire.first(f, 2)
    if any_val is not None:
        val = wire.first(wire.scan_fields(any_val), 1, b"")
        if isinstance(val, bytes):
            val = val.decode()
    return key, str(val)


def decode_selftrace_request(payload: bytes) -> list[dict]:
    """Inverse of :func:`encode_selftrace_request` over the fields the
    self-tracer writes — the test/forensics reader. Returns one dict
    per span: name / trace_id / span_id / parent_span_id (hex),
    start/end ns, attrs dict, links (list of trace-id hex)."""
    out: list[dict] = []
    req = wire.scan_fields(payload)
    for rs_buf in req.get(1, []):
        rs = wire.scan_fields(rs_buf)
        service = None
        res_buf = wire.first(rs, 1)
        if res_buf is not None:
            res = wire.scan_fields(res_buf)
            for attr_buf in res.get(1, []):
                k, v = _decode_kv(attr_buf)
                if k == "service.name":
                    service = v
        # ResourceSpans.scope_spans (2) wraps the spans once; the
        # spans are field 2 of the ScopeSpans submessage (the same
        # wrap-once layout otlp_export writes).
        span_bufs = []
        for ss_buf in rs.get(2, []):
            span_bufs.extend(wire.scan_fields(ss_buf).get(2, []))
        for span_buf in span_bufs:
            span = wire.scan_fields(span_buf)
            attrs = dict(
                _decode_kv(a) for a in span.get(9, [])
            )
            links = []
            for link_buf in span.get(13, []):
                link = wire.scan_fields(link_buf)
                tid = wire.first(link, 1, b"")
                links.append(tid.hex())
            out.append({
                "service": service,
                "name": wire.first(span, 5, b"").decode(),
                "trace_id": wire.first(span, 1, b"").hex(),
                "span_id": wire.first(span, 2, b"").hex(),
                "parent_span_id": (
                    wire.first(span, 4, b"") or b""
                ).hex(),
                "start_ns": wire.first(span, 7, 0),
                "end_ns": wire.first(span, 8, 0),
                "attrs": attrs,
                "links": links,
            })
    return out


def make_exporter(endpoint: str, timeout_s: float = 2.0, queue_max: int = 64):
    """A BackgroundPoster shipping encoded trace requests to an OTLP
    endpoint — the shared trace-transport selection
    (``otlp_export.make_traces_poster``: ``grpc://`` picks gRPC,
    anything else posts to ``/v1/traces``). The ONE network leg, and
    it lives entirely on the poster's sender thread."""
    return make_traces_poster(endpoint, timeout_s, queue_max)


class SelfTracer:
    """Low-overhead batch-lifecycle tracer (see module doc).

    ``submit(body)`` receives each encoded ExportTraceServiceRequest —
    normally a :class:`otlp_export.BackgroundPoster`'s ``submit`` (the
    network never runs on the caller's thread); tests pass a capture
    list. An unsampled batch costs one splitmix64 + compare; a
    disabled tracer is simply ``None`` at every call site.

    Thread contract: ``flush_segment`` is called by decode-pool
    workers (bounded deque, GIL-atomic appends); ``begin``/``finish``
    run on the pump/harvester threads, and a BatchTrace is only ever
    touched by the thread currently holding the batch (the pipeline's
    in-flight hand-off orders the accesses).
    """

    def __init__(
        self,
        submit: Callable[[bytes], None] | None = None,
        sample: float = 0.01,
        segment_ring: int = 8,
        service: str = SELF_SERVICE,
    ):
        self._submit = submit
        self.sample = float(sample)
        self.service = service
        self._seq = itertools.count()
        # Recent pool flush segments (ts, {phase: seconds}): the next
        # sampled batch absorbs them as ingest-phase spans. Bounded —
        # under sparse sampling old segments fall off rather than grow.
        self._segments: deque = deque(maxlen=max(int(segment_ring), 1))
        self.traces_started = 0
        self.traces_exported = 0
        self.spans_exported = 0
        self.links_exported = 0

    def flush_segment(self, phases: dict) -> None:
        """Record one decode-pool flush's phase durations (worker
        thread). Cheap: one dict copy + a bounded append."""
        self._segments.append((time.perf_counter(), dict(phases)))

    def begin(self) -> BatchTrace | None:
        """Per-batch sampling gate (pump thread): a BatchTrace for a
        sampled batch, None otherwise. Consumes pending flush segments
        into ingest-phase spans when sampled (unsampled batches leave
        them for the next sampled one; the ring bounds staleness)."""
        seq = next(self._seq)
        if not sampled(seq, self.sample):
            return None
        trace = BatchTrace(seq)
        self.traces_started += 1
        while self._segments:
            t_seg, phases = self._segments.popleft()
            for phase, dur in phases.items():
                name = SPAN_FOR_PHASE.get(phase)
                if name is not None:
                    trace.span(name, dur, end_perf=t_seg)
        return trace

    def finish(self, trace: BatchTrace) -> bytes:
        """Encode + hand off one completed trace (harvester/pump
        thread). Returns the encoded request (tests read it back)."""
        body = encode_selftrace_request(trace, self.service)
        self.traces_exported += 1
        self.spans_exported += len(trace.spans) + 1  # + root
        self.links_exported += sum(len(s[4]) for s in trace.spans)
        if self._submit is not None:
            self._submit(body)
        return body

    def stats(self) -> dict:
        return {
            "sample": self.sample,
            "traces_started": self.traces_started,
            "traces_exported": self.traces_exported,
            "spans_exported": self.spans_exported,
            "links_exported": self.links_exported,
            "segments_pending": len(self._segments),
        }
