"""Host-ingest throughput: OTLP bytes → pipeline columns.

Wire decode, attribute hashing and interning: the host half of the
ingest budget, measured without the card. Four engines do the same
bytes → ``SpanColumns`` work:

- ``measure_python``: the Python record decoder (the plain version);
- ``measure_native``: one native decode and one tensorize per request,
  on one thread;
- ``measure_pooled``: the decode pool (``runtime.ingest_pool``): batched
  ``decode_otlp_many``, pooled scratch, coalesced tensorize, N workers,
  into a null sink. ``measure_scaling`` sweeps the worker count;
- ``measure_raw`` and ``measure_fat_payload_scaling``: the native two
  passes alone, and one oversized export across extraction threads.

There is no fallback: without the native decoder the native engines
raise with its build error.
"""

from __future__ import annotations

import time

import numpy as np

from . import native, wire
from .otlp import MONITORED_ATTR_KEYS, decode_export_request
from .tensorize import SpanTensorizer


def make_payloads(n_requests: int = 64, spans_per_request: int = 128, seed: int = 0) -> list[bytes]:
    """OTLP ExportTraceServiceRequest payloads shaped like the shop's:
    one service per request, product-id attributes, ~2% error spans."""
    rng = np.random.default_rng(seed)
    services = [
        "frontend", "checkout", "cart", "payment", "currency",
        "product-catalog", "shipping", "ad", "recommendation", "quote",
    ]

    def anyval(s):
        return wire.encode_len(1, s.encode())

    def kv(k, v):
        return wire.encode_len(1, k.encode()) + wire.encode_len(2, anyval(v))

    payloads = []
    for _ in range(n_requests):
        svc = services[int(rng.integers(0, len(services)))]
        # Joined once per request: += over growing bytes is quadratic.
        span_bufs = []
        for _ in range(spans_per_request):
            start = int(rng.integers(10**18, 2 * 10**18))
            span = (
                wire.encode_len(1, bytes(rng.integers(0, 256, 16, dtype=np.uint8)))
                + wire.encode_len(5, b"oteldemo.rpc/Call")
                + wire.encode_fixed64(7, start)
                + wire.encode_fixed64(8, start + int(rng.integers(10**5, 10**9)))
                + wire.encode_len(9, kv("app.product.id", f"P-{int(rng.integers(0, 100))}"))
                + wire.encode_len(9, kv("rpc.system", "grpc"))
            )
            if rng.random() < 0.02:
                span += wire.encode_len(15, wire.encode_int(3, 2))
            span_bufs.append(wire.encode_len(2, span))
        resource = wire.encode_len(1, kv("service.name", svc))
        rs = wire.encode_len(1, resource) + wire.encode_len(2, b"".join(span_bufs))
        payloads.append(wire.encode_len(1, rs))
    return payloads


def measure(fn, payloads: list[bytes], n_spans: int, repeat: int = 5) -> float:
    """Best-of-``repeat`` spans/s of ``fn`` over all payloads."""
    fn(payloads[0])  # warmup
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        for p in payloads:
            fn(p)
        best = min(best, time.perf_counter() - t0)
    return n_spans / best


def measure_native(n_requests: int = 64, spans_per_request: int = 128, repeat: int = 5,
                   payloads: list[bytes] | None = None) -> float:
    """Native columnar decode, one request at a time (spans/s)."""
    if payloads is None:
        payloads = make_payloads(n_requests, spans_per_request)
    tz = SpanTensorizer(num_services=32)
    return measure(
        lambda p: tz.columns_from_columnar(native.decode_otlp(p, MONITORED_ATTR_KEYS)),
        payloads, n_requests * spans_per_request, repeat=repeat,
    )


def measure_python(n_requests: int = 64, spans_per_request: int = 128, repeat: int = 5,
                   payloads: list[bytes] | None = None) -> float:
    """The Python record decoder (spans/s)."""
    if payloads is None:
        payloads = make_payloads(n_requests, spans_per_request)
    tz = SpanTensorizer(num_services=32)
    return measure(
        lambda p: tz.columns_from_records(decode_export_request(p)),
        payloads, n_requests * spans_per_request, repeat=repeat,
    )


def measure_pooled(workers: int = 2, n_requests: int = 64, spans_per_request: int = 128,
                   repeat: int = 4, passes: int = 16, coalesce: int = 256,
                   payloads: list[bytes] | None = None) -> float:
    """The decode pool's spans/s (:func:`measure_pooled_detail`'s
    headline number)."""
    return measure_pooled_detail(
        workers=workers, n_requests=n_requests, spans_per_request=spans_per_request,
        repeat=repeat, passes=passes, coalesce=coalesce, payloads=payloads,
    )["spans_per_sec"]


def measure_pooled_detail(workers: int = 2, n_requests: int = 64, spans_per_request: int = 128,
                          repeat: int = 4, passes: int = 16, coalesce: int = 256,
                          payloads: list[bytes] | None = None) -> dict:
    """The decode pool's spans/s and its phase breakdown.

    Through the real :class:`~.ingest_pool.IngestPool` (tickets, bounded
    queue, batched decode into pooled scratch, coalesced tensorize) into
    a null sink. ``passes`` replays the payload set per timed region so
    the queue stays deep enough for coalescing to engage.
    ``phase_share`` splits flush wall time between decode, the CRC
    manifest (verify), the intern and column pass (tensorize) and the
    merge (submit).
    """
    from .ingest_pool import TOP_PHASES, IngestPool

    if payloads is None:
        payloads = make_payloads(n_requests, spans_per_request)
    n_spans = n_requests * spans_per_request * passes
    tz = SpanTensorizer(num_services=32)
    pool = IngestPool(
        lambda cols: None, tz, workers=workers, coalesce_max=coalesce,
        max_pending=n_requests * passes + 8,
    )
    try:
        for p in payloads:  # warmup: size the scratch
            pool.submit(p)
        pool.drain()
        best = float("inf")
        for _ in range(repeat):
            t0 = time.perf_counter()
            for _ in range(passes):
                for p in payloads:
                    pool.submit(p)
            pool.drain()
            best = min(best, time.perf_counter() - t0)
        stats = pool.stats()
    finally:
        pool.close()
    phase = stats["phase_s"]
    # Shares over the top-level phases only: scan and extract are
    # inside decode.
    total = sum(phase.get(k, 0.0) for k in TOP_PHASES) or 1.0
    decode_s = phase.get("decode", 0.0) or 1.0
    return {
        "spans_per_sec": n_spans / best,
        "phase_share": {k: round(phase.get(k, 0.0) / total, 4) for k in TOP_PHASES},
        # The decode's own split between its two passes (fractions of
        # decode time; the rest is the ctypes and scratch glue).
        "decode_split": {
            "scan": round(phase.get("scan", 0.0) / decode_s, 4),
            "extract": round(phase.get("extract", 0.0) / decode_s, 4),
        },
        "tickets_parked": stats["tickets_parked"],
        "tickets_recycled": stats["tickets_recycled"],
    }


def measure_raw(n_requests: int = 64, spans_per_request: int = 128, repeat: int = 5,
                payloads: list[bytes] | None = None) -> dict:
    """The native two passes per thread: scan, extract and the whole
    call, with no pool, tensorize or CRC manifest. The pass times come
    from inside the one batched call (ingest.cc stamps them), so they
    carry no ctypes overhead."""
    if payloads is None:
        payloads = make_payloads(n_requests, spans_per_request)
    n_spans = n_requests * spans_per_request
    total = sum(map(len, payloads))
    scratch = native.alloc_scratch(*native.scratch_dims(total, len(payloads)))
    phases: dict[str, float] = {}
    native.decode_otlp_many(payloads, MONITORED_ATTR_KEYS, scratch, phases=phases)  # warmup
    decode_t = scan_t = extract_t = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        native.decode_otlp_many(payloads, MONITORED_ATTR_KEYS, scratch, phases=phases)
        decode_t = min(decode_t, time.perf_counter() - t0)
        scan_t = min(scan_t, phases.get("scan") or decode_t)
        extract_t = min(extract_t, phases.get("extract") or decode_t)
    return {
        "scan_spans_per_sec": n_spans / scan_t,
        "extract_spans_per_sec": n_spans / extract_t,
        "decode_spans_per_sec": n_spans / decode_t,
        "scan_bytes_per_sec": total / scan_t,
        "payload_bytes": total,
    }


def measure_fat_payload_scaling(spans: int = 65536, threads_list=(1, 2), repeat: int = 3) -> dict:
    """One oversized export decoded with N extraction threads:
    ``{"1": spans/s, "2": spans/s, ..., "scaling": rate_N / rate_1}``."""
    payload = make_payloads(1, spans, seed=3)[0]
    scratch = native.alloc_scratch(*native.scratch_dims(len(payload), 1))
    out: dict = {}
    for t in threads_list:
        best = float("inf")
        native.decode_otlp_many([payload], MONITORED_ATTR_KEYS, scratch, threads=t, shard_min_bytes=0)
        for _ in range(repeat):
            t0 = time.perf_counter()
            native.decode_otlp_many([payload], MONITORED_ATTR_KEYS, scratch, threads=t, shard_min_bytes=0)
            best = min(best, time.perf_counter() - t0)
        out[str(t)] = spans / best
    rates = [out[str(t)] for t in threads_list]
    out["scaling"] = round(rates[-1] / rates[0], 3) if rates[0] else None
    return out


def measure_scaling(workers_list=(1, 2, 3, 4), n_requests: int = 64, spans_per_request: int = 128,
                    repeat: int = 3, payloads: list[bytes] | None = None,
                    detail: dict | None = None) -> dict[str, float]:
    """Worker count → pooled spans/s. With ``detail`` (a dict) each
    count's phase breakdown lands in ``detail[str(workers)]`` too."""
    if payloads is None:
        payloads = make_payloads(n_requests, spans_per_request)
    out: dict[str, float] = {}
    for w in workers_list:
        got = measure_pooled_detail(
            workers=w, n_requests=n_requests, spans_per_request=spans_per_request,
            repeat=repeat, payloads=payloads,
        )
        out[str(w)] = round(got["spans_per_sec"], 1)
        if detail is not None:
            detail[str(w)] = {k: v for k, v in got.items() if k != "spans_per_sec"}
    return out
