"""ctypes bindings for the native OTLP span decoder (``csrc/host/ingest.cc``).

Protobuf ``ExportTraceServiceRequest`` bodies → columnar numpy arrays,
the host half of the ingest path: the per-record Python decoder
(``runtime.otlp.decode_export_request``) is its plain version, and the
two give the same columns and the same verdicts on malformed bodies.

Build on demand: the one translation unit is compiled with the host C++
compiler (``g++ -O3 -pthread``) at first use into
``build/torch_kernels/libingest_<hash>.so``, the hash taken over the
source, so an edited source builds anew and concurrent builds (test
workers) each write a temp file and ``os.replace`` it into place. There
is no fallback: when the library cannot build, :func:`available` is
False, :func:`load_error` says why, and every decode raises.

**GIL contract.** The library loads with ``ctypes.CDLL``, not
``ctypes.PyDLL``, so ctypes releases the GIL for the whole of every
foreign call. The C code touches no Python object (payloads pass as
borrowed ``c_char_p`` pointers kept alive by the caller, outputs are
numpy-owned memory), which is what makes that safe. ``decode_otlp_many``
may spawn up to ``threads`` native threads to shard its extraction;
they are spawned and joined inside the foreign call and see only raw
buffers.

The same library decodes the Kafka ``orders`` topic:
:func:`decode_orders` turns a poll's OrderResult payloads into the
order-record columns (``runtime.kafka_orders.decode_orders_columnar``).
The USD rate table it normalises order values with is installed once
per load from the port's ``currency_data``.

The native OTLP/HTTP front door (``csrc/host/frontdoor.cc``) is the
second library here, built the same way into
``build/torch_kernels/libfrontdoor_<hash>.so``: an acceptor and one
thread per connection frame requests natively and hand complete bodies
to the Python pump (``runtime.frontdoor``) as tickets. Its calls follow
the same GIL contract; ``otd_fd_next`` blocks with the GIL released.
There is no fallback for it either: :func:`frontdoor_start` raises with
the compiler's error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
INGEST_SOURCE = _PKG / "csrc" / "host" / "ingest.cc"
FRONTDOOR_SOURCE = _PKG / "csrc" / "host" / "frontdoor.cc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None
_fd_lib: ctypes.CDLL | None = None
_fd_error: str | None = None


class ColumnarSpans(NamedTuple):
    """Decoded OTLP spans as columns (one row per span, document order).

    ``svc_idx`` points into ``services`` (one entry per resource-spans
    block). ``None`` means the resource had no service.name — the
    record-level decoder's "unknown" — which is distinct from a
    present-but-empty name (interned as ``""``, as the record path does).
    """

    duration_us: np.ndarray  # float32[N]
    trace_key: np.ndarray  # uint64[N] — first 8 bytes of trace_id, LE
    is_error: np.ndarray  # uint8[N]
    attr_crc: np.ndarray  # uint32[N] — CRC32 of the chosen attr value
    attr_present: np.ndarray  # uint8[N]
    svc_idx: np.ndarray  # int32[N]
    event_count: np.ndarray  # int32[N] — span events on the span
    has_exception: np.ndarray  # uint8[N] — exception/error event present
    services: list[str | None]


class ColumnarOrders(NamedTuple):
    """Decoded OrderResult batch as columns (one row per message)."""

    value_units: np.ndarray  # float32[N] — shipping cost in USD (value lane)
    order_key: np.ndarray  # uint64[N] — first 8 bytes of order id
    attr_crc: np.ndarray  # uint32[N] — CRC32 of first non-empty product id


def build_command(out: Path, source: Path = INGEST_SOURCE) -> list[str]:
    """The host compiler's command line that builds ``source`` (the
    decoder by default) into ``out``. ``-pthread``: the batched decode
    spawns ``std::thread``s, and the front door runs a thread per
    connection."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) on PATH")
    return [
        cxx, "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
        "-shared", "-o", str(out), str(source),
    ]


def library_path(source: Path = INGEST_SOURCE) -> Path:
    """``build/torch_kernels/lib<stem>_<source hash>.so``."""
    key = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{key}.so"


def _build(source: Path) -> tuple[ctypes.CDLL | None, str | None]:
    """Build ``source`` once per source version and load it: ``(lib,
    None)``, or ``(None, why)`` when it cannot build."""
    path = library_path(source)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            proc = subprocess.run(
                build_command(tmp, source), capture_output=True, text=True, timeout=300
            )
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            return None, str(e)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return None, proc.stderr.strip() or f"compiler exited {proc.returncode}"
        os.replace(tmp, path)
    return ctypes.CDLL(str(path)), None


def _configure(lib: ctypes.CDLL) -> None:
    # Payload pointers are c_char_p so Python bytes pass zero-copy (the
    # C side only reads; lengths travel separately, so NULs are fine).
    lib.otd_decode_otlp.restype = ctypes.c_int
    lib.otd_decode_otlp.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,           # buf, len
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,  # keys
        ctypes.c_int,                               # cap
        ctypes.c_void_p, ctypes.c_void_p,           # duration, trace
        ctypes.c_void_p, ctypes.c_void_p,           # err, crc
        ctypes.c_void_p, ctypes.c_void_p,           # present, svc_idx
        ctypes.c_void_p, ctypes.c_void_p,           # event_count, has_exc
        ctypes.c_char_p, ctypes.c_size_t,           # svc_buf, cap
        ctypes.c_void_p, ctypes.c_int,              # svc_len, rs_cap
        ctypes.POINTER(ctypes.c_int32),             # n_services
    ]
    lib.otd_decode_otlp_many.restype = ctypes.c_int
    lib.otd_decode_otlp_many.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p,  # bufs, lens
        ctypes.c_int,                               # n_payloads
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,  # keys
        ctypes.c_int,                               # cap
        ctypes.c_void_p, ctypes.c_void_p,           # duration, trace
        ctypes.c_void_p, ctypes.c_void_p,           # err, crc
        ctypes.c_void_p, ctypes.c_void_p,           # present, svc_idx
        ctypes.c_void_p, ctypes.c_void_p,           # event_count, has_exc
        ctypes.c_char_p, ctypes.c_size_t,           # svc_buf, cap
        ctypes.c_void_p, ctypes.c_int,              # svc_len, rs_cap
        ctypes.POINTER(ctypes.c_int32),             # n_services
        ctypes.c_void_p,                            # payload_rows
        ctypes.c_int, ctypes.c_longlong,            # n_threads, shard_min
        ctypes.POINTER(ctypes.c_double),            # scan_s
        ctypes.POINTER(ctypes.c_double),            # extract_s
    ]
    # The two passes alone: pass 1 (structural scan → span index) and
    # pass 2 (index → columns).
    lib.otd_scan_otlp.restype = ctypes.c_int
    lib.otd_scan_otlp.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,           # buf, len
        ctypes.c_void_p, ctypes.c_void_p,           # span_off, span_len
        ctypes.c_void_p, ctypes.c_int,              # span_svc, span_cap
        ctypes.c_char_p, ctypes.c_size_t,           # svc_buf, cap
        ctypes.c_void_p, ctypes.c_int,              # svc_len, rs_cap
        ctypes.POINTER(ctypes.c_int32),             # n_services
    ]
    lib.otd_extract_otlp.restype = ctypes.c_int
    lib.otd_extract_otlp.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,           # buf, len
        ctypes.c_void_p, ctypes.c_void_p,           # span_off, span_len
        ctypes.c_void_p, ctypes.c_int,              # span_svc, n_spans
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,  # keys
        ctypes.c_void_p, ctypes.c_void_p,           # duration, trace
        ctypes.c_void_p, ctypes.c_void_p,           # err, crc
        ctypes.c_void_p, ctypes.c_void_p,           # present, svc_idx
        ctypes.c_void_p, ctypes.c_void_p,           # event_count, has_exc
    ]
    lib.otd_decode_orders.restype = ctypes.c_int
    lib.otd_decode_orders.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    # Install the USD table for the order value lane once per load: the
    # factors kafka_orders.order_to_record applies per message.
    lib.otd_set_order_rates.restype = None
    lib.otd_set_order_rates.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int
    ]
    from ..currency_data import EUR_RATES, to_usd_factor

    # The C side keeps at most 64 entries and drops the rest silently: a
    # longer table would give native factor 1.0 where Python has the rate.
    assert len(EUR_RATES) <= 64, "EUR_RATES exceeds native rate-table cap"
    codes = b"".join(code.encode().ljust(8, b"\0")[:8] for code in EUR_RATES)
    factors = (ctypes.c_double * len(EUR_RATES))(
        *(to_usd_factor(code) for code in EUR_RATES)
    )
    lib.otd_set_order_rates(codes, factors, len(EUR_RATES))


def _load() -> ctypes.CDLL | None:
    """Build (once per source version) and bind the decoder; None when
    it cannot build (``_error`` says why)."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        lib, err = _build(INGEST_SOURCE)
        if lib is None:
            _error = err
            return None
        _configure(lib)
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def load_error() -> str | None:
    """Why the decoder is unavailable (None when it loaded)."""
    _load()
    return _error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_error}")
    return lib


# -- the native front door (csrc/host/frontdoor.cc) ----------------------------


def _configure_frontdoor(lib: ctypes.CDLL) -> None:
    # The acceptor and the per-connection threads live on the C side;
    # these entry points are the pump's batch drain and verdict
    # write-back. otd_fd_next blocks with the GIL released (ctypes.CDLL,
    # the decode calls' contract), so a waiting pump costs the
    # interpreter nothing.
    lib.otd_fd_start.restype = ctypes.c_int64
    lib.otd_fd_start.argtypes = [
        ctypes.c_char_p,                            # host (IPv4 literal)
        ctypes.c_int32, ctypes.c_int64,             # port, max_body
        ctypes.c_int32, ctypes.c_int64,             # max_conns, hdr_timeout
    ]
    lib.otd_fd_port.restype = ctypes.c_int32
    lib.otd_fd_port.argtypes = [ctypes.c_int64]
    lib.otd_fd_next.restype = ctypes.c_int64
    lib.otd_fd_next.argtypes = [
        ctypes.c_int64,                             # handle
        ctypes.c_void_p, ctypes.c_void_p,           # ids, kinds
        ctypes.c_void_p, ctypes.c_void_p,           # ptrs, lens
        ctypes.c_int64, ctypes.c_int64,             # max_n, timeout_ms
    ]
    lib.otd_fd_respond.restype = ctypes.c_int32
    lib.otd_fd_respond.argtypes = [
        ctypes.c_int64, ctypes.c_int64,             # handle, req id
        ctypes.c_int32, ctypes.c_int32,             # status, retry_after
    ]
    lib.otd_fd_stats.restype = None
    lib.otd_fd_stats.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    lib.otd_fd_quiesce.restype = None
    lib.otd_fd_quiesce.argtypes = [ctypes.c_int64]
    lib.otd_fd_stop.restype = None
    lib.otd_fd_stop.argtypes = [ctypes.c_int64]


def _load_frontdoor() -> ctypes.CDLL | None:
    """Build (once per source version) and bind the front door; None
    when it cannot build (``_fd_error`` says why)."""
    global _fd_lib, _fd_error
    if _fd_lib is not None or _fd_error is not None:
        return _fd_lib
    with _lock:
        if _fd_lib is not None or _fd_error is not None:
            return _fd_lib
        lib, err = _build(FRONTDOOR_SOURCE)
        if lib is None:
            _fd_error = err
            return None
        _configure_frontdoor(lib)
        _fd_lib = lib
        return lib


def frontdoor_available() -> bool:
    return _load_frontdoor() is not None


def frontdoor_load_error() -> str | None:
    """Why the front door is unavailable (None when it loaded)."""
    _load_frontdoor()
    return _fd_error


def _require_frontdoor() -> ctypes.CDLL:
    lib = _load_frontdoor()
    if lib is None:
        raise RuntimeError(f"native frontdoor unavailable: {_fd_error}")
    return lib


# Signal kinds a front-door ticket carries (frontdoor.cc constants): the
# pump routes traces to the decode pool's pointer path and metrics/logs
# (scrape-cadence traffic) to the Python decoders.
FD_KIND_TRACES = 0
FD_KIND_METRICS = 1
FD_KIND_LOGS = 2

# otd_fd_stats slot names, in the order of frontdoor.cc's StatIdx.
FD_STAT_NAMES = (
    "accepted", "live_conns", "enqueued", "pending", "bad_length",
    "oversized", "chunked", "truncated", "disconnect", "overcap",
    "health", "notfound", "bytes_in", "responded",
)


class FrontDoorBatch(NamedTuple):
    """Reusable drain buffers for :func:`frontdoor_next`, allocated once
    per pump: the steady-state drain allocates no numpy array."""

    ids: np.ndarray  # int64[max_n] — ticket ids
    kinds: np.ndarray  # int32[max_n] — FD_KIND_*
    ptrs: np.ndarray  # uint64[max_n] — native body addresses
    lens: np.ndarray  # int64[max_n] — body lengths


def frontdoor_alloc_batch(max_n: int) -> FrontDoorBatch:
    return FrontDoorBatch(
        np.empty(max_n, np.int64), np.empty(max_n, np.int32),
        np.empty(max_n, np.uint64), np.empty(max_n, np.int64),
    )


def frontdoor_start(
    port: int, max_body: int, max_conns: int = 64,
    header_timeout_ms: int = 10000, host: str = "0.0.0.0",
) -> int:
    """Start a native front door on ``host:port`` (port 0: ephemeral);
    returns the server handle.

    Raises ``RuntimeError`` when the library cannot build (with the
    compiler's error) or the address cannot be bound: a front door that
    silently did not bind would leave callers believing it serves.
    """
    lib = _require_frontdoor()
    h = lib.otd_fd_start(
        host.encode(), int(port), int(max_body), int(max_conns), int(header_timeout_ms)
    )
    if h < 0:
        raise RuntimeError(f"frontdoor bind failed on {host}:{port}")
    return int(h)


def frontdoor_port(handle: int) -> int:
    return int(_require_frontdoor().otd_fd_port(int(handle)))


def frontdoor_next(handle: int, batch: FrontDoorBatch, timeout_ms: int = 100) -> int:
    """Drain up to ``len(batch.ids)`` complete request tickets into
    ``batch``, blocking up to ``timeout_ms`` with the GIL released.
    Returns the count, 0 on timeout, or -1 once the server is stopping
    and its queue is empty (the pump's exit signal)."""
    return int(_require_frontdoor().otd_fd_next(
        int(handle), batch.ids.ctypes.data, batch.kinds.ctypes.data,
        batch.ptrs.ctypes.data, batch.lens.ctypes.data,
        batch.ids.shape[0], int(timeout_ms),
    ))


def frontdoor_body(ptr: int, length: int) -> ctypes.Array:
    """Borrow a ticket's native body as a ctypes view, with no copy:
    ``len()`` and :func:`decode_otlp_many` both take it. The buffer
    stays valid until :func:`frontdoor_respond` for its id (the
    frontdoor.cc ownership rule), so answer only after the decode has
    consumed the bytes."""
    return (ctypes.c_char * int(length)).from_address(int(ptr))


def frontdoor_respond(handle: int, req_id: int, status: int, retry_after: int = 0) -> None:
    """Deliver a ticket's verdict: the connection thread writes the
    canned response and recycles the body buffer."""
    _require_frontdoor().otd_fd_respond(int(handle), int(req_id), int(status), int(retry_after))


def frontdoor_stats(handle: int) -> dict[str, int]:
    out = np.zeros(len(FD_STAT_NAMES), np.int64)
    _require_frontdoor().otd_fd_stats(int(handle), out.ctypes.data)
    return {k: int(v) for k, v in zip(FD_STAT_NAMES, out)}


def frontdoor_quiesce(handle: int) -> None:
    """Graceful drain, phase 1: stop accepting; queued tickets keep
    flowing to the pump, new requests answer 503."""
    _require_frontdoor().otd_fd_quiesce(int(handle))


def frontdoor_stop(handle: int) -> None:
    """Full stop: 503 every still-queued ticket, wake the pump
    (:func:`frontdoor_next` returns -1), join every native thread."""
    _require_frontdoor().otd_fd_stop(int(handle))


# Monitored-key ctypes arrays, cached per key tuple: the key set is a
# process-lifetime constant (otlp.MONITORED_ATTR_KEYS).
_keys_cache: dict[tuple, ctypes.Array] = {}


def _keys_array(attr_keys: Sequence[str]) -> ctypes.Array:
    t = tuple(attr_keys)
    arr = _keys_cache.get(t)
    if arr is None:
        arr = (ctypes.c_char_p * len(t))(*[k.encode() for k in t])
        _keys_cache[t] = arr
    return arr


def _service_names(svc_buf, svc_len: np.ndarray) -> list[str | None]:
    """The length-prefixed name table: a negative length is a resource
    without service.name. Only the used prefix of the buffer is copied."""
    lens = svc_len.tolist()
    blob = ctypes.string_at(svc_buf, sum(ln for ln in lens if ln > 0))
    out: list[str | None] = []
    pos = 0
    for ln in lens:
        if ln < 0:
            out.append(None)
        else:
            out.append(blob[pos:pos + ln].decode("utf-8", "replace"))
            pos += ln
    return out


def decode_otlp(payload: bytes, attr_keys: Sequence[str]) -> ColumnarSpans:
    """Columnar decode of one ExportTraceServiceRequest.

    Raises ``ValueError`` on malformed wire data — the same verdicts as
    ``otlp.decode_export_request``.
    """
    lib = _require()
    keys = _keys_array(attr_keys)
    cap = len(payload) // 16 + 64
    # One name byte per payload byte is the ceiling (names are payload
    # substrings); one resource-spans entry needs ≥2 payload bytes.
    svc_cap = len(payload) + 1
    rs_cap = len(payload) // 2 + 2
    svc_buf = ctypes.create_string_buffer(svc_cap)
    svc_len = np.empty(rs_cap, np.int32)
    n_services = ctypes.c_int32(0)
    retried = False
    while True:
        duration = np.empty(cap, np.float32)
        trace = np.empty(cap, np.uint64)
        err = np.empty(cap, np.uint8)
        crc = np.empty(cap, np.uint32)
        present = np.empty(cap, np.uint8)
        svc_idx = np.empty(cap, np.int32)
        event_count = np.empty(cap, np.int32)
        has_exc = np.empty(cap, np.uint8)
        n = lib.otd_decode_otlp(
            payload, len(payload), keys, len(attr_keys), cap,
            duration.ctypes.data, trace.ctypes.data,
            err.ctypes.data, crc.ctypes.data,
            present.ctypes.data, svc_idx.ctypes.data,
            event_count.ctypes.data, has_exc.ctypes.data,
            svc_buf, svc_cap,
            svc_len.ctypes.data, rs_cap,
            ctypes.byref(n_services),
        )
        if n == -2 and not retried:  # pathological tiny-span payloads
            cap = len(payload) // 2 + 64
            retried = True
            continue
        if n < 0:
            raise ValueError(f"malformed OTLP payload (code {n})")
        return ColumnarSpans(
            duration[:n].copy(), trace[:n].copy(), err[:n].copy(),
            crc[:n].copy(), present[:n].copy(), svc_idx[:n].copy(),
            event_count[:n].copy(), has_exc[:n].copy(),
            _service_names(svc_buf, svc_len[: n_services.value]),
        )


class DecodeScratch(NamedTuple):
    """Reusable output buffers for :func:`decode_otlp_many`.

    One scratch serves one decode in flight. The result of a decode into
    a scratch is views into these arrays: copy the rows out (
    ``SpanTensorizer.columns_from_columnar(..., copy=True)``) before the
    scratch is used again.
    """

    cap: int
    svc_cap: int
    rs_cap: int
    duration: np.ndarray  # float32[cap]
    trace: np.ndarray  # uint64[cap]
    err: np.ndarray  # uint8[cap]
    crc: np.ndarray  # uint32[cap]
    present: np.ndarray  # uint8[cap]
    svc_idx: np.ndarray  # int32[cap]
    event_count: np.ndarray  # int32[cap]
    has_exc: np.ndarray  # uint8[cap]
    svc_buf: ctypes.Array  # char[svc_cap]
    svc_len: np.ndarray  # int32[rs_cap]


def alloc_scratch(cap: int, svc_cap: int, rs_cap: int) -> DecodeScratch:
    return DecodeScratch(
        cap, svc_cap, rs_cap,
        np.empty(cap, np.float32), np.empty(cap, np.uint64),
        np.empty(cap, np.uint8), np.empty(cap, np.uint32),
        np.empty(cap, np.uint8), np.empty(cap, np.int32),
        np.empty(cap, np.int32), np.empty(cap, np.uint8),
        ctypes.create_string_buffer(svc_cap), np.empty(rs_cap, np.int32),
    )


def scratch_dims(payload_bytes: int, n_payloads: int, retry: bool = False) -> tuple[int, int, int]:
    """(cap, svc_cap, rs_cap) for a batch of payloads — the per-payload
    bounds of :func:`decode_otlp` summed (``retry`` switches to the
    len/2 span ceiling of the retry)."""
    denom = 2 if retry else 16
    return (
        payload_bytes // denom + 64 * max(n_payloads, 1),
        payload_bytes + 1,
        payload_bytes // 2 + 2 * max(n_payloads, 1),
    )


# Below this many bytes a batch is never sharded across native threads:
# the extraction is then shorter than a thread's spawn and join.
SHARD_MIN_BYTES_DEFAULT = 262144


def decode_otlp_many(
    payloads: Sequence[bytes],
    attr_keys: Sequence[str],
    scratch: DecodeScratch | None = None,
    threads: int = 0,
    shard_min_bytes: int = SHARD_MIN_BYTES_DEFAULT,
    phases: dict | None = None,
) -> tuple[ColumnarSpans, np.ndarray]:
    """Batched columnar decode: many requests, one foreign call.

    Returns ``(columns, payload_rows)``: ``columns`` holds every
    well-formed payload's rows in argument order (``svc_idx`` into one
    batch-wide service list), and ``payload_rows[i]`` is payload i's row
    count, or ``-1`` when payload i was malformed — its batchmates keep
    their rows.

    The extraction pass is sharded across up to ``threads`` native
    threads at span boundaries once the batch holds ``shard_min_bytes``;
    ``threads<=1`` keeps it serial. ``phases`` (a dict) receives the
    two passes' wall seconds as ``{"scan": s, "extract": s}``.

    A payload is ``bytes`` or a ctypes buffer (the front door's borrowed
    body, :func:`frontdoor_body`), whose address is passed as is: its
    owner keeps it alive for the call.

    With ``scratch`` the returned arrays are views into it; without,
    fresh copies. Raises ``ValueError`` only for an error that poisons
    the whole batch.
    """
    lib = _require()
    n_payloads = len(payloads)
    bufs = (ctypes.c_char_p * max(n_payloads, 1))()
    for i, p in enumerate(payloads):
        bufs[i] = p if isinstance(p, bytes) else ctypes.cast(p, ctypes.c_char_p)
    lens = (
        np.fromiter(map(len, payloads), np.uint64, count=n_payloads)
        if n_payloads else np.zeros(1, np.uint64)
    )
    total = int(lens.sum()) if n_payloads else 0
    payload_rows = np.empty(max(n_payloads, 1), np.int32)
    keys = _keys_array(attr_keys)
    scan_s = ctypes.c_double(0.0)
    extract_s = ctypes.c_double(0.0)
    retried = False
    while True:
        need = scratch_dims(total, n_payloads, retried)
        s = scratch
        if s is None or s.cap < need[0] or s.svc_cap < need[1] or s.rs_cap < need[2]:
            s = alloc_scratch(*need)
        n_services = ctypes.c_int32(0)
        n = lib.otd_decode_otlp_many(
            bufs, lens.ctypes.data, n_payloads,
            keys, len(attr_keys), s.cap,
            s.duration.ctypes.data, s.trace.ctypes.data,
            s.err.ctypes.data, s.crc.ctypes.data,
            s.present.ctypes.data, s.svc_idx.ctypes.data,
            s.event_count.ctypes.data, s.has_exc.ctypes.data,
            s.svc_buf, s.svc_cap,
            s.svc_len.ctypes.data, s.rs_cap,
            ctypes.byref(n_services), payload_rows.ctypes.data,
            int(threads), int(shard_min_bytes),
            ctypes.byref(scan_s), ctypes.byref(extract_s),
        )
        if n in (-2, -3) and not retried:
            # Tiny spans overflowed the estimated capacity: retry once at
            # the hard ceiling, past a caller scratch that is too small.
            retried = True
            scratch = None
            continue
        if n < 0:
            raise ValueError(f"otlp batch decode failed (code {n})")
        if phases is not None:
            phases["scan"] = scan_s.value
            phases["extract"] = extract_s.value
        services = _service_names(s.svc_buf, s.svc_len[: n_services.value])
        cols = ColumnarSpans(
            s.duration[:n], s.trace[:n], s.err[:n], s.crc[:n],
            s.present[:n], s.svc_idx[:n], s.event_count[:n],
            s.has_exc[:n], services,
        )
        if scratch is None:  # no caller-owned buffers: hand out copies
            cols = ColumnarSpans(*(a.copy() for a in cols[:8]), services)
        return cols, payload_rows[:n_payloads]


class SpanIndex(NamedTuple):
    """Pass-1 index over one payload (:func:`scan_otlp`): span record
    boundaries and the resource-spans service table, offsets relative to
    the payload's first byte."""

    span_off: np.ndarray  # int32[N] — span submessage offset
    span_len: np.ndarray  # int32[N] — span submessage length
    span_svc: np.ndarray  # int32[N] — resource-spans entry per span
    services: list[str | None]


def scan_otlp(payload: bytes) -> SpanIndex:
    """Pass 1 alone: structural scan → span index. Raises ``ValueError``
    on malformed framing; damage inside a span is pass 2's verdict."""
    lib = _require()
    cap = len(payload) // 2 + 64  # hard ceiling: a span costs ≥2 bytes
    rs_cap = len(payload) // 2 + 2
    svc_cap = len(payload) + 1
    span_off = np.empty(cap, np.int32)
    span_len = np.empty(cap, np.int32)
    span_svc = np.empty(cap, np.int32)
    svc_buf = ctypes.create_string_buffer(svc_cap)
    svc_len = np.empty(rs_cap, np.int32)
    n_services = ctypes.c_int32(0)
    n = lib.otd_scan_otlp(
        payload, len(payload),
        span_off.ctypes.data, span_len.ctypes.data, span_svc.ctypes.data,
        cap, svc_buf, svc_cap, svc_len.ctypes.data, rs_cap,
        ctypes.byref(n_services),
    )
    if n < 0:
        raise ValueError(f"malformed OTLP payload (code {n})")
    return SpanIndex(
        span_off[:n].copy(), span_len[:n].copy(), span_svc[:n].copy(),
        _service_names(svc_buf, svc_len[: n_services.value]),
    )


def extract_otlp(payload: bytes, index: SpanIndex, attr_keys: Sequence[str]) -> ColumnarSpans:
    """Pass 2 alone: a :func:`scan_otlp` index → columns. Raises
    ``ValueError`` on a malformed span interior."""
    lib = _require()
    n = index.span_off.shape[0]
    duration = np.empty(n, np.float32)
    trace = np.empty(n, np.uint64)
    err = np.empty(n, np.uint8)
    crc = np.empty(n, np.uint32)
    present = np.empty(n, np.uint8)
    svc_idx = np.empty(n, np.int32)
    event_count = np.empty(n, np.int32)
    has_exc = np.empty(n, np.uint8)
    rc = lib.otd_extract_otlp(
        payload, len(payload),
        index.span_off.ctypes.data, index.span_len.ctypes.data,
        index.span_svc.ctypes.data, n,
        _keys_array(attr_keys), len(attr_keys),
        duration.ctypes.data, trace.ctypes.data,
        err.ctypes.data, crc.ctypes.data,
        present.ctypes.data, svc_idx.ctypes.data,
        event_count.ctypes.data, has_exc.ctypes.data,
    )
    if rc < 0:
        raise ValueError(f"malformed OTLP payload (code {rc})")
    return ColumnarSpans(
        duration, trace, err, crc, present, svc_idx, event_count, has_exc,
        list(index.services),
    )


def decode_orders(payloads: Sequence[bytes]) -> ColumnarOrders:
    """Columnar decode of a batch of OrderResult payloads; raises
    ``ValueError`` on a malformed payload (the per-message decoder's
    verdict)."""
    lib = _require()
    n = len(payloads)
    bufs = (ctypes.c_char_p * max(n, 1))(*payloads)
    lens = np.asarray([len(p) for p in payloads] or [0], np.uint64)
    value = np.empty(max(n, 1), np.float32)
    key = np.empty(max(n, 1), np.uint64)
    crc = np.empty(max(n, 1), np.uint32)
    rc = lib.otd_decode_orders(
        bufs, lens.ctypes.data, n,
        value.ctypes.data, key.ctypes.data, crc.ctypes.data,
    )
    if rc < 0:
        raise ValueError(f"malformed OrderResult payload (code {rc})")
    return ColumnarOrders(value[:n], key[:n], crc[:n])
