"""The verified columnar frame: checksummed, versioned bytes for state.

A checkpoint file is one frame. The layout is the reference's, byte for
byte, so a frame written by either package decodes in the other (all
integers little-endian)::

    offset  size  field
    0       4     magic            b"OTDF"
    4       2     format version   (readers accept MIN_READ_VERSION..FRAME_VERSION)
    6       2     flags            (reserved, 0)
    8       8     schema hash      (u64 over the column name/dtype/rank
                                    table; 0 in v1 frames)
    16      4     header length    (u32, JSON bytes incl. alignment pad)
    20      ...   header JSON      {"cols": [{"n", "t", "s"[, "c"]}...],
                                    "meta": {...}} — "t" is the numpy
                                    dtype.str, "s" the shape, "c" the
                                    per-column CRC32C (v2+)
    ...     ...   column payloads  contiguous C-order bytes, each column
                                    start padded to 8-byte alignment
    end-4   4     trailer          CRC32C over bytes[0 : end-4]

The trailer catches any flipped bit in the frame; the per-column CRCs
are taken from the source memory before its bytes are copied in, so a
source that changes during the encode fails at decode. A v2 reader
accepts v1 frames (no column CRCs, zero schema hash), and
:func:`decode_arrays` also accepts the pre-frame npz layout ("v0").

CRC32C runs in native code: ``csrc/host/crc32c.cc`` (slicing-by-8, or
SSE4.2's ``crc32`` instruction, which computes the same polynomial) is
compiled with the host C++ compiler at first use into
``build/torch_kernels/`` and bound with ``ctypes``. Where no compiler
exists the portable table loop below computes the same bits, about a
hundred times slower; :func:`crc_backend` says which one runs.

The span profile (:data:`SPAN_COLUMNS`, :func:`encode_spans`,
:func:`decode_spans`) frames the native decoder's columns, and
:func:`span_column_crcs` / :func:`verify_span_columns` certify decode
scratch views in place; both are the reference's bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import json
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np

FRAME_MAGIC = b"OTDF"
FRAME_VERSION = 2
# Oldest frame version this reader still decodes. The pre-frame npz
# layout ("v0") is accepted by decode_arrays/read_npz, by sniffing.
MIN_READ_VERSION = 1

_FIXED = struct.Struct("<4sHHQI")  # magic, version, flags, schema, hlen
_TRAILER = struct.Struct("<I")
_ALIGN = 8


class FrameError(ValueError):
    """Malformed frame (structure, schema, or checksum)."""


class FrameCorrupt(FrameError):
    """A frame whose bytes cannot be trusted: truncated, checksum
    mismatch, or an unparseable header. Consumers quarantine it instead
    of merging."""


class FrameVersionError(FrameError):
    """A frame whose format version is outside this reader's window: an
    upgrade-order problem, not corruption, so consumers do not
    quarantine it."""


class Frame(NamedTuple):
    """A decoded frame: ``arrays`` are zero-copy views into the frame
    buffer."""

    version: int
    arrays: dict[str, np.ndarray]
    meta: dict
    schema: int


# -- CRC32C ------------------------------------------------------------

_CRC32C_POLY = 0x82F63B78  # reflected Castagnoli
_py_table: list[int] | None = None

_PKG = Path(__file__).resolve().parent.parent
CRC_SOURCE = _PKG / "csrc" / "host" / "crc32c.cc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

_crc_lib: ctypes.CDLL | None = None
_crc_error: str | None = None  # why the native CRC is unavailable
_crc_lock = threading.Lock()


def _py_crc32c_table() -> list[int]:
    global _py_table
    if _py_table is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
            table.append(c)
        _py_table = table
    return _py_table


def _py_crc32c(data, crc: int = 0) -> int:
    """Portable table-driven CRC32C: the plain version of the native
    one, used where no compiler exists."""
    table = _py_crc32c_table()
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    c = ~crc & 0xFFFFFFFF
    for b in bytes(data):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return ~c & 0xFFFFFFFF


def _compiler() -> str | None:
    return shutil.which("g++") or shutil.which("c++")


def crc_build_command(out: Path) -> list[str]:
    """The host compiler's command line that builds the native CRC32C
    into ``out``: one source, ``csrc/host/crc32c.cc``."""
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) on PATH")
    return [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", str(out), str(CRC_SOURCE)]


def _crc_lib_path() -> Path:
    key = hashlib.sha256(CRC_SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libcrc32c_{key}.so"


def _load_crc() -> ctypes.CDLL | None:
    """Build (once per source version) and bind the native CRC32C; None
    when no compiler exists or the build fails (``_crc_error`` says
    why)."""
    global _crc_lib, _crc_error
    if _crc_lib is not None or _crc_error is not None:
        return _crc_lib
    with _crc_lock:
        if _crc_lib is not None or _crc_error is not None:
            return _crc_lib
        path = _crc_lib_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            try:
                proc = subprocess.run(
                    crc_build_command(tmp), capture_output=True, text=True, timeout=120
                )
            except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
                _crc_error = str(e)
                return None
            if proc.returncode != 0:
                _crc_error = proc.stderr.strip() or f"compiler exited {proc.returncode}"
                return None
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.crc32c_update.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
        lib.crc32c_update.restype = ctypes.c_uint32
        lib.crc32c_uses_hw.argtypes = []
        lib.crc32c_uses_hw.restype = ctypes.c_int
        _crc_lib = lib
        return lib


def crc_backend() -> str:
    """``"native"`` when the compiled CRC32C runs, ``"python"`` when the
    portable loop does (no compiler, or its build failed)."""
    return "native" if _load_crc() is not None else "python"


def crc32c(data, crc: int = 0) -> int:
    """CRC32C over ``data`` (bytes, bytearray, memoryview or an ndarray),
    continuing from ``crc``. An ndarray's own memory is checksummed (no
    ``tobytes`` copy), which is what lets :func:`encode` certify the
    source before copying it."""
    lib = _load_crc()
    if lib is None:
        return _py_crc32c(data, crc)
    a = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    return int(lib.crc32c_update(a.ctypes.data, a.nbytes, crc & 0xFFFFFFFF))


def _crc_range(buf, start: int, end: int) -> int:
    """CRC32C over ``buf[start:end]`` without slicing (a frombuffer view
    is free; a slice of a multi-MB frame is a copy)."""
    return crc32c(np.frombuffer(buf, np.uint8, count=end - start, offset=start))


# -- schema hash -------------------------------------------------------


def schema_hash(cols: list[tuple[str, str, int]]) -> int:
    """u64 over the (name, dtype.str, rank) table. Shapes are left out:
    row counts vary per frame, the layout does not."""
    blob = ";".join(f"{n}:{t}:{r}" for n, t, r in cols).encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "little")


# -- process-wide write/verify policy ----------------------------------

_write_version = FRAME_VERSION
_verify_default = True
_quarantine_dir: str | None = None
_quarantine_seq = itertools.count()
_quarantine_lock = threading.Lock()


def configure(
    write_version: int | None = None,
    verify: bool | None = None,
    quarantine_dir: str | None = None,
) -> None:
    """Set the process-wide frame policy."""
    global _write_version, _verify_default, _quarantine_dir
    if write_version is not None:
        if not MIN_READ_VERSION <= int(write_version) <= FRAME_VERSION:
            raise ValueError(
                f"frame write version {write_version} outside "
                f"{MIN_READ_VERSION}..{FRAME_VERSION}"
            )
        _write_version = int(write_version)
    if verify is not None:
        _verify_default = bool(verify)
    if quarantine_dir is not None:
        _quarantine_dir = quarantine_dir or None


def write_version() -> int:
    return _write_version


def verify_enabled() -> bool:
    return _verify_default


def quarantine(buf: bytes, hop: str, directory: str | None = None) -> str | None:
    """Write a corrupt frame's bytes aside for inspection. Returns the
    evidence path, or None when no quarantine directory is configured
    or the write fails."""
    directory = directory or _quarantine_dir
    if not directory:
        return None
    try:
        os.makedirs(directory, exist_ok=True)
        with _quarantine_lock:
            seq = next(_quarantine_seq)
        path = os.path.join(directory, f"{hop}-{os.getpid()}-{seq}.frame.corrupt")
        with open(path, "wb") as f:
            f.write(buf)
        return path
    except OSError:
        return None


# -- encode ------------------------------------------------------------


def _pad_to(n: int, align: int = _ALIGN) -> int:
    return (-n) % align


def encode(
    arrays: dict[str, np.ndarray],
    meta: dict | None = None,
    version: int | None = None,
) -> bytes:
    """Arrays + meta → one self-describing frame.

    Column order is dict order. Per-column CRCs (v2+) are taken from the
    source arrays before their bytes are copied into the frame. ``meta``
    must be JSON-serializable.
    """
    if version is None:
        version = _write_version
    if not MIN_READ_VERSION <= version <= FRAME_VERSION:
        raise ValueError(f"cannot write frame version {version}")
    cols = []
    blobs: list[bytes] = []
    schema_rows: list[tuple[str, str, int]] = []
    for name, arr in arrays.items():
        # Not ascontiguousarray: it promotes 0-d arrays to 1-d and would
        # rewrite the shape of scalar state (step_idx).
        a = np.asarray(arr)
        if not a.flags.c_contiguous:
            a = np.ascontiguousarray(a)
        entry: dict = {"n": name, "t": a.dtype.str, "s": list(a.shape)}
        if version >= 2:
            entry["c"] = crc32c(a)
        cols.append(entry)
        schema_rows.append((name, a.dtype.str, a.ndim))
        blobs.append(a.tobytes())
    schema = schema_hash(schema_rows) if version >= 2 else 0
    header = json.dumps({"cols": cols, "meta": meta or {}}, separators=(",", ":")).encode()
    # Space padding (JSON-transparent) so the payload starts 8-byte aligned.
    header += b" " * _pad_to(_FIXED.size + len(header))
    out = bytearray()
    out += _FIXED.pack(FRAME_MAGIC, version, 0, schema, len(header))
    out += header
    for blob in blobs:
        out += b"\0" * _pad_to(len(out))
        out += blob
    out += _TRAILER.pack(crc32c(out))
    return bytes(out)


# -- decode ------------------------------------------------------------


def _parse_header(buf: bytes) -> tuple[int, int, int, dict, int]:
    """(version, schema, header_len, header_doc, payload_start): the
    structure only, no checksum verification."""
    if len(buf) < _FIXED.size + _TRAILER.size:
        raise FrameCorrupt(f"frame truncated at {len(buf)} bytes")
    magic, version, _flags, schema, hlen = _FIXED.unpack_from(buf, 0)
    if magic != FRAME_MAGIC:
        raise FrameCorrupt(f"bad frame magic {magic!r}")
    if version > FRAME_VERSION or version < MIN_READ_VERSION:
        # A failing trailer means a flipped bit in the version field, which
        # is corruption (quarantine, cold start), not version skew.
        stored = _TRAILER.unpack_from(buf, len(buf) - _TRAILER.size)[0]
        if _crc_range(buf, 0, len(buf) - _TRAILER.size) != stored:
            raise FrameCorrupt(
                f"frame version field reads {version} and the trailer "
                "CRC fails: corrupt header, not version skew"
            )
        raise FrameVersionError(
            f"frame version {version} outside this reader's window "
            f"{MIN_READ_VERSION}..{FRAME_VERSION}"
        )
    start = _FIXED.size + hlen
    if start + _TRAILER.size > len(buf):
        raise FrameCorrupt("frame header overruns the buffer")

    def _require(ok: bool, why: str) -> None:
        if not ok:
            raise FrameCorrupt(f"frame header unparseable: {why}")

    try:
        doc = json.loads(buf[_FIXED.size:start].decode())
        cols = doc["cols"]
    except Exception as e:  # noqa: BLE001 — any header shape fault is corruption
        raise FrameCorrupt(f"frame header unparseable: {e}") from e
    _require(isinstance(cols, list), "cols is not a list")
    for c in cols:
        _require(isinstance(c, dict) and isinstance(c.get("n"), str), "column name missing")
        try:
            np.dtype(c.get("t"))
        except Exception as e:  # noqa: BLE001 — unknown dtype string
            raise FrameCorrupt(f"frame header unparseable: {e}") from e
        shape = c.get("s")
        _require(
            isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape),
            f"column {c.get('n')!r} has a non-natural shape",
        )
    return version, schema, hlen, doc, start


def decode(
    buf: bytes,
    verify: bool | None = None,
    expect_schema: int | None = None,
) -> Frame:
    """One frame → :class:`Frame` (zero-copy array views).

    With ``verify`` (default: the module policy, normally True) the
    trailer CRC is checked first, then every per-column CRC (v2+) and the
    schema hash: :class:`FrameCorrupt` on any mismatch or truncation,
    :class:`FrameVersionError` outside the version window. A v2 frame
    whose schema is not ``expect_schema`` raises :class:`FrameError`.
    """
    if verify is None:
        verify = _verify_default
    version, schema, _hlen, doc, start = _parse_header(buf)
    cols = doc["cols"]
    if verify:
        stored = _TRAILER.unpack_from(buf, len(buf) - _TRAILER.size)[0]
        actual = _crc_range(buf, 0, len(buf) - _TRAILER.size)
        if actual != stored:
            bad = _bad_columns(buf, cols, start) if version >= 2 else []
            raise FrameCorrupt(
                f"frame trailer CRC mismatch (stored {stored:#010x}, "
                f"computed {actual:#010x})"
                + (f"; corrupt column(s): {', '.join(bad)}" if bad else "")
            )
    arrays: dict[str, np.ndarray] = {}
    pos = start
    schema_rows: list[tuple[str, str, int]] = []
    for c in cols:
        dtype = np.dtype(c["t"])
        shape = tuple(c["s"])
        nbytes = int(dtype.itemsize * int(np.prod(shape, dtype=np.int64)))
        pos += _pad_to(pos)
        if pos + nbytes + _TRAILER.size > len(buf):
            raise FrameCorrupt(
                f"column {c['n']!r} overruns the frame "
                f"({pos + nbytes} past {len(buf) - _TRAILER.size})"
            )
        count = nbytes // dtype.itemsize if dtype.itemsize else 0
        try:
            view = np.frombuffer(buf, dtype=dtype, count=count, offset=pos)
            arrays[c["n"]] = view.reshape(shape)
        except (ValueError, TypeError) as e:
            raise FrameCorrupt(f"column {c['n']!r} unmappable ({dtype}, {shape}): {e}") from e
        schema_rows.append((c["n"], dtype.str, len(shape)))
        if verify and version >= 2:
            actual = _crc_range(buf, pos, pos + nbytes)
            if actual != int(c["c"]):
                raise FrameCorrupt(
                    f"column {c['n']!r} CRC mismatch (stored "
                    f"{int(c['c']):#010x}, computed {actual:#010x}) — "
                    "source mutated during encode, or storage rot"
                )
        pos += nbytes
    if version >= 2:
        computed_schema = schema_hash(schema_rows)
        if verify and computed_schema != schema:
            raise FrameCorrupt("frame schema hash does not match its column table")
        schema = computed_schema
    if expect_schema is not None and version >= 2 and schema != expect_schema:
        raise FrameError(
            f"frame schema {schema:#018x} is not the expected profile {expect_schema:#018x}"
        )
    return Frame(version, arrays, doc.get("meta", {}), schema)


def _bad_columns(buf: bytes, cols: list, start: int) -> list[str]:
    """Best-effort list of columns whose stored CRC mismatches."""
    bad = []
    pos = start
    try:
        for c in cols:
            dtype = np.dtype(c["t"])
            nbytes = int(dtype.itemsize * int(np.prod(tuple(c["s"]), dtype=np.int64)))
            pos += _pad_to(pos)
            if pos + nbytes + _TRAILER.size > len(buf):
                bad.append(c["n"])
                break
            if _crc_range(buf, pos, pos + nbytes) != int(c.get("c", -1)):
                bad.append(c["n"])
            pos += nbytes
    except Exception:  # noqa: BLE001 — diagnostics only
        pass
    return bad


class FramePeek(NamedTuple):
    """Header-only view of a frame: version, schema hash and meta."""

    version: int
    schema: int
    meta: dict


def peek_meta(buf: bytes) -> FramePeek:
    """:class:`FramePeek` from the header only: no payload verification,
    no column decode."""
    version, schema, _hlen, doc, _start = _parse_header(buf)
    return FramePeek(version, schema, doc.get("meta", {}))


def peek_stream_meta(f) -> FramePeek:
    """Header-only peek at an open binary stream's current position;
    leaves the stream just past the header JSON."""
    fixed = f.read(_FIXED.size)
    if len(fixed) < _FIXED.size:
        raise FrameCorrupt("frame shorter than its fixed header")
    _magic, _version, _flags, _schema, hlen = _FIXED.unpack(fixed)
    header = f.read(hlen)
    return peek_meta(fixed + header + b"\0" * _TRAILER.size)


def peek_file_meta(path: str) -> FramePeek:
    """Header-only read of a frame file: the fixed header and the JSON,
    never the payload."""
    with open(path, "rb") as f:
        return peek_stream_meta(f)


# -- migration shims ---------------------------------------------------


def sniff(buf: bytes) -> str:
    """'frame' | 'npz' (the pre-frame v0 zip layout) | 'unknown'."""
    if buf[:4] == FRAME_MAGIC:
        return "frame"
    if buf[:2] == b"PK":
        return "npz"
    return "unknown"


def read_npz(source) -> dict[str, np.ndarray]:
    """Legacy ("v0") npz decode. ``source`` is a path or bytes. Every way
    the container can lie raises :class:`FrameCorrupt`; environment
    faults (permissions, EIO, memory) propagate."""
    import io
    import zipfile
    import zlib

    f = io.BytesIO(source) if isinstance(source, (bytes, bytearray)) else source
    try:
        with np.load(f) as data:
            return {k: data[k] for k in data.files}
    except (
        zipfile.BadZipFile,
        zlib.error,
        EOFError,
        struct.error,
        ValueError,
        KeyError,
        IndexError,
    ) as e:
        raise FrameCorrupt(f"legacy npz unreadable: {e}") from e


def write_npz(arrays: dict[str, np.ndarray], compressed: bool = True) -> bytes:
    """Legacy ("v0") npz encode, for fixtures of the old layout."""
    import io

    buf = io.BytesIO()
    (np.savez_compressed if compressed else np.savez)(buf, **arrays)
    return buf.getvalue()


def decode_arrays(blob: bytes, verify: bool | None = None) -> dict[str, np.ndarray]:
    """Arrays from a frame or a legacy npz blob (sniffed)."""
    kind = sniff(blob)
    if kind == "frame":
        return decode(blob, verify=verify).arrays
    if kind == "npz":
        return read_npz(blob)
    raise FrameCorrupt(f"payload is neither frame nor npz ({blob[:4]!r})")


# -- the ingest span profile -------------------------------------------

# The decode-scratch column set (native.ColumnarSpans without the
# services list, which rides in meta), so the schema hash is a constant
# both ends pin.
SPAN_COLUMNS: tuple[tuple[str, str], ...] = (
    ("duration_us", "<f4"),
    ("trace_key", "<u8"),
    ("is_error", "|u1"),
    ("attr_crc", "<u4"),
    ("attr_present", "|u1"),
    ("svc_idx", "<i4"),
    ("event_count", "<i4"),
    ("has_exception", "|u1"),
)
SPAN_SCHEMA = schema_hash([(n, np.dtype(t).str, 1) for n, t in SPAN_COLUMNS])


def span_column_crcs(cols) -> dict[str, int]:
    """Per-column CRC32Cs over a ColumnarSpans' memory (scratch views
    included): taken when a decode finishes, re-checked by
    :func:`verify_span_columns` before the scratch is reused."""
    return {
        name: crc32c(np.ascontiguousarray(getattr(cols, name)))
        for name, _t in SPAN_COLUMNS
    }


def verify_span_columns(cols, crcs: dict[str, int]) -> list[str]:
    """Names of columns whose memory no longer matches ``crcs`` (empty:
    intact)."""
    return [
        name
        for name, _t in SPAN_COLUMNS
        if crc32c(np.ascontiguousarray(getattr(cols, name))) != int(crcs[name])
    ]


def encode_spans(cols, version: int | None = None) -> bytes:
    """native.ColumnarSpans → one frame (the service list in meta)."""
    arrays = {
        name: np.asarray(getattr(cols, name)).astype(np.dtype(t), copy=False)
        for name, t in SPAN_COLUMNS
    }
    return encode(arrays, meta={"services": list(cols.services)}, version=version)


def decode_spans(buf: bytes, verify: bool | None = None):
    """Frame → native.ColumnarSpans (verified, zero-copy views)."""
    from .native import ColumnarSpans

    f = decode(buf, verify=verify, expect_schema=SPAN_SCHEMA)
    missing = [n for n, _t in SPAN_COLUMNS if n not in f.arrays]
    if missing:
        raise FrameError(f"span frame missing columns {missing}")
    return ColumnarSpans(
        *(f.arrays[n] for n, _t in SPAN_COLUMNS),
        services=[s if s is None else str(s) for s in f.meta.get("services", [])],
    )
