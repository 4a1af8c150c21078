"""Kafka wire protocol: the subset the orders leg speaks.

The shop's asynchronous tier is a Kafka broker whose consumers poll over
TCP (the upstream demo's fraud-detection and accounting services). No
Kafka client library is needed: like ``runtime.wire`` for protobuf, this
module writes the protocol's primitives itself — size-prefixed
request/response framing, the primitive codecs, the v0 MessageSet
(magic 0, zlib CRC32) and the v2 RecordBatch (magic 2: CRC-32C,
varint-packed records with per-record HEADERS, the slot that carries W3C
trace context across the async boundary). Produce v3 and Fetch v4 use
the RecordBatch, the minimum Kafka 3.x brokers accept; ListOffsets v0,
Metadata v0, FindCoordinator v0, OffsetCommit v2 and OffsetFetch v1 stay
in the non-flexible era (no KIP-482 tagged fields). Interop scope: Kafka
3.x brokers (4.0 removed those auxiliary versions, KIP-896). The in-repo
broker (``kafka_broker``) speaks the same subset.

The bytes are the JAX package's ``kafka_wire``'s, byte for byte, so
either package's client talks to either package's broker. The
RecordBatch CRC-32C runs in native code through ``frame.crc32c``
(``csrc/host/crc32c.cc``); the table loop :func:`crc32c_plain` is its
plain version.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

from . import frame

# API keys (the public protocol's).
PRODUCE = 0
FETCH = 1
LIST_OFFSETS = 2
METADATA = 3
OFFSET_COMMIT = 8
OFFSET_FETCH = 9
FIND_COORDINATOR = 10

# Error codes.
NO_ERROR = 0
OFFSET_OUT_OF_RANGE = 1
UNKNOWN_TOPIC_OR_PARTITION = 3
UNSUPPORTED_VERSION = 35


class KafkaWireError(ValueError):
    """Malformed Kafka wire data."""


class KafkaProduceError(KafkaWireError):
    """Broker answered the Produce but rejected the record (non-zero
    partition error code) — the transport is healthy, so retrying on a
    fresh connection cannot help; callers should bound retries and
    dead-letter instead of treating this as a broken broker."""

    def __init__(self, code: int, partition: int):
        super().__init__(f"produce error {code} on partition {partition}")
        self.code = code
        self.partition = partition


# --- primitive codecs --------------------------------------------------


class Reader:
    """Sequential reader over one request/response body."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise KafkaWireError("truncated message")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def int8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def int16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def int32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def int64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> str | None:
        n = self.int16()
        if n == -1:
            return None
        return self._take(n).decode("utf-8")

    def bytes_(self) -> bytes | None:
        n = self.int32()
        if n == -1:
            return None
        return self._take(n)

    def array(self, fn):
        n = self.int32()
        if n < 0:
            return []
        return [fn() for _ in range(n)]

    def remaining(self) -> bytes:
        return self.buf[self.pos :]


def enc_int8(v: int) -> bytes:
    return struct.pack(">b", v)


def enc_int16(v: int) -> bytes:
    return struct.pack(">h", v)


def enc_int32(v: int) -> bytes:
    return struct.pack(">i", v)


def enc_int64(v: int) -> bytes:
    return struct.pack(">q", v)


def enc_string(v: str | None) -> bytes:
    if v is None:
        return enc_int16(-1)
    raw = v.encode("utf-8")
    return enc_int16(len(raw)) + raw


def enc_bytes(v: bytes | None) -> bytes:
    if v is None:
        return enc_int32(-1)
    return enc_int32(len(v)) + v


def enc_array(items, fn) -> bytes:
    return enc_int32(len(items)) + b"".join(fn(x) for x in items)


# --- request/response framing -----------------------------------------


def encode_request(
    api_key: int,
    api_version: int,
    correlation_id: int,
    client_id: str,
    body: bytes,
) -> bytes:
    """Size-prefixed request with the v1 (non-flexible) header."""
    payload = (
        enc_int16(api_key)
        + enc_int16(api_version)
        + enc_int32(correlation_id)
        + enc_string(client_id)
        + body
    )
    return enc_int32(len(payload)) + payload


class RequestHeader(NamedTuple):
    api_key: int
    api_version: int
    correlation_id: int
    client_id: str | None


def decode_request_header(reader: Reader) -> RequestHeader:
    return RequestHeader(
        api_key=reader.int16(),
        api_version=reader.int16(),
        correlation_id=reader.int32(),
        client_id=reader.string(),
    )


def encode_response(correlation_id: int, body: bytes) -> bytes:
    payload = enc_int32(correlation_id) + body
    return enc_int32(len(payload)) + payload


def read_frame(sock) -> bytes | None:
    """One size-prefixed frame off a socket; None on clean EOF."""
    header = _read_exact(sock, 4)
    if header is None:
        return None
    (size,) = struct.unpack(">i", header)
    if size < 0 or size > 64 * 1024 * 1024:
        raise KafkaWireError(f"implausible frame size {size}")
    frame = _read_exact(sock, size)
    if frame is None:
        raise KafkaWireError("truncated frame")
    return frame


def _read_exact(sock, n: int) -> bytes | None:
    """Exactly n bytes; None on EOF at a frame boundary, error mid-frame."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            if got == 0:
                return None
            raise KafkaWireError("connection closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


# --- CRC-32C (Castagnoli) ---------------------------------------------
# RecordBatch v2 checksums with CRC-32C, not zlib's CRC-32/IEEE: the
# reflected polynomial 0x82F63B78, as every Kafka client computes it.

def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c_plain(data: bytes, crc: int = 0) -> int:
    """Table-driven CRC-32C in Python: the plain version of :func:`crc32c`."""
    crc ^= 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C over ``data`` in native code (``frame.crc32c``)."""
    return frame.crc32c(data, crc)


# --- zigzag varints (RecordBatch v2 integer packing) ------------------


def enc_varint(v: int) -> bytes:
    """Signed zigzag varint (the only flavor the record format uses)."""
    zz = (v << 1) ^ (v >> 63) if v < 0 else v << 1
    out = bytearray()
    while True:
        b = zz & 0x7F
        zz >>= 7
        if zz:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def dec_varint(buf: bytes, pos: int) -> tuple[int, int]:
    """(value, new_pos); signed zigzag."""
    shift = 0
    zz = 0
    while True:
        if pos >= len(buf):
            raise KafkaWireError("truncated varint")
        b = buf[pos]
        pos += 1
        zz |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 63:
            raise KafkaWireError("varint overflow")
    return (zz >> 1) ^ -(zz & 1), pos


# --- MessageSet v0 (magic 0) ------------------------------------------


class KafkaMessage(NamedTuple):
    offset: int
    key: bytes | None
    value: bytes | None


def encode_message(key: bytes | None, value: bytes | None) -> bytes:
    """One magic-0 message body (without the offset/size envelope)."""
    rest = enc_int8(0) + enc_int8(0) + enc_bytes(key) + enc_bytes(value)
    crc = zlib.crc32(rest) & 0xFFFFFFFF
    return struct.pack(">I", crc) + rest


def encode_message_set(messages, base_offset: int = 0) -> bytes:
    """[(key, value), ...] → on-wire MessageSet with assigned offsets."""
    out = []
    for i, (key, value) in enumerate(messages):
        msg = encode_message(key, value)
        out.append(enc_int64(base_offset + i) + enc_int32(len(msg)) + msg)
    return b"".join(out)


def decode_message_set(buf: bytes) -> list[KafkaMessage]:
    """On-wire MessageSet → messages; a trailing partial message (the
    protocol allows brokers to cut one at the fetch byte limit) is
    dropped, matching every real client's behavior."""
    out: list[KafkaMessage] = []
    pos = 0
    n = len(buf)
    while pos + 12 <= n:
        offset, size = struct.unpack(">qi", buf[pos : pos + 12])
        if pos + 12 + size > n:
            break  # partial trailing message
        body = buf[pos + 12 : pos + 12 + size]
        pos += 12 + size
        crc_stored = struct.unpack(">I", body[:4])[0]
        rest = body[4:]
        if zlib.crc32(rest) & 0xFFFFFFFF != crc_stored:
            raise KafkaWireError(f"bad message CRC at offset {offset}")
        r = Reader(rest)
        magic = r.int8()
        if magic != 0:
            raise KafkaWireError(f"unsupported message magic {magic}")
        r.int8()  # attributes (no compression in this subset)
        key = r.bytes_()
        value = r.bytes_()
        out.append(KafkaMessage(offset=offset, key=key, value=value))
    return out


# --- RecordBatch v2 (magic 2) -----------------------------------------
# The modern record format: one batch envelope (fixed-width header,
# CRC-32C over everything after the crc field) wrapping varint-packed
# records, each with an offset/timestamp delta and a HEADERS list —
# the slot trace context rides in (the upstream checkout writes it).


class KafkaRecord(NamedTuple):
    offset: int
    key: bytes | None
    value: bytes | None
    headers: tuple  # ((str, bytes|None), ...)
    timestamp_ms: int = 0


def _enc_varbytes(v: bytes | None) -> bytes:
    if v is None:
        return enc_varint(-1)
    return enc_varint(len(v)) + v


def encode_record_batch(
    records,
    base_offset: int = 0,
    base_timestamp_ms: int = 0,
) -> bytes:
    """[(key, value, headers), ...] → one on-wire v2 RecordBatch.

    ``headers`` per record: iterable of (str, bytes|None) pairs (or a
    {str: bytes} mapping). Produced with producerId/epoch/sequence -1
    (idempotence/transactions are out of scope) and no compression.
    """
    recs = []
    for i, (key, value, headers) in enumerate(records):
        if hasattr(headers, "items"):
            headers = list(headers.items())
        body = (
            b"\x00"  # record attributes (unused)
            + enc_varint(0)  # timestamp delta
            + enc_varint(i)  # offset delta
            + _enc_varbytes(key)
            + _enc_varbytes(value)
            + enc_varint(len(headers))
        )
        for hkey, hval in headers:
            raw = hkey.encode("utf-8")
            body += enc_varint(len(raw)) + raw + _enc_varbytes(hval)
        recs.append(enc_varint(len(body)) + body)
    n = len(records)
    tail = (
        enc_int16(0)  # batch attributes: no compression, CREATE_TIME
        + enc_int32(max(n - 1, 0))  # lastOffsetDelta
        + enc_int64(base_timestamp_ms)
        + enc_int64(base_timestamp_ms)  # maxTimestamp
        + enc_int64(-1)  # producerId
        + enc_int16(-1)  # producerEpoch
        + enc_int32(-1)  # baseSequence
        + enc_int32(n)
        + b"".join(recs)
    )
    crc = crc32c(tail)
    after_length = (
        enc_int32(-1)  # partitionLeaderEpoch
        + enc_int8(2)  # magic
        + struct.pack(">I", crc)
        + tail
    )
    return enc_int64(base_offset) + enc_int32(len(after_length)) + after_length


def decode_record_batches(buf: bytes) -> list[KafkaRecord]:
    """On-wire record data → records with absolute offsets + headers.

    Handles multiple concatenated batches (a fetch may return several);
    a trailing partial batch — the protocol lets brokers cut one at the
    byte limit — is dropped, like every real client does. A magic-0/1
    segment in the same buffer raises: mixed-format logs don't occur in
    this subset.
    """
    out: list[KafkaRecord] = []
    pos = 0
    n = len(buf)
    while pos + 12 <= n:
        base_offset, batch_len = struct.unpack(">qi", buf[pos : pos + 12])
        if pos + 12 + batch_len > n:
            break  # partial trailing batch
        batch = buf[pos + 12 : pos + 12 + batch_len]
        pos += 12 + batch_len
        if len(batch) < 9:
            raise KafkaWireError("runt record batch")
        magic = batch[4]
        if magic != 2:
            raise KafkaWireError(f"unsupported batch magic {magic}")
        (crc_stored,) = struct.unpack(">I", batch[5:9])
        tail = batch[9:]
        if crc32c(tail) != crc_stored:
            raise KafkaWireError(f"bad batch CRC at offset {base_offset}")
        r = Reader(tail)
        r.int16()  # attributes (no compression in this subset)
        r.int32()  # lastOffsetDelta
        base_ts = r.int64()
        r.int64()  # maxTimestamp
        r.int64()  # producerId
        r.int16()  # producerEpoch
        r.int32()  # baseSequence
        num_records = r.int32()
        rest = tail[r.pos :]
        rpos = 0
        for _ in range(num_records):
            length, rpos = dec_varint(rest, rpos)
            end = rpos + length
            if length < 0 or end > len(rest):
                raise KafkaWireError("truncated record")
            rpos += 1  # record attributes
            ts_delta, rpos = dec_varint(rest, rpos)
            off_delta, rpos = dec_varint(rest, rpos)
            klen, rpos = dec_varint(rest, rpos)
            key = None
            if klen >= 0:
                key = rest[rpos : rpos + klen]
                rpos += klen
            vlen, rpos = dec_varint(rest, rpos)
            value = None
            if vlen >= 0:
                value = rest[rpos : rpos + vlen]
                rpos += vlen
            hcount, rpos = dec_varint(rest, rpos)
            headers = []
            for _h in range(max(hcount, 0)):
                hklen, rpos = dec_varint(rest, rpos)
                if hklen < 0 or rpos + hklen > len(rest):
                    raise KafkaWireError("truncated header key")
                hkey = rest[rpos : rpos + hklen].decode("utf-8")
                rpos += hklen
                hvlen, rpos = dec_varint(rest, rpos)
                hval = None
                if hvlen >= 0:
                    hval = rest[rpos : rpos + hvlen]
                    rpos += hvlen
                headers.append((hkey, hval))
            if rpos != end:
                rpos = end  # tolerate future per-record extensions
            out.append(
                KafkaRecord(
                    offset=base_offset + off_delta,
                    key=key,
                    value=value,
                    headers=tuple(headers),
                    timestamp_ms=base_ts + ts_delta,
                )
            )
    return out
