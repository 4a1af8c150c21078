"""Minimal protobuf wire-format reader (stdlib-only, schema-agnostic).

OTLP/HTTP carries ``ExportTraceServiceRequest`` protobuf bodies. This
scanner decodes the universal wire format (varint / fixed32 / fixed64 /
length-delimited) into ``{field_number: [raw values]}`` and lets
schema-aware projections (``otlp``) pick out the fields the detector
needs by field number. Unknown fields are skipped, as protobuf's own
forward-compatibility contract demands.
"""

from __future__ import annotations

_WT_VARINT = 0
_WT_FIXED64 = 1
_WT_LEN = 2
_WT_FIXED32 = 5


class WireError(ValueError):
    """Malformed protobuf wire data."""


def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    """Decode one base-128 varint at ``pos``; returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise WireError("varint too long")


def scan_fields(buf: bytes) -> dict[int, list]:
    """One-level scan: field number → list of raw values.

    varint fields decode to int; fixed32/fixed64 to little-endian int;
    length-delimited to ``bytes`` (submessages are re-scanned by the
    caller that knows the schema).
    """
    fields: dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field_no, wire_type = tag >> 3, tag & 0x7
        if field_no == 0:
            raise WireError("field number 0")
        if wire_type == _WT_VARINT:
            val, pos = read_varint(buf, pos)
        elif wire_type == _WT_FIXED64:
            if pos + 8 > n:
                raise WireError("truncated fixed64")
            val = int.from_bytes(buf[pos : pos + 8], "little")
            pos += 8
        elif wire_type == _WT_FIXED32:
            if pos + 4 > n:
                raise WireError("truncated fixed32")
            val = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        elif wire_type == _WT_LEN:
            ln, pos = read_varint(buf, pos)
            if pos + ln > n:
                raise WireError("truncated bytes field")
            val = buf[pos : pos + ln]
            pos += ln
        else:
            raise WireError(f"unsupported wire type {wire_type}")
        fields.setdefault(field_no, []).append(val)
    return fields


def first(fields: dict[int, list], field_no: int, default=None):
    vals = fields.get(field_no)
    return vals[0] if vals else default


def to_int64(value: int) -> int:
    """Sign-extend a decoded varint: proto3 int32/int64 encode negatives
    as 64-bit two's complement, which :func:`read_varint` returns as the
    raw unsigned value."""
    return value - (1 << 64) if value >= (1 << 63) else value


# --- encoding helpers (tests + loopback fixtures) ---------------------


def encode_varint(value: int) -> bytes:
    if value < 0:
        # Protobuf encodes negative int32/int64 as the 64-bit two's
        # complement (always 10 bytes on the wire).
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_tag(field_no: int, wire_type: int) -> bytes:
    return encode_varint((field_no << 3) | wire_type)


def encode_len(field_no: int, payload: bytes) -> bytes:
    return encode_tag(field_no, _WT_LEN) + encode_varint(len(payload)) + payload


def encode_int(field_no: int, value: int) -> bytes:
    return encode_tag(field_no, _WT_VARINT) + encode_varint(value)


def encode_fixed64(field_no: int, value: int) -> bytes:
    return encode_tag(field_no, _WT_FIXED64) + value.to_bytes(8, "little")


def encode_double(field_no: int, value: float) -> bytes:
    import struct

    return encode_tag(field_no, _WT_FIXED64) + struct.pack("<d", value)
