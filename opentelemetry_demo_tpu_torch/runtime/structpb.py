"""google.protobuf.Struct codec over the hand-rolled wire scanner.

flagd's evaluation protocol carries the evaluation context and flag
metadata as ``google.protobuf.Struct`` (schemas.flagd.dev evaluation
service — the :8013 surface every OpenFeature flagd provider dials).
This codec maps Struct ⇄ plain Python (dict/list/str/float/bool/None),
the same JSON model ``json.loads`` produces, so the flag evaluator
works on native values.

Wire shapes (struct.proto):
  Struct    { map<string, Value> fields = 1; }  — map entry: key=1, value=2
  Value     { null_value=1 | number_value=2(double) | string_value=3 |
              bool_value=4 | struct_value=5 | list_value=6 }
  ListValue { repeated Value values = 1; }
"""

from __future__ import annotations

import struct as _struct

from . import wire


def decode_struct(buf: bytes) -> dict:
    out: dict = {}
    if not buf:
        return out
    f = wire.scan_fields(buf)
    for entry in f.get(1, []):
        if not isinstance(entry, bytes):
            continue
        ef = wire.scan_fields(entry)
        key = wire.first(ef, 1, b"")
        val = wire.first(ef, 2, b"")
        if isinstance(key, bytes):
            out[key.decode("utf-8", "replace")] = decode_value(
                val if isinstance(val, bytes) else b""
            )
    return out


def decode_value(buf: bytes):
    f = wire.scan_fields(buf)
    # proto3 oneof: last set field wins; scan in declaration order and
    # keep the highest-numbered occurrence present.
    if 6 in f:
        lv = f[6][-1]
        lf = wire.scan_fields(lv if isinstance(lv, bytes) else b"")
        return [
            decode_value(v) for v in lf.get(1, []) if isinstance(v, bytes)
        ]
    if 5 in f:
        sv = f[5][-1]
        return decode_struct(sv if isinstance(sv, bytes) else b"")
    if 4 in f:
        return bool(f[4][-1])
    if 3 in f:
        raw = f[3][-1]
        return raw.decode("utf-8", "replace") if isinstance(raw, bytes) else ""
    if 2 in f:
        raw = f[2][-1]
        if isinstance(raw, int):  # fixed64 little-endian bits
            return _struct.unpack("<d", raw.to_bytes(8, "little"))[0]
        return 0.0
    return None  # null_value or empty


def encode_value(v) -> bytes:
    if v is None:
        return wire.encode_int(1, 0)
    if isinstance(v, bool):  # before int: bool subclasses int
        return wire.encode_int(4, 1 if v else 0)
    if isinstance(v, (int, float)):
        return wire.encode_double(2, float(v))  # oneof: always emitted
    if isinstance(v, str):
        return wire.encode_len(3, v.encode("utf-8"))
    if isinstance(v, dict):
        return wire.encode_len(5, encode_struct(v))
    if isinstance(v, (list, tuple)):
        body = b"".join(wire.encode_len(1, encode_value(x)) for x in v)
        return wire.encode_len(6, body)
    raise TypeError(f"unmappable Struct value type {type(v).__name__}")


def encode_struct(d: dict) -> bytes:
    out = b""
    for key, val in d.items():
        entry = wire.encode_len(1, str(key).encode("utf-8"))
        entry += wire.encode_len(2, encode_value(val))
        out += wire.encode_len(1, entry)
    return out
