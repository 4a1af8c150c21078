"""The host hashes the detector's lanes are built from, frozen in NumPy.

A span reaches the detector as five columns: its service's slot, its
duration in microseconds, its error bit, a trace key and an attribute
key. These functions derive the last two and the sketch indices from
the span as the generator wrote it:

- trace key: the first 8 bytes of the 16-byte trace id, little-endian;
- attribute CRC: CRC-32 of the first monitored attribute's string value
  (the empty string when the span carries none);
- HLL cell: splitmix64 of the trace key, the bucket its low ``p`` bits,
  the rank the leading zeros of the rest plus one;
- CMS cells: splitmix64 of ``attr_crc | slot << 32``, rows
  ``(lo + i * hi) mod width`` (Kirsch-Mitzenmacher).
"""

from __future__ import annotations

import zlib

import numpy as np

GAMMA = np.uint64(0x9E3779B97F4A7C15)
M1 = np.uint64(0xBF58476D1CE4E5B9)
M2 = np.uint64(0x94D049BB133111EB)
U32 = np.uint64(0xFFFFFFFF)

# Attribute keys whose value keys the heavy-hitter sketch, in priority
# order (the OTel demo's product, order and session ids).
MONITORED_ATTR_KEYS = ("app.product.id", "app.order.id", "app.session.id", "session.id")


def splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser over uint64, wrapping."""
    z = np.asarray(x, np.uint64) + GAMMA
    z = (z ^ (z >> np.uint64(30))) * M1
    z = (z ^ (z >> np.uint64(27))) * M2
    return z ^ (z >> np.uint64(31))


def crc32_of(values: list[str | None]) -> np.ndarray:
    """CRC-32 of each UTF-8 string (None hashes as the empty string)."""
    return np.array([zlib.crc32((v or "").encode()) for v in values], np.uint64)


def _bit_length32(x: np.ndarray) -> np.ndarray:
    """Bit length of uint64 values below 2**32 (exact through float64)."""
    _, e = np.frexp(x.astype(np.float64))
    return e.astype(np.int64)


def hll_cells(trace_key: np.ndarray, p: int) -> tuple[np.ndarray, np.ndarray]:
    """(bucket, rank) of each trace key: bucket = low ``p`` bits of the
    hash, rank = leading zeros of ``hash >> p`` in its 64 - p bits, + 1."""
    h = splitmix64(trace_key)
    bucket = (h & np.uint64((1 << p) - 1)).astype(np.int64)
    w = h >> np.uint64(p)
    w_hi, w_lo = w >> np.uint64(32), w & U32
    bits = np.where(w_hi != 0, 32 + _bit_length32(w_hi), _bit_length32(w_lo))
    return bucket, ((64 - p) - bits + 1).astype(np.int32)


def cms_cells(attr_crc: np.ndarray, slot: np.ndarray, depth: int, width: int) -> np.ndarray:
    """Counter index of each span in each row, int64[depth, n]."""
    h = splitmix64(np.asarray(attr_crc, np.uint64) | (np.asarray(slot, np.uint64) << np.uint64(32)))
    hi, lo = h >> np.uint64(32), h & U32
    rows = [((lo + np.uint64(i) * hi) & U32) & np.uint64(width - 1) for i in range(depth)]
    return np.stack(rows).astype(np.int64)
