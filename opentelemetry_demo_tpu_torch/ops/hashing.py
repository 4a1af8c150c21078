"""Hashing primitives for sketch keys: host (NumPy) and device (torch).

Every sketch consumes one 64-bit hash per key, carried as two 32-bit
lanes ``(hi, lo)``. The host path hashes real keys with vectorised
splitmix64; the device path synthesises hashes from counters with two
murmur3 fmix32 finalisers (benchmarks).

Torch has no usable ``uint32`` arithmetic, so device lanes hold the
same bits as ``int32`` (``np.ndarray.view(np.int32)``). The functions
here widen to ``int64``, mask with ``& 0xFFFFFFFF`` after every wrapping
step, and hand back ``int32`` tensors with the uint32 bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

_SPLIT_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SPLIT_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SPLIT_M2 = np.uint64(0x94D049BB133111EB)

_U32 = 0xFFFFFFFF


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorised splitmix64 over a ``uint64`` NumPy array (host path)."""
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x += _SPLIT_GAMMA
        z = x.copy()
        z ^= z >> np.uint64(30)
        z *= _SPLIT_M1
        z ^= z >> np.uint64(27)
        z *= _SPLIT_M2
        z ^= z >> np.uint64(31)
    return z


def split_hi_lo_np(h64: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split host uint64 hashes into ``(hi, lo)`` uint32 lanes."""
    hi = (h64 >> np.uint64(32)).astype(np.uint32)
    lo = (h64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 lanes holding uint32 bits → their unsigned value in int64."""
    return x.to(torch.int64) & _U32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2³²) → int32 lanes with the same low 32 bits."""
    x = x & _U32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2³² for a in [0, 2³²), without int64 overflow: split
    the constant into 16-bit halves so each partial product is < 2⁴⁹."""
    lo = (a * (c & 0xFFFF)) & _U32
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """Murmur3 32-bit finaliser over uint32 bits; int32 in, int32 out."""
    h = u32(h)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return as_i32(h)


def hash_u32_pair(
    x: torch.Tensor, seed: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand uint32 keys into two independent 32-bit hash lanes."""
    x = u32(x)
    hi = fmix32(as_i32(x ^ ((0x9E3779B9 + seed) & _U32)))
    lo = fmix32(as_i32(x ^ ((0x85EBCA77 + 2 * seed) & _U32)))
    return hi, lo


def hash_spans_synthetic(
    start: int,
    batch: int,
    seed: int = 0,
    device: "torch.device | str | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Synthetic span-key hashes for the counter range
    ``[start, start+batch)``, made on ``device`` (the card unless the
    caller names another)."""
    x = torch.arange(batch, dtype=torch.int64, device=resolve_device(device))
    x = (x + start) & _U32
    return hash_u32_pair(as_i32(x), seed=seed)
