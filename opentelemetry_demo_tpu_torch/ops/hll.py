"""HyperLogLog on register tensors ``int32[..., S, R]``.

Registers hold the rank (leading-zero count + 1) of the best hash seen
per bucket. Update is a scatter-max, merge an elementwise max, query the
bias-corrected harmonic estimator. Invalid lanes carry rank 0, the
max identity, so batches stay fixed-width.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .hashing import u32

HLL_P = 12


def hll_init(
    num_keys: int,
    p: int = HLL_P,
    leading: tuple[int, ...] = (),
    device: "torch.device | str | None" = None,
) -> torch.Tensor:
    """Zeroed register bank ``int32[*leading, num_keys, 2**p]`` on
    ``device`` (the card unless the caller names another)."""
    return torch.zeros(
        (*leading, num_keys, 1 << p), dtype=torch.int32, device=resolve_device(device)
    )


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of int64 values in [0, 2³²) within 32 bits (32 for
    0). ``frexp`` of the exact float64 value gives the bit length."""
    _, e = torch.frexp(x.to(torch.float64))
    return 32 - e.to(torch.int64)


def hll_indices(
    hash_hi: torch.Tensor, hash_lo: torch.Tensor, p: int = HLL_P
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split 64-bit hashes (uint32 bits in int32 lanes) into
    ``(bucket, rank)``, both int32.

    Bucket is the low ``p`` bits of ``lo``; rank is the leading-zero
    count of ``h64 >> p`` within its (64-p)-bit frame, plus one. The
    two 32-bit lanes of ``w = h64 >> p`` are formed in int64 and their
    leading zeros counted by :func:`_clz32`.
    """
    hi = u32(hash_hi)
    lo = u32(hash_lo)
    bucket = (lo & ((1 << p) - 1)).to(torch.int32)
    w_lo = ((lo >> p) | (hi << (32 - p))) & 0xFFFFFFFF
    w_hi = hi >> p
    lz = torch.where(w_hi != 0, _clz32(w_hi) - p, (32 - p) + _clz32(w_lo))
    return bucket, (lz + 1).to(torch.int32)


def hll_update(
    regs: torch.Tensor,
    key: torch.Tensor,
    bucket: torch.Tensor,
    rank: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scatter-max a batch of (key, bucket, rank) into ``regs[..., S, R]``.

    Keys outside ``[0, S)`` are dropped (``scatter_reduce`` raises on
    out-of-range ids, so they are masked to rank 0 on cell 0 first).
    Returns a new tensor.
    """
    s, r = regs.shape[-2], regs.shape[-1]
    rank = rank.to(torch.int32)
    key = key.to(torch.int64)
    in_range = (key >= 0) & (key < s)
    keep = in_range if valid is None else in_range & valid
    rank = torch.where(keep, rank, 0)
    flat_idx = torch.where(in_range, key * r + bucket.to(torch.int64), 0)
    flat = regs.reshape(*regs.shape[:-2], s * r).clone()
    idx = flat_idx.expand(*flat.shape[:-1], flat_idx.shape[0])
    src = rank.expand(*flat.shape[:-1], rank.shape[0])
    flat.scatter_reduce_(-1, idx, src, reduce="amax", include_self=True)
    return flat.reshape(regs.shape)


def hll_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """HLL union: registers merge by elementwise max (exact, order-free)."""
    return torch.maximum(a, b)


def hll_estimate(regs: torch.Tensor) -> torch.Tensor:
    """Bias-corrected cardinality estimate over the last axis, float32,
    with the small-range linear-counting correction."""
    # Scalar constants in float32, as the reference computes them.
    m = np.float32(regs.shape[-1])
    alpha = np.float32(0.7213) / (np.float32(1.0) + np.float32(1.079) / m)
    regs_f = regs.to(torch.float32)
    inv_sum = torch.sum(torch.exp2(-regs_f), dim=-1)
    raw = float(alpha * m * m) / inv_sum
    zeros = torch.sum((regs == 0).to(torch.float32), dim=-1)
    lc = float(m) * torch.log(float(m) / torch.clamp(zeros, min=1.0))
    use_lc = (raw <= float(np.float32(2.5) * m)) & (zeros > 0)
    return torch.where(use_lc, lc, raw)


def hll_estimate_np(regs) -> np.ndarray:
    """Host twin of :func:`hll_estimate` over a numpy register snapshot."""
    regs = np.asarray(regs)
    m = np.float32(regs.shape[-1])
    regs_f = regs.astype(np.float32)
    alpha = np.float32(0.7213) / (np.float32(1.0) + np.float32(1.079) / m)
    inv_sum = np.sum(np.exp2(-regs_f, dtype=np.float32), axis=-1, dtype=np.float32)
    raw = alpha * m * m / inv_sum
    zeros = np.sum((regs == 0), axis=-1).astype(np.float32)
    lc = m * np.log(m / np.maximum(zeros, np.float32(1.0)), dtype=np.float32)
    use_lc = (raw <= np.float32(2.5) * m) & (zeros > 0)
    return np.where(use_lc, lc, raw)
