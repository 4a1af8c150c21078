"""EWMA mean/variance tracking and z-scores over keyed axes.

State is a pair of ``float32[..., S, T]`` tensors (mean, var) for S
services × T timescales. The per-service batch reduction
(:func:`segment_stats`) is a one-hot product, as in the reference.
"""

from __future__ import annotations

import torch

from .. import resolve_device


def ewma_init(
    num_keys: int, num_scales: int, device: "torch.device | str | None" = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed (mean, var) state ``float32[num_keys, num_scales]`` on
    ``device`` (the card unless the caller names another)."""
    device = resolve_device(device)
    shape = (num_keys, num_scales)
    return (
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
    )


def segment_stats(
    values: torch.Tensor,
    seg: torch.Tensor,
    num_segments: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-segment (count, sum, sum-of-squares) via one-hot matmul.

    ``values: float32[B]``, ``seg: int[B]`` → three ``float32[S]``. Ids
    outside ``[0, S)`` match no column. The product runs in full float32
    as long as ``torch.backends.cuda.matmul.allow_tf32`` stays False
    (PyTorch's default).
    """
    cols = torch.arange(num_segments, device=values.device)
    onehot = (cols[None, :] == seg.to(torch.int64)[:, None]).to(torch.float32)
    if valid is not None:
        onehot = onehot * valid.to(torch.float32)[:, None]
    values = values.to(torch.float32)
    stacked = torch.stack([torch.ones_like(values), values, values * values])
    out = stacked @ onehot  # [3, S]
    return out[0], out[1], out[2]


def ewma_update(
    mean: torch.Tensor,
    var: torch.Tensor,
    x: torch.Tensor,
    alpha: torch.Tensor,
    observed: torch.Tensor | None = None,
    warmup: torch.Tensor | None = None,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One EWMA step; returns ``(mean', var', z)``.

    The z-score is taken against the prior state, then the state absorbs
    the observation (West's update ``var' = (1-α)(var + α·δ²)``).
    ``observed`` freezes keys with no data (z=0); ``warmup`` zeroes z.
    """
    x = x.to(torch.float32)
    delta = x - mean
    z = delta / torch.sqrt(var + eps)
    new_mean = mean + alpha * delta
    new_var = (1.0 - alpha) * (var + alpha * delta * delta)
    if observed is not None:
        obs = observed.to(torch.bool)
        new_mean = torch.where(obs, new_mean, mean)
        new_var = torch.where(obs, new_var, var)
        z = torch.where(obs, z, 0.0)
    if warmup is not None:
        z = torch.where(warmup.to(torch.bool), 0.0, z)
    return new_mean, new_var, z
