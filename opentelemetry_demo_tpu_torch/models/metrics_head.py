"""Metrics detection head: EWMA z-scores over per-service metric rates.

The span detector watches the trace stream; this head watches the OTLP
metrics stream beside it: counter rates and gauge levels per (service,
metric) cell, at T timescales. The state is a debiased EWMA mean and
variance per cell with a relative plus absolute variance floor, so a
freshly warm cell does not alarm on scrape jitter.

The reference computes the head with plain array operations and no
kernel; so does this port, with torch operations on the state's device.
As in the span detector, :func:`metrics_head_step` **updates the state
in place** and returns it; the layout and the config are the
reference's, so a checkpoint carries the state across both ways.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device


class MetricsHeadConfig(NamedTuple):
    """Static shapes and thresholds, field for field the reference's
    (checkpoints persist ``list(config)`` positionally)."""

    num_services: int = 32
    num_metrics: int = 32  # interned metric-name slots (beyond: dropped)
    taus_s: tuple[float, ...] = (10.0, 60.0, 300.0)  # scrape-cadence scales
    z_threshold: float = 6.0
    warmup_obs: float = 8.0  # observations before a cell may alarm
    rel_floor: float = 0.10  # σ floor as a fraction of the mean
    abs_floor: float = 1.0  # absolute σ² floor (rate units²)

    @property
    def num_taus(self) -> int:
        return len(self.taus_s)


class MetricsHeadState(NamedTuple):
    mean: torch.Tensor  # float32[S, M, T]
    var: torch.Tensor  # float32[S, M, T]
    obs: torch.Tensor  # float32[S, M] — observations seen per cell
    step_idx: torch.Tensor  # int32[]


class MetricsHeadReport(NamedTuple):
    z: torch.Tensor  # float32[S, M, T]
    cell_flags: torch.Tensor  # bool[S, M] — any timescale over threshold
    flags: torch.Tensor  # bool[S] — any metric over threshold


def metrics_head_init(
    config: MetricsHeadConfig, device: "torch.device | str | None" = None
) -> MetricsHeadState:
    """A zeroed head state on ``device`` (the card unless the caller
    names another)."""
    device = resolve_device(device)
    s, m, t = config.num_services, config.num_metrics, config.num_taus
    return MetricsHeadState(
        mean=torch.zeros((s, m, t), dtype=torch.float32, device=device),
        var=torch.zeros((s, m, t), dtype=torch.float32, device=device),
        obs=torch.zeros((s, m), dtype=torch.float32, device=device),
        step_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def metrics_head_step(
    config: MetricsHeadConfig,
    state: MetricsHeadState,
    x: torch.Tensor,  # float32[S, M] — rate/level observations
    observed: torch.Tensor,  # bool[S, M] — which cells saw data
    dt: torch.Tensor,  # float32[] — seconds since the previous step
) -> tuple[MetricsHeadState, MetricsHeadReport]:
    """One EWMA z step, **in place** on ``state`` (also returned), and
    its report. z is taken against the prior state, then the state
    absorbs the observation (West's update)."""
    x = x.to(torch.float32)[:, :, None]  # [S, M, 1]
    obs3 = observed.to(torch.bool)[:, :, None]  # [S, M, 1]
    # From pageable memory without a wait: the copy is staged at once.
    taus = torch.tensor(config.taus_s, dtype=torch.float32).to(x.device, non_blocking=True)
    # Debiased smoothing: until a cell has seen ~1/α observations, the
    # running-average weight.
    alpha = torch.maximum(
        1.0 - torch.exp(-torch.clamp(dt, min=1e-3) / taus),  # [T]
        1.0 / (state.obs[:, :, None] + 1.0),  # [S, M, 1]
    )  # [S, M, T]

    delta = x - state.mean
    floor2 = (config.rel_floor * state.mean) ** 2 + config.abs_floor
    z = delta / torch.sqrt(state.var + floor2)
    warm = (state.obs < config.warmup_obs)[:, :, None]
    z = torch.where(obs3 & ~warm, z, 0.0)

    new_mean = torch.where(obs3, state.mean + alpha * delta, state.mean)
    new_var = torch.where(
        obs3, (1.0 - alpha) * (state.var + alpha * delta * delta), state.var
    )
    state.mean.copy_(new_mean)
    state.var.copy_(new_var)
    state.obs.add_(observed.to(torch.float32))
    state.step_idx.add_(1)

    cell_flags = (z.abs() > config.z_threshold).any(dim=2)  # [S, M]
    flags = cell_flags.any(dim=1)  # [S]
    return state, MetricsHeadReport(z=z, cell_flags=cell_flags, flags=flags)


def head_state_from_numpy(state_np, device: "torch.device | str | None" = None) -> MetricsHeadState:
    """A head state pulled to numpy (by field name) → this package's
    state on ``device``, bit for bit."""
    device = resolve_device(device)
    return MetricsHeadState(
        **{
            name: torch.from_numpy(np.array(getattr(state_np, name), copy=True)).to(device)
            for name in MetricsHeadState._fields
        }
    )


class MetricsHead:
    """Owns the head state on its device and steps it.

    ``x``, ``observed`` and ``dt`` go to the device in one copy (packed
    into one pinned float32 buffer), so
    ``observe`` never waits on the card; the report stays on the device.
    """

    def __init__(
        self,
        config: MetricsHeadConfig | None = None,
        device: "torch.device | str | None" = None,
    ):
        self.config = config or MetricsHeadConfig()
        self.device = resolve_device(device)
        self.state = metrics_head_init(self.config, self.device)

    def observe(self, x: np.ndarray, observed: np.ndarray, dt: float) -> MetricsHeadReport:
        s, m = self.config.num_services, self.config.num_metrics
        n = s * m
        cuda = self.device.type == "cuda"
        buf = torch.empty(2 * n + 1, dtype=torch.float32, pin_memory=cuda)
        host = buf.numpy()
        host[:n] = np.asarray(x, np.float32).reshape(-1)
        host[n:2 * n] = np.asarray(observed, bool).reshape(-1)
        host[2 * n] = np.float32(dt)
        dev = buf.to(self.device, non_blocking=True) if cuda else buf
        self.state, report = metrics_head_step(
            self.config,
            self.state,
            dev[:n].view(s, m),
            dev[n:2 * n].view(s, m) != 0,
            dev[2 * n],
        )
        return report
