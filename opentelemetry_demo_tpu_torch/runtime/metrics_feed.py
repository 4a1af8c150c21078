"""Metric stream → dense observations → metrics head (host glue).

Metric points arrive at scrape cadence, so this feed is light: a
lock-guarded accumulator that folds :class:`MetricRecord` s into dense
``[S, M]`` arrays and one head step per pump.

Cumulative monotonic sums difference against the last seen value (a
counter reset counts the new value, the Prometheus rate() rule);
delta-temporality sums accumulate directly; gauges and non-monotonic
sums observe the latest level. Service and metric names intern into
``S`` and ``M`` slots; a name past capacity gets -1 and its points are
DROPPED (counted in ``points_overflow``), not folded: a shared overflow
slot would interleave unrelated cumulative counters, and the reset rule
would then make up huge deltas.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch

from ..models.metrics_head import MetricsHead, MetricsHeadConfig, MetricsHeadReport
from .otlp_metrics import TEMPORALITY_DELTA, MetricRecord


class MetricsFeed:
    """Accumulates metric points and pumps them through the metrics head
    on ``device`` (the card unless the caller names another).

    ``service_id`` maps service names to the span pipeline's ids when the
    two legs are co-deployed (pass ``SpanTensorizer.service_id``); by
    default the feed keeps its own intern table.
    """

    def __init__(
        self,
        config: MetricsHeadConfig | None = None,
        service_id: Callable[[str], int] | None = None,
        on_report: Callable[[float, MetricsHeadReport], None] | None = None,
        device: "torch.device | str | None" = None,
    ):
        self.config = config or MetricsHeadConfig()
        self.head = MetricsHead(self.config, device)
        self.on_report = on_report
        # Guards the accumulators, the intern tables and the head step
        # (the step only enqueues work on the card; a checkpoint takes its
        # copy of the head state under this lock).
        self._lock = threading.Lock()
        s, m = self.config.num_services, self.config.num_metrics
        self._service_id = service_id or self._intern_service
        self._service_names: list[str] = []
        self._service_table: dict[str, int] = {}
        self._metric_names: list[str] = []
        self._metric_table: dict[str, int] = {}
        # Cumulative-counter memory + per-pump accumulation.
        self._last = np.zeros((s, m), np.float64)
        self._has_last = np.zeros((s, m), bool)
        self._accum = np.zeros((s, m), np.float64)
        self._rate_obs = np.zeros((s, m), bool)
        self._level = np.zeros((s, m), np.float64)
        self._level_obs = np.zeros((s, m), bool)
        self._t_last: float | None = None
        self.points_total = 0
        self.points_overflow = 0

    # -- intern tables --------------------------------------------------

    def _intern_service(self, name: str) -> int:
        """Slot for ``name``, or -1 when capacity is exhausted."""
        sid = self._service_table.get(name)
        if sid is None:
            if len(self._service_names) >= self.config.num_services:
                return -1
            sid = len(self._service_names)
            self._service_table[name] = sid
            self._service_names.append(name)
        return sid

    @property
    def service_names(self) -> list[str]:
        """Interned service names (with an external ``service_id`` the
        caller owns the name ↔ id map)."""
        return list(self._service_names)

    def metric_id(self, name: str) -> int:
        """Slot for ``name``, or -1 when capacity is exhausted."""
        mid = self._metric_table.get(name)
        if mid is None:
            if len(self._metric_names) >= self.config.num_metrics:
                return -1
            mid = len(self._metric_names)
            self._metric_table[name] = mid
            self._metric_names.append(name)
        return mid

    @property
    def metric_names(self) -> list[str]:
        return list(self._metric_names)

    def metric_slot_names(self) -> list[str]:
        """Slot → metric name, padded to the configured width."""
        pad = self.config.num_metrics - len(self._metric_names)
        return self._metric_names + ["?"] * pad

    # -- ingest ---------------------------------------------------------

    def submit(self, records: list[MetricRecord]) -> None:
        with self._lock:
            for rec in records:
                sid = self._service_id(rec.service)
                mid = self.metric_id(rec.name)
                if sid < 0 or sid >= self.config.num_services or mid < 0:
                    self.points_overflow += 1
                    continue
                self.points_total += 1
                if rec.kind == "sum" and rec.monotonic:
                    if rec.temporality == TEMPORALITY_DELTA:
                        self._accum[sid, mid] += rec.value
                        self._rate_obs[sid, mid] = True
                    elif self._has_last[sid, mid]:
                        prev = self._last[sid, mid]
                        # Counter reset: the new cumulative IS the delta.
                        delta = rec.value - prev if rec.value >= prev else rec.value
                        self._accum[sid, mid] += delta
                        self._rate_obs[sid, mid] = True
                        self._last[sid, mid] = rec.value
                    else:
                        self._last[sid, mid] = rec.value
                        self._has_last[sid, mid] = True
                else:  # gauge / non-monotonic sum: observe the level
                    self._level[sid, mid] = rec.value
                    self._level_obs[sid, mid] = True

    # -- pump -----------------------------------------------------------

    def pump(self, t_now: float | None = None) -> MetricsHeadReport | None:
        """Fold the accumulated points into one head step.

        Returns the report (tensors on the head's device) and fires
        ``on_report`` when any cell was observed; None on an empty
        interval, so quiet cells never absorb made-up zeros. Without
        ``t_now`` the last timebase is reused, which makes the elapsed
        time zero, and zero elapsed time folds nothing (rates divide by
        it): accumulation goes on until a real timestamp arrives.
        """
        with self._lock:
            if t_now is None:
                t_now = self._t_last if self._t_last is not None else time.monotonic()
            if self._t_last is None:
                self._t_last = t_now
                # First pump: counters have at most baselines recorded.
                self._rate_obs[:] = False
                self._level_obs[:] = False
                self._accum[:] = 0.0
                return None
            dt = t_now - self._t_last
            if dt <= 0.0:
                return None  # no elapsed time: keep accumulating
            observed = self._rate_obs | self._level_obs
            if not observed.any():
                self._t_last = t_now
                return None
            x = np.where(self._rate_obs, self._accum / dt, self._level).astype(np.float32)
            self._accum[:] = 0.0
            self._rate_obs[:] = False
            self._level_obs[:] = False
            self._t_last = t_now
            report = self.head.observe(x, observed, dt)
        if self.on_report is not None:
            self.on_report(t_now, report)
        return report

    def flagged_services(self, report: MetricsHeadReport, names: list[str]) -> list[str]:
        flags = report.flags
        mask = np.asarray(flags.cpu() if isinstance(flags, torch.Tensor) else flags)
        return [n for i, n in enumerate(names) if i < mask.shape[0] and mask[i]]
