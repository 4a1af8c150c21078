"""Helpers the per-layer readers share."""

from __future__ import annotations

import numpy as np


def phase_mean_ms(rec: dict, phase: str) -> float | None:
    """Mean seconds of one ``phase_observe`` phase over the window, in ms."""
    dts = [dt for name, _t, dt in rec["phase_events"] if name == phase]
    return float(np.mean(dts)) * 1e3 if dts else None


def pool_us_per_kspan(rec: dict, *phases: str) -> float | None:
    """Decode-pool seconds of ``phases`` over the window, per 1000 spans
    flushed, in microseconds."""
    if not rec["pool_spans"]:
        return None
    s = sum(rec["pool_phase_s"].get(p, 0.0) for p in phases)
    return s * 1e6 / (rec["pool_spans"] / 1e3)


def idle_pct(rec: dict) -> float | None:
    dev = rec["device"]
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
