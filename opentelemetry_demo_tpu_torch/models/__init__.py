"""Model layer: the streaming anomaly detector (sketch banks + EWMA/CUSUM
heads, advanced in place by one step per batch)."""

from .detector import (
    AnomalyDetector,
    DetectorConfig,
    DetectorReport,
    DetectorState,
    detector_init,
    detector_step,
    report_pack,
    report_unpack,
    state_from_numpy,
    state_to_numpy,
)
from .windows import WindowClock

__all__ = [
    "AnomalyDetector",
    "DetectorConfig",
    "DetectorReport",
    "DetectorState",
    "detector_init",
    "detector_step",
    "report_pack",
    "report_unpack",
    "state_from_numpy",
    "state_to_numpy",
    "WindowClock",
]
