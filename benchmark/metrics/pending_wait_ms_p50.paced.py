"""Median wait of a batch's oldest rows in the pipeline's pending queue,
from their enqueue to the pump's take (``pending_wait``), in ms."""

import numpy as np


def read(rec):
    dts = [dt for name, _t, dt in rec["phase_events"] if name == "pending_wait"]
    return float(np.median(dts)) * 1e3 if dts else None
