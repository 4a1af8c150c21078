"""Median time a dispatched batch's report stays in flight, from the end
of its dispatch to the start of its harvest (``inflight``), in ms."""

import numpy as np


def read(rec):
    dts = [dt for name, _t, dt in rec["phase_events"] if name == "inflight"]
    return float(np.median(dts)) * 1e3 if dts else None
