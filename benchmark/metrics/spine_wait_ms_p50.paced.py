"""Median wait of a staged batch on the spine's ring, from its stage to
the pump's take (``spine_wait``), in ms."""

import numpy as np


def read(rec):
    dts = [dt for name, _t, dt in rec["phase_events"] if name == "spine_wait"]
    return float(np.median(dts)) * 1e3 if dts else None
