"""Device time per dispatched step over the traced slice (the union of
its CUDA activity over the steps dispatched in it), in ms."""

import numpy as np


def read(rec):
    dev = rec["device"]
    if not dev:
        return None
    t = rec["batch_times"]
    steps = int(np.sum((t >= dev["t0"]) & (t <= dev["t1"])))
    return dev["busy_s"] * 1e3 / steps if steps else None
