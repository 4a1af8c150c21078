"""99th percentile of a request's wait in the decode pool's queue, from
its enqueue to the worker's take (``queue_wait``), in ms."""

import numpy as np


def read(rec):
    dts = [dt for name, _t, dt in rec["phase_events"] if name == "queue_wait"]
    return float(np.percentile(dts, 99)) * 1e3 if dts else None
