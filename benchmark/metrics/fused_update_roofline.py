"""K1's share of its memory roofline: the bytes the traced slice's
batches must move (harness/k1_bytes.py, no partials) at the H100's
3.35 TB/s, over K1's profiler time, in %."""

import numpy as np

from benchmark.harness.k1_bytes import batch_bytes
from benchmark.harness.peaks import HBM_BYTES_PER_S


def read(rec):
    dev = rec["device"]
    if not dev or not dev["k1_launches"]:
        return None
    t = rec["batch_times"]
    pick = np.nonzero((t >= dev["t0"]) & (t <= dev["t1"]))[0]
    if not pick.size:
        return None
    g = rec["cfg"]["detector"]
    cols = rec["batch_cols"]
    mean = np.mean([batch_bytes(g, cols[i][7], cols[i][2], cols[i][5], cols[i][6]) for i in pick])
    return 100.0 * mean * dev["k1_launches"] / HBM_BYTES_PER_S / dev["k1_s"]
