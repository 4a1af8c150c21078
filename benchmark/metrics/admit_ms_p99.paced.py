"""99th percentile of a body's time from its due time to the pool's
verdict (its ticket resolved: rows enqueued), in ms."""

import numpy as np


def read(rec):
    x = rec["admit_ms"]
    x = x[np.isfinite(x)]
    return float(np.percentile(x, 99)) if x.size else None
