"""Bytes K1 (the fused sketch update, ``csrc/fused_update.cu``) must move
for one dispatched batch, counted from the batch itself:

- every lane read once: service, log-latency, error, the trace hash's
  two words, valid, and a CMS index per row (4 B each, valid 1 B);
- every bank cell the batch touches, read and written once in each
  window's current bank: the distinct (service, bucket) HLL registers
  and the distinct CMS counters;
- the heads read and written once, the stats and z-scores written.

The stats partials the kernel also moves belong to its design, not to
the batch, and are left out. Hashes come from the reference's frozen
copies (``reference/hashing.py``).
"""

from __future__ import annotations

import numpy as np

from ..reference.hashing import cms_cells, hll_cells


def batch_bytes(geometry: dict, width: int, slot, trace_key, attr_crc) -> int:
    s, p = int(geometry["num_services"]), int(geometry["hll_p"])
    d, w = int(geometry["cms_depth"]), int(geometry["cms_width"])
    t, nw = len(geometry["taus_s"]), len(geometry["windows_s"])
    slot = np.asarray(slot, np.int64)
    lane_bytes = int(width) * (4 * 5 + 1 + 4 * d)
    bucket, _ = hll_cells(np.asarray(trace_key, np.uint64), p)
    hll = np.unique(slot * (1 << p) + bucket).shape[0]
    idx = cms_cells(np.asarray(attr_crc, np.uint64), slot, d, w)
    cms = np.unique(idx + (np.arange(d, dtype=np.int64) * w)[:, None]).shape[0]
    bank_bytes = (hll + cms) * nw * 4 * 2
    head_bytes = (5 * s * t + 3 * s + s) * 4 * 2 + 3 * s * t * 4 + 4 * s * 4 + 8
    return lane_bytes + bank_bytes + head_bytes
