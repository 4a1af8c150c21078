"""Host-side window clock: turns wall time into (dt, rotate-mask) inputs.

The detector step has no clocks and no branches: the host decides which
tumbling windows crossed a boundary between two batches and passes that
as a bool mask (a data input).
"""

from __future__ import annotations

import numpy as np


class WindowClock:
    """Tracks tumbling-window boundary crossings for each window length.

    ``tick(t_now)`` returns ``(dt, rotate)`` where ``rotate[w]`` is True
    iff windows_s[w] has a boundary in ``(t_prev, t_now]``. If the stream
    stalls for several boundaries, one rotation still suffices: the bank
    holds {cur, prev} and older content is by definition stale.
    """

    def __init__(self, windows_s: tuple[float, ...]):
        self.windows_s = np.asarray(windows_s, np.float64)
        self._t_prev: float | None = None

    def tick(self, t_now: float) -> tuple[float, np.ndarray]:
        if self._t_prev is None:
            self._t_prev = float(t_now)
            return 1e-3, np.zeros(len(self.windows_s), bool)
        dt = max(float(t_now) - self._t_prev, 1e-3)
        rotate = (
            np.floor(t_now / self.windows_s) > np.floor(self._t_prev / self.windows_s)
        )
        self._t_prev = float(t_now)
        return dt, rotate
