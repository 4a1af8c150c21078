"""Mean self time of one ``pump`` call: its seconds less those of the
dispatch, put_wait, harvest, flag and report phases whose interval lies
inside it (1 us tolerance), in ms. A phase's interval ends at its
event's clock and starts its seconds earlier."""

import bisect

import numpy as np

CHILDREN = ("dispatch", "put_wait", "harvest", "flag", "report")
TOL_S = 1e-6


def read(rec):
    events = rec["phase_events"]
    pumps = sorted((t - dt, t) for name, t, dt in events if name == "pump")
    if not pumps:
        return None
    starts = [a for a, _b in pumps]
    inside = np.zeros(len(pumps))
    for name, t, dt in events:
        if name not in CHILDREN:
            continue
        i = bisect.bisect_right(starts, t - dt + TOL_S) - 1
        if i >= 0 and pumps[i][0] - TOL_S <= t - dt and t <= pumps[i][1] + TOL_S:
            inside[i] += dt
    total = np.array([b - a for a, b in pumps])
    return float(np.mean(total - inside)) * 1e3
