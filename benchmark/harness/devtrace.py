"""The device's side of a traced window, from ``torch.profiler``.

Reads the CUDA activity of the traced slice (kernels, copies and
memsets on every stream): the seconds in which anything ran (their
union), the time and count of each device operation, and the idle gaps
between them, each named by the host phase it overlaps most (the
pipeline's ``phase_observe`` phases on the pump thread, the pool's on
the decode workers, else the pump's sleep between calls).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

ANCHOR = "bench.anchor"
K1_KERNEL = "sketch_kernel"
COPY_OPS = ("Memcpy", "Memset")


class DeviceTrace:
    """Start and stop a profiler over a slice of the window."""

    def __init__(self):
        import torch

        self.torch = torch
        self.prof = None
        self.slices = 0
        self.t0 = self.t1 = None
        self.anchor_host = None

    def _profile(self):
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        return torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        """Bring the profiler's device tracing up once (set-up): its first
        start takes seconds, which would eat the traced slice."""
        torch = self.torch
        with self._profile():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        torch = self.torch
        self.prof = self._profile()
        self.prof.start()
        with torch.profiler.record_function(ANCHOR):
            self.anchor_host = time.perf_counter()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.slices += 1

    def kernels_seen(self) -> bool:
        """Whether the last slice recorded a kernel, copies and memsets
        aside, from the profiler's raw events (nothing is parsed; the look
        stops at the first kernel). Now and then the profiler keeps a
        slice's copies and loses every kernel; such a slice cannot be read."""
        from torch.autograd import DeviceType

        raw = self.prof.profiler.kineto_results.events()
        return any(e.device_type() == DeviceType.CUDA and not e.name().startswith(COPY_OPS) for e in raw)

    def read(self, phase_events, pump_spans) -> dict:
        """Busy seconds, device ops by time, K1's launches and seconds,
        and idle seconds by the host phase under them."""
        from torch.autograd import DeviceType

        if not self.kernels_seen():
            raise RuntimeError(f"the profiler recorded no kernel in any of {self.slices} slices")
        events = self.prof.events()
        anchor = [e.time_range.start for e in events if e.name == ANCHOR]
        if not anchor:
            raise RuntimeError("the profiler lost its anchor range")
        # Host perf_counter seconds of a trace microsecond.
        off = self.anchor_host - anchor[0] * 1e-6
        lo, hi = self.t0, self.t1
        spans, by_name, k1 = [], defaultdict(float), []
        for e in events:
            if e.device_type != DeviceType.CUDA:
                continue
            a = e.time_range.start * 1e-6 + off
            b = e.time_range.end * 1e-6 + off
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            spans.append((a, b))
            by_name[e.name] += b - a
            if K1_KERNEL in e.name:
                k1.append(b - a)
        spans.sort()
        busy, end, gaps = 0.0, lo, []
        for a, b in spans:
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if hi > end:
            gaps.append((end, hi))
        return dict(
            t0=lo, t1=hi, window_s=hi - lo, busy_s=busy, ops=len(spans), slices=self.slices,
            k1_s=sum(k1), k1_launches=len(k1),
            device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            idle_gaps=_name_gaps(gaps, phase_events, pump_spans, lo, hi)[:10],
        )


# Phases observed when they end, on the thread that ran them (the spine's
# stage is reported later, at dispatch, so it has no place in time here).
PUMP_PHASES = ("dispatch", "harvest", "flag", "put_wait")
POOL_PHASES = ("decode", "verify", "tensorize", "submit")


def _name_gaps(gaps, phase_events, pump_spans, lo, hi) -> list:
    """Idle seconds by what the host was doing: each gap's seconds go to
    the host intervals over it (a pump phase before the rest of a pump
    call, before the decode workers' phases), the rest to the pump's
    sleep between calls."""
    host = []
    for phase, t_end, dt in phase_events:
        if phase in PUMP_PHASES or phase in POOL_PHASES:
            if t_end >= lo and t_end - dt <= hi:
                host.append((t_end - dt, t_end, phase))
    for a, b in pump_spans:
        if b >= lo and a <= hi:
            host.append((a, b, "pump_other"))
    order = PUMP_PHASES + ("pump_other",) + POOL_PHASES
    rank = {p: i for i, p in enumerate(order)}
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g1)
        pieces = sorted(((max(a, g0), min(b, g1), name) for a, b, name in host[max(0, i - 256):i]
                         if min(b, g1) > max(a, g0)), key=lambda p: rank[p[2]])
        taken: list[tuple[float, float]] = []  # disjoint, what higher ranks took
        for a, b, name in pieces:
            free = _subtract((a, b), taken)
            got = sum(d - c for c, d in free)
            if got > 0:
                idle[name] += got
                taken = sorted(taken + free)
        idle["pump_sleep"] += (g1 - g0) - sum(d - c for c, d in taken)
    return sorted(([n, s] for n, s in idle.items() if s > 0), key=lambda kv: -kv[1])


def _subtract(span, taken):
    """The parts of ``span`` outside the disjoint sorted intervals ``taken``."""
    a, b = span
    out = []
    for c, d in taken:
        if d <= a or c >= b:
            continue
        if c > a:
            out.append((a, c))
        a = max(a, d)
        if a >= b:
            return out
    if b > a:
        out.append((a, b))
    return out
