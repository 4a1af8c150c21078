"""Idle gaps are split by what the host was doing over them, each second
once, a pump phase before the rest of its pump call; a slice that lost
its kernels is traced again, and never read."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmark.harness.cell import trace_slices
from benchmark.harness.devtrace import DeviceTrace, _name_gaps


def test_idle_seconds_go_once_to_the_highest_ranked_host_interval():
    gaps = [(0.0, 1.0), (2.0, 3.0)]
    phases = [("dispatch", 0.3, 0.2), ("decode", 0.5, 0.4)]
    pumps = [(0.05, 0.35)]
    got = dict(_name_gaps(gaps, phases, pumps, 0.0, 3.0))
    assert got["dispatch"] == pytest.approx(0.2)
    assert got["pump_other"] == pytest.approx(0.1)
    assert got["decode"] == pytest.approx(0.15)
    assert got["pump_sleep"] == pytest.approx(2.0 - 0.45)
    assert sum(got.values()) == pytest.approx(2.0)


class FakeTrace:
    """A profiler whose first ``lose`` slices keep no kernel."""

    def __init__(self, lose: int):
        self.lose = lose
        self.slices = 0
        self.t0 = None

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self):
        self.slices += 1

    def kernels_seen(self):
        return self.slices > self.lose


@pytest.mark.parametrize("lose,slices", [(0, 1), (1, 2), (9, 3)])
def test_a_slice_that_lost_its_kernels_is_traced_again_while_the_window_has_room(lose, slices):
    dev = FakeTrace(lose)
    now = time.perf_counter()
    trace_slices(dev, now, now + 0.35, 0.1)
    assert dev.slices == slices


def test_a_trace_with_no_kernel_is_not_read():
    """Copies alone are no reading of the device: the run fails rather
    than report a step time or an idle share from them."""
    from torch.autograd import DeviceType

    class Raw:
        def __init__(self, name):
            self._name = name

        def name(self):
            return self._name

        def device_type(self):
            return DeviceType.CUDA

    dev = DeviceTrace.__new__(DeviceTrace)
    dev.slices = 2
    dev.prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: [Raw("Memcpy HtoD (Pinned -> Device)"), Raw("Memset (Device)")])))
    assert not dev.kernels_seen()
    with pytest.raises(RuntimeError, match="no kernel"):
        dev.read([], [])
    dev.prof.profiler.kineto_results.events = lambda: [Raw("Memcpy DtoH"), Raw("sketch_kernel(SketchArgs)")]
    assert dev.kernels_seen()
