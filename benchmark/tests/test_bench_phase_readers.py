"""The readers of the wait, report and pump phases: on a synthetic record
with known events, on a record without those phases (a program that does
not observe them: no reading, no error), and on a whole small run of the
harness on the CPU, where each reads a number."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import measures, spec
from benchmark.tests.conftest import CLOSED, PACED, ROOT, run_small

NEW = ("queue_wait_ms_p99.paced", "pending_wait_ms_p50.paced", "spine_wait_ms_p50.paced",
       "inflight_ms_p50.paced", "report_ms.paced", "pump_self_ms.sat")


def _events():
    ev = [("queue_wait", 10.0 + i, 0.001 * (i + 1)) for i in range(100)]  # 1..100 ms
    ev += [("pending_wait", 20.0, s) for s in (0.010, 0.030, 0.050)]
    ev += [("spine_wait", 20.0, s) for s in (0.060, 0.070, 0.080, 0.090)]
    ev += [("inflight", 20.0, s) for s in (0.0, 0.040, 0.020)]
    ev += [("report", 20.0, s) for s in (0.001, 0.003)]
    # Pump 1 spans [1.000, 1.010]: dispatch 4 ms and report 1 ms inside it,
    # a harvest that started before it and a stage (not a child) left out.
    ev += [("dispatch", 1.005, 0.004), ("report", 1.0095, 0.001), ("harvest", 1.001, 0.002),
           ("stage", 1.006, 0.001), ("pump", 1.010, 0.010)]
    # Pump 2 spans [2.000, 2.020]: put_wait 2 ms and flag 3 ms inside it; a
    # dispatch ending 0.5 us past its end still counts.
    ev += [("put_wait", 2.003, 0.002), ("flag", 2.010, 0.003), ("dispatch", 2.0200005, 0.005),
           ("pump", 2.020, 0.020)]
    return ev


@pytest.mark.parametrize("name, want", [
    ("queue_wait_ms_p99.paced", 99.01),
    ("pending_wait_ms_p50.paced", 30.0),
    ("spine_wait_ms_p50.paced", 75.0),
    ("inflight_ms_p50.paced", 20.0),
    # The mean over the three report events, the one inside a pump too.
    ("report_ms.paced", 5.0 / 3.0),
    # Pump 1: 10 - 4 - 1 = 5 ms; pump 2: 20 - 2 - 3 - 5 = 10 ms.
    ("pump_self_ms.sat", 7.5),
])
def test_reader_on_a_synthetic_record(name, want):
    got = spec.metric_reader(name)({"phase_events": _events()})
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_without_its_phase(name):
    older = [("dispatch", 1.0, 0.004), ("harvest", 1.01, 0.0002), ("put_wait", 1.0, 0.0)]
    assert spec.metric_reader(name)({"phase_events": older}) is None


def test_the_new_entries_read_their_layers_phases():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert all(entries[n]["source"] == "program_span" and entries[n]["unit"] == "ms" for n in NEW)
    assert [entries[n]["workloads"] for n in NEW] == [["shop.paced"]] * 5 + [["shop.saturate"]]


@pytest.mark.parametrize("mix, names", [
    (PACED, NEW[:5]),
    (CLOSED, NEW[5:]),
])
def test_each_reader_reads_a_number_from_a_small_run(mix, names):
    run = run_small(mix=mix, seconds=1.5)
    rec = measures.record(run)
    for name in names:
        v = spec.metric_reader(name)(rec)
        assert v is not None and v >= 0.0, name
