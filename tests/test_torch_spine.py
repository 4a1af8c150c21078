"""The port's device-put spine: ring slots, the two guards, lifecycle.

- ``pack_columns_into`` (into a plain batch or a spine slot's int32
  views) equals ``pack_columns`` and the reference's, chunked or not.
- Spine on, at ring depths 1, 2 and 3, against spine off: the detector
  state bit-identical and every report read equal to the inline run's
  (a missing guard would let a copy overwrite lanes a step still reads,
  or a pack overwrite bytes a copy still reads).
- The ring: slots allocated once per width and reused, a slot's host
  buffer repacked only after its last copy, a failed pack raised to the
  pump with its slot left free, and ``stats``.
- The pump puts and dispatches each batch in the same call: nothing is
  staged after any pump, and no thread is started for it.
- ``spine_overlap=False`` leaves state and reports bit-identical to
  overlap on, and the reference's takes all wait.
- How deep the pump pipelines across its own calls: a caught-up pump
  (its take left no rows) reads its own batch's report before it
  returns; a backlogged one keeps one report in flight; the way from one
  to the other skips no report; the async harvester and a positive
  harvest interval keep their cadence.
- A backlogged take's width (adaptive batching): the smallest ladder
  width that holds the backlog, up to the ladder's top, with the
  controller's width and hold untouched, spine on and off; the state
  after the drain equals the reference detector stepped over the
  batches the port dispatched.
- On the card (``gpu``): the same bit-identity, with a spin kernel ahead
  of each step so copies land behind running steps, and the async
  harvester under ``drain``.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import AnomalyDetector as JAnomalyDetector
from opentelemetry_demo_tpu.models import DetectorConfig as JDetectorConfig
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu.runtime.pipeline import DetectorPipeline as JDetectorPipeline
from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
from opentelemetry_demo_tpu_torch.runtime.lagbench import make_columns
from opentelemetry_demo_tpu_torch.runtime import selftrace
from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
from opentelemetry_demo_tpu_torch.runtime.spine import DevicePutSpine, slot_views
from opentelemetry_demo_tpu_torch.utils.flags import FlagEvaluator
from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanColumns, SpanTensorizer

SMALL = dict(num_services=8, hll_p=8, cms_width=512)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the spine's streams and events run only on the card)")
    return torch.device("cuda")


def _stream(seed=7, n_batches=40, width=256):
    """Chunks of varied size, so some pumps leave a backlog and the
    overlap path (dispatch k while staging k+1) engages."""
    rng = np.random.default_rng(seed)
    return [make_columns(rng, width if i % 3 else 2 * width - 12) for i in range(n_batches)]


def _run(device, chunks, spine_ring=0, harvest_async=False, width=256, spin_cycles=0, **kw):
    det = AnomalyDetector(DetectorConfig(**SMALL), device=device)
    if spin_cycles:
        # A spin kernel ahead of each staged step on the dispatch stream
        # keeps step k running while the copy for batch k + depth is
        # issued into the same device slot.
        step = det.observe_staged_packed

        def slow_step(lanes, t_now):
            torch.cuda._sleep(spin_cycles)
            return step(lanes, t_now)

        det.observe_staged_packed = slow_step
    reports = []
    pipe = DetectorPipeline(
        det,
        on_report=lambda t, r, f: reports.append((t, r, tuple(f))),
        batch_size=width,
        spine_ring=spine_ring,
        harvest_async=harvest_async,
        **kw,
    )
    t = 0.0
    for cols in chunks:
        pipe.submit_columns(cols)
        pipe.pump(t)
        t += 0.05
    pipe.close()
    reports.sort(key=lambda r: r[0])
    return det, pipe, reports


def _assert_same_run(ref, got):
    (d0, p0, r0), (d1, p1, r1) = ref, got
    assert p0.stats.batches == p1.stats.batches and p0.stats.spans == p1.stats.spans
    for name, a, b in zip(d0.state._fields, d0.state, d1.state):
        assert torch.equal(a.cpu(), b.cpu()), name
    # Every report the spine run read equals the inline run's at that
    # batch; a report can be skipped (two in flight), never altered. The
    # final drain dispatches its batches at one time stamp: those are
    # told apart by order, so only stamps of one batch are matched.
    assert len(r1) + p1.stats.reports_skipped == p1.stats.batches
    stamps = [t for t, _, _ in r0]
    by_t = {t: (r, f) for t, r, f in r0 if stamps.count(t) == 1}
    matched = 0
    for t, r, f in r1:
        if t not in by_t:
            continue
        rr, ff = by_t[t]
        assert f == ff, t
        for name, x, y in zip(r._fields, r, rr):
            assert np.array_equal(x, y), (t, name)
        matched += 1
    assert matched >= len(by_t) - p1.stats.reports_skipped > 0


@pytest.mark.parametrize("chunk_rows", [0, 7, 64, 1000])
def test_pack_columns_into_matches_pack_columns_and_the_reference(chunk_rows):
    tz = SpanTensorizer(num_services=8, batch_size=256)
    rng = np.random.default_rng(3)
    cols = make_columns(rng, 200)
    ref = tz.pack_columns(cols, width=256)
    jref = jtz.SpanTensorizer(num_services=8, batch_size=256).pack_columns(
        jtz.SpanColumns(*cols), width=256
    )
    slot = tz.alloc_batch(256)
    got = tz.pack_columns_into(slot, cols, chunk_rows=chunk_rows)
    assert got.svc is slot.svc and got.valid is slot.valid  # no hidden allocation
    for name, x, y, z in zip(ref._fields, ref, got, jref):
        assert x.dtype == y.dtype == z.dtype and x.tobytes() == y.tobytes() == z.tobytes(), name
    # A spine slot: the same lanes as int32 views of one buffer.
    buf = torch.full((8 * 256,), -7, dtype=torch.int32)
    views = tz.pack_columns_into(slot_views(buf, 256), cols, chunk_rows=chunk_rows)
    for name, x, y in zip(ref._fields, ref, views):
        assert np.array_equal(x.astype(y.dtype) if name == "valid" else x, y), name
    assert buf.numpy()[7 * 256:].tolist() == ref.valid.astype(np.int32).tolist()


def test_pack_into_overflow_refused():
    tz = SpanTensorizer(num_services=8, batch_size=64)
    with pytest.raises(ValueError, match="exceeds batch width"):
        tz.pack_columns_into(tz.alloc_batch(64), make_columns(np.random.default_rng(0), 65))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_spine_on_equals_spine_off(depth):
    chunks = _stream()
    _assert_same_run(_run("cpu", chunks), _run("cpu", chunks, spine_ring=depth))


@pytest.mark.parametrize("depth", [1, 3])
def test_spine_with_the_async_harvester_equals_spine_off(depth):
    chunks = _stream(seed=8)
    _assert_same_run(_run("cpu", chunks), _run("cpu", chunks, spine_ring=depth, harvest_async=True))


def test_chunked_spine_pack_equals_spine_off():
    chunks = _stream(seed=9, n_batches=12)
    _assert_same_run(_run("cpu", chunks), _run("cpu", chunks, spine_ring=2, spine_chunk_rows=37))


def test_spine_run_flags_as_the_reference_pipeline():
    """The port's spine run against the reference pipeline on the same
    stream: identical flags, integer reports exact, floats close."""
    chunks = _stream(seed=10, n_batches=30)
    _, p1, got = _run("cpu", chunks, spine_ring=2)
    reports = []
    jpipe = JDetectorPipeline(
        JAnomalyDetector(JDetectorConfig(**SMALL)),
        on_report=lambda t, r, f: reports.append((t, r, tuple(f))),
        batch_size=256,
    )
    t = 0.0
    for cols in chunks:
        jpipe.submit_columns(jtz.SpanColumns(*cols))
        jpipe.pump(t)
        t += 0.05
    jpipe.close()
    stamps = [t for t, _, _ in reports]
    by_t = {t: (r, f) for t, r, f in reports if stamps.count(t) == 1}
    assert len(got) > 20
    for t, r, f in got:
        if t not in by_t:
            continue
        jr, jf = by_t[t]
        assert f == jf, t
        for name, x, y in zip(r._fields, r, jr):
            y = np.asarray(y)
            if np.issubdtype(x.dtype, np.floating):
                np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5, err_msg=name)
            else:
                assert np.array_equal(x, y), (t, name)


def _spy_waits(monkeypatch, spine_cls) -> list[bool]:
    """The ``wait`` of every ``take`` the pump makes, in order."""
    waits: list[bool] = []
    take = spine_cls.take

    def spy(self, *args, **kw):
        waits.append(bool(kw["wait"] if "wait" in kw else args[0]))
        return take(self, *args, **kw)

    monkeypatch.setattr(spine_cls, "take", spy)
    return waits


def _reference_run(chunks, **kw):
    reports = []
    jpipe = JDetectorPipeline(
        JAnomalyDetector(JDetectorConfig(**SMALL)),
        on_report=lambda t, r, f: reports.append((t, r, tuple(f))),
        batch_size=256,
        **kw,
    )
    t = 0.0
    for cols in chunks:
        jpipe.submit_columns(jtz.SpanColumns(*cols))
        jpipe.pump(t)
        t += 0.05
    jpipe.close()
    return jpipe, sorted(reports, key=lambda r: r[0])


@pytest.mark.parametrize("depth", [1, 2])
def test_overlap_off_leaves_state_and_verdicts_as_overlap_on_and_the_reference(monkeypatch, depth):
    """``spine_overlap=False`` (``ANOMALY_SPINE_OVERLAP=0``) makes the
    port's pump wait on the host for each put's copy (on the card; off it
    every copy is synchronous) and the reference's takes all wait; it
    changes no bit of the state or of a report: overlap decides only when
    the host goes on.
    The reports equal the reference pipeline's on the same stream. (The
    reference's own spine-on run is not the comparison: under CPU load
    its reports vary from run to run, while the port's do not.)"""
    from opentelemetry_demo_tpu.runtime.spine import DevicePutSpine as JDevicePutSpine

    chunks = _stream(seed=11, n_batches=30)
    on = _run("cpu", chunks, spine_ring=depth)
    off = _run("cpu", chunks, spine_ring=depth, spine_overlap=False)
    assert on[1]._spine.overlap is True and off[1]._spine.overlap is False
    assert off[1].spine_stats()["puts_total"] == off[1].stats.batches
    _assert_same_run(on, off)
    ref_waits = _spy_waits(monkeypatch, JDevicePutSpine)
    jpipe, _ = _reference_run(chunks, spine_ring=depth, spine_overlap=False)
    assert jpipe._spine.overlap is False
    assert ref_waits and all(ref_waits)
    _, reports = _reference_run(chunks)
    _, _, got = off
    # The final drain dispatches its batches at one time stamp: only the
    # stamps of one batch are matched report to report.
    stamps = [t for t, _, _ in reports]
    by_t = {t: (r, f) for t, r, f in reports if stamps.count(t) == 1}
    assert len(by_t) > 20
    for t, r, f in got:
        if t not in by_t:
            continue
        jr, jf = by_t[t]
        assert f == jf, t
        for name, x, y in zip(r._fields, r, jr):
            y = np.asarray(y)
            if np.issubdtype(x.dtype, np.floating):
                np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5, err_msg=name)
            else:
                assert np.array_equal(x, y), (t, name)


def test_ring_slots_are_allocated_once_and_reused():
    tz = SpanTensorizer(num_services=8, batch_size=128)
    spine = DevicePutSpine(tz, "cpu", depth=2)
    rng = np.random.default_rng(5)
    for i in range(8):
        put = spine.put(make_columns(rng, 128), 128)
        assert put.lanes.shape == (8 * 128,) and put.slot == i % 2
        spine.release(put)
    hosts = set()
    for slot in spine._slots:
        assert list(slot.host) == [128] and list(slot.dev) == [128]
        hosts.add(slot.host[128][0].data_ptr())
    assert len(hosts) == 2
    st = spine.stats()
    assert st["puts_total"] == 8 and st["ring_depth"] == 2 and st["staged"] == 0
    assert st["overlap_hits"] + st["overlap_misses"] == 8


class _SlowCopy:
    """A slot's last copy event that takes ``HOLD_S`` to finish; the pack
    that follows must find it done."""

    HOLD_S = 0.05

    def __init__(self, log: list[str]):
        self.log = log

    def synchronize(self) -> None:
        time.sleep(self.HOLD_S)
        self.log.append("copy done")


def test_a_slot_waits_for_its_last_batch_to_be_released():
    """Guard 1: a slot's host buffer is repacked only once its last copy
    is done. The put waits on the copy's event before it packs, the
    waited seconds are the put's ``wait_s`` and the stats' ``take_wait_s``,
    and the lanes then hold the new batch."""
    tz = SpanTensorizer(num_services=8, batch_size=64)
    spine = DevicePutSpine(tz, "cpu", depth=1)
    rng = np.random.default_rng(1)
    log: list[str] = []
    pack = tz.pack_columns_into

    def logged_pack(*a, **kw):
        log.append("pack")
        return pack(*a, **kw)

    tz.pack_columns_into = logged_pack
    first = spine.put(make_columns(rng, 64), 64)
    spine.release(first)
    spine._slots[0].copied = _SlowCopy(log)
    b = make_columns(rng, 64)
    second = spine.put(b, 64)
    assert log == ["pack", "copy done", "pack"]
    assert second.slot == 0 and second.lanes is first.lanes
    assert second.wait_s >= _SlowCopy.HOLD_S and second.wait_s <= spine.stats()["take_wait_s"]
    want = tz.pack_columns(b, width=64)
    assert np.array_equal(slot_views(second.lanes, 64).trace_lo, want.trace_lo)
    spine.release(second)


def test_a_failed_stage_raises_to_the_taker():
    """A pack that fails (one row too many) raises to the pump that put
    it; the slot is left free, so the next pump's batch takes it."""
    det = AnomalyDetector(DetectorConfig(**SMALL), device="cpu")
    pipe = DetectorPipeline(det, batch_size=64, spine_ring=2)
    rng = np.random.default_rng(4)
    pack = pipe._spine.tensorizer.pack_columns_into
    pipe._spine.tensorizer.pack_columns_into = lambda views, cols, **kw: pack(
        views, make_columns(rng, 65), **kw
    )
    try:
        pipe.submit_columns(make_columns(rng, 64))
        with pytest.raises(ValueError, match="exceeds batch width"):
            pipe.pump(0.0)
        assert pipe.stats.batches == 0 and pipe._spine.pending() == 0 and pipe._spine._seq == 0
        pipe._spine.tensorizer.pack_columns_into = pack
        pipe.submit_columns(make_columns(rng, 64))
        pipe.pump(0.1)
        # The batch went through slot 0; slot 1 was never touched.
        assert pipe._spine._seq == 1 and not pipe._spine._slots[1].host
        assert pipe.stats.batches == 1 and pipe.spine_stats()["puts_total"] == 1
    finally:
        pipe.close()


def test_spine_knobs_and_stats_surface():
    with pytest.raises(ValueError):
        DevicePutSpine(SpanTensorizer(), "cpu", depth=0)
    det = AnomalyDetector(DetectorConfig(**SMALL), device="cpu")
    pipe = DetectorPipeline(det, batch_size=128)
    assert pipe.spine_stats() is None
    pipe.close()
    pipe = DetectorPipeline(det, batch_size=128, spine_ring=3)
    st = pipe.spine_stats()
    assert set(st) == {"ring_depth", "staged", "puts_total", "overlap_hits", "overlap_misses",
                       "overlap_ratio", "step_waits", "stage_s", "take_wait_s"}
    assert st["ring_depth"] == 3
    pipe.close()


def _pump_pipe(**kw):
    """A CPU pipeline of width 256 whose ``on_report`` lists each report's
    timebase and the thread that read it."""
    det = AnomalyDetector(DetectorConfig(**SMALL), device="cpu")
    seen: list[tuple[float, str]] = []
    pipe = DetectorPipeline(
        det, on_report=lambda t, r, f: seen.append((t, threading.current_thread().name)),
        batch_size=256, **kw,
    )
    return pipe, seen


def _in_flight(pipe) -> int:
    with pipe._inflight_lock:
        return len(pipe._inflight)


@pytest.mark.parametrize("spine_ring", [2, 0])
def test_a_caught_up_pump_reads_its_own_batch_before_it_returns(spine_ring):
    """Each pump takes everything queued (200 rows, width 256): before it
    returns, its own batch's report has reached ``on_report``, and its
    ``spine_wait`` (spine on, overlap on) and ``inflight`` were observed
    inside the call. Nothing is left staged or in flight."""
    events: list[tuple[str, float]] = []
    pipe, seen = _pump_pipe(
        spine_ring=spine_ring, phase_observe=lambda p, dt: events.append((p, time.perf_counter()))
    )
    rng = np.random.default_rng(3)
    want = {selftrace.PHASE_INFLIGHT} | ({selftrace.PHASE_SPINE_WAIT} if spine_ring else set())
    try:
        for k in range(4):
            pipe.submit_columns(make_columns(rng, 200))
            t0 = time.perf_counter()
            pipe.pump(float(k))
            t1 = time.perf_counter()
            assert [t for t, _ in seen] == [float(i) for i in range(k + 1)]
            assert want <= {p for p, t in events if t0 <= t <= t1}
            assert _in_flight(pipe) == 0
            assert spine_ring == 0 or pipe._spine.pending() == 0
        assert pipe.stats.pumps_caught_up == 4 and pipe.stats.reports_same_pump == 4
        assert pipe.stats.reports_skipped == 0
    finally:
        pipe.close()


def test_a_backlogged_pump_keeps_one_report_in_flight_and_the_overlap_take():
    """Rows left after every take: one report stays in flight, so step k
    runs while batch k+1 is put, and no pump reads a report it
    dispatched."""
    pipe, seen = _pump_pipe(spine_ring=2)
    rng = np.random.default_rng(4)
    for _ in range(6):
        pipe.submit_columns(make_columns(rng, 256))
    try:
        for k in range(4):
            pipe.pump(float(k))
            assert _in_flight(pipe) == 1
        assert len(seen) == pipe.stats.batches - 1
        assert pipe.stats.pumps_caught_up == 0 and pipe.stats.reports_same_pump == 0
        pipe.drain()
        assert [t for t, _ in seen] == sorted(t for t, _ in seen) and len(seen) == 6
        assert pipe.stats.reports_skipped == 0
    finally:
        pipe.close()


def test_from_backlogged_to_caught_up_no_report_is_skipped():
    """One report in flight when the last rows are taken: the caught-up
    pump dispatches its own batch beside it, pushing none out unread, and
    ends with every report read, its own among them."""
    pipe, seen = _pump_pipe(spine_ring=2)
    rng = np.random.default_rng(5)
    for _ in range(4):
        pipe.submit_columns(make_columns(rng, 256))
    try:
        for k in range(3):
            pipe.pump(float(k))
            assert _in_flight(pipe) == 1 and [t for t, _ in seen] == [float(i) for i in range(k)]
        pipe.pump(3.0)
        assert [t for t, _ in seen] == [0.0, 1.0, 2.0, 3.0]
        assert _in_flight(pipe) == 0 and pipe._spine.pending() == 0
        assert pipe.stats.reports_skipped == 0 and pipe.stats.batches == 4
        assert pipe.stats.pumps_caught_up == 1 and pipe.stats.reports_same_pump == 1
    finally:
        pipe.close()


_OFF = {"flags": {"anomalyDetectorEnabled": {
    "state": "ENABLED", "variants": {"on": True, "off": False}, "defaultVariant": "off",
}}}


@pytest.mark.parametrize("case", ["backlogged", "caught_up", "flag_off"])
def test_nothing_is_staged_after_a_pump(case):
    """Whatever a pump finds (a backlog, input it catches up with, or the
    detector switched off), it leaves no batch on the ring: every batch it
    put is dispatched, and at most one report rides to the next pump."""
    kw = dict(flags=FlagEvaluator(_OFF)) if case == "flag_off" else {}
    pipe, _ = _pump_pipe(spine_ring=2, **kw)
    rng = np.random.default_rng(8)
    rows = 256 if case == "backlogged" else 200
    try:
        for k in range(4):
            pipe.submit_columns(make_columns(rng, rows))
            if case == "backlogged":
                pipe.submit_columns(make_columns(rng, rows))
            pipe.pump(float(k))
            assert pipe._spine.pending() == 0 and pipe.spine_stats()["staged"] == 0
            assert pipe.spine_stats()["puts_total"] == pipe.stats.batches
            assert _in_flight(pipe) <= 1
        assert pipe.stats.batches == (0 if case == "flag_off" else 4)
        assert pipe.stats.dropped_disabled == (4 * rows if case == "flag_off" else 0)
    finally:
        pipe.close()


@pytest.mark.parametrize("depth", [1, 2])
def test_a_backlogged_pump_dispatches_the_batch_it_took(depth):
    """A backlog of six widths: each pump dispatches, in the same call,
    the batch it took (its timebase and its rows), not one put on an
    earlier pump."""
    pipe, _ = _pump_pipe(spine_ring=depth)
    dispatched: list[tuple[float, np.ndarray]] = []
    pipe.history_capture = lambda cols, t: dispatched.append((t, np.array(cols.trace_key)))
    rng = np.random.default_rng(9)
    sent = [make_columns(rng, 256) for _ in range(6)]
    for cols in sent:
        pipe.submit_columns(cols)
    try:
        for k in range(5):
            pipe.pump(float(k))
            assert pipe.pending_rows() == (5 - k) * 256
            assert len(dispatched) == pipe.stats.batches == k + 1
            t, keys = dispatched[-1]
            assert t == float(k) and np.array_equal(keys, sent[k].trace_key)
    finally:
        pipe.close()


def test_no_thread_is_started_for_the_spine():
    """The pump puts on its own thread: no thread starts while it pumps,
    after a failed pack, or stays after ``close``."""
    before = set(threading.enumerate())
    pipe, _ = _pump_pipe(spine_ring=2)
    rng = np.random.default_rng(10)
    pack = pipe._spine.tensorizer.pack_columns_into

    def failing_pack(*a, **kw):
        raise ValueError("pack failed")

    try:
        pipe._spine.tensorizer.pack_columns_into = failing_pack
        pipe.submit_columns(make_columns(rng, 256))
        with pytest.raises(ValueError, match="pack failed"):
            pipe.pump(0.0)
        pipe._spine.tensorizer.pack_columns_into = pack
        for k in range(3):
            pipe.submit_columns(make_columns(rng, 256))
            pipe.pump(float(k + 1))
        assert set(threading.enumerate()) <= before
    finally:
        pipe.close()
    assert set(threading.enumerate()) <= before
    assert not [t for t in threading.enumerate() if t.name == "spine-stager"]
    assert pipe.stats.batches == 3


@pytest.mark.parametrize(
    "kw", [dict(spine_ring=2, harvest_async=True), dict(spine_ring=0, harvest_interval_s=3600.0)]
)
def test_the_async_harvester_and_a_harvest_interval_keep_their_cadence(kw):
    """Caught-up input with the async harvester (it reads every report on
    its own thread) or a harvest interval no pump reaches (the pumps read
    none; of three, the oldest is skipped): no pump takes the caught-up
    branch, and the drain reads what is left."""
    pipe, seen = _pump_pipe(**kw)
    rng = np.random.default_rng(6)
    try:
        for k in range(3):
            pipe.submit_columns(make_columns(rng, 200))
            pipe.pump(float(k))
        if "harvest_interval_s" in kw:
            assert not seen and _in_flight(pipe) == 2
        pipe.drain()
        assert pipe.stats.pumps_caught_up == 0 and pipe.stats.reports_same_pump == 0
        if "harvest_async" in kw:
            assert pipe.stats.reports_skipped == 0 and len(seen) == 3
            assert {name for _, name in seen} == {"report-harvester"}
        else:
            assert pipe.stats.reports_skipped == 1 and [t for t, _ in seen] == [1.0, 2.0]
    finally:
        pipe.close()


def test_dispatch_against_state_readers_under_the_dispatch_lock():
    """The pump puts and dispatches every batch while three readers copy
    the state under the dispatch lock: no error, every put dispatched,
    every report finite."""
    det = AnomalyDetector(DetectorConfig(**SMALL), device="cpu")
    harvested = []
    pipe = DetectorPipeline(det, on_report=lambda t, r, f: harvested.append(r), batch_size=256, spine_ring=2)
    rng = np.random.default_rng(11)
    stop = threading.Event()
    failures: list[str] = []

    def reader():
        while not stop.is_set():
            try:
                with pipe._dispatch_lock:
                    copied = [t.clone() for t in det.state]
                assert int(copied[-1]) >= 0
            except Exception as e:  # noqa: BLE001 — collected
                failures.append(repr(e))
                return

    readers = [threading.Thread(target=reader, daemon=True) for _ in range(3)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: races show sooner
    for th in readers:
        th.start()
    t = 0.0
    try:
        for _ in range(60):
            pipe.submit_columns(make_columns(rng, 256))
            pipe.submit_columns(make_columns(rng, 256))
            pipe.pump(t)
            t += 0.05
    finally:
        sys.setswitchinterval(switch)
        stop.set()
        for th in readers:
            th.join(timeout=10.0)
        pipe.close()
    assert not any(th.is_alive() for th in readers)
    assert not failures, failures
    st = pipe.spine_stats()
    assert st["puts_total"] == pipe.stats.batches == 120
    for rep in harvested:
        assert np.isfinite(rep.lat_z).all()


def test_staged_args_equal_the_inline_args():
    """``AnomalyDetector.staged_args`` on a slot's lanes hands the step
    exactly what ``_args`` hands it for the same batch and clock."""
    tz = SpanTensorizer(num_services=8, batch_size=128)
    cols = make_columns(np.random.default_rng(6), 100)
    a = AnomalyDetector(DetectorConfig(**SMALL), device="cpu")
    b = AnomalyDetector(DetectorConfig(**SMALL), device="cpu")
    buf = torch.zeros(8 * 128, dtype=torch.int32)
    tz.pack_columns_into(slot_views(buf, 128), cols)
    for t in (0.0, 0.3, 1.7):
        want = a._args(tz.pack_columns(cols, width=128), t)
        got = b.staged_args(buf, t)
        for x, y in zip(want, got):
            assert x.dtype == y.dtype and torch.equal(x, y)


BASE = 64


def _backlog_case(case: str):
    """(pipeline knobs, rows of each chunk queued before the first pump,
    pumps before the drain, the widths dispatched, takes widened)."""
    return {
        # 3 × base pending: one take at 4 × base.
        "backlog": (dict(), [BASE] * 3, 1, [4 * BASE], 1),
        # One base width pending: the base width.
        "one_width": (dict(), [BASE], 1, [BASE], 0),
        # Adaptive batching off: one base width a pump.
        "adaptive_off": (dict(adaptive_batching=False), [BASE] * 3, 3, [BASE] * 3, 0),
        # 6 × base in one chunk over a 4 × top: the top, then the 2 × base
        # left, its tail requeued with its enqueue time.
        "over_the_top": (dict(max_batch_growth=4), [6 * BASE], 2, [4 * BASE, 2 * BASE], 2),
    }[case]


@pytest.mark.parametrize("spine_ring", [0, 2])
@pytest.mark.parametrize("case", ["backlog", "one_width", "adaptive_off", "over_the_top"])
def test_a_backlogged_take_is_as_wide_as_its_backlog(case, spine_ring):
    """Each take's width follows the rows pending at it; ``batch_width``
    read inside ``history_capture`` is the dispatched batch's; the
    controller's width is untouched, so a sub-width batch after a
    widened take is not held; every row goes once, in order; and after
    the drain the sketches and step count equal the reference detector
    stepped over the same batches at the same widths."""
    knobs, chunks, pumps, widths, widened = _backlog_case(case)
    knobs = dict(dict(adaptive_batching=True, max_batch_growth=8), **knobs)
    pipe = DetectorPipeline(
        AnomalyDetector(DetectorConfig(**SMALL), device="cpu"),
        batch_size=BASE, spine_ring=spine_ring, **knobs,
    )
    seen: list[tuple[int, float, SpanColumns]] = []
    pipe.history_capture = lambda cols, t: seen.append(
        (pipe.batch_width, t, SpanColumns(*(np.array(c) for c in cols)))
    )
    rng = np.random.default_rng(12)
    sent = [make_columns(rng, n) for n in chunks]
    try:
        for cols in sent:
            pipe.submit_columns(cols)
        with pipe._pending_lock:
            t_enq = pipe._pending[-1][1]
        for k in range(pumps):
            pipe.pump(0.1 * k)
            if case == "over_the_top" and k == 0:
                with pipe._pending_lock:
                    assert pipe._pending_rows == 2 * BASE and pipe._pending[0][1] == t_enq
        assert [w for w, _, _ in seen] == widths
        assert [c.rows for _, _, c in seen] == [min(w, sum(chunks)) for w in widths]
        assert pipe.stats.pumps_widened == widened and pipe.pending_rows() == 0
        assert pipe._width == BASE and pipe.batch_width == BASE
        # No hold: the controller never left the base width.
        late = make_columns(rng, BASE // 2)
        sent.append(late)
        pipe.submit_columns(late)
        pipe.pump(0.1 * pumps)
        assert len(seen) == len(widths) + 1 and seen[-1][0] == BASE
        pipe.drain()
    finally:
        pipe.close()
    got = np.concatenate([c.trace_key for _, _, c in seen])
    assert np.array_equal(got, np.concatenate([c.trace_key for c in sent]))

    ref = JAnomalyDetector(JDetectorConfig(**SMALL))
    tz = jtz.SpanTensorizer(num_services=SMALL["num_services"], batch_size=BASE)
    for width, t, cols in seen:
        ref.observe_packed(tz.pack_columns(jtz.SpanColumns(*cols), width=width), t)
    state = pipe.detector.state
    for name in ("hll_bank", "cms_bank", "span_total", "obs_batches", "step_idx"):
        assert np.array_equal(getattr(state, name).cpu().numpy(), np.asarray(getattr(ref.state, name))), name
    assert int(state.step_idx) == len(seen) == pipe.stats.batches


# -- on the card ---------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_spine_on_equals_spine_off_on_the_card(cuda_device, depth):
    chunks = _stream(seed=12)
    _assert_same_run(_run(cuda_device, chunks), _run(cuda_device, chunks, spine_ring=depth))


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2])
def test_spine_waits_for_the_step_that_reads_a_slot(cuda_device, depth):
    """~20 ms of spin ahead of every step, and the async harvester, so the
    pump runs ahead of the card: the copy for batch k + depth is issued
    while step k still waits to read the slot. The side stream's wait on
    the step's event is all that keeps those lanes intact; the state must
    equal the spine-off run's bit for bit."""
    chunks = _stream(seed=14, n_batches=24)
    d0, p0, _ = _run(cuda_device, chunks)
    d1, p1, reports = _run(cuda_device, chunks, spine_ring=depth, harvest_async=True, spin_cycles=40_000_000)
    assert p1.spine_stats()["step_waits"] > 0  # the guard was exercised
    assert p1.stats.batches == p0.stats.batches and p1.stats.harvest_errors == 0
    assert len(reports) + p1.stats.reports_skipped == p1.stats.batches
    for name, a, b in zip(d0.state._fields, d0.state, d1.state):
        assert torch.equal(a.cpu(), b.cpu()), name


def _queue_then_drain(device, chunks, **kw):
    det = AnomalyDetector(DetectorConfig(**SMALL), device=device)
    reports = []
    pipe = DetectorPipeline(det, on_report=lambda t, r, f: reports.append((r, f)), batch_size=256, **kw)
    for cols in chunks:
        pipe.submit_columns(cols)
    pipe.pump(0.0)
    pipe.drain()
    alive = pipe.harvester_alive()
    pipe.close()
    return det, pipe, reports, alive


def _assert_drained_alike(ref, got):
    (d0, p0, r0, _), (d1, p1, r1, alive) = ref, got
    assert alive and p1.stats.harvest_errors == 0
    assert p1.stats.batches == p0.stats.batches and len(r0) == p0.stats.batches
    assert len(r1) + p1.stats.reports_skipped == p1.stats.batches
    for name, a, b in zip(d0.state._fields, d0.state, d1.state):
        assert torch.equal(a.cpu(), b.cpu()), name
    # The newest report is never superseded: it is the last one read.
    for name, x, y in zip(r0[-1][0]._fields, r0[-1][0], r1[-1][0]):
        assert np.array_equal(x, y), name


def test_async_harvester_reads_the_reports_under_drain():
    """All batches queued, then one drain: the spine dispatches them and
    the harvester reads every report not superseded in flight; the state
    equals the inline synchronous run's."""
    chunks = _stream(seed=13, n_batches=24)
    _assert_drained_alike(_queue_then_drain("cpu", chunks),
                          _queue_then_drain("cpu", chunks, spine_ring=2, harvest_async=True))


@pytest.mark.gpu
def test_async_harvester_on_the_card_reads_the_reports_under_drain(cuda_device):
    chunks = _stream(seed=13, n_batches=24)
    _assert_drained_alike(_queue_then_drain(cuda_device, chunks),
                          _queue_then_drain(cuda_device, chunks, spine_ring=2, harvest_async=True))
