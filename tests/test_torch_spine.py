"""The port's device-put spine: ring slots, the two guards, lifecycle.

- ``pack_columns_into`` (into a plain batch or a spine slot's int32
  views) equals ``pack_columns`` and the reference's, chunked or not.
- Spine on, at ring depths 1, 2 and 3, against spine off: the detector
  state bit-identical and every report read equal to the inline run's
  (a missing guard would let a copy overwrite lanes a step still reads,
  or a pack overwrite bytes a copy still reads).
- The ring: slots allocated once per width and reused, a slot waits for
  its last batch's release, ``take`` never hangs after ``close``,
  ``discard_pending`` and ``stats``.
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
from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
from opentelemetry_demo_tpu_torch.runtime.spine import DevicePutSpine, SpineError, slot_views
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


def test_ring_slots_are_allocated_once_and_reused():
    tz = SpanTensorizer(num_services=8, batch_size=128)
    spine = DevicePutSpine(tz, "cpu", depth=2)
    rng = np.random.default_rng(5)
    try:
        for i in range(8):
            spine.stage(make_columns(rng, 128), 128, float(i), float(i))
            staged = spine.take(wait=True)
            assert staged is not None and staged.lanes is not None
            assert staged.lanes.shape == (8 * 128,) and staged.slot == i % 2
            spine.release(staged)
        hosts = set()
        for slot in spine._slots:
            assert list(slot.host) == [128] and list(slot.dev) == [128]
            hosts.add(slot.host[128][0].data_ptr())
        assert len(hosts) == 2
        st = spine.stats()
        assert st["puts_total"] == 8 and st["ring_depth"] == 2 and st["staged"] == 0
        assert st["overlap_hits"] + st["overlap_misses"] == 8
    finally:
        spine.close()


def test_a_slot_waits_for_its_last_batch_to_be_released():
    """Guard 2 on the CPU: the stager does not repack or overwrite a slot
    until the batch that holds it is released, so a non-waiting take
    finds nothing and a release lets the next batch through."""
    tz = SpanTensorizer(num_services=8, batch_size=64)
    spine = DevicePutSpine(tz, "cpu", depth=1)
    rng = np.random.default_rng(1)
    try:
        a, b = make_columns(rng, 64), make_columns(rng, 64)
        spine.stage(a, 64, 0.0, 0.0)
        first = spine.take(wait=True)
        lanes_a = first.lanes.clone()
        spine.stage(b, 64, 0.1, 0.1)
        time.sleep(0.1)
        assert spine.take(wait=False) is None  # the slot is still held
        assert torch.equal(first.lanes, lanes_a)  # and its lanes untouched
        spine.release(first)
        second = spine.take(wait=True)
        assert second is not None and second.slot == 0 and second.lanes is first.lanes
        want = tz.pack_columns(b, width=64)
        assert np.array_equal(slot_views(second.lanes, 64).trace_lo, want.trace_lo)
        spine.release(second)
    finally:
        spine.close()


def test_take_does_not_hang_after_close():
    tz = SpanTensorizer(num_services=8, batch_size=64)
    spine = DevicePutSpine(tz, "cpu", depth=1)
    rng = np.random.default_rng(2)
    spine.stage(make_columns(rng, 64), 64, 0.0, 0.0)
    held = spine.take(wait=True)
    spine.stage(make_columns(rng, 64), 64, 0.1, 0.1)  # waits for the held slot
    spine.close()
    t0 = time.monotonic()
    with pytest.raises(SpineError, match="closed"):
        spine.take(wait=True, timeout=10.0)
    assert time.monotonic() - t0 < 5.0
    assert spine.take(wait=True) is None
    with pytest.raises(SpineError, match="closed"):
        spine.stage(make_columns(rng, 64), 64, 0.2, 0.2)
    assert not spine.alive()
    spine.release(held)


def test_discard_pending_drops_staged_rows_and_frees_their_slots():
    tz = SpanTensorizer(num_services=8, batch_size=64)
    spine = DevicePutSpine(tz, "cpu", depth=2)
    rng = np.random.default_rng(3)
    try:
        spine.stage(make_columns(rng, 64), 64, 0.0, 0.0)
        spine.stage(make_columns(rng, 40), 64, 0.1, 0.1)
        spine.stage(make_columns(rng, 30), 64, 0.2, 0.2)
        assert spine.pending() == 3
        assert spine.discard_pending() == 134
        assert spine.pending() == 0 and spine.take(wait=False) is None
        # The ring still works after the discard.
        spine.stage(make_columns(rng, 64), 64, 0.3, 0.3)
        staged = spine.take(wait=True)
        assert staged is not None and staged.t_now == 0.3
        spine.release(staged)
    finally:
        spine.close()


def test_a_batch_discarded_while_it_waits_for_its_slot_frees_nothing_it_never_took():
    tz = SpanTensorizer(num_services=8, batch_size=64)
    spine = DevicePutSpine(tz, "cpu", depth=1)
    rng = np.random.default_rng(5)
    try:
        spine.stage(make_columns(rng, 64), 64, 0.0, 0.0)
        held = spine.take(wait=True)
        spine.stage(make_columns(rng, 64), 64, 0.1, 0.1)  # waits for the held slot
        time.sleep(0.1)
        assert spine.discard_pending() == 64
        spine.release(held)
        spine.stage(make_columns(rng, 64), 64, 0.2, 0.2)
        staged = spine.take(wait=True, timeout=10.0)
        assert staged.t_now == 0.2 and staged.slot == 0
        spine.release(staged)
    finally:
        spine.close()


def test_a_failed_stage_raises_to_the_taker():
    tz = SpanTensorizer(num_services=8, batch_size=64)
    spine = DevicePutSpine(tz, "cpu", depth=1)
    rng = np.random.default_rng(4)
    try:
        spine.stage(make_columns(rng, 65), 64, 0.0, 0.0)  # one row too many
        with pytest.raises(SpineError, match="exceeds batch width"):
            spine.take(wait=True)
        spine.stage(make_columns(rng, 64), 64, 0.1, 0.1)  # the slot was freed
        staged = spine.take(wait=True)
        spine.release(staged)
    finally:
        spine.close()


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


def test_drain_flushes_staged_batches():
    det = AnomalyDetector(DetectorConfig(**SMALL), device="cpu")
    pipe = DetectorPipeline(det, batch_size=128, spine_ring=3)
    rng = np.random.default_rng(2)
    for _ in range(5):
        pipe.submit_columns(make_columns(rng, 128))
    pipe.drain()
    assert pipe.pending_rows() == 0 and pipe._spine.pending() == 0
    assert pipe.stats.batches == 5 and pipe.stats.spans == 5 * 128
    assert pipe.spine_stats()["puts_total"] == 5
    pipe.close()


def test_dispatch_against_state_readers_under_the_dispatch_lock():
    """The stager packs batch k+1 while the pump dispatches k and three
    readers copy the state under the dispatch lock: no error, every put
    dispatched, every report finite."""
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
