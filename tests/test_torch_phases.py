"""The port's phase timeline: every ``phase_observe`` call is made on the
thread that ran the phase, when it ends, so a recorder that stamps
``time.perf_counter()`` at each call places every phase in time
(``runtime/selftrace.py``'s contract).

The pump's work phases nest inside its ``pump`` phase, the spine's
``stage`` among them; the four waits
(``queue_wait``, ``pending_wait``, ``spine_wait``, ``inflight``) each
cover a hold the test makes, and ``report`` times ``on_report``. The
port alone: these phases have no counterpart in the reference package.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest

from opentelemetry_demo_tpu_torch.models import detector as tdet
from opentelemetry_demo_tpu_torch.runtime import native, selftrace, tensorize
from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

SMALL = dict(num_services=8, cms_width=512, hll_p=8)
HOLD_S = 0.05
# The pump's phases that run inside one ``pump`` call when the harvest is
# synchronous.
PUMP_CHILDREN = (
    selftrace.PHASE_DISPATCH, selftrace.PHASE_PUT_WAIT, selftrace.PHASE_HARVEST,
    selftrace.PHASE_FLAG, selftrace.PHASE_REPORT,
)


class Recorder:
    """``phase_observe`` as the contract reads it: (phase, end, seconds,
    thread name) with the end stamped at the call."""

    def __init__(self):
        self.events: list[tuple[str, float, float, str]] = []
        self._lock = threading.Lock()

    def __call__(self, phase: str, seconds: float) -> None:
        t = time.perf_counter()
        with self._lock:
            self.events.append((phase, t, seconds, threading.current_thread().name))

    def of(self, phase: str) -> list[tuple[str, float, float, str]]:
        return [e for e in self.events if e[0] == phase]


def _cols(rng, n, services=4, slow=False):
    lat = rng.gamma(4.0, 250.0, n).astype(np.float32)
    svc = rng.integers(0, services, n).astype(np.int32)
    if slow:
        lat[svc == 3] *= 10_000.0
    return tensorize.SpanColumns(
        svc=svc, lat_us=lat,
        is_error=(rng.random(n) < 0.02).astype(np.float32),
        trace_key=rng.integers(0, 2**63, n, dtype=np.uint64),
        attr_crc=rng.integers(0, 2**32, n, dtype=np.uint64),
    )


def _pipe(rec, **kw):
    kw.setdefault("batch_size", 64)
    cfg = tdet.DetectorConfig(**SMALL, warmup_batches=2.0, z_warmup_batches=3.0)
    pipe = DetectorPipeline(tdet.AnomalyDetector(cfg, device="cpu"), phase_observe=rec, **kw)
    for name in ("frontend", "cart", "checkout", "ad"):
        pipe.tensorizer.service_id(name)
    return pipe


def test_every_pump_phase_lies_inside_a_pump():
    """A flagging run on the spine with a synchronous harvest: each
    dispatch, put_wait, harvest, flag and report interval lies inside one
    ``pump`` interval."""
    rec = Recorder()
    pipe = _pipe(rec, spine_ring=2, on_report=lambda *a: None)
    rng = np.random.default_rng(11)
    # A thread switch between a phase's last clock read and the
    # recorder's would shift the recorded start of the enclosing pump.
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1.0)
    try:
        for i in range(24):
            pipe.submit_columns(_cols(rng, 64, slow=i >= 12))
            pipe.submit_columns(_cols(rng, 32))
            pipe.pump(i * 0.25)
            pipe.pump(i * 0.25 + 0.1)
        # drain() harvests the last reports outside any pump.
        n_pumped = len(rec.events)
        pipe.drain()
    finally:
        sys.setswitchinterval(switch)
        pipe.close()
    pumps = [(t - dt, t) for _p, t, dt, _th in rec.of(selftrace.PHASE_PUMP)]
    children = [e for e in rec.events[:n_pumped] if e[0] in PUMP_CHILDREN]
    assert {e[0] for e in children} == set(PUMP_CHILDREN)
    tol = 1e-6
    for phase, t, dt, _th in children:
        assert any(a - tol <= t - dt and t <= b + tol for a, b in pumps), (phase, t - dt, t)


def test_a_pump_that_returns_early_is_observed():
    """The flag off drops the queue and returns at once: the call is still
    one ``pump`` phase."""
    from opentelemetry_demo_tpu_torch.utils.flags import FlagEvaluator

    rec = Recorder()
    flags = FlagEvaluator({"flags": {"anomalyDetectorEnabled": {
        "state": "ENABLED", "variants": {"on": True, "off": False}, "defaultVariant": "off",
    }}})
    pipe = _pipe(rec, flags=flags)
    pipe.submit_columns(_cols(np.random.default_rng(1), 64))
    pipe.pump(0.0)
    pipe.pump(0.1)
    assert pipe.stats.dropped_disabled == 64
    assert [e[0] for e in rec.events] == [selftrace.PHASE_PUMP, selftrace.PHASE_PUMP]


def test_stage_is_observed_on_the_stager_thread():
    """The pump packs and puts each batch itself: every ``stage`` is
    observed on the pump's thread, inside a ``pump`` call."""
    rec = Recorder()
    pipe = _pipe(rec, spine_ring=2)
    rng = np.random.default_rng(3)
    try:
        for i in range(6):
            pipe.submit_columns(_cols(rng, 64))
            pipe.pump(i * 0.25)
        pipe.drain()
    finally:
        pipe.close()
    stages = rec.of(selftrace.PHASE_STAGE)
    assert len(stages) == pipe.spine_stats()["puts_total"] == 6
    assert {e[3] for e in rec.events} == {threading.current_thread().name}
    pumps = [(t - dt, t) for _p, t, dt, _th in rec.of(selftrace.PHASE_PUMP)]
    for _p, t, dt, _th in stages:
        assert any(a <= t - dt and t <= b for a, b in pumps)


def test_harvest_is_observed_before_the_provenance_ring():
    """``harvest`` ends with the fetch and unpack: it is observed before
    ``provenance.observe_report`` runs."""
    rec = Recorder()

    class Provenance:
        def observe_report(self, t, report):
            rec("provenance", 0.0)

    pipe = _pipe(rec)
    pipe._provenance = Provenance()
    pipe.submit_columns(_cols(np.random.default_rng(2), 64))
    pipe.pump(0.0)
    order = [e[0] for e in rec.events if e[0] in ("provenance", selftrace.PHASE_HARVEST)]
    assert order == [selftrace.PHASE_HARVEST, "provenance"]


def test_pending_wait_covers_the_hold_before_the_pump():
    rec = Recorder()
    pipe = _pipe(rec)
    pipe.submit_columns(_cols(np.random.default_rng(4), 64))
    time.sleep(HOLD_S)
    pipe.pump(0.0)
    waits = rec.of(selftrace.PHASE_PENDING_WAIT)
    assert len(waits) == 1 and waits[0][2] >= HOLD_S
    # An idle pump forms no batch and observes no wait.
    pipe.pump(0.1)
    assert len(rec.of(selftrace.PHASE_PENDING_WAIT)) == 1


def test_spine_wait_covers_a_slow_stage():
    """A pack that takes ``HOLD_S``: the batch waits at least that long
    from its put's start to its dispatch (``spine_wait``), which holds
    the pack and copy issue (``stage``) and any wait on a copy
    (``put_wait``)."""
    rec = Recorder()
    pipe = _pipe(rec, spine_ring=2)
    pack = pipe._spine.tensorizer.pack_columns_into

    def slow_pack(*a, **kw):
        time.sleep(HOLD_S)
        return pack(*a, **kw)

    pipe._spine.tensorizer.pack_columns_into = slow_pack
    try:
        pipe.submit_columns(_cols(np.random.default_rng(5), 64))
        pipe.pump(0.0)
    finally:
        pipe.close()
    (spine,) = rec.of(selftrace.PHASE_SPINE_WAIT)
    (put,) = rec.of(selftrace.PHASE_PUT_WAIT)
    (stage,) = rec.of(selftrace.PHASE_STAGE)
    assert spine[2] >= stage[2] >= HOLD_S and put[2] + stage[2] <= spine[2]
    assert spine[3] == put[3] == stage[3] == threading.current_thread().name


def test_inflight_covers_the_hold_before_the_harvest():
    """A report no pump reads (a harvest interval no pump reaches) stays in
    flight until the drain; a skipped report emits no ``inflight``."""
    rec = Recorder()
    pipe = _pipe(rec, harvest_interval_s=3600.0)
    rng = np.random.default_rng(6)
    for i in range(3):
        pipe.submit_columns(_cols(rng, 64))
        pipe.pump(i * 0.25)
    time.sleep(HOLD_S)
    pipe.drain()
    waits = rec.of(selftrace.PHASE_INFLIGHT)
    assert pipe.stats.reports_skipped == 1
    assert len(waits) == 2 and all(w[2] >= HOLD_S for w in waits)


def test_report_times_the_callback():
    rec = Recorder()
    pipe = _pipe(rec, on_report=lambda *a: time.sleep(HOLD_S))
    pipe.submit_columns(_cols(np.random.default_rng(7), 64))
    pipe.pump(0.0)
    (report,) = rec.of(selftrace.PHASE_REPORT)
    assert report[2] >= HOLD_S
    # Without a callback there is nothing to time.
    rec2 = Recorder()
    pipe2 = _pipe(rec2)
    pipe2.submit_columns(_cols(np.random.default_rng(7), 64))
    pipe2.pump(0.0)
    assert not rec2.of(selftrace.PHASE_REPORT)


def test_queue_wait_once_per_request():
    """One worker whose sink is held: each request queued behind the held
    flush waits at least the hold; every request is observed once, on a
    pool worker, and the pool's ``phase_s`` holds no wait."""
    if not native.available():
        pytest.skip(f"native ingest unavailable: {native.load_error()}")
    from opentelemetry_demo_tpu_torch.runtime import ingest_pool, otlp_export

    rec = Recorder()
    release = threading.Event()
    got: list[int] = []

    def sink(cols):
        release.wait(10.0)
        got.append(cols.rows)

    pool = ingest_pool.IngestPool(sink, tensorize.SpanTensorizer(8), workers=1, coalesce_max=1,
                                  phase_observe=rec)
    body = otlp_export.encode_export_request(
        [tensorize.SpanRecord("cart", 100.0 + i, bytes([i]) * 16) for i in range(8)], t_ns=10**18
    )
    try:
        tickets = [pool.submit(body) for _ in range(3)]
        records = [tensorize.SpanRecord("ad", 5.0, bytes([9]) * 16)]
        tickets.append(pool.submit_records(records))
        time.sleep(HOLD_S)
        release.set()
        for t in tickets:
            t.result(10.0)
        assert pool.drain(10.0)
    finally:
        release.set()
        pool.close()
    assert got == [8, 8, 8, 1]
    waits = rec.of(selftrace.PHASE_QUEUE_WAIT)
    assert len(waits) == 4
    assert {w[3] for w in waits} == {"ingest-pool-0"}
    # The first request went straight to the idle worker; the rest queued
    # behind its held flush.
    assert all(w[2] >= HOLD_S for w in waits[1:])
    assert selftrace.PHASE_QUEUE_WAIT not in pool.stats()["phase_s"]
