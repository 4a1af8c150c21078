"""The port's pipeline against the reference's under overload.

The same scripted submits and pumps go through the reference pipeline
(JAX, CPU) and the port's (``device="cpu"``) with one virtual clock
patched into the ``time`` attribute of both pipeline modules: shed rows
per lane (the error lane always 0), saturation events, brownout levels,
``admission_retry_after``, tenant-quota sheds, the adaptive width over
one outcome sequence, the in-flight bound's skips and ``query_meta``
after a flagged run must be equal. The one departure: once the port's
pumps are stamped, a saturated queue's Retry-After is its own drain time,
at most the reference's constant; its rule and a closed loop on the wall
clock are tested here too. Then the pipeline-level overload cases of
``tests/test_overload.py`` on the port, the harvester's supervision
hooks, ``warm_widths`` and the two benches at a small size.
"""

from __future__ import annotations

import threading
import time
import types
from collections import deque

import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import AnomalyDetector as JAnomalyDetector
from opentelemetry_demo_tpu.models import DetectorConfig as JDetectorConfig
from opentelemetry_demo_tpu.runtime import lagbench as jlagbench
from opentelemetry_demo_tpu.runtime import overloadbench as joverloadbench
from opentelemetry_demo_tpu.runtime import pipeline as jpipe
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
from opentelemetry_demo_tpu_torch.runtime import lagbench, overloadbench, pipeline
from opentelemetry_demo_tpu_torch.runtime.pipeline import SHED_LANES, DetectorPipeline
from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanColumns

SMALL = dict(num_services=8, hll_p=8, cms_width=512)
PIPE = dict(batch_size=64, queue_max_rows=512, high_watermark=0.85, low_watermark=0.5,
            brownout_hold_s=0.05, retry_after_s=0.7)


def make_cols(n, err_frac=0.0, seed=0, n_svc=8):
    rng = np.random.default_rng(seed)
    return SpanColumns(
        svc=rng.integers(0, n_svc, n).astype(np.int32),
        lat_us=rng.gamma(4.0, 250.0, n).astype(np.float32),
        is_error=(rng.random(n) < err_frac).astype(np.float32) if err_frac else np.zeros(n, np.float32),
        trace_key=rng.integers(0, 2**63, n, dtype=np.uint64),
        attr_crc=rng.integers(0, 2**32, n, dtype=np.uint64),
    )


def make_pipe(**kw):
    args = dict(PIPE)
    args.update(kw)
    return DetectorPipeline(AnomalyDetector(DetectorConfig(**SMALL), device="cpu"), **args)


def make_ref(cfg=None, **kw):
    args = dict(PIPE)
    args.update(kw)
    return jpipe.DetectorPipeline(JAnomalyDetector(cfg or JDetectorConfig(**SMALL)), **args)


@pytest.fixture
def clock(monkeypatch):
    """One virtual clock for both pipeline modules: ``monotonic`` and
    ``time`` read it; tests advance it by hand."""
    state = {"t": 1000.0}
    virtual = types.SimpleNamespace(
        monotonic=lambda: state["t"], time=lambda: 1.7e9 + state["t"],
        perf_counter=time.perf_counter, sleep=time.sleep,
    )
    for mod in (jpipe, pipeline):
        monkeypatch.setattr(mod, "time", virtual)
    return state


def _pending_error_rows(pipe) -> int:
    with pipe._pending_lock:
        return sum(int((c.is_error > 0).sum()) for c, _ in pipe._pending)


def _admission(p, hint: bool = True) -> tuple:
    with p._pending_lock:
        keys = [c.trace_key.tolist() for c, _ in p._pending]
    return (
        p.pending_rows(), p.saturated, p.brownout_level, dict(p.stats.shed_rows),
        p.stats.brownout_rows, p.stats.saturation_events,
        p.admission_retry_after() if hint else None,
        p.stats.batches, p.stats.spans, keys,
    )


def _period(pump_starts, now: float) -> float:
    """The pump's period from the test's own record of the pump calls'
    starts: the mean of the last eight intervals, or the time since the
    last start if longer."""
    last = pump_starts[-9:]
    return max((last[-1] - last[0]) / (len(last) - 1), now - last[-1])


def _drain_rule(pending: int, low: int, take: int, pump_starts: list, now: float, cap: float) -> float:
    """The saturated queue's Retry-After: the pumps to the low watermark
    (at least one) times the period, at most ``cap``; ``cap`` before two
    pumps."""
    if len(pump_starts) < 2:
        return cap
    return min(max(-(-(pending - low) // take), 1) * _period(pump_starts, now), cap)


def _hint_follows(port, ref, pump_starts: list, now: float) -> None:
    """The port's hint is None exactly when the reference's is; else it
    is the rule over the port's own queue and pump starts, and never
    above the reference's (the cap)."""
    got, want = port.admission_retry_after(), ref.admission_retry_after()
    assert (got is None) == (want is None)
    if got is None:
        return
    pending = port.pending_rows()
    take = port._take_width(port._controller_width(), pending)
    assert got == pytest.approx(_drain_rule(pending, port._low_rows, take, pump_starts, now, want), abs=1e-12)
    assert got <= want


def _as_ref(cols: SpanColumns):
    return jtz.SpanColumns(*cols)


# -- parity with the reference under one clock -----------------------------


def test_admission_and_brownout_follow_the_reference(clock):
    """A flood, a sustained stretch, then recovery: after every submit
    and pump both pipelines hold the same queue (row for row), the same
    saturation and brownout state and the same counters. The saturated
    Retry-After differs on purpose once the port's pumps are stamped: it
    is the port's drain time, capped at the reference's constant."""
    port, ref = make_pipe(), make_ref()
    seen, pump_starts = [], []
    try:
        for i in range(90):
            clock["t"] += 0.02
            if i < 50:
                cols = make_cols(40 + 17 * (i % 5), err_frac=0.1, seed=i)
                port.submit_columns(cols)
                ref.submit_columns(_as_ref(cols))
                assert _admission(port, hint=False) == _admission(ref, hint=False), i
                _hint_follows(port, ref, pump_starts, clock["t"])
            if i % 2 or i >= 50:
                pump_starts.append(clock["t"])
                port.pump(clock["t"])
                ref.pump(clock["t"])
                assert _admission(port, hint=False) == _admission(ref, hint=False), i
                _hint_follows(port, ref, pump_starts, clock["t"])
            seen.append(port.brownout_level)
        assert max(seen) >= 2 and seen[-1] == 0
        # The rule engaged: some saturated answers came in below the cap.
        assert port.stats.retry_hints_derived > 0
        assert port.stats.shed_rows["ok"] > 0 and port.stats.shed_rows["error"] == 0
        assert port.stats.saturation_events == ref.stats.saturation_events >= 1
    finally:
        port.close()
        ref.close()


def test_tenant_quota_follows_the_reference(clock):
    tenant_of = {f"svc-{i}": ("noisy" if i < 6 else "quiet") for i in range(8)}.get
    port = make_pipe(queue_max_rows=0, tenant_of=tenant_of, tenant_quota_rows_s=300.0)
    ref = make_ref(queue_max_rows=0, tenant_of=tenant_of, tenant_quota_rows_s=300.0)
    for p in (port, ref):
        for i in range(8):
            p.tensorizer.service_id(f"svc-{i}")
    try:
        for i in range(30):
            clock["t"] += 0.1
            cols = make_cols(120, err_frac=0.2, seed=100 + i)
            port.submit_columns(cols)
            ref.submit_columns(_as_ref(cols))
            assert port.stats.shed_rows_tenant == ref.stats.shed_rows_tenant, i
            assert _admission(port) == _admission(ref), i
        assert port.stats.shed_rows_tenant.get("noisy", 0) > 0
        assert "quiet" not in port.stats.shed_rows_tenant
    finally:
        port.close()
        ref.close()


def test_retry_after_at_the_keyspace_shed_rung_follows_the_reference(clock):
    port, ref = make_pipe(keyspace_retry_after_s=2.5), make_ref(keyspace_retry_after_s=2.5)
    try:
        levels = []
        for i in range(40):
            clock["t"] += 1.0
            fill = 0.9 if i < 25 else 0.5
            a = port.keyspace_update(fill, now=clock["t"])
            b = ref.keyspace_update(fill, now=clock["t"])
            assert a == b and port.admission_retry_after() == ref.admission_retry_after(), i
            levels.append(a)
        assert 4 in levels and levels[-1] < 4
        assert port.admission_retry_after() is None
    finally:
        port.close()
        ref.close()


def test_adaptive_width_follows_the_reference(clock):
    """One outcome sequence (skip bursts, clean stretches, a quick
    re-skip after a decay) through both width controllers."""
    port = make_pipe(queue_max_rows=0, adaptive_batching=True, max_batch_growth=6)
    ref = make_ref(queue_max_rows=0, adaptive_batching=True, max_batch_growth=6)
    rng = np.random.default_rng(4)
    outcomes = (
        [True, True, True, False] * 3 + [False] * 40 + [True, False, True, True] * 2
        + [False] * 30 + list(rng.random(80) < 0.3) + [False] * 120
    )
    widths = []
    try:
        for i, skipped in enumerate(outcomes):
            clock["t"] += 0.4 if i % 7 else 3.0
            port._note_outcome(skipped=bool(skipped))
            ref._note_outcome(skipped=bool(skipped))
            assert port.batch_width == ref.batch_width, i
            widths.append(port.batch_width)
        assert max(widths) == 64 * 8 and min(widths) == 64 and widths[-1] == 64
    finally:
        port.close()
        ref.close()


def test_reports_skipped_at_a_harvest_interval_follow_the_reference(clock):
    """With a long harvest interval at most two reports are in flight and
    older ones are dropped unread: the same count both ways."""
    port = make_pipe(queue_max_rows=0, harvest_interval_s=5.0)
    ref = make_ref(queue_max_rows=0, harvest_interval_s=5.0)
    got = {"port": 0, "ref": 0}
    port.on_report = lambda *a: got.__setitem__("port", got["port"] + 1)
    ref.on_report = lambda *a: got.__setitem__("ref", got["ref"] + 1)
    try:
        for i in range(30):
            clock["t"] += 0.5
            cols = make_cols(64, seed=200 + i)
            port.submit_columns(cols)
            ref.submit_columns(_as_ref(cols))
            port.pump(clock["t"])
            ref.pump(clock["t"])
            assert port.stats.reports_skipped == ref.stats.reports_skipped, i
        port.drain()
        ref.drain()
        assert got["port"] == got["ref"]
        assert port.stats.reports_skipped > 0
        assert got["port"] + port.stats.reports_skipped == port.stats.batches == 30
    finally:
        port.close()
        ref.close()


FLAG_CFG = dict(num_services=8, hll_p=8, cms_width=512, warmup_batches=5.0, z_warmup_batches=20.0)


def _flagged_run(pipe, as_cols):
    """30 clean batches, then six with service 3 ten times slower."""
    rng = np.random.default_rng(21)
    for k in range(36):
        n = 64
        svc = rng.integers(0, 6, n).astype(np.int32)
        lat = rng.gamma(8.0, 25.0 * (1 + svc)).astype(np.float32)
        if k >= 30:
            lat = np.where(svc == 3, lat * 10.0, lat).astype(np.float32)
        cols = SpanColumns(svc, lat, (rng.random(n) < 0.02).astype(np.float32),
                           rng.integers(0, 2**63, n, dtype=np.uint64),
                           (rng.zipf(1.5, n) % 40).astype(np.uint64))
        pipe.submit_columns(as_cols(cols))
        pipe.pump(k * 0.25)
    pipe.drain()


def test_query_meta_after_a_flagged_run_follows_the_reference(clock):
    port = DetectorPipeline(AnomalyDetector(DetectorConfig(**FLAG_CFG), device="cpu"), batch_size=64,
                            exemplar_ring=4, hh_candidates=16)
    ref = jpipe.DetectorPipeline(JAnomalyDetector(JDetectorConfig(**FLAG_CFG)), batch_size=64,
                                 exemplar_ring=4, hh_candidates=16)
    for i in range(6):
        port.tensorizer.service_id(f"svc-{i}")
        ref.tensorizer.service_id(f"svc-{i}")
    _flagged_run(port, lambda c: c)
    _flagged_run(ref, _as_ref)
    got, want = port.query_meta(), ref.query_meta()
    # No provenance engine on either side: no bundles in either block.
    assert got["explains"] == [] and got["explanations_built"] == 0
    assert got == want
    assert got["anomalies"] and got["exemplars"] and got["exemplars_captured"] > 0
    assert any(ev["service"] == 3 and "latency" in ev["signals"] for ev in got["anomalies"])
    # Restored into fresh pipelines of either package, the block reads back.
    fresh = make_pipe(exemplar_ring=4, hh_candidates=16)
    fresh.restore_query_meta(got)
    back = fresh.query_meta()
    assert back["exemplars_captured"] == 0
    assert {k: v for k, v in back.items() if k != "exemplars_captured"} == {
        k: v for k, v in got.items() if k != "exemplars_captured"}
    jfresh = make_ref(exemplar_ring=4, hh_candidates=16)
    jfresh.restore_query_meta(got)
    jback = jfresh.query_meta()
    assert jback == back
    for p in (port, ref, fresh, jfresh):
        p.close()


# -- the saturated queue's Retry-After: its own drain time -----------------

# A 2,048-row queue (high watermark 1,740 rows, low 1,024), pumped empty
# at ``starts`` (seconds), then flooded with ``rows``; the question comes
# ``since`` seconds after the last pump's start. ``take`` is the width
# the rule must use, ``want`` the answer.
DRAIN = dict(queue_max_rows=2048, retry_after_s=0.7)
DRAIN_CASES = {
    # No period is known before two pumps: the cap, as the reference.
    "no_pump": dict(starts=(), since=0.0, want=0.7),
    "one_pump": dict(starts=(0.0,), since=0.01, want=0.7),
    # The ladder's top (64 × 8) holds the backlog: ceil(776 / 512) = 2.
    "adaptive_top": dict(kw=dict(adaptive_batching=True), starts=(0.0, 0.05), since=0.01, take=512,
                         want=2 * 0.05),
    # Adaptive batching off: the base width, ceil(776 / 64) = 13 pumps.
    "base_width": dict(starts=(0.0, 0.02), since=0.005, take=64, want=13 * 0.02),
    # One take (a ladder up to 1,024) reaches the low watermark: one period.
    "one_take_left": dict(kw=dict(adaptive_batching=True, max_batch_growth=16), starts=(0.0, 0.05),
                          since=0.01, take=1024, want=0.05),
    # The mean of the last eight intervals: the 0.5 s gap has left it.
    "last_eight_intervals": dict(kw=dict(adaptive_batching=True),
                                 starts=(0.0, 0.5) + tuple(0.5 + 0.03 * k for k in range(1, 9)),
                                 since=0.01, take=512, want=2 * 0.03),
    # A stalled pump raises the period to the time since its start...
    "stalled": dict(kw=dict(adaptive_batching=True), starts=(0.0, 0.05), since=0.2, take=512, want=2 * 0.2),
    # ...up to the cap.
    "stalled_past_the_cap": dict(kw=dict(adaptive_batching=True), starts=(0.0, 0.05), since=0.9, take=512,
                                 want=0.7),
    # The keyspace ladder's shed rung, the queue admitting: its own hint.
    "keyspace_shed_rung": dict(kw=dict(keyspace_hold_s=0.01, keyspace_retry_after_s=2.5),
                               starts=(0.0, 0.05), rows=0, since=0.01, want=2.5),
}


@pytest.mark.parametrize("case", sorted(DRAIN_CASES))
def test_a_saturated_queue_hints_its_own_drain(clock, case):
    c = DRAIN_CASES[case]
    starts, rows, since = c["starts"], c.get("rows", 1800), c["since"]
    pipe = make_pipe(**DRAIN, **c.get("kw", {}))
    try:
        t0 = clock["t"]
        for t in starts:
            clock["t"] = t0 + t
            pipe.pump(clock["t"])  # on an empty queue: stamps, takes nothing
        if rows:
            pipe.submit_columns(make_cols(rows, err_frac=0.1, seed=31))
        else:
            for _ in range(8):
                clock["t"] += 0.02
                pipe.keyspace_update(0.95, now=clock["t"])
            assert pipe.keyspace_level == 4
        clock["t"] += since
        assert pipe.saturated == bool(rows) and pipe.pending_rows() == rows
        if "take" in c:
            assert pipe._take_width(pipe._controller_width(), rows) == c["take"]
        got = pipe.admission_retry_after()
        assert got == pytest.approx(c["want"], abs=1e-9)
        if rows and len(starts) >= 2:
            # Never below one period (unless the cap is), never above the cap.
            period = _period(starts, starts[-1] + since)
            assert min(period, pipe.retry_after_s) - 1e-9 <= got <= pipe.retry_after_s
        # Only the saturated answers below the cap count, with their seconds.
        derived = bool(rows) and got < pipe.retry_after_s
        assert pipe.stats.retry_hints_derived == int(derived)
        assert pipe.stats.retry_hint_s_sum == pytest.approx(got if derived else 0.0)
        # Asking again counts again; the queue, the flag and the ladder are untouched.
        assert pipe.admission_retry_after() == got
        assert pipe.stats.retry_hints_derived == 2 * int(derived)
        assert pipe.saturated == bool(rows) and pipe.pending_rows() == rows and pipe.brownout_level == 0
    finally:
        pipe.close()


def _closed_loop(hold_at_cap: bool, seconds: float = 1.0) -> dict:
    """One exporter offering 256-row bodies as the benchmark's closed
    loop does (ask ``admission_retry_after`` before each body, wait
    exactly its answer) against a pump every 20 ms, on the wall clock,
    with one torch thread so the loop leaves the other cores alone.
    ``hold_at_cap`` keeps the rule at its cap, as if no pump were
    stamped. Returns the pump calls, those that found the queue empty,
    and the rows offered, dispatched, shed and browned out."""
    dispatched = []
    pipe = make_pipe(queue_max_rows=2048, batch_size=64, adaptive_batching=True, retry_after_s=0.4,
                     brownout_hold_s=2.0,
                     history_capture=lambda cols, t: dispatched.append(cols.trace_key.copy()))
    if hold_at_cap:
        pipe._pump_starts = deque(maxlen=0)
    stop = threading.Event()
    offered, pumps = [], {"calls": 0, "empty": 0}

    def exporter():
        k = 0
        while not stop.is_set():
            wait = pipe.admission_retry_after()
            if wait is None:
                body = make_cols(256, err_frac=0.05, seed=k)
                body = body._replace(trace_key=np.arange(k * 256, (k + 1) * 256, dtype=np.uint64))
                pipe.submit_columns(body)
                offered.append(body.trace_key)
                k += 1
            elif stop.wait(wait):
                return

    def pump():
        while not stop.wait(0.02):
            empty = pipe.pending_rows() == 0
            pipe.pump(time.monotonic())
            pumps["calls"] += 1
            pumps["empty"] += int(empty)

    threads = [threading.Thread(target=exporter), threading.Thread(target=pump)]
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pipe.warm_widths()
        for t in threads:
            t.start()
        time.sleep(seconds)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
        pipe.close()
        torch.set_num_threads(torch_threads)
    assert not any(t.is_alive() for t in threads)
    return dict(pumps, offered=np.sort(np.concatenate(offered)), dispatched=np.sort(np.concatenate(dispatched)),
                shed=dict(pipe.stats.shed_rows), brownout=pipe.stats.brownout_rows,
                saturations=pipe.stats.saturation_events, derived=pipe.stats.retry_hints_derived)


def test_a_closed_loop_finds_the_queue_empty_less_often_with_the_drain_hint():
    capped, derived = _closed_loop(hold_at_cap=True), _closed_loop(hold_at_cap=False)
    assert capped["saturations"] >= 1 and derived["saturations"] >= 1
    assert capped["derived"] == 0 and derived["derived"] > 0
    assert derived["empty"] < capped["empty"], (derived, capped)
    assert derived["empty"] / derived["calls"] < capped["empty"] / capped["calls"]
    for run in (capped, derived):
        assert run["shed"] == {"ok": 0, "error": 0} and run["brownout"] == 0
        # Every offered row dispatched once (close drains the queue).
        np.testing.assert_array_equal(run["dispatched"], run["offered"])


# -- the pipeline-level cases of tests/test_overload.py, on the port --------


class TestBoundedAdmission:
    def test_flood_respects_budget_and_error_lane(self):
        pipe = make_pipe()
        err_fed = 0
        for i in range(40):
            cols = make_cols(100, err_frac=0.1, seed=i)
            err_fed += int((cols.is_error > 0).sum())
            pipe.submit_columns(cols)
        try:
            assert pipe.pending_rows() <= pipe.queue_max_rows
            assert pipe.stats.shed_rows["ok"] > 0
            assert pipe.stats.shed_rows["error"] == 0
            assert _pending_error_rows(pipe) == err_fed
            assert pipe.saturated
            assert pipe.admission_retry_after() == 0.7
        finally:
            pipe.close()

    def test_shed_lanes_contract(self):
        assert "ok" in SHED_LANES and "error" not in SHED_LANES
        assert SHED_LANES == jpipe.SHED_LANES

    def test_shed_drops_oldest_ok_first(self):
        pipe = make_pipe(queue_max_rows=128, batch_size=64)
        old, new = make_cols(100, seed=1), make_cols(100, seed=2)
        pipe.submit_columns(old)
        pipe.submit_columns(new)
        try:
            with pipe._pending_lock:
                chunks = [c for c, _ in pipe._pending]
            assert pipe.pending_rows() == 128
            assert chunks[0].rows == 28
            np.testing.assert_array_equal(chunks[0].trace_key, old.trace_key[72:])
            np.testing.assert_array_equal(chunks[-1].trace_key, new.trace_key)
        finally:
            pipe.close()

    def test_hysteresis_resumes_only_below_low_watermark(self):
        pipe = make_pipe(queue_max_rows=512)
        pipe.submit_columns(make_cols(500, seed=3))
        try:
            assert pipe.saturated
            t = 0.0
            pipe.pump(t)
            pipe.pump(t)
            assert pipe._low_rows < pipe.pending_rows() < pipe._high_rows
            assert pipe.saturated
            while pipe.pending_rows() > pipe._low_rows:
                t += 0.1
                pipe.pump(t)
            assert not pipe.saturated
            assert pipe.admission_retry_after() is None
        finally:
            pipe.close()

    def test_unbounded_by_default(self):
        pipe = DetectorPipeline(AnomalyDetector(DetectorConfig(**SMALL), device="cpu"), batch_size=64)
        try:
            pipe.submit_columns(make_cols(5000, seed=4))
            assert pipe.pending_rows() == 5000
            assert not pipe.saturated
            assert pipe.stats.shed_rows["ok"] == 0
        finally:
            pipe.close()

    def test_bad_watermarks_refused(self):
        with pytest.raises(ValueError):
            make_pipe(high_watermark=0.5, low_watermark=0.8)
        with pytest.raises(ValueError):
            make_pipe(queue_max_rows=32, batch_size=64)


class TestBrownout:
    def test_sustained_saturation_engages_and_relaxes(self, clock):
        pipe = make_pipe(brownout_hold_s=0.05)
        pipe.submit_columns(make_cols(500, seed=5))
        try:
            assert pipe.saturated and pipe.brownout_level == 0
            clock["t"] += 0.06  # sustained past the hold
            pipe.submit_columns(make_cols(10, seed=6))
            assert pipe.brownout_level >= 1
            t = 0.0
            for _ in range(400):
                clock["t"] += 0.01
                pipe.pump(t)
                t += 0.1
                if not pipe.saturated and pipe.brownout_level == 0:
                    break
            assert pipe.brownout_level == 0
            assert not pipe.saturated
            assert pipe.pending_rows() <= pipe._low_rows
        finally:
            pipe.close()

    def test_transient_spike_never_engages_ladder(self, clock):
        pipe = make_pipe(brownout_hold_s=10.0)
        pipe.submit_columns(make_cols(500, seed=7))
        try:
            assert pipe.saturated
            for _ in range(20):
                clock["t"] += 0.1
                pipe.submit_columns(make_cols(10, seed=8))
            assert pipe.brownout_level == 0
        finally:
            pipe.close()

    def test_sampling_is_deterministic_spares_error_lane_and_keeps_the_reference_rows(self):
        pipe, ref = make_pipe(), make_ref()
        cols = make_cols(4096, err_frac=0.25, seed=9)
        kept = pipe._brownout_sample(cols, 2)
        assert int((kept.is_error > 0).sum()) == int((cols.is_error > 0).sum())
        n_ok = int((cols.is_error == 0).sum())
        assert 0.15 * n_ok < int((kept.is_error == 0).sum()) < 0.35 * n_ok
        np.testing.assert_array_equal(kept.trace_key, make_pipe()._brownout_sample(cols, 2).trace_key)
        for level in (1, 2, 3, 4):
            np.testing.assert_array_equal(
                pipe._brownout_sample(cols, level).trace_key,
                ref._brownout_sample(_as_ref(cols), level).trace_key,
            )
        pipe.close()
        ref.close()

    def test_sampling_uniform_for_ascii_keys(self):
        pipe = make_pipe()
        keys = np.array(
            [np.frombuffer(f"ord-{i:04d}".encode()[:8], np.uint64)[0] for i in range(2048)], dtype=np.uint64
        )
        kept = pipe._brownout_sample(make_cols(2048, seed=10)._replace(trace_key=keys), 1)
        assert 0.4 * 2048 < kept.rows < 0.6 * 2048
        pipe.close()


class TestOverloadDriver:
    def test_five_x_sustained_holds_every_invariant(self):
        # The ladder stops at level 2, where the sampled feed (5 × 128 ×
        # (0.95 / 4 + 0.05) = 184 rows a pump) still outruns the 128 the
        # pump dispatches: the queue stays saturated under load however
        # long a step takes here.
        out = overloadbench.measure_overload(
            over_factor=5.0, seconds=1.0, batch=128, queue_max_rows=1024, brownout_hold_s=0.15,
            brownout_max_level=2, error_fraction=0.05, pump_interval_s=0.01,
            config=DetectorConfig(**SMALL), device="cpu",
        )
        assert out["saturated_under_load"]
        assert out["max_pending_rows"] <= out["queue_max_rows"]
        assert out["shed_error_rows"] == 0
        assert out["shed_ok_rows"] > 0
        assert out["brownout_max_level"] >= 1
        assert out["conserved"]
        assert out["recovery_s"] is not None
        ref = joverloadbench.measure_overload(
            over_factor=5.0, seconds=0.3, batch=128, queue_max_rows=1024, brownout_hold_s=0.15,
            pump_interval_s=0.01, config=JDetectorConfig(**SMALL),
        )
        # The port adds the drain hint's counters: the feed asks the hint
        # while the queue is saturated, and the pump is stamped.
        assert set(out) == set(ref) | {"retry_hints_derived", "retry_hint_s_sum"}
        assert out["retry_hints_derived"] > 0 and out["retry_hint_s_sum"] > 0


def test_lagbench_at_a_small_size_returns_the_reference_keys():
    out = lagbench.measure_lag(rate=4000.0, seconds=0.4, batch=64, config=DetectorConfig(**SMALL), device="cpu")
    ref = jlagbench.measure_lag(rate=4000.0, seconds=0.2, batch=64, config=JDetectorConfig(**SMALL))
    # The port adds its pump counters: each paced pump takes the one
    # chunk queued, so each is caught up, reads its own report and is
    # never widened.
    assert set(out) == set(ref) | {"pumps_caught_up", "pumps_widened", "reports_same_pump"}
    assert out["batches"] > 0 and out["spans"] == out["batches"] * 64
    assert out["pumps_caught_up"] == out["reports_same_pump"] == out["batches"]
    assert out["pumps_widened"] == 0
    assert 0.0 < out["p99_ms"] < 10_000.0 and out["rtt_pairs"] > 0
    cols_a = lagbench.make_columns(np.random.default_rng(0), 32)
    cols_b = jlagbench.make_columns(np.random.default_rng(0), 32)
    for a, b in zip(cols_a, cols_b):
        np.testing.assert_array_equal(a, b)


def test_adaptive_lagbench_settles_and_reports_its_width():
    out = lagbench.measure_lag(rate=8000.0, seconds=0.3, batch=64, config=DetectorConfig(**SMALL),
                               adaptive=True, max_batch_growth=4, settle_s=0.2, device="cpu")
    assert out["settle_s"] == 0.2 and out["final_batch_width"] in (64, 128, 256)


# -- the harvester, the RTT probe and warm_widths --------------------------


def test_harvester_alive_and_restart():
    reports = []
    pipe = make_pipe(queue_max_rows=0, harvest_async=True, on_report=lambda *a: reports.append(a))
    try:
        assert pipe.harvester_alive()
        pipe.restart_harvester()  # healthy: a no-op
        thread = pipe._harvest_thread
        pipe._harvest_stop = True
        pipe._harvest_wake.set()
        thread.join(timeout=5.0)
        assert not pipe.harvester_alive()
        pipe.restart_harvester()
        assert pipe.harvester_alive() and pipe._harvest_thread is not thread
        for i in range(6):
            pipe.submit_columns(make_cols(64, seed=300 + i))
            pipe.pump(i * 0.1)
        pipe.drain()
        assert len(reports) + pipe.stats.reports_skipped == 6
        assert pipe.stats.harvest_errors == 0
    finally:
        pipe.close()
    assert not pipe.harvester_alive()
    sync = make_pipe(queue_max_rows=0)
    assert sync.harvester_alive()
    sync.restart_harvester()
    assert sync._harvest_thread is None
    sync.close()


def test_a_raising_on_report_does_not_kill_the_harvester():
    def boom(*a):
        raise RuntimeError("consumer bug")

    pipe = make_pipe(queue_max_rows=0, harvest_async=True, on_report=boom)
    try:
        for i in range(4):
            pipe.submit_columns(make_cols(64, seed=400 + i))
            pipe.pump(i * 0.1)
        pipe.drain()
        assert pipe.harvester_alive()
        assert pipe.stats.harvest_errors + pipe.stats.reports_skipped == 4
        assert pipe.stats.harvest_errors >= 1
    finally:
        pipe.close()


def test_rtt_probe_pairs_each_harvest():
    pipe = make_pipe(queue_max_rows=0, rtt_probe=True)
    for i in range(5):
        pipe.submit_columns(make_cols(64, seed=500 + i))
        pipe.pump(i * 0.1)
    pipe.close()
    assert len(pipe.stats.rtt_ms) == len(pipe.stats.lag_ms) == 5
    net = pipe.stats.lag_net_samples()
    assert net.shape == (5,) and np.isfinite(net).all()


def test_warm_widths_leaves_state_and_clock_untouched():
    pipe = make_pipe(queue_max_rows=0, adaptive_batching=True, max_batch_growth=4)
    det = pipe.detector
    for i in range(3):
        pipe.submit_columns(make_cols(64, seed=600 + i))
        pipe.pump(i * 0.3)
    pipe.drain()
    before = [t.clone() for t in det.state]
    t_prev = det.clock._t_prev
    pipe.warm_widths()
    for name, a, b in zip(det.state._fields, before, det.state):
        assert torch.equal(a, b), name
    assert det.clock._t_prev == t_prev
    pipe.close()
