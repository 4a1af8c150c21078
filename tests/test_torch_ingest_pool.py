"""The port's decode pool against the reference's.

The same payloads, made from a seed with numpy, go through the port's
``IngestPool`` (``opentelemetry_demo_tpu_torch.runtime.ingest_pool``)
and the reference's; the columns they hand their sinks must be the same
bytes with the same intern ids, with one worker and with four. Then the
per-request verdicts inside a coalesced flush, the bounded queue, the
scratch tickets (park, recycle, a scribbled scratch quarantined),
buffer-backed payloads, the pool feeding a pipeline (no scratch memory
reaches a device copy) and the absent decoder.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.runtime import ingest_pool as jpool
from opentelemetry_demo_tpu.runtime import native as jnative
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
from opentelemetry_demo_tpu_torch.runtime import frame, ingest_pool, native, tensorize
from opentelemetry_demo_tpu_torch.runtime.ingestbench import make_payloads
from opentelemetry_demo_tpu_torch.runtime.otlp import MONITORED_ATTR_KEYS
from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

JOIN_S = 30.0


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    assert native.available(), native.load_error()
    assert jnative.available(), jnative.load_error()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (host-to-device copies of pooled rows)")
    return torch.device("cuda")


def _copying_sink(out: list):
    """A sink that keeps a copy: the pool hands out views into scratch."""
    return lambda cols: out.append(tuple(np.array(a, copy=True) for a in cols))


def _pools(workers: int, **kw):
    got_port, got_ref = [], []
    port = ingest_pool.IngestPool(_copying_sink(got_port), tensorize.SpanTensorizer(32), workers=workers, **kw)
    ref = jpool.IngestPool(_copying_sink(got_ref), jtz.SpanTensorizer(num_services=32), workers=workers, **kw)
    return (port, got_port), (ref, got_ref)


def _rows(parts: list) -> np.ndarray:
    """All rows of a list of column tuples, as one structured array
    sorted by every field (flush order is free with several workers)."""
    cols = [np.concatenate([p[i] for p in parts]) for i in range(5)]
    rec = np.rec.fromarrays(cols, names="svc,lat,err,trace,crc")
    return np.sort(rec, order=["trace", "svc", "lat", "err", "crc"])


@pytest.mark.parametrize("workers", [1, 4])
def test_pool_columns_equal_the_reference_pool(workers):
    payloads = make_payloads(n_requests=24, spans_per_request=96, seed=11)
    (port, got_port), (ref, got_ref) = _pools(workers)
    try:
        # One request per flush first, one at a time: every service is
        # interned in the same order on both sides before the workers race.
        for p in payloads[:12]:
            port.submit(p).result(JOIN_S)
            ref.submit(p).result(JOIN_S)
        assert port.tensorizer.service_names == ref.tensorizer.service_names
        n_serial = len(got_port)
        for i in range(n_serial):
            for a, b in zip(got_port[i], got_ref[i]):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        tickets = [(port.submit(p), ref.submit(p)) for p in payloads[12:] * 3]
        for tp, tr in tickets:
            tp.result(JOIN_S)
            tr.result(JOIN_S)
        assert port.drain(JOIN_S) and ref.drain(JOIN_S)
    finally:
        port.close()
        ref.close()
    a, b = _rows(got_port), _rows(got_ref)
    assert a.tobytes() == b.tobytes()
    assert port.tensorizer.service_names == ref.tensorizer.service_names
    st = port.stats()
    assert st["flushed_spans"] == ref.stats()["flushed_spans"] == 96 * (12 + 36)
    assert st["decode_errors"] == 0 and st["worker_failures"] == 0


def _hold_first_flush(pool_mod, tz, workers=1, **kw):
    """A pool whose first flush waits on ``gate`` in its sink, so the
    requests submitted meanwhile queue up and coalesce."""
    gate, entered = threading.Event(), threading.Event()
    got: list = []

    def sink(cols):
        if not entered.is_set():
            entered.set()
            assert gate.wait(JOIN_S)
        got.append(tuple(np.array(a, copy=True) for a in cols))

    return pool_mod.IngestPool(sink, tz, workers=workers, **kw), gate, entered, got


@pytest.mark.parametrize("which", ["port", "reference"])
def test_a_malformed_payload_gets_its_own_verdict_in_a_coalesced_flush(which):
    good = make_payloads(n_requests=3, spans_per_request=40, seed=5)
    mod, tz = (ingest_pool, tensorize.SpanTensorizer(32)) if which == "port" else (
        jpool, jtz.SpanTensorizer(num_services=32))
    pool, gate, entered, got = _hold_first_flush(mod, tz)
    try:
        first = pool.submit(good[0])
        assert entered.wait(JOIN_S)
        batch = [pool.submit(p) for p in (good[1], b"\x0a\xff", good[2])]
        gate.set()
        first.result(JOIN_S)
        batch[0].result(JOIN_S)
        batch[2].result(JOIN_S)
        with pytest.raises(ValueError):
            batch[1].result(JOIN_S)
        assert pool.drain(JOIN_S)
        st = pool.stats()
    finally:
        gate.set()
        pool.close()
    assert st["flushes"] == 2 and st["coalesced_requests"] == 4 and st["decode_errors"] == 1
    assert [g[0].shape[0] for g in got] == [40, 80]


def test_coalesced_verdicts_and_rows_equal_the_reference():
    payloads = make_payloads(n_requests=4, spans_per_request=32, seed=6)
    mixed = [payloads[1], b"\xff\xfe\xfd", payloads[2], b"\x0a\xff", payloads[3]]
    runs = {}
    for which, mod, tz in (("port", ingest_pool, tensorize.SpanTensorizer(32)),
                           ("reference", jpool, jtz.SpanTensorizer(num_services=32))):
        pool, gate, entered, got = _hold_first_flush(mod, tz)
        try:
            pool.submit(payloads[0])
            assert entered.wait(JOIN_S)
            tickets = [pool.submit(p) for p in mixed]
            gate.set()
            verdicts = []
            for t in tickets:
                try:
                    t.result(JOIN_S)
                    verdicts.append("ok")
                except ValueError:
                    verdicts.append("malformed")
            assert pool.drain(JOIN_S)
        finally:
            gate.set()
            pool.close()
        runs[which] = (verdicts, got, tz.service_names)
    assert runs["port"][0] == runs["reference"][0] == ["ok", "malformed", "ok", "malformed", "ok"]
    assert runs["port"][2] == runs["reference"][2]
    for a, b in zip(runs["port"][1], runs["reference"][1]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("which", ["port", "reference"])
def test_a_full_queue_raises_saturated_and_recovers(which):
    mod, tz = (ingest_pool, tensorize.SpanTensorizer(32)) if which == "port" else (
        jpool, jtz.SpanTensorizer(num_services=32))
    payload = make_payloads(n_requests=1, spans_per_request=8, seed=2)[0]
    pool, gate, entered, _got = _hold_first_flush(mod, tz, max_pending=1)
    pool.SUBMIT_TIMEOUT_S = 0.05
    try:
        first = pool.submit(payload)
        assert entered.wait(JOIN_S)
        queued = pool.submit(payload)  # the one pending slot
        with pytest.raises(mod.IngestPoolSaturated):
            pool.submit(payload)
        assert pool.stats()["submitted"] == 2
        gate.set()
        first.result(JOIN_S)
        queued.result(JOIN_S)
        pool.submit(payload).result(JOIN_S)  # room again
    finally:
        gate.set()
        pool.close()


def _held_pool(mod, tz):
    """A pool whose sink keeps the views it is handed (as a pipeline
    keeps its pending rows until the pump)."""
    held: list = []
    return mod.IngestPool(held.append, tz, workers=1), held


@pytest.mark.parametrize("which", ["port", "reference"])
def test_parked_scratch_recycles_once_the_views_are_gone(which):
    mod, tz = (ingest_pool, tensorize.SpanTensorizer(32)) if which == "port" else (
        jpool, jtz.SpanTensorizer(num_services=32))
    payloads = make_payloads(n_requests=3, spans_per_request=64, seed=8)
    pool, held = _held_pool(mod, tz)
    try:
        pool.submit(payloads[0]).result(JOIN_S)
        pool.submit(payloads[1]).result(JOIN_S)
        st = pool.stats()
        assert st["tickets_parked"] == 2 and st["scratch_parked"] == 2 and st["tickets_recycled"] == 0
        held.clear()
        pool.submit(payloads[2]).result(JOIN_S)  # its acquire scavenges
        assert pool.stats()["tickets_recycled"] == 2
    finally:
        pool.close()
    assert pool.stats()["frames_corrupt"] == 0


@pytest.mark.parametrize("which", ["port", "reference"])
def test_a_scribbled_parked_scratch_is_counted_and_quarantined(which, tmp_path):
    mod, tz, fr = (ingest_pool, tensorize.SpanTensorizer(32), frame) if which == "port" else (
        jpool, jtz.SpanTensorizer(num_services=32), __import__(
            "opentelemetry_demo_tpu.runtime.frame", fromlist=["frame"]))
    payloads = make_payloads(n_requests=2, spans_per_request=64, seed=9)
    fr.configure(quarantine_dir=str(tmp_path))
    pool, held = _held_pool(mod, tz)
    try:
        pool.submit(payloads[0]).result(JOIN_S)
        held[0].lat_us[3] += 1.0  # a view into the parked scratch
        held.clear()
        pool.submit(payloads[1]).result(JOIN_S)
        assert pool.drain(JOIN_S)
        st = pool.stats()
    finally:
        pool.close()
        fr.configure(quarantine_dir="")
    assert st["frames_corrupt"] == 1 and st["tickets_recycled"] == 0
    evidence = list(tmp_path.iterdir())
    assert len(evidence) == 1 and evidence[0].name.startswith("ingest-")
    assert fr.decode_spans(evidence[0].read_bytes()).duration_us.shape == (64,)


def test_drain_recycles_what_the_pipeline_let_go():
    """Without a next flush only ``drain`` scavenges: the last flushes'
    scratch comes back once their rows are gone."""
    payloads = make_payloads(n_requests=3, spans_per_request=64, seed=10)
    pool, held = _held_pool(ingest_pool, tensorize.SpanTensorizer(32))
    try:
        for p in payloads:
            pool.submit(p).result(JOIN_S)
        assert pool.drain(JOIN_S) and pool.stats()["tickets_recycled"] == 0
        held.clear()
        assert pool.drain(JOIN_S)
        st = pool.stats()
    finally:
        pool.close()
    assert st["tickets_recycled"] == st["tickets_parked"] == 3 and st["scratch_parked"] == 0


def test_scratch_held_a_batch_at_a_time_is_not_reallocated_every_batch():
    """A pipeline holds a batch's flushes until its pump: the freelist
    keeps as many scratches as were ever parked at once, so the pool
    allocates for the first batch and then recycles."""
    payloads = make_payloads(n_requests=6, spans_per_request=64, seed=12)
    pool, held = _held_pool(ingest_pool, tensorize.SpanTensorizer(32))
    try:
        for _batch in range(10):
            for p in payloads:
                pool.submit(p).result(JOIN_S)
            held.clear()  # the pump
        assert pool.drain(JOIN_S)
        st = pool.stats()
    finally:
        pool.close()
    assert st["tickets_recycled"] == st["tickets_parked"] == 60
    assert st["scratch_allocations"] <= len(payloads) + 1


def test_buffer_backed_payloads_decode_like_bytes():
    payloads = make_payloads(n_requests=3, spans_per_request=50, seed=13)
    bufs = [(ctypes.c_char * len(p)).from_buffer_copy(p) for p in payloads]
    want, want_rows = native.decode_otlp_many(payloads, MONITORED_ATTR_KEYS)
    mixed = [bufs[0], payloads[1], bufs[2]]
    for batch in (bufs, mixed):
        got, rows = native.decode_otlp_many(batch, MONITORED_ATTR_KEYS)
        assert rows.tolist() == want_rows.tolist() == [50, 50, 50]
        ref, ref_rows = jnative.decode_otlp_many(batch, MONITORED_ATTR_KEYS)
        assert ref_rows.tolist() == rows.tolist()
        for name in native.ColumnarSpans._fields[:8]:
            a, b, c = getattr(got, name), getattr(want, name), getattr(ref, name)
            assert a.tobytes() == b.tobytes() == c.tobytes(), name
        assert got.services == want.services == ref.services
    got_cols: list = []
    pool = ingest_pool.IngestPool(_copying_sink(got_cols), tensorize.SpanTensorizer(32), workers=1)
    try:
        for b in bufs:
            pool.submit(b).result(JOIN_S)
    finally:
        pool.close()
    tz = tensorize.SpanTensorizer(32)
    serial = [tz.columns_from_columnar(native.decode_otlp(p, MONITORED_ATTR_KEYS)) for p in payloads]
    for got_one, want_one in zip(got_cols, serial):
        for a, b in zip(got_one, want_one):
            assert a.tobytes() == b.tobytes()


def test_decode_reports_its_two_passes():
    payloads = make_payloads(n_requests=4, spans_per_request=200, seed=14)
    phases: dict = {}
    native.decode_otlp_many(payloads, MONITORED_ATTR_KEYS, phases=phases)
    assert set(phases) == {"scan", "extract"} and all(v >= 0.0 for v in phases.values())
    pool = ingest_pool.IngestPool(lambda cols: None, tensorize.SpanTensorizer(32), workers=1)
    try:
        for p in payloads:
            pool.submit(p)
        assert pool.drain(JOIN_S)
        phase_s = pool.stats()["phase_s"]
    finally:
        pool.close()
    assert set(phase_s) == set(ingest_pool.TOP_PHASES) | {"scan", "extract"}
    assert phase_s["decode"] > 0.0 and phase_s["decode"] >= phase_s["scan"]


def test_the_pool_raises_at_construction_without_the_decoder(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "no host C++ compiler (g++ or c++) on PATH")
    with pytest.raises(RuntimeError, match="native ingest unavailable: no host C"):
        ingest_pool.IngestPool(lambda cols: None, tensorize.SpanTensorizer(32))


def _pool_into_pipeline(device):
    """The pool feeding a spine + async-harvester pipeline; every staged
    batch's lanes are checked against the memory of every scratch the
    pool has handed out."""
    cfg = DetectorConfig(num_services=8, hll_p=8, cms_width=512)
    det = AnomalyDetector(cfg, device=device)
    pipe = DetectorPipeline(det, batch_size=256, spine_ring=2, harvest_async=True)
    pool = ingest_pool.IngestPool(pipe.submit_columns, pipe.tensorizer, workers=2)
    scratches: list = []
    acquire = pool._scratch.acquire

    def tracking_acquire(*dims):
        s = acquire(*dims)
        scratches.append(s)
        return s

    pool._scratch.acquire = tracking_acquire
    shared: list = []
    step = det.observe_staged_packed

    def checking_step(lanes, t_now):
        # The copy sources are the spine slots' host buffers; on the CPU
        # the lanes themselves are host memory too.
        sources = [buf.numpy() for slot in pipe._spine._slots for buf, _views in slot.host.values()]
        if lanes.device.type == "cpu":
            sources.append(lanes.numpy())
        for src in sources:
            for s in scratches:
                for arr in (s.duration, s.trace, s.err, s.crc, s.present, s.svc_idx):
                    shared.append(np.shares_memory(src, arr))
        return step(lanes, t_now)

    det.observe_staged_packed = checking_step
    return pipe, pool, shared


@pytest.mark.parametrize("on_card", [False, pytest.param(True, marks=pytest.mark.gpu)])
def test_pooled_rows_reach_the_device_through_host_copies_only(on_card, request):
    device = request.getfixturevalue("cuda_device") if on_card else torch.device("cpu")
    payloads = make_payloads(n_requests=12, spans_per_request=100, seed=15)
    pipe, pool, shared = _pool_into_pipeline(device)
    try:
        for k in range(3):
            for t in [pool.submit(p) for p in payloads]:
                t.result(JOIN_S)
            pipe.pump(k * 0.25)
        pipe.drain()
        assert pool.drain(JOIN_S)
        st = pool.stats()
    finally:
        pipe.close()
        pool.close()
    assert shared and not any(shared)
    assert pipe.stats.spans == 3 * 12 * 100
    assert st["tickets_recycled"] == st["tickets_parked"] and st["frames_corrupt"] == 0
