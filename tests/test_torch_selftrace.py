"""The port's self-tracer and flight recorder against the JAX reference:
deterministic sampling and ids, the encoded trace bytes for the same
batch trace, the decoded structure of a traced pipeline run (span names,
parents, ids, attributes, links), the ingest segments the decode pool
records, the phase histogram vocabulary, and the flight recorder's ring,
snapshot and dump files.

Tolerance: ids, bytes, span structure, links and dump files compare
exactly. Span times come from each process's clock and are compared only
for order (start ≤ end), never across packages.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from opentelemetry_demo_tpu.models import detector as jdet
from opentelemetry_demo_tpu.runtime import flightrec as jflightrec
from opentelemetry_demo_tpu.runtime import pipeline as jpipeline
from opentelemetry_demo_tpu.runtime import selftrace as jselftrace
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu_torch.models import detector as tdet
from opentelemetry_demo_tpu_torch.ops.hashing import splitmix64_np
from opentelemetry_demo_tpu_torch.runtime import native, selftrace, tensorize
from opentelemetry_demo_tpu_torch.runtime.flightrec import FlightRecorder
from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

SMALL = dict(num_services=8, cms_width=512, hll_p=8)
NAMES = ["frontend", "cart", "checkout", "ad"]


def _cols(rng, n, services=4):
    return dict(
        svc=rng.integers(0, services, n).astype(np.int32),
        lat_us=rng.gamma(4.0, 250.0, n).astype(np.float32),
        is_error=(rng.random(n) < 0.02).astype(np.float32),
        trace_key=rng.integers(0, 2**63, n, dtype=np.uint64),
        attr_crc=rng.integers(0, 2**32, n, dtype=np.uint64),
    )


def drive_flagging_pipeline(which, tracer, phase_observe=None, batches=30, **port_kw):
    """A small detector warmed up, then service 3's latency ×10,000 so the
    flag path fires; returns the ingested trace-id prefixes of service 3.
    ``port_kw`` goes to the port's pipeline alone."""
    kw = dict(**SMALL, warmup_batches=2.0, z_warmup_batches=3.0)
    if which == "port":
        pipe = DetectorPipeline(
            tdet.AnomalyDetector(tdet.DetectorConfig(**kw), device="cpu"), batch_size=64,
            exemplar_ring=4, selftrace=tracer, phase_observe=phase_observe, **port_kw,
        )
        cols_t = tensorize.SpanColumns
    else:
        pipe = jpipeline.DetectorPipeline(
            jdet.AnomalyDetector(jdet.DetectorConfig(**kw)), batch_size=64,
            exemplar_ring=4, selftrace=tracer, phase_observe=phase_observe,
        )
        cols_t = jtz.SpanColumns
    for name in NAMES:
        pipe.tensorizer.service_id(name)
    rng = np.random.default_rng(4)
    submitted: set[str] = set()
    t = 0.0
    for i in range(batches):
        cols = _cols(rng, 64)
        if i >= batches // 2:
            cols["lat_us"][cols["svc"] == 3] *= 10_000.0
        for v in cols["trace_key"][cols["svc"] == 3]:
            submitted.add(int(v).to_bytes(8, "little").hex())
        pipe.submit_columns(cols_t(**cols))
        pipe.pump(t)
        pipe.drain()
        t += 0.25
    assert pipe.exemplars_captured > 0
    if which == "port":
        pipe.close()
    return submitted


# --- sampling and ids ---------------------------------------------------


class TestSampling:
    def test_splitmix64_matches_np(self):
        xs = np.array([0, 1, 2, 123456789, 2**63, 2**64 - 1], dtype=np.uint64)
        for x, want in zip(xs, splitmix64_np(xs)):
            assert selftrace.splitmix64(int(x)) == int(want) == jselftrace.splitmix64(int(x))

    @pytest.mark.parametrize("rate", [0.0, 0.01, 0.05, 0.25, 0.5, 1.0])
    def test_sampled_chooses_the_reference_batches(self, rate):
        ours = [selftrace.sampled(i, rate) for i in range(8192)]
        assert ours == [jselftrace.sampled(i, rate) for i in range(8192)]
        if 0.0 < rate < 1.0:
            assert abs(sum(ours) / len(ours) - rate) < max(0.3 * rate, 0.01)

    def test_sampling_is_deterministic(self):
        a = [selftrace.sampled(i, 0.25) for i in range(4096)]
        assert a == [selftrace.sampled(i, 0.25) for i in range(4096)]
        assert all(selftrace.sampled(i, 1.0) for i in range(64))
        assert not any(selftrace.sampled(i, 0.0) for i in range(64))

    def test_unsampled_batch_returns_none(self):
        tracer = selftrace.SelfTracer(sample=0.0)
        assert tracer.begin() is None
        assert tracer.traces_started == 0

    @pytest.mark.parametrize("seq", [0, 1, 77, 2**40])
    def test_trace_and_span_ids_equal_reference(self, seq):
        ours, ref = selftrace.BatchTrace(seq), jselftrace.BatchTrace(seq)
        assert ours.trace_id == ref.trace_id
        for i in range(4):
            assert selftrace._span_id(ours.trace_id, i) == jselftrace._span_id(ref.trace_id, i)

    def test_tables_equal_reference(self):
        for name in dir(jselftrace):
            if name.startswith(("SPAN_", "PHASE_")) or name in ("SELF_SERVICE",):
                assert getattr(selftrace, name) == getattr(jselftrace, name), name


# --- encoding -------------------------------------------------------------


def _fixed_trace(mod, seq):
    """A BatchTrace with a fixed clock and a fixed span list."""
    tr = mod.BatchTrace(seq)
    tr.t0_wall = 1_700_000_000.25
    tr.t0_perf = 100.0
    tr.span(mod.SPAN_DECODE, 0.002, end_perf=99.999)
    tr.span(mod.SPAN_STAGE, 0.0003, end_perf=100.001, attrs=(("overlap.hit", "1"),))
    tr.span(mod.SPAN_DISPATCH, 0.0001, end_perf=100.002)
    tr.span(mod.SPAN_HARVEST, 0.004, end_perf=100.007)
    tr.span(
        mod.SPAN_FLAG, 0.0005, end_perf=100.008,
        attrs=(("flagged.services", "cart,ad"),),
        links=("0011223344556677", "8899aabbccddeeff"),
    )
    tr.attrs.append(("batch.rows", "64"))
    return tr


@pytest.mark.parametrize("seq", [0, 5, 1234])
def test_encoded_trace_bytes_equal_reference(seq):
    ours = selftrace.encode_selftrace_request(_fixed_trace(selftrace, seq))
    ref = jselftrace.encode_selftrace_request(_fixed_trace(jselftrace, seq))
    assert ours == ref
    assert selftrace.decode_selftrace_request(ours) == jselftrace.decode_selftrace_request(ref)


def test_decoded_trace_structure():
    body = selftrace.encode_selftrace_request(_fixed_trace(selftrace, 9), service="svc-x")
    spans = selftrace.decode_selftrace_request(body)
    root = spans[-1]
    assert root["name"] == selftrace.SPAN_BATCH
    assert root["attrs"] == {"batch.seq": "9", "batch.rows": "64"}
    assert [s["name"] for s in spans[:-1]] == [
        selftrace.SPAN_DECODE, selftrace.SPAN_STAGE, selftrace.SPAN_DISPATCH,
        selftrace.SPAN_HARVEST, selftrace.SPAN_FLAG,
    ]
    for s in spans:
        assert s["service"] == "svc-x"
        assert s["start_ns"] <= s["end_ns"]
        if s is not root:
            assert s["parent_span_id"] == root["span_id"]
    # The root spans its children, including the decode that predates it.
    assert root["start_ns"] <= min(s["start_ns"] for s in spans)
    assert spans[-2]["links"] == ["0011223344556677" + "00" * 8, "8899aabbccddeeff" + "00" * 8]


def test_ingest_segments_ride_the_next_sampled_batch():
    tracer = selftrace.SelfTracer(submit=lambda b: None, sample=1.0)
    tracer.flush_segment({
        selftrace.PHASE_DECODE: 0.001,
        selftrace.PHASE_VERIFY: 0.0002,
        selftrace.PHASE_TENSORIZE: 0.0005,
        "unknown-phase": 0.1,
    })
    trace = tracer.begin()
    assert [s[0] for s in trace.spans] == [
        selftrace.SPAN_DECODE, selftrace.SPAN_VERIFY, selftrace.SPAN_TENSORIZE,
    ]
    assert tracer.stats()["segments_pending"] == 0


def test_segment_ring_is_bounded_and_kept_for_a_sampled_batch():
    """Unsampled batches leave the segments for the next sampled one; the
    ring keeps the newest ``segment_ring`` of them."""
    tracer = selftrace.SelfTracer(submit=lambda b: None, sample=0.0, segment_ring=3)
    for i in range(5):
        tracer.flush_segment({selftrace.PHASE_DECODE: 0.001 * (i + 1)})
    assert tracer.begin() is None
    assert tracer.stats()["segments_pending"] == 3
    tracer.sample = 1.0
    trace = tracer.begin()
    assert [round(s[2], 6) for s in trace.spans] == [0.003, 0.004, 0.005]


def test_finish_counts_and_submits():
    bodies: list[bytes] = []
    tracer = selftrace.SelfTracer(submit=bodies.append, sample=1.0)
    trace = tracer.begin()
    trace.span(selftrace.SPAN_FLAG, 0.001, links=("aa" * 8,))
    body = tracer.finish(trace)
    assert bodies == [body]
    assert tracer.stats() == {
        "sample": 1.0, "traces_started": 1, "traces_exported": 1,
        "spans_exported": 2, "links_exported": 1, "segments_pending": 0,
    }


# --- a traced pipeline run ----------------------------------------------


def _structure(bodies):
    out = []
    for body in bodies:
        for s in selftrace.decode_selftrace_request(body):
            out.append((
                s["service"], s["name"], s["trace_id"], s["span_id"], s["parent_span_id"],
                s["attrs"], s["links"],
            ))
    return out


def test_traced_pipeline_run_equals_reference():
    """Both pipelines fed the same stream with sample 1.0: the same
    traces, spans, parents, ids, attributes and flag-span links."""
    ours: list[bytes] = []
    ref: list[bytes] = []
    submitted = drive_flagging_pipeline("port", selftrace.SelfTracer(submit=ours.append, sample=1.0))
    drive_flagging_pipeline("reference", jselftrace.SelfTracer(submit=ref.append, sample=1.0))
    assert len(ours) == len(ref) == 30
    assert _structure(ours) == _structure(ref)
    flag_spans = [
        s for b in ours for s in selftrace.decode_selftrace_request(b) if s["name"] == selftrace.SPAN_FLAG
    ]
    links = [link for s in flag_spans for link in s["links"]]
    assert links, "a flagging run must produce linked flag spans"
    for link in links:
        assert len(link) == 32 and link[:16] in submitted


def test_span_parent_and_links_round_trip():
    bodies: list[bytes] = []
    tracer = selftrace.SelfTracer(submit=bodies.append, sample=1.0)
    drive_flagging_pipeline("port", tracer)
    assert tracer.traces_exported == tracer.traces_started > 0
    spans = selftrace.decode_selftrace_request(bodies[-1])
    roots = [s for s in spans if s["name"] == selftrace.SPAN_BATCH]
    assert len(roots) == 1
    root = roots[0]
    assert root["trace_id"] == selftrace.BatchTrace(int(root["attrs"]["batch.seq"])).trace_id.hex()
    names = {s["name"] for s in spans}
    assert {selftrace.SPAN_DISPATCH, selftrace.SPAN_HARVEST} <= names
    for span in spans:
        assert span["service"] == selftrace.SELF_SERVICE
        if span is not root:
            assert span["parent_span_id"] == root["span_id"]
            assert span["trace_id"] == root["trace_id"]
        assert span["start_ns"] <= span["end_ns"]


def test_unsampled_run_exports_nothing():
    bodies: list[bytes] = []
    tracer = selftrace.SelfTracer(submit=bodies.append, sample=0.0)
    drive_flagging_pipeline("port", tracer, batches=20)
    assert bodies == [] and tracer.traces_started == 0


def test_sampled_batches_are_the_reference_batches():
    """At sample 0.25 the port exports the traces of the same batch
    sequence numbers as the reference."""
    ours: list[bytes] = []
    ref: list[bytes] = []
    drive_flagging_pipeline("port", selftrace.SelfTracer(submit=ours.append, sample=0.25))
    drive_flagging_pipeline("reference", jselftrace.SelfTracer(submit=ref.append, sample=0.25))

    def seqs(bodies):
        return [
            s["attrs"]["batch.seq"] for b in bodies for s in selftrace.decode_selftrace_request(b)
            if s["name"] == selftrace.SPAN_BATCH
        ]

    assert seqs(ours) == seqs(ref) == [str(i) for i in range(30) if selftrace.sampled(i, 0.25)]


def test_a_skipped_report_takes_its_trace_in_both_packages():
    """A report dropped unread (a third in flight under a harvest interval
    no pump reaches) is never finished, in the reference as in the port:
    one trace per harvested report, of the same batches."""

    def run(which):
        bodies: list[bytes] = []
        if which == "port":
            tracer = selftrace.SelfTracer(submit=bodies.append, sample=1.0)
            pipe = DetectorPipeline(
                tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device="cpu"), batch_size=64,
                harvest_interval_s=3600.0, selftrace=tracer,
            )
            cols_t = tensorize.SpanColumns
        else:
            tracer = jselftrace.SelfTracer(submit=bodies.append, sample=1.0)
            pipe = jpipeline.DetectorPipeline(
                jdet.AnomalyDetector(jdet.DetectorConfig(**SMALL)), batch_size=64,
                harvest_interval_s=3600.0, selftrace=tracer,
            )
            cols_t = jtz.SpanColumns
        rng = np.random.default_rng(5)
        try:
            for i in range(6):
                pipe.submit_columns(cols_t(**_cols(rng, 64)))
                pipe.pump(i * 0.25)
            pipe.drain()
        finally:
            pipe.close()
        seqs = [
            s["attrs"]["batch.seq"] for b in bodies for s in selftrace.decode_selftrace_request(b)
            if s["name"] == selftrace.SPAN_BATCH
        ]
        return pipe.stats.batches, pipe.stats.reports_skipped, tracer.traces_started, tracer.traces_exported, seqs

    assert run("port") == run("reference") == (6, 4, 6, 2, ["4", "5"])


def test_spine_carries_the_trace_to_dispatch():
    """With the spine on, a sampled batch's trace gains the stage and put
    spans and still reaches the harvester."""
    bodies: list[bytes] = []
    tracer = selftrace.SelfTracer(submit=bodies.append, sample=1.0)
    pipe = DetectorPipeline(
        tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device="cpu"), batch_size=64,
        spine_ring=2, selftrace=tracer,
    )
    rng = np.random.default_rng(7)
    try:
        for i in range(6):
            pipe.submit_columns(tensorize.SpanColumns(**_cols(rng, 64)))
            pipe.pump(i * 0.25)
        pipe.drain()
    finally:
        pipe.close()
    assert len(bodies) == 6
    for body in bodies:
        names = [s["name"] for s in selftrace.decode_selftrace_request(body)]
        assert names[:4] == [selftrace.SPAN_STAGE, selftrace.SPAN_PUT, selftrace.SPAN_DISPATCH, selftrace.SPAN_HARVEST]


def test_phase_observe_sees_registered_labels_only():
    """A flagging run on the spine with a report callback, and a decode
    pool fed one body: every label observed is in the ``PHASE_*`` table,
    the waits, ``report`` and ``pump`` among them."""
    if not native.available():
        pytest.skip(f"native ingest unavailable: {native.load_error()}")
    from opentelemetry_demo_tpu_torch.runtime import ingest_pool, otlp_export

    phases: list[str] = []
    tracer = selftrace.SelfTracer(submit=lambda b: None, sample=0.0)
    drive_flagging_pipeline("port", tracer, phase_observe=lambda n, dt: phases.append(n), batches=20,
                            spine_ring=2, on_report=lambda *a: None)
    pool = ingest_pool.IngestPool(
        lambda cols: None, tensorize.SpanTensorizer(8), workers=1,
        phase_observe=lambda n, dt: phases.append(n),
    )
    body = otlp_export.encode_export_request(
        [tensorize.SpanRecord("cart", 100.0 + i, bytes([i]) * 16) for i in range(20)], t_ns=10**18
    )
    try:
        pool.submit(body).result(10.0)
        assert pool.drain(10.0)
    finally:
        pool.close()
    table = {v for k, v in vars(selftrace).items() if k.startswith("PHASE_")}
    assert set(phases) <= table
    assert {selftrace.PHASE_DISPATCH, selftrace.PHASE_HARVEST, selftrace.PHASE_HARVEST_LAG,
            selftrace.PHASE_FLAG, selftrace.PHASE_STAGE, selftrace.PHASE_PUT_WAIT} <= set(phases)
    assert {selftrace.PHASE_QUEUE_WAIT, selftrace.PHASE_PENDING_WAIT, selftrace.PHASE_SPINE_WAIT,
            selftrace.PHASE_INFLIGHT, selftrace.PHASE_REPORT, selftrace.PHASE_PUMP} <= set(phases)


def test_pool_flush_records_a_segment():
    """The decode pool's flush feeds ``phase_observe`` and the tracer's
    segment ring with the same phases."""
    if not native.available():
        pytest.skip(f"native ingest unavailable: {native.load_error()}")
    from opentelemetry_demo_tpu_torch.runtime import ingest_pool, otlp_export

    seen: list[str] = []
    tracer = selftrace.SelfTracer(submit=lambda b: None, sample=1.0)
    got: list = []
    pool = ingest_pool.IngestPool(
        lambda cols: got.append(cols.rows), tensorize.SpanTensorizer(8), workers=1,
        phase_observe=lambda n, dt: seen.append(n), selftrace=tracer,
    )
    body = otlp_export.encode_export_request(
        [tensorize.SpanRecord("cart", 100.0 + i, bytes([i]) * 16) for i in range(20)], t_ns=10**18
    )
    try:
        pool.submit(body).result(10.0)
        assert pool.drain(10.0)
    finally:
        pool.close()
    assert got == [20]
    assert set(ingest_pool.TOP_PHASES) <= set(seen)
    trace = tracer.begin()
    names = {s[0] for s in trace.spans}
    assert {selftrace.SPAN_DECODE, selftrace.SPAN_VERIFY, selftrace.SPAN_TENSORIZE, selftrace.SPAN_SUBMIT} <= names


# --- flight recorder ------------------------------------------------------


class TestFlightRecorder:
    def test_flight_ring_is_bounded(self):
        rec = FlightRecorder(size=64)
        for i in range(1000):
            rec.record("tick", i=i)
        events = rec.snapshot()
        assert len(events) == 64 and rec.size == 64
        assert events[-1]["i"] == 999
        totals, _dumps = rec.counts()
        assert totals["tick"] == 1000

    def test_dump_writes_evidence_and_cooldown(self, tmp_path):
        rec = FlightRecorder(size=8, dump_dir=str(tmp_path), dump_cooldown_s=60.0)
        rec.record("role", state="fenced")
        path = rec.dump("fenced")
        assert path is not None and os.path.exists(path)
        doc = json.loads(open(path).read())
        assert doc["reason"] == "fenced"
        assert [e["kind"] for e in doc["events"]] == ["role"]
        assert rec.dump("fenced") is None  # cooldown
        assert rec.dump("fenced", force=True) is not None
        assert rec.counts()[1]["fenced"] == 2

    def test_dump_without_dir_is_ring_only(self):
        rec = FlightRecorder(size=8)
        rec.record("x")
        assert rec.dump("saturated") is None

    def test_ring_snapshot_and_dump_equal_reference(self, tmp_path):
        """The same events on the same clock: equal rings, counters, dump
        file names and dump bytes."""
        clock = iter(np.arange(1000.0, 2000.0, 0.125).tolist())
        clock_ref = iter(np.arange(1000.0, 2000.0, 0.125).tolist())
        ours = FlightRecorder(size=16, dump_dir=str(tmp_path / "port"), clock=lambda: next(clock))
        ref = jflightrec.FlightRecorder(size=16, dump_dir=str(tmp_path / "ref"), clock=lambda: next(clock_ref))
        for rec in (ours, ref):
            for i in range(40):
                rec.record("brownout" if i % 3 else "role", level=i % 5, detail={"seq": i, "ok": i % 2 == 0})
        assert ours.snapshot() == ref.snapshot()
        assert ours.counts() == ref.counts()
        p_ours = ours.dump("saturated", brownout_level=3)
        p_ref = ref.dump("saturated", brownout_level=3)
        assert os.path.basename(p_ours) == os.path.basename(p_ref)
        assert open(p_ours, "rb").read() == open(p_ref, "rb").read()

    def test_unwritable_dir_counts_not_raises(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("x")
        rec = FlightRecorder(size=4, dump_dir=str(blocker / "sub"))
        rec.record("x")
        assert rec.dump("degraded") is None
        assert rec.dump_errors == 1
