"""The PyTorch port's host path against the JAX reference: OTLP bodies →
decode → tensorizer columns and batches (bit for bit) → the pipeline's
flags (identical to the reference detector's on the same stream).
"""

import json

import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import detector as jdet
from opentelemetry_demo_tpu.runtime import otlp as jotlp
from opentelemetry_demo_tpu.runtime import otlp_export as jexport
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu.runtime import wire as jwire
from opentelemetry_demo_tpu_torch.models import detector as tdet
from opentelemetry_demo_tpu_torch.models.windows import WindowClock
from opentelemetry_demo_tpu_torch.runtime import otlp, tensorize, wire
from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

SERVICES = ["frontend", "checkout", "payment", "cart", "currency", "ad"]
CFG = dict(
    num_services=8, hll_p=8, cms_width=512, warmup_batches=5.0,
    z_warmup_batches=20.0,
)


def _records(rng, n, slow=None, events=False):
    """``n`` spans over SERVICES; ``slow`` names a service whose latency
    is ten times its base."""
    out = []
    for i in range(n):
        s = int(rng.integers(0, len(SERVICES)))
        base = 200.0 * (s + 1)
        lat = float(rng.gamma(8.0, base / 8.0)) * (10.0 if SERVICES[s] == slow else 1.0)
        evs = ()
        if events and i % 17 == 0:
            evs = (tensorize.SpanEvent("exception", 12.5, (("exception.message", "boom"),)),)
        out.append(
            tensorize.SpanRecord(
                service=SERVICES[s],
                duration_us=round(lat, 3),
                trace_id=rng.bytes(16),
                is_error=bool(rng.random() < 0.02),
                attr=f"product-{int(rng.zipf(1.5)) % 40}",
                name=f"op-{s}",
                events=evs,
            )
        )
    return out


def _as_ref(records):
    return [
        jtz.SpanRecord(
            r.service, r.duration_us, r.trace_id, r.is_error, r.attr, r.name,
            tuple(jtz.SpanEvent(*e) for e in r.events),
        )
        for r in records
    ]


def _json_body(records, t_ns):
    spans_by_svc = {}
    for r in records:
        start = t_ns - int(r.duration_us * 1000)
        sp = {
            "traceId": bytes(r.trace_id).hex(),
            "name": r.name,
            "startTimeUnixNano": str(start),
            "endTimeUnixNano": str(t_ns),
            "attributes": [{"key": "app.product.id", "value": {"stringValue": r.attr}}],
            "events": [
                {
                    "name": e.name,
                    "timeUnixNano": str(start + int(e.ts_offset_us * 1000)),
                    "attributes": [{"key": k, "value": {"stringValue": v}} for k, v in e.attrs],
                }
                for e in r.events
            ],
        }
        if r.is_error:
            sp["status"] = {"code": 2}
        spans_by_svc.setdefault(r.service, []).append(sp)
    doc = {
        "resourceSpans": [
            {
                "resource": {"attributes": [{"key": "service.name", "value": {"stringValue": svc}}]},
                "scopeSpans": [{"spans": spans}],
            }
            for svc, spans in spans_by_svc.items()
        ]
    }
    return json.dumps(doc).encode()


# -- wire and OTLP decode -------------------------------------------------


def test_wire_scanner_equals_reference(rng):
    body = jexport.encode_export_request(_as_ref(_records(rng, 50, events=True)), t_ns=10**18)
    assert wire.scan_fields(body) == jwire.scan_fields(body)
    for v in (0, 1, 127, 128, 300, 2**63 - 1, -1, -(2**40)):
        assert wire.encode_varint(v) == jwire.encode_varint(v)
        assert wire.read_varint(wire.encode_varint(v), 0) == jwire.read_varint(jwire.encode_varint(v), 0)
    with pytest.raises(wire.WireError):
        wire.scan_fields(b"\x0a\xff")


def test_encoder_is_byte_identical_to_reference(rng):
    recs = _records(rng, 80, events=True)
    assert otlp.encode_export_request(recs, 10**18) == jexport.encode_export_request(
        _as_ref(recs), t_ns=10**18
    )


@pytest.mark.parametrize("encoding", ["protobuf", "json"])
def test_decode_equals_reference(rng, encoding):
    recs = _records(rng, 120, events=True)
    t_ns = 1_700_000_000_000_000_000
    if encoding == "protobuf":
        body = otlp.encode_export_request(recs, t_ns)
        got, ref = otlp.decode_export_request(body), jotlp.decode_export_request(body)
    else:
        body = _json_body(recs, t_ns)
        got, ref = otlp.decode_export_request_json(body), jotlp.decode_export_request_json(body)
    assert len(got) == len(ref) == len(recs)
    for g, r in zip(got, ref):
        assert tuple(g[:6]) == tuple(r[:6])
        assert [tuple(e) for e in g.events] == [tuple(e) for e in r.events]
    assert {(r.service, r.is_error, r.attr) for r in got} == {
        (r.service, r.is_error, r.attr) for r in recs
    }


def test_malformed_protobuf_raises_wire_error():
    with pytest.raises(ValueError):
        otlp.decode_export_request(b"\x0a\x03\x08\x01\x10")


# -- tensorizer ------------------------------------------------------------


def test_columns_and_batches_equal_reference(rng):
    body = otlp.encode_export_request(_records(rng, 700, events=True), 10**18)
    got_tz = tensorize.SpanTensorizer(num_services=8, batch_size=256)
    ref_tz = jtz.SpanTensorizer(num_services=8, batch_size=256)
    got_cols = got_tz.columns_from_records(otlp.decode_export_request(body))
    ref_cols = ref_tz.columns_from_records(jotlp.decode_export_request(body))
    for name, g, r in zip(jtz.SpanColumns._fields, got_cols, ref_cols):
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    assert got_tz.service_names == ref_tz.service_names
    got_b = got_tz.tensorize(otlp.decode_export_request(body))
    ref_b = ref_tz.tensorize(jotlp.decode_export_request(body))
    assert len(got_b) == len(ref_b) == 3
    for gb, rb in zip(got_b, ref_b):
        for name, g, r in zip(jtz.TensorBatch._fields, gb, rb):
            assert g.dtype == r.dtype, name
            np.testing.assert_array_equal(g, r, err_msg=name)


def test_interner_overflow_equals_reference():
    got = tensorize.SpanTensorizer(num_services=4, batch_size=16)
    ref = jtz.SpanTensorizer(num_services=4, batch_size=16)
    names = ["a", "b", "a", "c", "d", "e", "c", "b"]
    assert [got.service_id(n) for n in names] == [ref.service_id(n) for n in names]
    assert got.service_names == ref.service_names == ["a", "b", "c"]
    assert got.overflow_assigns_total == 2


@pytest.mark.parametrize("n,width", [(0, 64), (5, 64), (64, 64), (3, 128)])
def test_pack_arrays_equals_reference(rng, n, width):
    svc = rng.integers(0, 8, n).astype(np.int32)
    lat = rng.random(n).astype(np.float32)
    tid = rng.integers(0, 2**63, n, dtype=np.uint64)
    attr = rng.integers(0, 2**32, n, dtype=np.uint64)
    kw = dict(is_error=(rng.random(n) < 0.5).astype(np.float32), attr_key=attr, width=width)
    got = tensorize.SpanTensorizer(8, 64).pack_arrays(svc, lat, tid, **kw)
    ref = jtz.SpanTensorizer(8, 64).pack_arrays(svc, lat, tid, **kw)
    for name, g, r in zip(jtz.TensorBatch._fields, got, ref):
        np.testing.assert_array_equal(g, r, err_msg=name)
    with pytest.raises(ValueError, match="exceeds batch width"):
        tensorize.SpanTensorizer(8, 4).pack_arrays(
            np.zeros(9, np.int32), np.zeros(9, np.float32), np.zeros(9, np.uint64)
        )


def test_window_clock_equals_reference():
    from opentelemetry_demo_tpu.models.windows import WindowClock as JWindowClock

    got, ref = WindowClock((1.0, 10.0, 60.0)), JWindowClock((1.0, 10.0, 60.0))
    for t in (9.5, 10.2, 10.7, 61.0, 61.0, 200.3):
        (gd, gr), (rd, rr) = got.tick(t), ref.tick(t)
        assert gd == rd
        np.testing.assert_array_equal(gr, rr)


# -- the pipeline ------------------------------------------------------------


def _stream(rng, n_batches, per_batch, fault_at, slow="payment"):
    """Protobuf export bodies, one per batch interval; from ``fault_at``
    on, ``slow`` runs ten times slower."""
    return [
        otlp.encode_export_request(
            _records(rng, per_batch, slow=slow if k >= fault_at else None),
            10**18 + k * 250_000_000,
        )
        for k in range(n_batches)
    ]


def test_pipeline_flags_equal_reference_detector(rng):
    """OTLP bodies → decode → pipeline (one batch per pump) on the CPU;
    the reference detector gets the same stream, packed by the
    reference tensorizer. Every harvested report's flags match, and the
    injected latency fault flags the slow service."""
    b, n_batches, fault_at = 256, 70, 50
    bodies = _stream(rng, n_batches, b, fault_at)
    seen = []
    pipe = DetectorPipeline(
        tdet.AnomalyDetector(tdet.DetectorConfig(**CFG), device="cpu"),
        on_report=lambda t, rep, names: seen.append((t, rep.flags.copy(), names)),
        batch_size=b,
    )
    ref_det = jdet.AnomalyDetector(jdet.DetectorConfig(**CFG))
    ref_tz = jtz.SpanTensorizer(num_services=8, batch_size=b)
    ref_flags = []
    for k, body in enumerate(bodies):
        t = k * 0.25
        pipe.submit(otlp.decode_export_request(body))
        pipe.pump(t)
        (batch,) = ref_tz.tensorize(jotlp.decode_export_request(body))
        ref_flags.append(np.asarray(ref_det.observe(batch, t).flags))
    pipe.drain()
    assert [t for t, _, _ in seen] == [k * 0.25 for k in range(n_batches)]
    for k, ((_, flags, names), want) in enumerate(zip(seen, ref_flags)):
        np.testing.assert_array_equal(flags, want, err_msg=f"batch {k}")
        assert names == [ref_tz.service_names[i] for i in np.nonzero(want)[0]]
    assert not any(f.any() for _, f, _ in seen[:fault_at])
    assert any("payment" in names for _, _, names in seen[fault_at:])
    assert pipe.stats.batches == n_batches and pipe.stats.spans == n_batches * b
    assert len(pipe.stats.lag_ms) == n_batches
    assert pipe.pending_rows() == 0


def test_pipeline_splits_backlog_into_full_batches(rng):
    reports = []
    pipe = DetectorPipeline(
        tdet.AnomalyDetector(tdet.DetectorConfig(**CFG), device="cpu"),
        on_report=lambda t, rep, names: reports.append(rep.svc_count.sum()),
        batch_size=128,
    )
    pipe.submit(_records(rng, 300))
    pipe.submit([])
    assert pipe.pending_rows() == 300
    pipe.pump(1.0)
    assert pipe.pending_rows() == 172
    pipe.drain()
    assert pipe.stats.batches == 3 and pipe.stats.spans == 300
    assert reports == [128.0, 128.0, 44.0]
    pipe.pump(2.0)  # idle pump: nothing to dispatch, nothing to read
    assert pipe.stats.batches == 3 and pipe.stats.lag_p99_ms() >= 0.0


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_pipeline_on_the_card_flags_as_the_cpu(rng, cuda_device):
    b = 256
    bodies = _stream(rng, 60, b, 45)
    runs = []
    for device in (cuda_device, "cpu"):
        seen = []
        pipe = DetectorPipeline(
            tdet.AnomalyDetector(tdet.DetectorConfig(**CFG), device=device),
            on_report=lambda t, rep, names, seen=seen: seen.append(rep.flags.copy()),
            batch_size=b,
        )
        for k, body in enumerate(bodies):
            pipe.submit(otlp.decode_export_request(body))
            pipe.pump(k * 0.25)
        pipe.drain()
        runs.append(np.stack(seen))
    np.testing.assert_array_equal(runs[0], runs[1])
