"""The port's verdict provenance against the JAX reference: bundle ids,
the engine's assembly, the bundles two pipelines build from the same
seeded stream with a fault, the flag-time state snapshot they cite, the
``query_meta`` block with its bundles crossing between the packages, and
the log documents the bundles are exported as.

Tolerance: ids, signals, heads, exemplars, top-k keys and counts, and
encoded bytes compare exactly; the float fields of bundles (trajectories,
EWMA and CUSUM state, cardinality estimates) at rtol 1e-4, atol 1e-5;
flags identical. A bundle's state block against ``state_to_numpy`` of
the same detector at the same step compares exactly.
"""

from __future__ import annotations

import json
import re
from types import SimpleNamespace

import numpy as np
import pytest

from opentelemetry_demo_tpu.models import detector as jdet
from opentelemetry_demo_tpu.runtime import otlp_export as jexport
from opentelemetry_demo_tpu.runtime import pipeline as jpipeline
from opentelemetry_demo_tpu.runtime import provenance as jprov
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu_torch.models import detector as tdet
from opentelemetry_demo_tpu_torch.runtime import otlp_export, tensorize
from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
from opentelemetry_demo_tpu_torch.runtime.provenance import (
    HEAD_CUSUM,
    HEAD_EWMA_Z,
    HEAD_FOR_REASON,
    REASON_CUSUM,
    REASON_LATENCY,
    ProvenanceEngine,
    bundle_id,
    log_doc,
)

RTOL, ATOL = 1e-4, 1e-5
SMALL = dict(num_services=8, hll_p=8, cms_width=512)
FLAGGY = dict(SMALL, warmup_batches=2.0, z_warmup_batches=3.0)
NAMES = ("frontend", "cart", "checkout", "currency", "payment", "email")


def _stream(n_batches=30, rows=64, fault_from=15, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        cols = dict(
            svc=(rng.integers(0, 20, rows) % len(NAMES)).astype(np.int32),
            lat_us=rng.gamma(4.0, 250.0, rows).astype(np.float32),
            is_error=(rng.random(rows) < 0.02).astype(np.float32),
            trace_key=rng.integers(0, 2**63, rows, dtype=np.uint64),
            attr_crc=(rng.zipf(1.6, rows) % 50).astype(np.uint64),
        )
        if fault_from is not None and i >= fault_from:
            cols["lat_us"][cols["svc"] == 3] *= 10_000.0
        out.append(cols)
    return out


def _pipe(which, provenance_on=True, cfg=FLAGGY, **kw):
    if which == "port":
        det = tdet.AnomalyDetector(tdet.DetectorConfig(**cfg), device="cpu")
        prov = ProvenanceEngine(det.config) if provenance_on else None
        pipe = DetectorPipeline(det, batch_size=64, provenance=prov, **kw)
    else:
        det = jdet.AnomalyDetector(jdet.DetectorConfig(**cfg))
        prov = jprov.ProvenanceEngine(det.config) if provenance_on else None
        pipe = jpipeline.DetectorPipeline(det, batch_size=64, provenance=prov, **kw)
    for n in NAMES:
        pipe.tensorizer.service_id(n)
    return pipe


def _feed(pipe, stream, cols_t, on_step=None):
    t = 0.0
    for cols in stream:
        pipe.submit_columns(cols_t(**cols))
        pipe.pump(t)
        pipe.drain()
        if on_step is not None:
            on_step(pipe)
        t += 0.25


@pytest.fixture(scope="module")
def twin():
    stream = _stream()
    port = _pipe("port")
    ref = _pipe("reference")
    _feed(port, stream, tensorize.SpanColumns)
    _feed(ref, stream, jtz.SpanColumns)
    return port, ref


def _close(a, b, path="bundle"):
    """Exact for ints, strings and structure; floats at RTOL/ATOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, set(a) ^ set(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert b == pytest.approx(a, rel=RTOL, abs=ATOL), path
    else:
        assert a == b, path


# --- ids and the engine ---------------------------------------------------


class TestBundleId:
    def test_pure_function_of_replicated_coordinates(self):
        assert bundle_id(1, 42, 3) == bundle_id(1, 42, 3)
        assert re.fullmatch(r"[0-9a-f]{16}", bundle_id(1, 42, 3))

    def test_nearby_triples_do_not_collide(self):
        ids = {bundle_id(e, s, v) for e in range(3) for s in range(16) for v in range(8)}
        assert len(ids) == 3 * 16 * 8

    @pytest.mark.parametrize("epoch,seq,svc", [(0, 0, 0), (1, 42, 3), (7, 2**31 - 1, 31), (3, 99, 0)])
    def test_ids_equal_reference(self, epoch, seq, svc):
        assert bundle_id(epoch, seq, svc) == jprov.bundle_id(epoch, seq, svc)


def _fake_report(k: float, n: int = 8):
    return SimpleNamespace(lat_z=np.full(n, k, np.float32), cusum=np.zeros((n, 3), np.float32))


class TestEngine:
    def test_build_without_state_degrades_not_refuses(self):
        eng = ProvenanceEngine(tdet.DetectorConfig(**SMALL), topk=5, trajectory_windows=4, epoch_fn=lambda: 7)
        for k in range(6):
            eng.observe_report(float(k), _fake_report(0.5 + k))
        b = eng.build(
            t_batch=5.0, seq=9, service=3, label="currency",
            signals=[REASON_LATENCY, REASON_CUSUM], exemplars=["aa" * 8], state=None,
            hh_candidates=[], trace_id=None,
        )
        assert b["id"] == bundle_id(7, 9, 3)
        assert b["service"] == "currency" and b["service_id"] == 3
        assert b["heads"] == sorted({HEAD_EWMA_Z, HEAD_CUSUM})
        assert len(b["trajectory"]) == 4
        assert b["trajectory"][-1]["lat_z"] == [pytest.approx(5.5)]
        assert "ewma" not in b and "top_keys" not in b
        json.dumps(b)

    def test_head_mapping_is_total_over_reasons(self):
        eng = ProvenanceEngine(tdet.DetectorConfig(**SMALL))
        b = eng.build(
            t_batch=0.0, seq=0, service=0, label="frontend", signals=list(HEAD_FOR_REASON),
            exemplars=[], state=None, hh_candidates=[], trace_id=None,
        )
        assert b["heads"] == sorted(set(HEAD_FOR_REASON.values()))
        b2 = eng.build(
            t_batch=0.0, seq=1, service=0, label="frontend", signals=["not-a-reason"],
            exemplars=[], state=None, hh_candidates=[], trace_id=None,
        )
        assert b2["heads"] == []
        assert HEAD_FOR_REASON == jprov.HEAD_FOR_REASON

    def test_engine_bundles_equal_reference_on_one_state(self):
        """Both engines over the same numpy state and trajectory: the same
        bundle, state block included."""
        rng = np.random.default_rng(3)
        cfg = dict(SMALL)
        state = {
            "lat_mean": rng.random((8, 3)).astype(np.float32),
            "lat_var": rng.random((8, 3)).astype(np.float32),
            "err_mean": rng.random((8, 3)).astype(np.float32),
            "rate_mean": rng.random((8, 3)).astype(np.float32),
            "rate_var": rng.random((8, 3)).astype(np.float32),
            "card_mean": rng.random((8, 3)).astype(np.float32) * 50,
            "card_var": rng.random((8, 3)).astype(np.float32),
            "cusum": rng.random((8, 3)).astype(np.float32) * 9,
            "cms_bank": rng.integers(0, 40, (3, 2, 4, 512)).astype(np.int32),
            "hll_bank": rng.integers(0, 12, (3, 2, 8, 256)).astype(np.int32),
            "span_total": rng.random((3, 2)).astype(np.float32) * 1e4,
            "step_idx": np.asarray(17, np.int32),
        }
        ours = ProvenanceEngine(tdet.DetectorConfig(**cfg), topk=3, trajectory_windows=5)
        ref = jprov.ProvenanceEngine(jdet.DetectorConfig(**cfg), topk=3, trajectory_windows=5)
        for k in range(7):
            rep = SimpleNamespace(**{
                n: rng.normal(0, 2, (8, 3)).astype(np.float32)
                for n in ("lat_z", "err_z", "rate_z", "card_z", "card_est", "cusum")
            })
            ours.observe_report(float(k), rep)
            ref.observe_report(float(k), rep)
        kw = dict(
            t_batch=6.0, seq=17, service=2, label="checkout", signals=["latency", "cardinality", "cusum"],
            exemplars=["ab" * 8], state=state, hh_candidates=[5, 1, 9, 33, 2], trace_id="cd" * 16,
        )
        assert ours.build(**kw) == ref.build(**kw)

    def test_log_doc_bytes_equal_reference(self):
        eng = ProvenanceEngine(tdet.DetectorConfig(**SMALL))
        b = eng.build(
            t_batch=3.0, seq=2, service=1, label="cart", signals=[REASON_LATENCY], exemplars=["ab" * 8] * 7,
            state=None, hh_candidates=[], trace_id="cd" * 16,
        )
        doc = log_doc(b)
        assert doc.attrs["anomaly.bundle_id"] == b["id"]
        assert doc.trace_id == bytes.fromhex("cd" * 16)
        assert b["id"] in doc.body and "cart" in doc.body
        ours = otlp_export.encode_logs_request([doc, log_doc(dict(b, selftrace=None))], t_ns=10**18)
        ref = jexport.encode_logs_request([jprov.log_doc(b), jprov.log_doc(dict(b, selftrace=None))], t_ns=10**18)
        assert ours == ref and b["id"].encode() in ours

    def test_build_latency_samples_drain_once(self):
        eng = ProvenanceEngine(tdet.DetectorConfig(**SMALL))
        eng.build(
            t_batch=0.0, seq=0, service=0, label="a", signals=[], exemplars=[], state=None,
            hh_candidates=[], trace_id=None,
        )
        samples = eng.take_build_samples()
        assert len(samples) == 1 and samples[0] >= 0.0
        assert eng.take_build_samples() == []


# --- two pipelines, one stream --------------------------------------------


def test_both_pipelines_flag_the_same_batches(twin):
    port, ref = twin
    assert port.stats.flag_events == ref.stats.flag_events > 0
    evs_p = [(e["service"], e["signals"], e["exemplars"], e["bundle"]) for e in port.query_meta()["anomalies"]]
    evs_r = [(e["service"], e["signals"], e["exemplars"], e["bundle"]) for e in ref.query_meta()["anomalies"]]
    assert evs_p == evs_r
    assert {e[0] for e in evs_p} == {3}


def test_bundles_equal_reference(twin):
    """Same ids, signals, heads, trajectories, top-k contributors and
    state block from both pipelines."""
    port, ref = twin
    bp, br = port.query_meta()["explains"], ref.query_meta()["explains"]
    assert len(bp) == len(br) == port.explanations_built == ref.explanations_built > 0
    for a, b in zip(bp, br):
        assert {"ewma", "cusum", "cardinality", "top_keys"} <= a.keys()
        assert a["top_keys"], "candidates must have been captured"
        _close(a, b)


def test_bundle_state_block_is_the_flag_time_state():
    """Harvesting synchronously with nothing in flight, each bundle's
    state block equals one built from ``state_to_numpy`` of the detector
    at the same step, exactly."""
    pipe = _pipe("port")
    snaps = {}

    def on_step(p):
        snaps[int(p.detector.state.step_idx)] = tdet.state_to_numpy(p.detector.state)

    _feed(pipe, _stream(), tensorize.SpanColumns, on_step)
    bundles = pipe.query_meta()["explains"]
    assert bundles
    eng = ProvenanceEngine(pipe.detector.config)
    for b in bundles:
        state = snaps[b["seq"]]
        want = {}
        eng._attach_state(want, state._asdict(), b["service_id"], [int(k["attr_crc"], 16) for k in b["top_keys"]])
        for key in ("ewma", "cusum", "cardinality"):
            assert b[key] == want[key]
        assert [k["counts"] for k in b["top_keys"]] == [
            next(w for w in want["top_keys"] if w["attr_crc"] == k["attr_crc"])["counts"] for k in b["top_keys"]
        ]
    assert pipe.stats.provenance_misses == 0


def test_state_snapshot_dtypes_and_values():
    pipe = _pipe("port", cfg=SMALL)
    _feed(pipe, _stream(n_batches=4, fault_from=None), tensorize.SpanColumns)
    arrays, t_prev = pipe.state_snapshot()
    want = tdet.state_to_numpy(pipe.detector.state)
    assert list(arrays) == list(tdet.DetectorState._fields)
    for name in tdet.DetectorState._fields:
        a, w = arrays[name], getattr(want, name)
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert np.array_equal(a, w), name
    assert arrays["hll_bank"].dtype == np.int32 and arrays["lat_mean"].dtype == np.float32
    assert arrays["step_idx"].shape == () and int(arrays["step_idx"]) == 4
    assert t_prev == pipe.detector.clock._t_prev == 0.75


def test_disabled_provenance_still_flags():
    pipe = _pipe("port", provenance_on=False)
    _feed(pipe, _stream(), tensorize.SpanColumns)
    meta = pipe.query_meta()
    assert pipe.stats.flag_events > 0
    assert meta["explains"] == [] and meta["explanations_built"] == 0
    assert all(e["bundle"] is None for e in meta["anomalies"])
    assert pipe.take_explain_exports() == []


def test_failed_snapshot_costs_the_state_block_and_is_counted():
    pipe = _pipe("port")

    def boom():
        raise RuntimeError("copy failed")

    pipe.state_snapshot = boom
    _feed(pipe, _stream(), tensorize.SpanColumns)
    bundles = pipe.query_meta()["explains"]
    assert bundles and pipe.stats.provenance_misses == pipe.stats.flag_events
    for b in bundles:
        assert "ewma" not in b and "top_keys" not in b
        assert b["seq"] > 0 and b["trajectory"]


def test_take_explain_exports_drains_once_and_is_bounded():
    pipe = _pipe("port", explain_ring=4)
    _feed(pipe, _stream(), tensorize.SpanColumns)
    built = pipe.explanations_built
    assert built > 4
    out = pipe.take_explain_exports()
    assert len(out) == 4  # drop-oldest at the ring bound
    assert [b["id"] for b in out] == [b["id"] for b in pipe.query_meta()["explains"]]
    assert pipe.take_explain_exports() == []


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_query_meta_with_explains_restores_across_packages(twin, direction):
    port, ref = twin
    src = port if direction == "port_to_reference" else ref
    block = json.loads(json.dumps(src.query_meta()))
    dst = _pipe("reference" if direction == "port_to_reference" else "port")
    dst.restore_query_meta(block)
    got = dst.query_meta()
    for key in ("exemplars", "anomalies", "hh_candidates", "explains"):
        assert got[key] == block[key], key
    # Process counters are never restored.
    assert got["exemplars_captured"] == 0 and got["explanations_built"] == 0
