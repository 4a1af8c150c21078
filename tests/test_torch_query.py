"""The port's query plane against the JAX reference.

Engines over the same state (the JAX detector's, and the port's after
``state_from_numpy`` with the same ``query_meta`` block) answer every
endpoint with the same document, error answers included, through
``dispatch``, over HTTP and through the gRPC twin. Beside that: the
engine's snapshot lifecycle, the pipeline's query capture, the HTTP
surface's refusals, a refresh hammered against live dispatch, the
snapshot helper naming the steps' stream, and querybench on the CPU.

Tolerance: documents over the same state compare exactly, apart from the
fields that carry each process's wall clock (``meta.staleness_s``, the
timeline's ``t`` and the Grafana datapoints' timestamps), which are
dropped before the comparison. Statuses and error documents compare
exactly.
"""

from __future__ import annotations

import ast
import http.client
import json
import re
import threading
import time
from pathlib import Path
from urllib.parse import urlencode

import jax
import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import detector as jdet
from opentelemetry_demo_tpu.runtime import flightrec as jflightrec
from opentelemetry_demo_tpu.runtime import pipeline as jpipeline
from opentelemetry_demo_tpu.runtime import provenance as jprov
from opentelemetry_demo_tpu.runtime import query as jquery
from opentelemetry_demo_tpu.runtime import querybench as jquerybench
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu_torch.models import detector as tdet
from opentelemetry_demo_tpu_torch.ops import cms, hll
from opentelemetry_demo_tpu_torch.runtime import flightrec, hostcopy, query, querybench, tensorize
from opentelemetry_demo_tpu_torch.runtime import pipeline as pipeline_mod
from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
from opentelemetry_demo_tpu_torch.runtime.provenance import ProvenanceEngine
from opentelemetry_demo_tpu_torch.runtime.query import QueryEngine, QueryError, dispatch
from opentelemetry_demo_tpu_torch.runtime.querybench import state_snapshot_fn
from opentelemetry_demo_tpu_torch.telemetry import MetricRegistry

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(num_services=8, hll_p=8, cms_width=512)
NAMES = ("frontend", "cart", "checkout", "currency", "payment", "email")
TIMEOUT_S = 10.0


def _cols(rng, rows, fault=False):
    cols = dict(
        svc=(rng.integers(0, 20, rows) % len(NAMES)).astype(np.int32),
        lat_us=rng.gamma(4.0, 250.0, rows).astype(np.float32),
        is_error=(rng.random(rows) < 0.02).astype(np.float32),
        trace_key=rng.integers(0, 2**63, rows, dtype=np.uint64),
        attr_crc=(rng.zipf(1.6, rows) % 50).astype(np.uint64),
    )
    if fault:
        cols["lat_us"][cols["svc"] == 3] *= 1000.0
    return cols


def _port_pipe(cfg=SMALL, **kw):
    pipe = DetectorPipeline(tdet.AnomalyDetector(tdet.DetectorConfig(**cfg), device="cpu"), **kw)
    for n in NAMES:
        pipe.tensorizer.service_id(n)
    return pipe


def _flight(mod):
    clock = iter(np.arange(5000.0, 6000.0, 0.5).tolist())
    rec = mod.FlightRecorder(size=32, clock=lambda: next(clock))
    for i in range(12):
        rec.record("brownout" if i % 2 else "role", level=i, state="ok")
    return rec


# --- the same state behind both engines ---------------------------------


class World:
    """The JAX pipeline fed a stream with a fault on ``currency``, and the
    port's pipeline holding the same state and query block; an engine, an
    HTTP service and a gRPC twin over each."""

    def __init__(self):
        cfg = dict(SMALL, warmup_batches=2.0, z_warmup_batches=3.0)
        rdet = jdet.AnomalyDetector(jdet.DetectorConfig(**cfg))
        rpipe = jpipeline.DetectorPipeline(
            rdet, batch_size=128, exemplar_ring=4, provenance=jprov.ProvenanceEngine(rdet.config),
        )
        for n in NAMES:
            rpipe.tensorizer.service_id(n)
        rng = np.random.default_rng(5)
        t = 0.0
        for i in range(40):
            rpipe.submit_columns(jtz.SpanColumns(**_cols(rng, 128, fault=i >= 25)))
            rpipe.pump(t)
            rpipe.drain()
            t += 0.25
        assert rpipe.stats.flag_events > 0
        pdet = tdet.AnomalyDetector(tdet.DetectorConfig(**cfg), device="cpu")
        pdet.state = tdet.state_from_numpy(jax.device_get(rdet.state), device="cpu")
        pdet.clock._t_prev = rdet.clock._t_prev
        ppipe = DetectorPipeline(pdet, batch_size=128, exemplar_ring=4, provenance=ProvenanceEngine(pdet.config))
        for n in NAMES:
            ppipe.tensorizer.service_id(n)
        block = json.loads(json.dumps(rpipe.query_meta()))
        ppipe.restore_query_meta(block)
        # The process counters are not restored; copy them so the two
        # query blocks are the same.
        ppipe.exemplars_captured = rpipe.exemplars_captured
        ppipe.explanations_built = rpipe.explanations_built
        self.ref_pipe, self.port_pipe, self.block = rpipe, ppipe, block
        self.ref = jquery.QueryEngine(
            snapshot_fn=jquerybench._snapshot_fn(rdet, rpipe), flight_fn=_flight(jflightrec).snapshot,
        )
        self.port = QueryEngine(snapshot_fn=state_snapshot_fn(ppipe), flight_fn=_flight(flightrec).snapshot)
        self.registry = MetricRegistry()
        self.ref_http = jquery.QueryService(self.ref, host="127.0.0.1", port=0)
        self.port_http = query.QueryService(self.port, registry=self.registry, host="127.0.0.1", port=0)
        self.ref_grpc = self.port_grpc = None
        self._started = []
        for svc in (self.ref_http, self.port_http):
            svc.start()
            self._started.append(svc)
        try:
            import grpc  # noqa: F401
        except ImportError:
            return
        self.ref_grpc = jquery.QueryGrpcService(self.ref, host="127.0.0.1", port=0)
        self.port_grpc = query.QueryGrpcService(self.port, registry=self.registry, host="127.0.0.1", port=0)
        for svc in (self.ref_grpc, self.port_grpc):
            svc.start()
            self._started.append(svc)

    def stop(self):
        for svc in self._started:
            svc.stop()


@pytest.fixture(scope="module")
def world():
    w = World()
    try:
        yield w
    finally:
        w.stop()


def _http(port, method, path, params):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        if method == "GET":
            conn.request("GET", path + ("?" + urlencode(params) if params else ""))
        else:
            conn.request("POST", path, body=json.dumps(params), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


_GRPC_STATUS = {"OK": 200, "NOT_FOUND": 404, "INVALID_ARGUMENT": 400, "UNAVAILABLE": 503}


def _grpc(mod, target, path, params):
    """One Query RPC as ``grpc_query`` makes it, with a deadline."""
    import grpc

    with grpc.insecure_channel(target) as channel:
        call = channel.unary_unary(mod.GRPC_QUERY_METHOD, request_serializer=None, response_deserializer=None)
        try:
            raw = call(json.dumps({"path": path, "params": params}).encode(), timeout=TIMEOUT_S)
        except grpc.RpcError as e:
            return _GRPC_STATUS.get(e.code().name, -1), {"error": e.details()}
    return 200, json.loads(raw.decode())


def _ask(world, side, transport, method, path, params):
    if transport == "dispatch":
        if side == "port":
            return dispatch(world.port, path, dict(params))
        return jquery.dispatch(world.ref, path, dict(params))
    if transport == "http":
        svc = world.port_http if side == "port" else world.ref_http
        return _http(svc.port, method, path, params)
    if world.port_grpc is None:
        pytest.skip("grpcio is not installed")
    svc = world.port_grpc if side == "port" else world.ref_grpc
    mod = query if side == "port" else jquery
    return _grpc(mod, f"127.0.0.1:{svc.port}", path, params)


def _norm(doc):
    """Drop the fields that carry a process's wall clock."""
    doc = json.loads(json.dumps(doc))
    if isinstance(doc, dict):
        (doc.get("meta") or {}).pop("staleness_s", None)
        data = doc.get("data")
        if isinstance(data, dict):
            for e in data.get("timeline") or []:
                e.pop("t", None)
    if isinstance(doc, list):
        for series in doc:
            if isinstance(series, dict) and "datapoints" in series:
                series["datapoints"] = [v for v, _t in series["datapoints"]]
    return doc


DOC_CASES = [
    ("GET", "/", {}),
    ("GET", "/query/services", {}),
    ("GET", "/query/topk", {"service": "currency", "k": "5"}),
    ("GET", "/query/topk", {"service": "cart", "window": "0"}),
    ("GET", "/query/cardinality", {"service": "cart"}),
    ("GET", "/query/zscore", {"service": "currency"}),
    ("GET", "/query/zscore", {"service": "svc-7"}),
    ("GET", "/query/anomalies", {}),
    ("GET", "/query/anomalies", {"service": "currency", "limit": "2"}),
    ("GET", "/query/explain", {}),
    ("GET", "/query/explain", {"service": "currency", "limit": "1"}),
    ("GET", "/query/explain", {"id": "{bundle}"}),
    ("GET", "/query/flight", {"limit": "5"}),
    ("POST", "/search", {}),
    ("POST", "/query", {
        "range": {"from": "2020-01-01T00:00:00Z", "to": "2099-01-01T00:00:00Z"},
        "targets": [
            {"target": "cardinality:frontend"}, {"target": "cusum:currency"},
            {"target": "topk:currency"}, {"target": "anomalies"}, {"target": "flight"},
        ],
    }),
    ("POST", "/annotations", {"annotation": {"name": "anomalies", "query": "anomalies"}}),
]

ERR_CASES = [
    ("GET", "/query/topk", {}),
    ("GET", "/query/topk", {"service": "ghost"}),
    ("GET", "/query/zscore", {"service": "svc--1"}),
    ("GET", "/query/cardinality", {"service": "svc--1"}),
    ("GET", "/query/topk", {"service": "cart", "k": "x"}),
    ("GET", "/query/topk", {"service": "cart", "window": "9"}),
    ("GET", "/query/cardinality", {"service": "cart", "from": "1700000000"}),
    ("GET", "/query/topk", {"service": "cart", "from": "2020-01-01T00:00:00Z", "to": "2020-01-02T00:00:00Z"}),
    ("GET", "/query/zscore", {"service": "cart", "from": "1700000000000", "to": "1700000100000"}),
    ("GET", "/query/zscore", {"service": "cart", "to": "1700000000"}),
    ("GET", "/query/anomalies", {"from": "yesterday"}),
    ("GET", "/query/explain", {"from": "1700000000000"}),
    ("GET", "/query/anomalies", {"limit": "many"}),
    ("GET", "/query/topk", {"service": "cart", "from": "1700000000", "resolution": "fast"}),
    ("GET", "/nope", {}),
    ("POST", "/query", {"targets": [{"target": "bogus:x"}]}),
    ("POST", "/query", {"targets": [{"target": "cardinality:ghost"}]}),
]


def _fill(world, params):
    bundle = world.block["explains"][0]["id"]
    return {k: v.replace("{bundle}", bundle) if isinstance(v, str) else v for k, v in params.items()}


@pytest.mark.parametrize("transport", ["dispatch", "http", "grpc"])
@pytest.mark.parametrize("method,path,params", DOC_CASES, ids=[f"{c[1]}-{i}" for i, c in enumerate(DOC_CASES)])
def test_documents_equal_reference(world, transport, method, path, params):
    params = _fill(world, params)
    s_port, d_port = _ask(world, "port", transport, method, path, params)
    s_ref, d_ref = _ask(world, "reference", transport, method, path, params)
    assert s_port == s_ref == 200, (d_port, d_ref)
    assert _norm(d_port) == _norm(d_ref)


@pytest.mark.parametrize("transport", ["dispatch", "http", "grpc"])
@pytest.mark.parametrize("method,path,params", ERR_CASES, ids=[f"{c[1]}-{i}" for i, c in enumerate(ERR_CASES)])
def test_error_answers_equal_reference(world, transport, method, path, params):
    s_port, d_port = _ask(world, "port", transport, method, path, params)
    s_ref, d_ref = _ask(world, "reference", transport, method, path, params)
    assert s_port == s_ref and s_port in (400, 404)
    assert d_port == d_ref


def test_range_queries_answer_the_no_history_404(world):
    for path in ("/query/topk", "/query/cardinality", "/query/zscore"):
        status, doc = dispatch(world.port, path, {"service": "cart", "from": "1700000000"})
        assert (status, doc) == (404, {"error": "history tier not configured"})


def test_live_answers_carry_the_envelope(world):
    status, doc = dispatch(world.port, "/query/services", {})
    assert status == 200
    assert set(NAMES) <= set(doc["data"]["services"])
    meta = doc["meta"]
    assert meta["role"] == "primary" and meta["source"] == "live"
    assert meta["seq"] == 40 and 0.0 <= meta["staleness_s"] < 5.0
    status, doc = dispatch(world.port, "/query/anomalies", {})
    events = doc["data"]["events"]
    assert events and all(e["service"] == "currency" for e in events)
    flagged = next(e for e in events if e["exemplars"])
    assert re.fullmatch(r"[0-9a-f]{16}", flagged["exemplars"][0])
    assert flagged["bundle"] and flagged["trace_urls"][0].endswith(flagged["exemplars"][0])


def test_grpc_query_helper(world):
    """``grpc_query`` answers what HTTP answers (run on a thread joined
    with a deadline: the helper sets none)."""
    if world.port_grpc is None:
        pytest.skip("grpcio is not installed")
    out = {}
    th = threading.Thread(target=lambda: out.update(doc=query.grpc_query(
        f"127.0.0.1:{world.port_grpc.port}", "/query/cardinality", {"service": "cart"})), daemon=True)
    th.start()
    th.join(TIMEOUT_S)
    assert "doc" in out, "grpc_query did not answer in time"
    _status, http_doc = _http(world.port_http.port, "GET", "/query/cardinality", {"service": "cart"})
    assert out["doc"]["data"]["estimate"] == http_doc["data"]["estimate"]


def test_flight_not_wired_is_404_both_ways(world):
    ours = QueryEngine(snapshot_fn=lambda: ({}, {}))
    ref = jquery.QueryEngine(snapshot_fn=lambda: ({}, {}))
    assert dispatch(ours, "/query/flight", {}) == jquery.dispatch(ref, "/query/flight", {})
    assert dispatch(ours, "/query/flight", {})[0] == 404


def test_no_state_yet_is_503():
    ours = QueryEngine(snapshot_fn=lambda: ({}, {}))
    ref = jquery.QueryEngine(snapshot_fn=lambda: ({}, {}))
    got = dispatch(ours, "/query/services", {})
    assert got == jquery.dispatch(ref, "/query/services", {})
    assert got[0] == 503 and "error" in got[1]


def test_self_observability_on_the_registry(world):
    _http(world.port_http.port, "GET", "/query/services", {})
    _http(world.port_http.port, "GET", "/query/topk", {"service": "ghost"})
    _http(world.port_http.port, "GET", "/query/flight", {})
    text = world.registry.render()
    assert 'anomaly_query_requests_total{code="200",endpoint="/query/services"}' in text
    assert 'anomaly_query_requests_total{code="404",endpoint="/query/topk"}' in text
    assert "anomaly_query_latency_seconds_bucket" in text
    assert "anomaly_query_staleness_seconds " in text
    assert "anomaly_query_answer_staleness_seconds_count" in text


# --- the HTTP surface's refusals ----------------------------------------


def _raw(port, content_length):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.putrequest("POST", "/query")
        conn.putheader("Content-Length", content_length)
        conn.endheaders()
        resp = conn.getresponse()
        return resp.status, dict(resp.headers), resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("side", ["port", "reference"])
def test_oversized_post_refused_unread(world, side):
    port = (world.port_http if side == "port" else world.ref_http).port
    status, headers, _body = _raw(port, str(64 << 20))
    assert status == 413
    assert headers.get("Access-Control-Allow-Origin") == "*"  # CORS on errors too


@pytest.mark.parametrize("length", ["12abc", "-1"])
def test_malformed_content_length_closes_keepalive(world, length):
    status, headers, body = _raw(world.port_http.port, length)
    assert status == 400 and headers.get("Connection") == "close"
    assert (status, body) == _raw(world.ref_http.port, length)[::2]


def test_malformed_json_body_is_400(world):
    conn = http.client.HTTPConnection("127.0.0.1", world.port_http.port, timeout=TIMEOUT_S)
    try:
        conn.request("POST", "/query", body=b"[1, 2", headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 400 and json.loads(resp.read()) == {"error": "malformed JSON body"}
    finally:
        conn.close()


def test_cors_preflight(world):
    conn = http.client.HTTPConnection("127.0.0.1", world.port_http.port, timeout=TIMEOUT_S)
    try:
        conn.request("OPTIONS", "/query")
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 204
        assert resp.headers.get("Access-Control-Allow-Methods") == "GET, POST, OPTIONS"
    finally:
        conn.close()


def test_keepalive_serves_several_requests(world):
    conn = http.client.HTTPConnection("127.0.0.1", world.port_http.port, timeout=TIMEOUT_S)
    try:
        for path in ("/query/services", "/query/zscore?service=cart", "/"):
            conn.request("GET", path)
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read())
    finally:
        conn.close()


# --- engine lifecycle and reads -------------------------------------------


def test_read_helpers_match_the_tensor_ops():
    rng = np.random.default_rng(0)
    table = rng.integers(0, 1000, size=(3, 4, 512)).astype(np.int32)
    hi = rng.integers(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    idx_np = cms.cms_indices_np(hi, lo, 4, 512)
    idx_t = cms.cms_indices(torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64)), 4, 512)
    assert (idx_np == idx_t.numpy()).all()
    assert (cms.cms_query_np(table, idx_np) == cms.cms_query(torch.from_numpy(table), idx_t).numpy()).all()
    regs = rng.integers(0, 20, size=(3, 8, 256)).astype(np.int32)
    regs[0, 0] = 0  # the linear-counting branch too
    assert np.allclose(hll.hll_estimate_np(regs), hll.hll_estimate(torch.from_numpy(regs)).numpy(), rtol=1e-5)


def test_topk_counts_match_direct_cms_reads():
    from opentelemetry_demo_tpu_torch.ops.hashing import split_hi_lo_np, splitmix64_np

    pipe = _port_pipe(batch_size=128)
    rng = np.random.default_rng(2)
    for i in range(20):
        pipe.submit_columns(tensorize.SpanColumns(**_cols(rng, 128)))
        pipe.pump(i * 0.25)
    pipe.drain()
    engine = QueryEngine(snapshot_fn=state_snapshot_fn(pipe))
    status, doc = dispatch(engine, "/query/topk", {"service": "cart", "k": "5"})
    assert status == 200 and doc["data"]["top"]
    arrays, _meta = state_snapshot_fn(pipe)()
    cur = arrays["cms_bank"][:, 0]
    for row in doc["data"]["top"]:
        crc = np.asarray([int(row["attr_crc"], 16)], np.uint64)
        key = crc | (np.uint64(1) << np.uint64(32))  # cart
        hi, lo = split_hi_lo_np(splitmix64_np(key))
        direct = cms.cms_query_np(cur, cms.cms_indices_np(hi, lo, cur.shape[-2], cur.shape[-1]))
        assert row["counts"] == [int(c) for c in direct[:, 0]]
    counts = [row["count"] for row in doc["data"]["top"]]
    assert counts == sorted(counts, reverse=True)


def test_timeline_accretes_per_sequence():
    pipe = _port_pipe(batch_size=64)
    engine = QueryEngine(snapshot_fn=state_snapshot_fn(pipe), timeline_depth=4)
    rng = np.random.default_rng(3)
    for i in range(7):
        cols = _cols(rng, 64)
        cols["svc"][:] = 0
        pipe.submit_columns(tensorize.SpanColumns(**cols))
        pipe.pump(float(i))
        pipe.drain()
        engine.refresh()
    engine.refresh()  # the same seq: no duplicate
    status, doc = dispatch(engine, "/query/cardinality", {"service": "frontend"})
    assert status == 200
    seqs = [e["seq"] for e in doc["data"]["timeline"]]
    assert seqs == [4, 5, 6, 7]


def test_failed_refresh_serves_the_cached_snapshot():
    state = {"fail": False}
    pipe = _port_pipe(batch_size=64)
    snap = state_snapshot_fn(pipe)

    def flaky():
        if state["fail"]:
            raise RuntimeError("copy failed")
        return snap()

    engine = QueryEngine(snapshot_fn=flaky, max_staleness_s=0.0)
    assert engine.refresh()
    state["fail"] = True
    status, doc = dispatch(engine, "/query/services", {})
    assert status == 200 and doc["data"]["services"][:2] == ["frontend", "cart"]
    assert engine.refresh_errors >= 1


def test_single_flight_refresh():
    """Concurrent queries on a stale cache take one snapshot between them."""
    calls = []
    pipe = _port_pipe(batch_size=64)
    snap = state_snapshot_fn(pipe)
    gate = threading.Event()

    def slow():
        calls.append(1)
        gate.wait(TIMEOUT_S)
        return snap()

    engine = QueryEngine(snapshot_fn=slow, max_staleness_s=0.0)
    gate.set()
    engine.refresh()
    calls.clear()
    gate.clear()
    threads = [threading.Thread(target=engine.maybe_refresh) for _ in range(6)]
    for th in threads:
        th.start()
    time.sleep(0.1)
    gate.set()
    for th in threads:
        th.join(TIMEOUT_S)
    assert len(calls) == 1


def test_exemplars_round_trip_to_ingested_traces():
    pipe = _port_pipe(cfg=dict(SMALL, warmup_batches=2.0, z_warmup_batches=3.0), batch_size=64, exemplar_ring=4)
    rng = np.random.default_rng(4)
    submitted: set[str] = set()
    for i in range(30):
        cols = _cols(rng, 64)
        if i >= 15:
            cols["lat_us"][cols["svc"] == 3] *= 10_000.0
        for v in cols["trace_key"][cols["svc"] == 3]:
            submitted.add(int(v).to_bytes(8, "little").hex())
        pipe.submit_columns(tensorize.SpanColumns(**cols))
        pipe.pump(i * 0.25)
        pipe.drain()
    meta = pipe.query_meta()
    assert pipe.exemplars_captured > 0
    ring = meta["exemplars"]["3"]
    assert ring and len(ring) <= 4
    assert all(e["trace_id"] in submitted and e["signal"] for e in ring)
    events = [e for e in meta["anomalies"] if e["service"] == 3]
    assert events and all(tid in submitted for e in events for tid in e["exemplars"])
    assert json.loads(json.dumps(meta)) == meta


def _fake_flag_report(num_services=8, windows=3):
    from types import SimpleNamespace

    return SimpleNamespace(
        lat_z=np.full((num_services, windows), 9.0, np.float32),
        err_z=np.zeros((num_services, windows), np.float32),
        rate_z=np.zeros((num_services, windows), np.float32),
        card_z=np.zeros((num_services, windows), np.float32),
        cusum=np.zeros((num_services, 3), np.float32),
    )


def _strip_t(meta):
    meta = json.loads(json.dumps(meta))
    for ring in meta["exemplars"].values():
        for e in ring:
            e.pop("t")
    for e in meta["anomalies"]:
        e.pop("t")
    return meta


@pytest.mark.parametrize("exemplar_ring", [0, 4])
def test_capture_equals_reference(exemplar_ring):
    """The same flag through both pipelines' capture: the same query
    block (wall-clock stamps aside); ``exemplar_ring=0`` stops only the
    trace-id capture."""
    cols = _cols(np.random.default_rng(11), 64)
    cols["svc"][:32] = 3
    flags = np.zeros(8, bool)
    flags[3] = True
    port = DetectorPipeline(
        tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device="cpu"), batch_size=64,
        exemplar_ring=exemplar_ring, hh_candidates=16,
    )
    ref = jpipeline.DetectorPipeline(
        jdet.AnomalyDetector(jdet.DetectorConfig(**SMALL)), batch_size=64,
        exemplar_ring=exemplar_ring, hh_candidates=16,
    )
    port._capture_candidates(tensorize.SpanColumns(**cols))
    ref._capture_candidates(jtz.SpanColumns(**cols))
    port._capture_exemplars(1.0, tensorize.SpanColumns(**cols), _fake_flag_report(), flags, 6.0)
    ref._capture_exemplars(1.0, jtz.SpanColumns(**cols), _fake_flag_report(), flags, 6.0)
    assert _strip_t(port.query_meta()) == _strip_t(ref.query_meta())
    events = port.query_meta()["anomalies"]
    assert events[0]["signals"] == ["latency"]
    assert (events[0]["exemplars"] == []) == (exemplar_ring == 0)


def test_restore_query_meta_round_trip():
    cols = _cols(np.random.default_rng(12), 64)
    src = _port_pipe(batch_size=64, exemplar_ring=4, hh_candidates=16)
    src._capture_candidates(tensorize.SpanColumns(**cols))
    flags = np.zeros(8, bool)
    flags[2] = True
    src._capture_exemplars(1.0, tensorize.SpanColumns(**cols), _fake_flag_report(), flags, 6.0)
    block = src.query_meta()
    assert block["exemplars"] and block["anomalies"] and block["hh_candidates"]
    dst = _port_pipe(batch_size=64, exemplar_ring=4, hh_candidates=16)
    dst.restore_query_meta(json.loads(json.dumps(block)))
    restored = dst.query_meta()
    for key in ("exemplars", "anomalies", "hh_candidates", "explains"):
        assert restored[key] == block[key]
    assert dst.exemplars_captured == 0
    dst.restore_query_meta({})  # an empty block is a no-op


def test_candidate_ring_keeps_recent_not_largest():
    pipe = _port_pipe(batch_size=64, hh_candidates=4)

    def batch(crcs):
        n = len(crcs)
        return tensorize.SpanColumns(
            svc=np.zeros(n, np.int32), lat_us=np.ones(n, np.float32), is_error=np.zeros(n, np.float32),
            trace_key=np.arange(n, dtype=np.uint64), attr_crc=np.asarray(crcs, np.uint64),
        )

    for i, crcs in enumerate(([900, 901, 902, 903], [1, 2], [3, 4])):
        pipe.submit_columns(batch(crcs))
        pipe.pump(i * 0.25)
        pipe.drain()
    cands = pipe.query_meta()["hh_candidates"]["0"]
    assert set(cands) == {1, 2, 3, 4} and cands[0] in (3, 4)


@pytest.mark.parametrize("spine_ring,harvest_async", [(0, False), (2, True)])
def test_refresh_hammered_against_live_dispatch(spine_ring, harvest_async):
    """Snapshot refreshes and point queries from several threads while the
    pipeline dispatches: no refresh fails and every answer is whole."""
    pipe = _port_pipe(batch_size=256, spine_ring=spine_ring, harvest_async=harvest_async)
    engine = QueryEngine(snapshot_fn=state_snapshot_fn(pipe), max_staleness_s=0.0)
    rng = np.random.default_rng(7)
    stop = threading.Event()
    failures: list[str] = []
    seqs: list[int] = []

    def reader(idx):
        while not stop.is_set():
            try:
                assert engine.refresh()
                status, doc = dispatch(engine, "/query/cardinality", {"service": NAMES[idx % len(NAMES)]})
                assert status == 200
                seqs.append(doc["meta"]["seq"])
                assert dispatch(engine, "/query/topk", {"service": "frontend"})[0] == 200
            except Exception as e:  # noqa: BLE001 — collected, asserted
                failures.append(repr(e))
                return

    threads = [threading.Thread(target=reader, args=(i,), daemon=True) for i in range(2)]
    for th in threads:
        th.start()
    try:
        for i in range(100):
            pipe.submit_columns(tensorize.SpanColumns(**_cols(rng, 256)))
            pipe.pump(i * 0.05)
    finally:
        stop.set()
        for th in threads:
            th.join(TIMEOUT_S)
        pipe.close()
    assert not failures, failures
    assert engine.refresh_errors == 0
    assert seqs and max(seqs) <= 100


# --- the snapshot's stream --------------------------------------------------


def test_snapshot_names_the_step_stream(monkeypatch):
    """The snapshot orders its copy on the stream the steps were
    dispatched on (recorded under the dispatch lock), not on the
    snapshotting thread's current stream."""
    sentinel = object()
    monkeypatch.setattr(pipeline_mod, "_current_stream", lambda device: sentinel)
    seen = []
    start = hostcopy.HostCopy.start

    def spy(self, tensors, stream=None):
        seen.append(stream)
        start(self, tensors)  # the CPU copy takes no stream

    monkeypatch.setattr(hostcopy.HostCopy, "start", spy)
    pipe = _port_pipe(batch_size=64)
    assert pipe.step_stream is None
    pipe.submit_columns(tensorize.SpanColumns(**_cols(np.random.default_rng(1), 64)))
    pipe.pump(0.0)
    pipe.drain()
    assert pipe.step_stream is sentinel
    out = []
    th = threading.Thread(target=lambda: out.append(pipe.state_snapshot()))
    th.start()
    th.join(TIMEOUT_S)
    assert out and seen == [sentinel]
    assert int(out[0][0]["step_idx"]) == 1


def test_querybench_snapshot_is_the_pipeline_snapshot():
    pipe = _port_pipe(batch_size=64)
    pipe.submit_columns(tensorize.SpanColumns(**_cols(np.random.default_rng(2), 64)))
    pipe.pump(0.5)
    pipe.drain()
    arrays, meta = state_snapshot_fn(pipe)()
    assert set(meta) == {"offsets", "service_names", "clock_t_prev", "config", "query"}
    assert meta["service_names"][:len(NAMES)] == list(NAMES)
    assert meta["clock_t_prev"] == 0.5
    assert meta["config"] == list(pipe.detector.config._replace(sketch_impl=None))
    want = tdet.state_to_numpy(pipe.detector.state)
    for name in tdet.DetectorState._fields:
        assert np.array_equal(arrays[name], getattr(want, name))


def test_query_reads_state_only_through_the_snapshot():
    """``runtime/query.py`` never names the detector, its state or the
    dispatch lock: every read goes through ``snapshot_fn``."""
    tree = ast.parse((ROOT / "opentelemetry_demo_tpu_torch/runtime/query.py").read_text())
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert not names & {"detector", "state", "_dispatch_lock", "state_snapshot", "pipeline"}


# --- misc -------------------------------------------------------------------


def test_query_error_is_not_a_crash():
    e = QueryError(404, "nope")
    assert e.status == 404 and str(e) == "nope"


def test_dispatch_maps_internal_errors_to_500():
    class Boom:
        def services(self):
            raise KeyError("cms_bank")

    assert dispatch(Boom(), "/query/services", {}) == (500, {"error": "internal query error"})
    assert dispatch(Boom(), "/query/services", {}) == jquery.dispatch(Boom(), "/query/services", {})


def test_endpoint_label_bounds_metric_cardinality():
    assert query.endpoint_label("/query/topk") == "/query/topk"
    assert query.endpoint_label("/") == "/"
    for probe in ("/admin", "/query/topk/../x", "/%2e%2e", "/etc/passwd"):
        assert query.endpoint_label(probe) == "other"
    assert query.ENDPOINTS == jquery.ENDPOINTS


@pytest.mark.parametrize("raw", [None, "", 1700000000, 1700000000123, "1700000000", "2024-05-01T12:00:00Z", "soon", True])
def test_parse_ts_equals_reference(raw):
    assert query.parse_ts(raw) == jquery.parse_ts(raw)


def test_querybench_on_the_cpu():
    out = querybench.measure_query(seconds=0.5, query_threads=2, device="cpu")
    assert out["query_errors"] == 0 and out["queries_total"] > 0
    assert out["explain_queries"] > 0 and out["ingest_ratio"] > 0
    assert out["spans_fed"] > 0


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the snapshot orders a copy on a CUDA stream)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_snapshot_waits_for_a_step_on_another_stream(cuda_device):
    """A step dispatched on a side stream behind ~50 ms of spin; the
    snapshot, taken from the default stream at once, holds the state
    after that step."""
    pipe = DetectorPipeline(
        tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device=cuda_device), batch_size=64,
        harvest_interval_s=1e9,
    )
    rng = np.random.default_rng(9)
    pipe.submit_columns(tensorize.SpanColumns(**_cols(rng, 64)))
    pipe.pump(0.0)
    pipe.drain()
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        pipe.submit_columns(tensorize.SpanColumns(**_cols(rng, 64)))
        pipe.pump(0.25)
    assert pipe.step_stream == side
    arrays, _ = pipe.state_snapshot()
    torch.cuda.synchronize()
    want = tdet.state_to_numpy(pipe.detector.state)
    assert int(arrays["step_idx"]) == 2
    for name in tdet.DetectorState._fields:
        assert np.array_equal(arrays[name], getattr(want, name)), name
