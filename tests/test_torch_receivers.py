"""The port's OTLP receivers against the reference's.

The port's ``OtlpHttpReceiver`` and the reference's answer a shared
corpus (the one of ``tests/test_frontdoor.py``, plus JSON, metrics and
logs bodies) with the same status, the same ``Retry-After`` and the same
``rejects``, on each of their paths: the decode pool, the serial record
path and the native columns. The logs decoders and the ``LogStore``
equal the reference's; the gRPC receiver, its health service and the
probe answer as the reference's do. Last, the whole slice end to end:
OTLP bodies POSTed through the port's receiver and pool into the port's
pipeline on the CPU, against the reference's receiver, pool and JAX
pipeline: integer banks exact, floats within rtol 1e-4 / atol 1e-5,
flags identical.
"""

from __future__ import annotations

import json
import socket
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from opentelemetry_demo_tpu.models import detector as jdet
from opentelemetry_demo_tpu.runtime import ingest_pool as jpool
from opentelemetry_demo_tpu.runtime import otlp as jotlp
from opentelemetry_demo_tpu.runtime import pipeline as jpipeline
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu.telemetry import logstore as jlogstore
from opentelemetry_demo_tpu_torch.models import detector as tdet
from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
from opentelemetry_demo_tpu_torch.runtime import ingest_pool, otlp, otlp_metrics, tensorize, wire
from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
from opentelemetry_demo_tpu_torch.telemetry import logstore
from tests.test_frontdoor import MAX_BODY, _header, _http, _raw_request, _seed_corpus, _status

JOIN_S = 30.0


# -- bodies ------------------------------------------------------------------------


def _kv(k: str, v: str) -> bytes:
    return wire.encode_len(1, k.encode()) + wire.encode_len(2, wire.encode_len(1, v.encode()))


def _log_body(rng, services=("frontend", "cart", "checkout"), per=6) -> bytes:
    """ExportLogsServiceRequest protobuf with the spec's corners: text
    and number severities, a zero time with an observed time, records
    without body or trace id, and a resource without service.name."""
    rls = b""
    for j, svc in enumerate(services + (None,)):
        recs = b""
        for i in range(per):
            t = 0 if i % 4 == 0 else 10**18 + int(rng.integers(0, 10**9))
            rec = wire.encode_fixed64(1, t) + wire.encode_fixed64(11, 10**18 + i)
            num = int(rng.integers(0, 25))
            rec += wire.encode_int(2, num)
            if i % 3 == 1:
                rec += wire.encode_len(3, ["Information", "warning", "ERROR2", "Critical", "trace"][i % 5].encode())
            if i % 5:
                rec += wire.encode_len(5, wire.encode_len(1, f"{svc} line {i} {rng.integers(0, 99)}".encode()))
            rec += wire.encode_len(6, _kv("k", str(i))) + wire.encode_len(6, _kv("tenant", f"t{j}"))
            if i % 2:
                rec += wire.encode_len(9, rng.bytes(16))
            recs += wire.encode_len(2, rec)
        res = wire.encode_len(1, wire.encode_len(1, _kv("service.name", svc))) if svc else b""
        rls += wire.encode_len(1, res + wire.encode_len(2, recs))
    return rls


def _log_json(rng) -> bytes:
    logs = []
    for i in range(8):
        lr = {
            "timeUnixNano": "0" if i % 3 == 0 else str(10**18 + i),
            "observedTimeUnixNano": str(10**18 + 7 * i),
            "severityNumber": int(rng.integers(0, 25)),
            "body": {"stringValue": f"json line {i}"},
            "attributes": [{"key": "k", "value": {"stringValue": str(i)}},
                           {"key": "nil", "value": {}}],
        }
        if i % 2:
            lr["severityText"] = ["warn", "Err", "INFO", "fatal"][i % 4]
            lr["traceId"] = rng.bytes(16).hex()
        logs.append(lr)
    return json.dumps({"resourceLogs": [{
        "resource": {"attributes": [{"key": "service.name", "value": {"stringValue": "ad"}}]},
        "scopeLogs": [{"logRecords": logs}],
    }]}).encode()


def _span_json(rng, n=20) -> bytes:
    spans = [{
        "traceId": rng.bytes(16).hex(),
        "name": "op",
        "startTimeUnixNano": str(10**18),
        "endTimeUnixNano": str(10**18 + int(rng.integers(10**5, 10**8))),
        "attributes": [{"key": "app.product.id", "value": {"stringValue": f"P-{i % 7}"}}],
        "status": {"code": 2 if i % 9 == 0 else 0},
    } for i in range(n)]
    return json.dumps({"resourceSpans": [{
        "resource": {"attributes": [{"key": "service.name", "value": {"stringValue": "cart"}}]},
        "scopeSpans": [{"spans": spans}],
    }]}).encode()


def _metrics_body(k: int = 0) -> bytes:
    return otlp_metrics.encode_metrics_request(
        [(f"svc-{i}", [("http.server.requests", 100.0 * (k + 1) * (i + 1), True),
                       ("queue.depth", 4.0 + i, False)]) for i in range(3)],
        t_ns=10**18 + k * 10**10,
    )


def _corpus(rng) -> list[tuple[str, str, bytes, bytes | None, str]]:
    """(label, path, body, Content-Length override, Content-Type)."""
    pb = "application/x-protobuf"
    out = [(label, path, body, cl, pb) for label, path, body, cl in _seed_corpus()]
    return out + [
        ("json_traces", "/v1/traces", _span_json(rng), None, "application/json"),
        ("malformed_json_traces", "/v1/traces", b"{not json", None, "application/json"),
        ("valid_metrics", "/v1/metrics", _metrics_body(), None, pb),
        ("valid_logs", "/v1/logs", _log_body(rng), None, pb),
        ("json_logs", "/v1/logs", _log_json(rng), None, "application/json"),
        ("malformed_logs", "/v1/logs", b"\x0a\xff", None, pb),
        ("truncated_metrics", "/v1/metrics", _metrics_body()[:-3], None, pb),
    ]


def _send(port: int, path: str, body: bytes, cl: bytes | None, ctype: str) -> tuple:
    resp = _raw_request(port, _http(b"POST", path.encode(), body, headers={b"Content-Type": ctype.encode()},
                                    content_length=cl))
    return _status(resp), _header(resp, b"Retry-After")


# -- the HTTP receiver --------------------------------------------------------------


class _Sinks:
    def __init__(self):
        self.records, self.columns, self.metrics, self.logs = [], [], [], []


def _receiver(mod, path: str, sinks: _Sinks, pool=None, **kw):
    extra = dict(kw)
    if path == "pool":
        extra["on_payload"] = pool.submit
    elif path == "columnar":
        extra["on_columnar"] = sinks.columns.append
    rx = mod.OtlpHttpReceiver(
        sinks.records.extend, host="127.0.0.1", port=0,
        on_metric_records=sinks.metrics.extend, on_log_records=sinks.logs.extend,
        max_body_bytes=MAX_BODY, **extra,
    )
    rx.start()
    return rx


def _answers(mod, pool_mod, tz, path: str, corpus, **kw):
    sinks = _Sinks()
    got_cols: list = []
    pool = pool_mod.IngestPool(
        lambda cols: got_cols.append(tuple(np.array(a, copy=True) for a in cols)), tz, workers=1
    ) if path == "pool" else None
    rx = _receiver(mod, path, sinks, pool, **kw)
    try:
        answers = {label: _send(rx.port, p, body, cl, ct) for label, p, body, cl, ct in corpus}
    finally:
        rx.stop()
        if pool is not None:
            pool.close()
    return answers, dict(rx.rejects), sinks, got_cols


@pytest.mark.parametrize("path", ["pool", "serial", "columnar"])
def test_http_answers_equal_the_reference_on_the_shared_corpus(path):
    corpus = _corpus(np.random.default_rng(3))
    got, got_rej, got_sinks, got_cols = _answers(otlp, ingest_pool, tensorize.SpanTensorizer(32), path, corpus)
    ref, ref_rej, ref_sinks, ref_cols = _answers(jotlp, jpool, jtz.SpanTensorizer(num_services=32), path, corpus)
    assert got == ref
    assert got_rej == ref_rej
    assert got["valid_traces"] == (200, None) and got["malformed_traces"] == (400, None)
    assert got["oversized"] == (413, None) and got["bad_content_length"] == (400, None)
    assert got["valid_logs"] == got["json_logs"] == (200, None) and got["malformed_logs"] == (400, None)
    assert [tuple(r) for r in got_sinks.records] == [tuple(r) for r in ref_sinks.records]
    assert [tuple(m) for m in got_sinks.metrics] == [tuple(m) for m in ref_sinks.metrics]
    assert [vars(d) for d in got_sinks.logs] == [vars(d) for d in ref_sinks.logs]
    assert len(got_sinks.columns) == len(ref_sinks.columns)
    for a, b in zip(got_sinks.columns, ref_sinks.columns):
        for x, y in zip(a[:8], b[:8]):
            assert x.tobytes() == y.tobytes()
        assert a.services == b.services
    assert len(got_cols) == len(ref_cols)
    for a, b in zip(got_cols, ref_cols):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("hint,want", [(2.3, b"3"), (0.2, b"1"), (4.0, b"4")])
def test_saturation_answers_429_with_an_integer_retry_after(hint, want):
    corpus = [c for c in _corpus(np.random.default_rng(4))
              if c[0] in ("valid_traces", "valid_metrics", "valid_logs", "odd_path_is_traces")]
    runs = []
    for mod in (otlp, jotlp):
        answers, rejects, _s, _c = _answers(mod, None, None, "serial", corpus, retry_after=lambda: hint)
        runs.append((answers, rejects))
    assert runs[0] == runs[1]
    answers, rejects = runs[0]
    assert answers["valid_traces"] == answers["odd_path_is_traces"] == (429, want)
    assert answers["valid_metrics"] == answers["valid_logs"] == (200, None)
    assert rejects == {"saturated": 2}


class _Ticket:
    def __init__(self, exc=None):
        self._exc = exc

    def result(self, timeout=None):
        if self._exc is not None:
            raise self._exc


@pytest.mark.parametrize("outcome", ["pool_saturated", "worker_error", "wedged", "decode_error", "ok"])
def test_pool_verdicts_equal_the_reference(outcome):
    body = _seed_corpus()[0][2]
    runs = []
    for mod, pmod in ((otlp, ingest_pool), (jotlp, jpool)):
        def on_payload(payload, pmod=pmod):
            if outcome == "pool_saturated":
                raise pmod.IngestPoolSaturated("full")
            return _Ticket({"worker_error": pmod.IngestWorkerError("sink raised"),
                            "wedged": TimeoutError("wedged"),
                            "decode_error": ValueError("malformed"), "ok": None}[outcome])

        rx = mod.OtlpHttpReceiver(lambda r: None, host="127.0.0.1", port=0, on_payload=on_payload)
        rx.start()
        try:
            runs.append((_send(rx.port, "/v1/traces", body, None, "application/x-protobuf"), dict(rx.rejects)))
        finally:
            rx.stop()
    assert runs[0] == runs[1]
    assert runs[0][0] == {"pool_saturated": (429, b"1"), "worker_error": (500, None), "wedged": (503, b"1"),
                          "decode_error": (400, None), "ok": (200, None)}[outcome]


def test_a_receiver_asked_for_columns_without_the_decoder_refuses_to_start(monkeypatch):
    from opentelemetry_demo_tpu_torch.runtime import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "no host C++ compiler (g++ or c++) on PATH")
    with pytest.raises(RuntimeError, match="no host C"):
        otlp.OtlpHttpReceiver(lambda r: None, host="127.0.0.1", port=0, on_columnar=lambda c: None)


def test_a_client_that_stops_mid_body_frees_its_thread_and_counts_truncated():
    runs = []
    for mod in (otlp, jotlp):
        rx = mod.OtlpHttpReceiver(lambda r: None, host="127.0.0.1", port=0)
        rx.CONNECTION_TIMEOUT_S = 10.0
        rx.start()
        try:
            s = socket.create_connection(("127.0.0.1", rx.port))
            s.sendall(b"POST /v1/traces HTTP/1.1\r\nHost: x\r\nContent-Length: 100\r\n\r\n" + b"\x0a" * 10)
            s.shutdown(socket.SHUT_WR)
            buf = s.recv(65536)
            s.close()
            runs.append((_status(buf), dict(rx.rejects)))
        finally:
            rx.stop()
    assert runs[0] == runs[1] == (400, {"truncated": 1})


# -- the logs leg ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_log_decoders_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    body = _log_body(rng)
    got, ref = otlp.decode_logs_request(body), jotlp.decode_logs_request(body)
    assert len(got) == len(ref) == 4 * 6
    assert [vars(d) for d in got] == [vars(d) for d in ref]
    assert {d.service for d in got} == {"frontend", "cart", "checkout", "unknown"}
    js = _log_json(rng)
    assert [vars(d) for d in otlp.decode_logs_request_json(js)] == [vars(d) for d in jotlp.decode_logs_request_json(js)]
    for n in range(-1, 27):
        assert otlp._severity_from_number(n) == jotlp._severity_from_number(n)
    for text in (None, "", "info", "Information", "warning", "WARN", "ERROR2", "err", "Critical", "fatal",
                 "trace", "DEBUG", "notice"):
        assert logstore.normalize_severity(text) == jlogstore.normalize_severity(text)
    with pytest.raises(ValueError):
        otlp.decode_logs_request(b"\x0a\xff")


def test_log_store_equals_the_reference():
    rng = np.random.default_rng(7)
    docs = otlp.decode_logs_request(_log_body(rng, per=20))
    got, ref = logstore.LogStore(max_docs_per_index=30), jlogstore.LogStore(max_docs_per_index=30)
    for i, d in enumerate(docs):
        index = "otel" if i % 3 else "audit"
        got.add(d, index)
        ref.add(jlogstore.LogDoc(**vars(d)), index)
    assert got.indices() == ref.indices() == ["audit", "otel"]
    assert [got.count(i) for i in ("otel", "audit", "none")] == [ref.count(i) for i in ("otel", "audit", "none")]
    tid = next(d.trace_id for d in docs if d.trace_id)
    queries = [dict(), dict(service="cart"), dict(severity="ERROR"), dict(query="line 1"),
               dict(trace_id=tid), dict(index="audit", limit=3), dict(service="unknown", severity="INFO")]
    for q in queries:
        assert [vars(d) for d in got.search(**q)] == [vars(d) for d in ref.search(**q)], q
    with pytest.raises(ValueError):
        got.add(logstore.LogDoc(0.0, "a", "LOUD", "x"))


# -- gRPC --------------------------------------------------------------------------


@pytest.fixture
def grpc_mod():
    return pytest.importorskip("grpc")


def _grpc_receivers(grpc_mod, **kw):
    from opentelemetry_demo_tpu.runtime import otlp_grpc as jgrpc
    from opentelemetry_demo_tpu_torch.runtime import otlp_grpc

    out = []
    for mod in (otlp_grpc, jgrpc):
        sinks = _Sinks()
        rx = mod.OtlpGrpcReceiver(sinks.records.extend, host="127.0.0.1", port=0,
                                  on_metric_records=sinks.metrics.extend,
                                  on_log_records=sinks.logs.extend, **kw)
        rx.start()
        out.append((mod, rx, sinks))
    return out


def _call(grpc_mod, port: int, method: str, body: bytes):
    with grpc_mod.insecure_channel(f"127.0.0.1:{port}") as ch:
        fn = ch.unary_unary(method, request_serializer=None, response_deserializer=None)
        try:
            resp, call = fn.with_call(body, timeout=10)
            return "OK", resp, dict(call.trailing_metadata() or ())
        except grpc_mod.RpcError as e:
            return e.code().name, None, dict(e.trailing_metadata() or ())


def test_grpc_exports_equal_the_reference(grpc_mod):
    from opentelemetry_demo_tpu_torch.runtime import otlp_grpc

    rng = np.random.default_rng(8)
    spans = _seed_corpus()[0][2]
    calls = [(otlp_grpc.TRACE_EXPORT, spans), (otlp_grpc.TRACE_EXPORT, b"\xff\xfe"),
             (otlp_grpc.METRICS_EXPORT, _metrics_body()), (otlp_grpc.METRICS_EXPORT, b"\xff\xff\xff"),
             (otlp_grpc.LOGS_EXPORT, _log_body(rng)), (otlp_grpc.LOGS_EXPORT, b"\x0a\xff"),
             ("/opentelemetry.proto.collector.trace.v1.TraceService/Nope", b"")]
    runs = []
    for _mod, rx, sinks in _grpc_receivers(grpc_mod):
        try:
            answers = [_call(grpc_mod, rx.port, m, b)[:2] for m, b in calls]
        finally:
            rx.stop()
        runs.append((answers, dict(rx.rejects), sinks))
    (got, got_rej, gs), (ref, ref_rej, rs) = runs
    assert got == ref
    assert [a[0] for a in got] == ["OK", "INVALID_ARGUMENT", "OK", "INVALID_ARGUMENT", "OK",
                                   "INVALID_ARGUMENT", "UNIMPLEMENTED"]
    assert got_rej == ref_rej == {"malformed": 3}
    assert [tuple(r) for r in gs.records] == [tuple(r) for r in rs.records] and len(gs.records) == 16
    assert [tuple(m) for m in gs.metrics] == [tuple(m) for m in rs.metrics]
    assert [vars(d) for d in gs.logs] == [vars(d) for d in rs.logs]


def test_grpc_saturation_and_the_pool_path(grpc_mod):
    from opentelemetry_demo_tpu_torch.runtime import otlp_grpc

    body = _seed_corpus()[0][2]
    sat = _grpc_receivers(grpc_mod, retry_after=lambda: 1.5)
    try:
        answers = [_call(grpc_mod, rx.port, otlp_grpc.TRACE_EXPORT, body) for _m, rx, _s in sat]
        metrics = [_call(grpc_mod, rx.port, otlp_grpc.METRICS_EXPORT, _metrics_body())[0] for _m, rx, _s in sat]
    finally:
        for _m, rx, _s in sat:
            rx.stop()
    assert answers[0][0] == answers[1][0] == "RESOURCE_EXHAUSTED"
    assert answers[0][2].get("retry-after-s") == answers[1][2].get("retry-after-s") == "1.5"
    assert metrics == ["OK", "OK"]
    got: list = []
    pool = ingest_pool.IngestPool(lambda cols: got.append(cols.rows), tensorize.SpanTensorizer(32), workers=1)
    rx = otlp_grpc.OtlpGrpcReceiver(lambda r: None, host="127.0.0.1", port=0, on_payload=pool.submit)
    rx.start()
    try:
        ok = _call(grpc_mod, rx.port, otlp_grpc.TRACE_EXPORT, body)[0]
        bad = _call(grpc_mod, rx.port, otlp_grpc.TRACE_EXPORT, b"\x0a\xff")[0]
    finally:
        rx.stop()
        pool.close()
    assert (ok, bad, got) == ("OK", "INVALID_ARGUMENT", [16])
    assert rx.rejects == {"malformed": 1}


def test_grpc_health_equals_the_reference(grpc_mod):
    from opentelemetry_demo_tpu.runtime import grpc_health as jhealth
    from opentelemetry_demo_tpu_torch.runtime import grpc_health

    check = grpc_health.CHECK_METHOD
    runs = []
    for _mod, rx, _sinks in _grpc_receivers(grpc_mod):
        try:
            answers = [
                _call(grpc_mod, rx.port, check, b"")[:2],
                _call(grpc_mod, rx.port, check, wire.encode_len(
                    1, b"opentelemetry.proto.collector.trace.v1.TraceService"))[:2],
                _call(grpc_mod, rx.port, check, wire.encode_len(1, b"nope.Service"))[:2],
            ]
        finally:
            rx.stop()
        runs.append(answers)
    assert runs[0] == runs[1]
    assert runs[0][0] == ("OK", wire.encode_int(1, grpc_health.SERVING)) and runs[0][2][0] == "NOT_FOUND"
    assert (grpc_health.SERVING, grpc_health.NOT_SERVING) == (jhealth.SERVING, jhealth.NOT_SERVING)
    stop = threading.Event()
    svc = grpc_health.HealthService(["a.B"], stop, component_status=lambda s: 2 if s == "anomaly.component.x" else None)
    assert svc._status_response(wire.encode_len(1, b"anomaly.component.x")) == wire.encode_int(1, 2)
    stop.set()
    assert svc._status_response(b"") == wire.encode_int(1, grpc_health.NOT_SERVING)


# -- health_probe --------------------------------------------------------------------


@pytest.fixture
def stub_health_server(grpc_mod):
    """A gRPC server with only the port's health service; ``x`` is a
    supervised component that is up."""
    from concurrent import futures

    from opentelemetry_demo_tpu_torch.runtime.grpc_health import SERVING, HealthService

    stop = threading.Event()
    health = HealthService(["demo.Svc"], stop, component_status=lambda s: SERVING if s == "anomaly.component.x" else None)

    class Handler(grpc_mod.GenericRpcHandler):
        def service(self, details):
            return health.add_to_generic_handlers(grpc_mod, details.method)

    server = grpc_mod.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((Handler(),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    yield f"127.0.0.1:{port}", stop
    server.stop(0).wait()


def test_health_probe_against_a_stub_server(stub_health_server, monkeypatch):
    from opentelemetry_demo_tpu_torch.runtime import health_probe

    addr, stop = stub_health_server
    assert health_probe.probe(addr)
    assert health_probe.probe(addr, "demo.Svc")
    assert not health_probe.probe(addr, "nope.Service")
    for argv, code in ((["--component", "x"], 0), (["--service", "nope.Service"], 1)):
        monkeypatch.setattr(sys, "argv", ["health_probe", "--addr", addr, *argv])
        with pytest.raises(SystemExit) as e:
            health_probe.main()
        assert e.value.code == code
    stop.set()
    assert not health_probe.probe(addr)


def test_health_probe_reads_role_and_fleet_from_healthz():
    from opentelemetry_demo_tpu.runtime import health_probe as jprobe
    from opentelemetry_demo_tpu_torch.runtime import health_probe

    doc = {"role": "standby", "epoch": 3, "fleet": {"shard": "s1", "peers": {}}}

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            body = json.dumps(doc).encode()
            self.send_response(503 if self.path == "/healthz" else 404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    addr = f"127.0.0.1:{server.server_address[1]}"
    try:
        assert health_probe.probe_role(addr) == jprobe.probe_role(addr) == ("standby", 3)
        assert health_probe.probe_shard(addr) == jprobe.probe_shard(addr) == doc["fleet"]
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=JOIN_S)
    assert health_probe.probe_role(addr, timeout_s=0.5) is None
    assert health_probe.HEALTH_PREFIX == "anomaly.component."


# -- the slice end to end -----------------------------------------------------------

CFG = dict(num_services=8, hll_p=8, cms_width=512, warmup_batches=5.0, z_warmup_batches=20.0)
SERVICES = ["frontend", "checkout", "payment", "cart", "currency", "ad"]


def _bodies(rng, n_batches, per_batch, fault_at, slow="payment"):
    out = []
    for k in range(n_batches):
        recs = []
        for _ in range(per_batch):
            s = int(rng.integers(0, len(SERVICES)))
            lat = float(rng.gamma(8.0, 200.0 * (s + 1) / 8.0)) * (10.0 if SERVICES[s] == slow and k >= fault_at else 1.0)
            recs.append(tensorize.SpanRecord(SERVICES[s], round(lat, 3), rng.bytes(16), bool(rng.random() < 0.02),
                                             f"product-{int(rng.zipf(1.5)) % 40}", "op"))
        out.append(otlp.encode_export_request(recs, 10**18 + k * 250_000_000))
    return out


def test_the_slice_end_to_end_equals_the_reference():
    """OTLP bodies POSTed one at a time through the receiver and the
    decode pool into the pipeline, pumped once a batch: the port on the
    CPU against the reference's receiver, pool and JAX pipeline."""
    b, n_batches, fault_at = 256, 64, 46
    bodies = _bodies(np.random.default_rng(21), n_batches, b, fault_at)
    runs = {}
    for which in ("port", "reference"):
        seen: list = []
        if which == "port":
            pipe = DetectorPipeline(tdet.AnomalyDetector(tdet.DetectorConfig(**CFG), device="cpu"),
                                    on_report=lambda t, rep, names: seen.append((t, rep.flags.copy(), names)),
                                    batch_size=b)
            pool = ingest_pool.IngestPool(pipe.submit_columns, pipe.tensorizer, workers=1)
            mod = otlp
        else:
            pipe = jpipeline.DetectorPipeline(jdet.AnomalyDetector(jdet.DetectorConfig(**CFG)),
                                              on_report=lambda t, rep, names: seen.append(
                                                  (t, np.asarray(rep.flags).copy(), names)),
                                              batch_size=b)
            pool = jpool.IngestPool(pipe.submit_columns, pipe.tensorizer, workers=1)
            mod = jotlp
        rx = mod.OtlpHttpReceiver(lambda r: None, host="127.0.0.1", port=0, on_payload=pool.submit)
        rx.start()
        try:
            for k, body in enumerate(bodies):
                assert _send(rx.port, "/v1/traces", body, None, "application/x-protobuf") == (200, None)
                pipe.pump(k * 0.25)
            pipe.drain()
        finally:
            rx.stop()
            pool.close()
        state = (state_to_numpy(pipe.detector.state) if which == "port"
                 else type(pipe.detector.state)(*(np.asarray(a) for a in pipe.detector.state)))
        runs[which] = (seen, state, pipe.tensorizer.service_names, pipe.stats.spans)
    (seen, state, names, spans), (rseen, rstate, rnames, rspans) = runs["port"], runs["reference"]
    assert names == rnames and spans == rspans == n_batches * b
    assert [t for t, _, _ in seen] == [t for t, _, _ in rseen] == [k * 0.25 for k in range(n_batches)]
    for (t, flags, fnames), (_, rflags, rfnames) in zip(seen, rseen):
        np.testing.assert_array_equal(flags, rflags, err_msg=f"t={t}")
        assert fnames == rfnames
    assert not any(f.any() for _, f, _ in seen[:fault_at])
    assert any("payment" in n for _, _, n in seen[fault_at:])
    for name in state._fields:
        a, r = np.asarray(getattr(state, name)), np.asarray(getattr(rstate, name))
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, r, err_msg=name)
        else:
            np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-5, err_msg=name)
