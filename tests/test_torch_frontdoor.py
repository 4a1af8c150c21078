"""The port's native front door against the reference's and both receivers.

The port builds its own copy of the front door (``csrc/host/frontdoor.cc``)
with the host compiler. On the shared corpus of ``tests/test_frontdoor.py``
the port's ``FrontDoorServer`` answers what the reference's front door and
both ``OtlpHttpReceiver`` s answer, and the same payloads land in the pool's
sink as the same bytes through any of the four doors. Then the framing
(truncation at every boundary, pipelining, 413, chunked), the control
plane (saturation, graceful drain, a wedged flush that defers its
verdict), the native reject mirror, the metrics and logs legs, the
benches at a small size, and the pin that no Python HTTP machinery sits
on the front door's path.
"""

from __future__ import annotations

import ast
import inspect
import socket
import threading
import time

import numpy as np
import pytest

from opentelemetry_demo_tpu.runtime import frontdoor as jfrontdoor
from opentelemetry_demo_tpu.runtime import frontdoorbench as jfb
from opentelemetry_demo_tpu.runtime import ingest_pool as jpool
from opentelemetry_demo_tpu.runtime import ingestbench as jbench
from opentelemetry_demo_tpu.runtime import native as jnative
from opentelemetry_demo_tpu.runtime import otlp as jotlp
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu_torch.runtime import frontdoor, frontdoorbench, ingest_pool, ingestbench, native, otlp
from opentelemetry_demo_tpu_torch.runtime import tensorize
from opentelemetry_demo_tpu_torch.runtime.ingestbench import make_payloads
from tests.test_frontdoor import MAX_BODY, _header, _http, _raw_request, _seed_corpus, _status
from tests.test_torch_receivers import _log_body, _metrics_body

JOIN_S = 30.0


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    assert native.available() and native.frontdoor_available(), native.frontdoor_load_error()
    assert jnative.available() and jnative.frontdoor_available(), jnative.frontdoor_load_error()


def _copying_sink(out: list):
    return lambda cols: out.append(tuple(np.array(a, copy=True) for a in cols))


class _Door:
    """One of the four doors in front of its package's pool, with sinks."""

    def __init__(self, which: str, **kw):
        self.cols: list = []
        self.metrics: list = []
        self.logs: list = []
        port_side = which in ("port_fd", "port_http")
        pool_mod, tz = (ingest_pool, tensorize.SpanTensorizer(32)) if port_side else (
            jpool, jtz.SpanTensorizer(num_services=32))
        self.pool = pool_mod.IngestPool(_copying_sink(self.cols), tz, workers=1)
        self.tz = tz
        common = dict(max_body_bytes=MAX_BODY, on_metric_records=self.metrics.extend,
                      on_log_records=self.logs.extend, **kw)
        if which == "port_fd":
            self.srv = frontdoor.FrontDoorServer(self.pool, port=0, host="127.0.0.1", **common)
        elif which == "ref_fd":
            self.srv = jfrontdoor.FrontDoorServer(self.pool, port=0, **common)
        else:
            mod = otlp if which == "port_http" else jotlp
            self.srv = mod.OtlpHttpReceiver(lambda r: None, host="127.0.0.1", port=0,
                                            on_payload=self.pool.submit, **common)
            self.srv.start()
        self.port = self.srv.port

    def close(self):
        self.srv.stop()
        self.pool.close()


DOORS = ("port_fd", "ref_fd", "port_http", "ref_http")


def _corpus():
    rng = np.random.default_rng(17)
    return _seed_corpus() + [
        ("valid_metrics", "/v1/metrics", _metrics_body(), None),
        ("valid_logs", "/v1/logs", _log_body(rng), None),
        ("malformed_logs", "/v1/logs", b"\x0a\xff", None),
    ]


def test_the_four_doors_answer_the_shared_corpus_alike():
    corpus = _corpus()
    answers, rejects, sinks = {}, {}, {}
    for which in DOORS:
        door = _Door(which)
        try:
            answers[which] = {
                label: _status(_raw_request(door.port, _http(b"POST", path.encode(), body, content_length=cl)))
                for label, path, body, cl in corpus
            }
        finally:
            door.close()
        rejects[which] = {k: v for k, v in door.srv.rejects.items() if k != "disconnect"}
        sinks[which] = door
    assert answers["port_fd"] == answers["ref_fd"] == answers["port_http"] == answers["ref_http"]
    assert answers["port_fd"]["valid_traces"] == 200 and answers["port_fd"]["oversized"] == 413
    assert answers["port_fd"]["malformed_logs"] == 400 and answers["port_fd"]["valid_logs"] == 200
    assert rejects["port_fd"] == rejects["ref_fd"]
    assert rejects["port_http"] == rejects["ref_http"]
    m = [[tuple(r) for r in sinks[w].metrics] for w in DOORS]
    assert m[0] == m[1] == m[2] == m[3] and m[0]
    logs = [[vars(d) for d in sinks[w].logs] for w in DOORS]
    assert logs[0] == logs[1] == logs[2] == logs[3] and logs[0]


def test_the_same_payloads_land_as_the_same_columns_through_every_door():
    payloads = make_payloads(n_requests=4, spans_per_request=64, seed=9)
    got = {}
    for which in DOORS:
        door = _Door(which)
        try:
            for p in payloads:
                assert _status(_raw_request(door.port, _http(b"POST", b"/v1/traces", p))) == 200
                assert door.pool.drain(JOIN_S)
        finally:
            door.close()
        got[which] = (door.cols, door.tz.service_names)
    ref_cols, ref_names = got["port_fd"]
    assert len(ref_cols) == len(payloads)
    for which in DOORS[1:]:
        cols, names = got[which]
        assert names == ref_names
        for a, b in zip(cols, ref_cols):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _port_fd(pool=None, **kw):
    own = pool is None
    if own:
        pool = ingest_pool.IngestPool(lambda cols: None, tensorize.SpanTensorizer(32), workers=1)
    fd = frontdoor.FrontDoorServer(pool, port=0, host="127.0.0.1", max_body_bytes=MAX_BODY, **kw)
    return fd, (pool if own else None)


def _stop(fd, pool):
    fd.stop()
    if pool is not None:
        pool.close()


def test_truncation_at_every_boundary_leaves_the_door_serving():
    payload = make_payloads(n_requests=1, spans_per_request=8)[0]
    req = _http(b"POST", b"/v1/traces", payload)
    head_len = req.index(b"\r\n\r\n") + 4
    cuts = list(range(head_len + 1)) + [head_len + 1, head_len + len(payload) // 2, len(req) - 1]
    fd, pool = _port_fd()
    try:
        for cut in cuts:
            s = socket.create_connection(("127.0.0.1", fd.port))
            s.sendall(req[:cut])
            s.close()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and fd.stats()["live_conns"]:
            time.sleep(0.02)
        assert _status(_raw_request(fd.port, req)) == 200
        stats = fd.stats()
    finally:
        _stop(fd, pool)
    assert stats["truncated"] >= 1 and stats["live_conns"] <= 1
    assert fd.rejects.get("truncated") == stats["truncated"]


def test_pipelined_requests_get_their_own_verdicts_in_order():
    good = make_payloads(n_requests=1, spans_per_request=8)[0]
    wire_bytes = (_http(b"POST", b"/v1/traces", good) + _http(b"POST", b"/v1/traces", b"\xff\xfe\xfd")
                  + _http(b"POST", b"/v1/traces", good))
    fd, pool = _port_fd()
    statuses = []
    try:
        with socket.create_connection(("127.0.0.1", fd.port), timeout=15.0) as s:
            s.sendall(wire_bytes)
            buf = b""
            while len(statuses) < 3:
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\r\n\r\n" in buf and len(statuses) < 3:
                    head, buf = buf.split(b"\r\n\r\n", 1)
                    statuses.append(_status(head + b"\r\n\r\n"))
    finally:
        _stop(fd, pool)
    assert statuses == [200, 400, 200]
    assert fd.rejects == {"malformed": 1}


def test_oversized_is_refused_before_the_body_with_close():
    fd, pool = _port_fd()
    try:
        with socket.create_connection(("127.0.0.1", fd.port), timeout=10.0) as s:
            s.sendall(b"POST /v1/traces HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n" % (MAX_BODY + 1))
            buf = b""
            while b"\r\n\r\n" not in buf:
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
            assert _status(buf) == 413
            assert (_header(buf, b"Connection") or b"").lower() == b"close"
            assert s.recv(1024) == b""
        stats = fd.stats()
    finally:
        _stop(fd, pool)
    assert stats["oversized"] == 1 and stats["rejects"]["oversized"] == 1


def test_chunked_is_refused_and_the_door_keeps_serving():
    seen: list = []
    fd, pool = _port_fd(on_reject=seen.append)
    try:
        resp = _raw_request(fd.port, b"POST /v1/traces HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
                                     b"4\r\nwxyz\r\n0\r\n\r\n")
        assert _status(resp) == 400
        payload = make_payloads(n_requests=1, spans_per_request=4)[0]
        assert _status(_raw_request(fd.port, _http(b"POST", b"/v1/traces", payload))) == 200
        stats = fd.stats()
    finally:
        _stop(fd, pool)
    assert stats["chunked"] == 1 and seen == ["chunked"]


class _StubTicket:
    def __init__(self, delay_s: float = 0.0):
        self._delay = delay_s

    def done(self):
        return True

    def result(self, timeout=None):
        time.sleep(self._delay)


class _StubPool:
    def __init__(self):
        self.mode = "ok"
        self.submitted = 0

    def submit(self, payload):
        self.submitted += 1
        if self.mode == "saturated":
            raise ingest_pool.IngestPoolSaturated("full")
        return _StubTicket(0.3 if self.mode == "slow" else 0.0)


def test_saturation_answers_429_with_retry_after():
    hint = [None]
    pool = _StubPool()
    fd, _ = _port_fd(pool, retry_after=lambda: hint[0])
    req = _http(b"POST", b"/v1/traces", b"\x0a\x00")
    try:
        assert _status(_raw_request(fd.port, req)) == 200
        answers = []
        for h, mode in ((2.3, "ok"), (0.4, "ok"), (None, "saturated")):
            hint[0], pool.mode = h, mode
            resp = _raw_request(fd.port, req)
            answers.append((_status(resp), _header(resp, b"Retry-After")))
        metrics = _status(_raw_request(fd.port, _http(b"POST", b"/v1/metrics", b"")))
    finally:
        fd.stop()
    assert answers == [(429, b"3"), (429, b"1"), (429, b"1")]
    assert metrics == 200 and fd.rejects["saturated"] == 3


def test_graceful_drain_lets_the_verdict_in_flight_land():
    pool = _StubPool()
    pool.mode = "slow"
    fd, _ = _port_fd(pool)
    port = fd.port
    got: dict = {}

    def client():
        got["resp"] = _raw_request(port, _http(b"POST", b"/v1/traces", b"\x0a\x00"), timeout=15.0)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    deadline = time.monotonic() + 5.0
    while pool.submitted == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    fd.stop(drain_timeout_s=10.0)
    t.join(timeout=JOIN_S)
    assert not t.is_alive()
    assert _status(got.get("resp", b"")) == 200
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2.0)
    fd.stop()  # idempotent


def test_a_wedged_flush_defers_its_verdict_until_the_flush_lands():
    class _Wedged:
        def __init__(self):
            self.ev = threading.Event()

        def done(self):
            return self.ev.is_set()

        def result(self, timeout=None):
            if not self.ev.wait(timeout):
                raise TimeoutError("wedged flush")

    class _WedgedPool:
        def __init__(self):
            self.tickets = []

        def submit(self, payload):
            self.tickets.append(_Wedged())
            return self.tickets[-1]

    pool = _WedgedPool()
    fd, _ = _port_fd(pool, ticket_timeout_s=0.15)
    try:
        got: dict = {}

        def client():
            got["resp"] = _raw_request(fd.port, _http(b"POST", b"/v1/traces", b"\x0a\x00"), timeout=15.0)

        t = threading.Thread(target=client, daemon=True)
        t.start()
        deadline = time.monotonic() + 5.0
        while not pool.tickets and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pool.tickets
        time.sleep(0.6)  # well past the ticket timeout: still no verdict
        assert "resp" not in got and fd.stats()["pending"] == 1
        pool.tickets[0].ev.set()
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    finally:
        fd.stop()
    assert _status(got.get("resp", b"")) == 200


def test_the_port_frontdoor_imports_no_python_http():
    tree = ast.parse(inspect.getsource(frontdoor))
    imported: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module)
            imported.update(f"{node.module}.{a.name}" for a in node.names)
    banned = ("http", "socketserver", "urllib", "wsgiref", "asyncio")
    assert not [m for m in imported if m.split(".", 1)[0] in banned]
    assert "http.server" not in inspect.getsource(frontdoor).replace("``http.server``", "")


def test_the_library_is_named_by_its_source_hash_and_binds_the_host_it_is_given():
    path = native.library_path(native.FRONTDOOR_SOURCE)
    assert path.exists() and path.parent == native.BUILD_DIR and path.name.startswith("libfrontdoor_")
    assert "-pthread" in native.build_command(path, native.FRONTDOOR_SOURCE)
    with pytest.raises(RuntimeError, match="bind failed on not-an-address"):
        native.frontdoor_start(0, MAX_BODY, host="not-an-address")
    h = native.frontdoor_start(0, MAX_BODY, host="127.0.0.1")
    try:
        port = native.frontdoor_port(h)
        assert port > 0
        assert _raw_request(port, b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n").startswith(b"HTTP/1.1 200")
    finally:
        native.frontdoor_stop(h)
    assert native.frontdoor_stats(h)["health"] == 1


def test_frontdoor_start_raises_with_the_build_error(monkeypatch):
    monkeypatch.setattr(native, "_fd_lib", None)
    monkeypatch.setattr(native, "_fd_error", "frontdoor.cc:1: error: expected ';'")
    assert not native.frontdoor_available()
    with pytest.raises(RuntimeError, match="native frontdoor unavailable: frontdoor.cc:1: error"):
        frontdoor.FrontDoorServer(_StubPool(), port=0, host="127.0.0.1")


def test_bench_payloads_equal_the_reference():
    assert ingestbench.make_payloads(3, 40, seed=4) == jbench.make_payloads(3, 40, seed=4)
    names = [f"t{i % 3:02d}.svc-{i:07d}" for i in range(50)]
    assert frontdoorbench.make_named_payload(names) == jfb.make_named_payload(names)
    cols, rows = native.decode_otlp_many([frontdoorbench.make_named_payload(names)], otlp.MONITORED_ATTR_KEYS)
    assert rows.tolist() == [50] and cols.services == names


def test_the_benches_run_at_a_small_size():
    payloads = make_payloads(n_requests=4, spans_per_request=128, seed=1)
    assert ingestbench.measure_native(payloads=payloads, n_requests=4, spans_per_request=128, repeat=1) > 0
    assert ingestbench.measure_python(payloads=payloads, n_requests=4, spans_per_request=128, repeat=1) > 0
    detail = ingestbench.measure_pooled_detail(workers=1, payloads=payloads, n_requests=4, spans_per_request=128,
                                               repeat=1, passes=2)
    assert detail["spans_per_sec"] > 0 and set(detail["phase_share"]) == set(ingest_pool.TOP_PHASES)
    assert detail["tickets_parked"] >= 1
    raw = ingestbench.measure_raw(payloads=payloads, n_requests=4, spans_per_request=128, repeat=1)
    assert raw["payload_bytes"] == sum(map(len, payloads))
    fat = ingestbench.measure_fat_payload_scaling(spans=2048, repeat=1)
    assert set(fat) == {"1", "2", "scaling"}
    assert set(ingestbench.measure_scaling((1,), payloads=payloads, n_requests=4, spans_per_request=128,
                                           repeat=1)) == {"1"}
    got = frontdoorbench.measure_frontdoor_vs_pool(workers=1, n_requests=4, spans_per_request=128, seconds=0.3,
                                                   clients=2, depth=2, repeat=1, payloads=payloads)
    assert got["requests_ok"] == got["requests_sent"] > 0 and not got["client_errors"]
    assert got["frontdoor_spans_per_sec"] > 0 and got["pool_spans_per_sec"] > 0


def test_clients_in_a_process_of_their_own_count_like_threads():
    payloads = make_payloads(n_requests=2, spans_per_request=64, seed=2)
    fd, pool = _port_fd()
    try:
        phases = frontdoorbench.run_clients_in_child(fd.port, [(payloads, 0.3), (payloads[:1], 0.3)], 2, 2)
        st = fd.stats()
    finally:
        _stop(fd, pool)
    assert len(phases) == 2 and phases[1]["t_start"] > phases[0]["t_start"]
    assert all(p["ok"] == p["sent"] > 0 and not p.get("errors") for p in phases)
    assert st["responded"] == sum(p["sent"] for p in phases)
