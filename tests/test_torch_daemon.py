"""The port's detector daemon against the reference daemon.

Both daemons boot from the same environment in this process, get the
same OTLP bodies over HTTP and the same ``step(t)`` calls, and must end
in the same place: integer state bit for bit, float state within rtol
1e-4 / atol 1e-5, the same flags, and the same ``/metrics`` exposition
line for line but for the series named in ``EXCLUDED_SERIES`` and
``TIMING_SERIES`` (the latter present in both with the same labels). The
checkpoints they write resume in either package. The ingest-fault and
supervision cases of ``tests/test_chaos.py`` run against the port's
daemon. torch runs on one thread (its intra-op pool spins against
XLA's), and the parity cases turn the width-ladder warm-up off for both
daemons (``ANOMALY_ADAPTIVE_BATCH=0``): it is not what they test, and
two ladders compiling beside each other only cost time.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import re
import socket
import struct
import time

import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import DetectorConfig as RefConfig
from opentelemetry_demo_tpu.runtime import wire
from opentelemetry_demo_tpu.runtime.daemon import DetectorDaemon as RefDaemon
from opentelemetry_demo_tpu.runtime.otlp_metrics import encode_metrics_request
from opentelemetry_demo_tpu_torch.models.detector import DetectorConfig
from opentelemetry_demo_tpu_torch.runtime import daemon as port_daemon_mod
from opentelemetry_demo_tpu_torch.runtime import native as port_native
from opentelemetry_demo_tpu_torch.runtime.daemon import DetectorDaemon
from opentelemetry_demo_tpu_torch.telemetry import metrics as tele_metrics

SMALL = dict(num_services=8, hll_p=8, cms_width=512)
RTOL, ATOL = 1e-4, 1e-5

# Series that differ between two runs of the same package, or by design:
EXCLUDED_SERIES = (
    # the build labels: torch=/cuda= here, jax= in the reference (by design)
    "anomaly_build_info",
    # wall-clock durations and rates of this process
    "anomaly_phase_seconds",
    "anomaly_harvest_lag_seconds",
    "anomaly_spine_put_wait_seconds",
    "anomaly_query_latency_seconds",
    "anomaly_explain_latency_seconds",
    "anomaly_query_staleness_seconds",
    "anomaly_ingest_pool_worker_utilization",
    "app_anomaly_detection_lag_p99_ms",
    # the process's own resources (VmRSS, CPU seconds)
    "anomaly_process_rss_bytes",
    "container_",
)

# Series whose values follow timing, differently in each package: left
# out of the line-for-line comparison, but present in both expositions
# with the same label sets. The reference counts the takes that found
# its stager thread's copy already done; the port, which puts on the
# pump thread, counts the copies issued while the last step still ran
# on the card (none on the CPU).
TIMING_SERIES = (
    # the overlap hit share, over the run and per scrape window
    "anomaly_spine_put_overlap_ratio",
    "anomaly_spine_put_overlap_window_ratio",
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flags_doc(on: bool) -> str:
    return json.dumps({
        "flags": {
            "anomalyDetectorEnabled": {
                "state": "ENABLED",
                "variants": {"on": True, "off": False},
                "defaultVariant": "on" if on else "off",
            }
        }
    })


@pytest.fixture
def env(tmp_path, monkeypatch):
    flag_path = tmp_path / "flags.json"
    flag_path.write_text(_flags_doc(True))
    monkeypatch.setenv("ANOMALY_OTLP_PORT", "0")
    monkeypatch.setenv("ANOMALY_OTLP_GRPC_PORT", "-1")
    monkeypatch.setenv("ANOMALY_METRICS_PORT", "0")
    monkeypatch.setenv("ANOMALY_BATCH", "256")
    monkeypatch.setenv("ANOMALY_ADAPTIVE_BATCH", "0")
    monkeypatch.setenv("FLAGD_FILE", str(flag_path))
    monkeypatch.delenv("KAFKA_ADDR", raising=False)
    for knob in ("ANOMALY_ROLE", "ANOMALY_REPLICATION_PORT", "ANOMALY_REPLICATION_TARGET",
                 "ANOMALY_FLEET_SHARDS", "ANOMALY_FRONTDOOR_ENABLE"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.tmp_path = tmp_path
    return monkeypatch


def _boot(env, which: str, name: str):
    """Boot one package's daemon with its own checkpoint path."""
    env.setenv("ANOMALY_CHECKPOINT", str(env.tmp_path / name))
    if which == "port":
        return DetectorDaemon(DetectorConfig(**SMALL), device="cpu")
    return RefDaemon(RefConfig(**SMALL))


def _payload(service: str, n: int, rng, lat_ns=None) -> bytes:
    """One OTLP export of ``n`` spans; latencies drawn around 1 ms unless
    ``lat_ns`` fixes them (the encoding of tests/test_daemon.py)."""
    def kv(k, v):
        return wire.encode_len(1, k.encode()) + wire.encode_len(2, wire.encode_len(1, v.encode()))

    spans = b""
    for _ in range(n):
        start = 10**18
        dur = int(lat_ns) if lat_ns is not None else int(10**6 * rng.lognormal(0.0, 0.3))
        spans += wire.encode_len(
            2,
            wire.encode_len(1, bytes(rng.integers(0, 256, 16, dtype=np.uint8)))
            + wire.encode_fixed64(7, start)
            + wire.encode_fixed64(8, start + dur),
        )
    rs = wire.encode_len(1, wire.encode_len(1, kv("service.name", service))) + wire.encode_len(2, spans)
    return wire.encode_len(1, rs)


def _post(port: int, body: bytes, path: str = "/v1/traces") -> int:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10.0)
    conn.request("POST", path, body=body, headers={"Content-Type": "application/x-protobuf"})
    resp = conn.getresponse()
    resp.read()
    conn.close()
    return resp.status


def _scrape(daemon) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", daemon.exporter.port, timeout=10.0)
    conn.request("GET", "/metrics")
    text = conn.getresponse().read().decode()
    conn.close()
    return text


def _exposition(text: str) -> list[str]:
    return [
        line for line in text.splitlines()
        if not any(
            line.startswith(name) or line.startswith(f"# HELP {name}") or line.startswith(f"# TYPE {name}")
            for name in EXCLUDED_SERIES + TIMING_SERIES
        )
    ]


def _timing_samples(text: str) -> dict[str, set[str]]:
    """Each timing series' sample names with their labels, values and a
    histogram's ``le`` dropped (a bucket line shows once a value fell in
    it, so which buckets show follows the timing too)."""
    def labels(line: str) -> str:
        sample = re.sub(r'le="[^"]*",?', "", line.rsplit(" ", 1)[0])
        return sample.replace(",}", "}").replace("{}", "")

    return {
        name: {labels(line) for line in text.splitlines() if line.startswith(name)}
        for name in TIMING_SERIES
    }


def _assert_expositions_equal(port, ref) -> dict[str, set[str]]:
    port_text, ref_text = _scrape(port), _scrape(ref)
    assert _exposition(port_text) == _exposition(ref_text)
    timing = _timing_samples(port_text)
    assert timing == _timing_samples(ref_text)
    return timing


def _step(daemon, t: float) -> None:
    # The 1 s self-report cadence runs on the wall clock: fire it on
    # every step of both daemons so its series compare too.
    daemon._last_self_report = float("-inf")
    daemon.step(t)


def _ref_state(daemon) -> dict:
    return {k: np.asarray(v) for k, v in daemon.detector.state._asdict().items()}


def _port_state(daemon) -> dict:
    return daemon.pipeline.state_snapshot()[0]


def _assert_states(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want)
    for k, b in want.items():
        a = got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: {k}"
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{what}: {k}")


def _flag_lines(text: str) -> list[str]:
    return sorted(line for line in text.splitlines() if line.startswith(tele_metrics.ANOMALY_FLAG_TOTAL))


# -- the two cases of tests/test_daemon.py, side by side ----------------


def test_end_to_end_matches_the_reference_daemon(env):
    """Ingest → metrics, the disabled-flag leg, and the resume: the
    reference's first daemon case through both packages."""
    ref, port = _boot(env, "ref", "ref"), _boot(env, "port", "port")
    ref.start()
    port.start()
    rng = np.random.default_rng(0)
    try:
        for step in range(30):
            # a ×10 latency fault on cart from step 24 (past the warm-up)
            body = _payload("payment", 50, rng)
            fault = _payload("cart", 20, rng, lat_ns=10**7 if step >= 24 else None)
            for d in (ref, port):
                assert _post(d.receiver.port, body) == 200
                assert _post(d.receiver.port, fault) == 200
            for d in (ref, port):
                _step(d, step * 0.05)
        for d in (ref, port):
            d.pipeline.drain()
            _step(d, 30 * 0.05)
        want_state = _ref_state(ref)
        _assert_states(_port_state(port), want_state, "after 30 steps")
        assert port.pipeline.stats.spans == ref.pipeline.stats.spans == 30 * 70
        ref_text, port_text = _scrape(ref), _scrape(port)
        assert tele_metrics.ANOMALY_Z_SCORE in port_text and 'service="payment"' in port_text
        assert _flag_lines(port_text) == _flag_lines(ref_text)
        assert any('service="cart"' in line for line in _flag_lines(port_text))
        assert all(_assert_expositions_equal(port, ref).values())

        # Disable via the flag file: pending work drains and drops.
        flag_path = env.tmp_path / "flags.json"
        flag_path.write_text(_flags_doc(False))
        os.utime(flag_path)
        before = {id(d): d.pipeline.stats.spans for d in (ref, port)}
        body = _payload("payment", 50, rng)
        for d in (ref, port):
            _post(d.receiver.port, body)
            _step(d, 2.0)
            assert d.pipeline.stats.spans == before[id(d)]
        assert port.pipeline.stats.dropped_disabled == ref.pipeline.stats.dropped_disabled >= 50
        _assert_states(_port_state(port), want_state, "disabled leg")
        final = _port_state(port)
    finally:
        ref.shutdown()
        port.shutdown()

    # Reboot: state, names and window clock come back from each checkpoint.
    ref2, port2 = _boot(env, "ref", "ref"), _boot(env, "port", "port")
    try:
        assert port2.pipeline.tensorizer.service_names == ref2.pipeline.tensorizer.service_names
        assert port2.pipeline.tensorizer.service_names[:2] == ["payment", "cart"]
        _assert_states(_port_state(port2), _ref_state(ref2), "resumed")
        _assert_states(_port_state(port2), final, "resumed = final")
        assert int(port2.detector.state.step_idx) > 0
        assert port2.detector.clock._t_prev == pytest.approx(ref2.detector.clock._t_prev)
    finally:
        ref2.shutdown()
        port2.shutdown()


def test_metrics_leg_matches_the_reference_daemon(env):
    """The /v1/metrics leg: a counter-rate surge flags on both, the
    metrics heads agree, and the warm head state resumes."""
    ref, port = _boot(env, "ref", "ref"), _boot(env, "port", "port")
    ref.start()
    port.start()
    rng = np.random.default_rng(5)
    try:
        total, t = 0.0, 0.0
        for i in range(60):
            t += 5.0
            rate = 30.0 * (1.0 + 0.05 * rng.standard_normal())
            if i >= 50:
                rate = 300.0  # the queue-problems surge
            total += rate * 5.0
            body = encode_metrics_request(
                [("kafka", [("queue_depth_total", total, True)])], t_ns=int(t * 1e9)
            )
            for d in (ref, port):
                assert _post(d.receiver.port, body, "/v1/metrics") == 200
            for d in (ref, port):
                _step(d, t)
        ref_text, port_text = _scrape(ref), _scrape(port)
        assert 'app_anomaly_metric_flags_total{service="kafka"}' in port_text
        metric_lines = sorted(line for line in ref_text.splitlines() if line.startswith("app_anomaly_metric"))
        assert metric_lines and sorted(
            line for line in port_text.splitlines() if line.startswith("app_anomaly_metric")
        ) == metric_lines
        # no spans: the window histogram has no observation in either
        assert _assert_expositions_equal(port, ref)["anomaly_spine_put_overlap_ratio"]
        for name, want in ref.metrics_feed.head.state._asdict().items():
            got = getattr(port.metrics_feed.head.state, name).numpy()
            want = np.asarray(want)
            if want.dtype.kind in "iu":
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
    finally:
        ref.shutdown()
        port.shutdown()

    port2 = _boot(env, "port", "port")
    try:
        assert port2.metrics_feed.service_names == ["kafka"]
        assert port2.metrics_feed.metric_names == ["queue_depth_total"]
        assert float(port2.metrics_feed.head.state.obs[0, 0]) > 30  # warm, not reset
    finally:
        port2.shutdown()


def test_constant_latency_variance_is_zero_up_to_float32_cancellation(env):
    """The reference test's bodies carry one latency, so each batch's
    latency variance is 0 and its formula, E[x²] − 2·m·x̄ + m² over
    log-latencies near 6.9, cancels to a few float32 ulps of 2·x̄²: the
    reference's own result is one such value (0 here), the port's
    another. Integer state, flags and every other float agree at the
    stated tolerance; ``lat_var`` agrees within that cancellation."""
    ref, port = _boot(env, "ref", "ref"), _boot(env, "port", "port")
    ref.start()
    port.start()
    rng = np.random.default_rng(0)
    try:
        for step in range(30):
            body = _payload("payment", 50, rng, lat_ns=10**6)
            for d in (ref, port):
                assert _post(d.receiver.port, body) == 200
                _step(d, step * 0.05)
        for d in (ref, port):
            d.pipeline.drain()
        got, want = _port_state(port), _ref_state(ref)
        lat_var = (got.pop("lat_var"), want.pop("lat_var"))
        _assert_states(got, want, "constant latency")
        xbar = float(np.log(1000.0))  # log of the latency in µs
        bound = 4 * float(np.spacing(np.float32(2 * xbar * xbar)))
        for v in lat_var:
            assert float(np.abs(v).max()) <= bound
        assert _flag_lines(_scrape(port)) == _flag_lines(_scrape(ref))
    finally:
        ref.shutdown()
        port.shutdown()


@pytest.mark.parametrize("direction", ["reference-to-port", "port-to-reference"])
def test_checkpoint_resumes_across_packages(env, direction):
    """A daemon's shutdown checkpoint boots the other package's daemon
    with equal state, names and offsets."""
    writer_kind, reader_kind = ("ref", "port") if direction == "reference-to-port" else ("port", "ref")
    writer = _boot(env, writer_kind, "shared")
    writer.start()
    rng = np.random.default_rng(3)
    try:
        for step in range(12):
            assert _post(writer.receiver.port, _payload("checkout", 40, rng)) == 200
            assert _post(writer.receiver.port, _payload("payment", 30, rng)) == 200
            _step(writer, step * 0.05)
        writer.pipeline.drain()
        want = _port_state(writer) if writer_kind == "port" else _ref_state(writer)
        names = list(writer.pipeline.tensorizer.service_names)
    finally:
        writer.shutdown()
    reader = _boot(env, reader_kind, "shared")
    try:
        got = _port_state(reader) if reader_kind == "port" else _ref_state(reader)
        assert reader.pipeline.tensorizer.service_names == names
        for k, b in want.items():
            np.testing.assert_array_equal(got[k], b, err_msg=k)  # a file round trip is exact
    finally:
        reader.shutdown()


# -- boot contract ------------------------------------------------------


def test_daemon_runs_on_the_card_unless_asked(env):
    env.setenv("ANOMALY_CHECKPOINT", "")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectorDaemon(DetectorConfig(**SMALL))


def test_build_info_carries_torch_and_cuda(env):
    daemon = _boot(env, "port", "port")
    try:
        daemon.start()
        lines = [line for line in _scrape(daemon).splitlines() if line.startswith("anomaly_build_info{")]
        assert lines == [
            f'anomaly_build_info{{cuda="{torch.version.cuda or "none"}",frame_version="2",'
            f'torch="{torch.__version__}",version="0.1.0"}} 1.0'
        ]
    finally:
        daemon.shutdown()


def test_front_door_that_did_not_build_refuses_the_boot(env):
    env.setenv("ANOMALY_FRONTDOOR_ENABLE", "1")
    env.setenv("ANOMALY_CHECKPOINT", "")
    env.setattr(port_native, "frontdoor_available", lambda: False)
    env.setattr(port_native, "frontdoor_load_error", lambda: "g++: not found")
    with pytest.raises(RuntimeError, match="g\\+\\+: not found"):
        DetectorDaemon(DetectorConfig(**SMALL), device="cpu")


def test_front_door_serves_when_enabled(env):
    env.setenv("ANOMALY_FRONTDOOR_ENABLE", "1")
    env.setenv("ANOMALY_FRONTDOOR_PORT", "0")
    daemon = _boot(env, "port", "port")
    daemon.start()
    try:
        assert daemon.frontdoor is not None
        rng = np.random.default_rng(9)
        conn = http.client.HTTPConnection("127.0.0.1", daemon.frontdoor.port, timeout=10.0)
        conn.request("POST", "/v1/traces", body=_payload("cart", 64, rng),
                     headers={"Content-Type": "application/x-protobuf"})
        assert conn.getresponse().status == 200
        conn.close()
        daemon.step(0.0)
        daemon.pipeline.drain()
        assert daemon.pipeline.stats.spans == 64
    finally:
        daemon.shutdown()


def test_a_failed_warmup_is_kept_and_logged(env, caplog):
    env.setenv("ANOMALY_ADAPTIVE_BATCH", "1")
    env.setenv("ANOMALY_CHECKPOINT", "")

    def broken(self):
        raise RuntimeError("kernel did not launch")

    env.setattr(port_daemon_mod.DetectorPipeline, "warm_widths", broken)
    with caplog.at_level(logging.ERROR, logger=port_daemon_mod.__name__):
        daemon = DetectorDaemon(DetectorConfig(**SMALL), device="cpu")
        try:
            assert daemon.wait_warm(30.0)
            assert isinstance(daemon.warmup_error, RuntimeError)
            assert "kernel did not launch" in str(daemon.warmup_error)
        finally:
            daemon.shutdown()
    assert any("warm-up failed" in r.getMessage() and r.exc_info for r in caplog.records)


def test_warmup_runs_every_width_and_keeps_no_error(env):
    env.setenv("ANOMALY_ADAPTIVE_BATCH", "1")
    env.setenv("ANOMALY_CHECKPOINT", "")
    daemon = DetectorDaemon(DetectorConfig(**SMALL), device="cpu")
    try:
        before = {k: v.clone() for k, v in daemon.detector.state._asdict().items()}
        assert daemon.wait_warm(60.0)
        assert daemon.warmup_error is None
        for k, v in daemon.detector.state._asdict().items():
            assert torch.equal(v, before[k]), k  # the ladder runs on clones
    finally:
        daemon.shutdown()


@pytest.mark.parametrize("knob,overlap", [("0", False), ("1", True)])
def test_spine_overlap_knob_reaches_the_pump_in_both_packages(env, knob, overlap):
    """``ANOMALY_SPINE_OVERLAP`` is threaded into each daemon's spine, as
    the reference's ``runtime/daemon.py`` threads it."""
    env.setenv("ANOMALY_SPINE_RING", "2")
    env.setenv("ANOMALY_SPINE_OVERLAP", knob)
    for which in ("port", "ref"):
        daemon = _boot(env, which, f"ckpt-{which}")
        try:
            assert daemon.pipeline._spine.overlap is overlap, which
        finally:
            daemon.shutdown()


# -- tests/test_chaos.py::TestOtlpIngestFaults, against the port ----------


class TestOtlpIngestFaults:
    @pytest.fixture
    def daemon(self, env):
        env.setenv("ANOMALY_OTLP_MAX_BODY", "4096")
        d = _boot(env, "port", "ckpt")
        d.start()
        yield d
        d.shutdown()

    def _raw(self, port: int, data: bytes) -> bytes:
        s = socket.create_connection(("127.0.0.1", port), timeout=5.0)
        try:
            s.sendall(data)
            s.shutdown(socket.SHUT_WR)
            out = b""
            s.settimeout(5.0)
            while True:
                chunk = s.recv(4096)
                if not chunk:
                    return out
                out += chunk
        finally:
            s.close()

    def test_truncated_body_answers_400_and_server_lives(self, daemon):
        port = daemon.receiver.port
        resp = self._raw(
            port,
            b"POST /v1/traces HTTP/1.1\r\nHost: t\r\n"
            b"Content-Type: application/x-protobuf\r\n"
            b"Content-Length: 512\r\n\r\n" + b"\x0a\x08partial",
        )
        assert b"400" in resp.split(b"\r\n", 1)[0]
        assert daemon.receiver.rejects.get("truncated") == 1
        assert _post(port, b"") == 200
        daemon.step(0.0)
        assert 'anomaly_ingest_rejected_total{reason="truncated",transport="http"} 1.0' in _scrape(daemon)

    def test_oversized_body_answers_413_without_reading(self, daemon):
        port = daemon.receiver.port
        conn = http.client.HTTPConnection("127.0.0.1", port)
        conn.request("POST", "/v1/traces", body=b"x" * 8192, headers={"Content-Type": "application/x-protobuf"})
        assert conn.getresponse().status == 413
        assert daemon.receiver.rejects.get("oversized") == 1
        assert _post(port, b"") == 200

    def test_malformed_body_answers_400_with_counter(self, daemon):
        port = daemon.receiver.port
        assert _post(port, b"\xff\xff\xff\xff garbage") == 400
        assert daemon.receiver.rejects.get("malformed") == 1
        assert _post(port, b"") == 200

    def test_abrupt_disconnect_mid_body_survives(self, daemon):
        port = daemon.receiver.port
        s = socket.create_connection(("127.0.0.1", port), timeout=5.0)
        s.sendall(b"POST /v1/traces HTTP/1.1\r\nHost: t\r\nContent-Length: 100000\r\n\r\n" + b"y" * 10)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        s.close()  # RST
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not daemon.receiver.rejects:
            time.sleep(0.05)
        assert _post(port, b"") == 200


# -- tests/test_chaos.py::TestSupervisedDaemon, against the port ----------


class TestSupervisedDaemon:
    def test_dead_harvester_restarted(self, env):
        env.setenv("ANOMALY_HARVEST_ASYNC", "1")
        daemon = _boot(env, "port", "ckpt")
        daemon.start()
        try:
            assert daemon.pipeline.harvester_alive()
            daemon.pipeline._harvest_stop = True
            daemon.pipeline._harvest_wake.set()
            daemon.pipeline._harvest_thread.join(timeout=5.0)
            assert not daemon.pipeline.harvester_alive()
            deadline = time.monotonic() + 10.0
            t = 0.0
            while time.monotonic() < deadline:
                daemon.step(t)
                t += 0.25
                if daemon.pipeline.harvester_alive():
                    break
                time.sleep(0.05)
            assert daemon.pipeline.harvester_alive(), "harvester not revived"
            assert daemon._supervisor.restarts("harvester") >= 1
            assert 'anomaly_component_restarts_total{component="harvester"}' in _scrape(daemon)
        finally:
            daemon.shutdown()

    def test_component_health_on_grpc_surface(self, env):
        pytest.importorskip("grpc")
        from opentelemetry_demo_tpu_torch.runtime.health_probe import probe

        env.setenv("ANOMALY_OTLP_GRPC_PORT", "0")
        daemon = _boot(env, "port", "ckpt")
        daemon.start()
        try:
            addr = f"127.0.0.1:{daemon.grpc_receiver.port}"
            assert probe(addr)
            assert probe(addr, "anomaly.component.pump")
            assert not probe(addr, "anomaly.component.nope")
            daemon._supervisor.report_crash("pump", RuntimeError("boom"))
            assert not probe(addr, "anomaly.component.pump")
            assert probe(addr)
        finally:
            daemon.shutdown()

    def test_dead_http_receiver_restarted_same_port(self, env):
        daemon = _boot(env, "port", "ckpt")
        daemon.start()
        try:
            port = daemon.receiver.port
            daemon.receiver.stop()
            assert not daemon.receiver.alive()
            deadline = time.monotonic() + 10.0
            t = 0.0
            while time.monotonic() < deadline:
                daemon.step(t)
                t += 0.25
                if daemon.receiver.alive():
                    break
                time.sleep(0.05)
            assert daemon.receiver.alive(), "receiver not revived"
            assert daemon.receiver.port == port
            assert _post(port, b"") == 200
        finally:
            daemon.shutdown()


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the daemon's default device is the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_daemon_on_the_card_flags_a_fault(env, cuda_device):
    """``DetectorDaemon()`` with no device runs on the card: a ×10
    latency fault on one service flags there as on the CPU twin."""
    env.setenv("ANOMALY_CHECKPOINT", "")
    card = DetectorDaemon(DetectorConfig(**SMALL))
    cpu = DetectorDaemon(DetectorConfig(**SMALL), device="cpu")
    assert card.device.type == "cuda" and card.detector.state.hll_bank.is_cuda
    card.start()
    cpu.start()
    rng = np.random.default_rng(2)
    try:
        for step in range(40):
            body = _payload("payment", 50, rng)
            fault = _payload("cart", 20, rng, lat_ns=10**7 if step >= 30 else None)
            for d in (card, cpu):
                assert _post(d.receiver.port, body) == 200
                assert _post(d.receiver.port, fault) == 200
            for d in (card, cpu):
                _step(d, step * 0.05)
        for d in (card, cpu):
            d.pipeline.drain()
        _assert_states(_port_state(card), _port_state(cpu), "card vs CPU")
        assert any('service="cart"' in line for line in _flag_lines(_scrape(card)))
        assert _flag_lines(_scrape(card)) == _flag_lines(_scrape(cpu))
        assert card.warmup_error is None
    finally:
        card.shutdown()
        cpu.shutdown()
