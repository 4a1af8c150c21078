"""``python -m opentelemetry_demo_tpu_torch``: the port's daemon as a process.

- With ``--device cpu`` it boots, announces its ports, flags a POSTed
  ×10 latency fault on ``/metrics``, and on SIGTERM writes its
  checkpoint and exits 0.
- Without ``--device`` it runs on the card, so with no card it exits
  non-zero with the "no CUDA device" message and binds nothing.
- The counterpart of ``tests/test_replication.py``'s
  ``test_failover_drill_sigkill_primary``: a port primary daemon
  process, SIGKILLed under live Kafka and OTLP load, and an in-process
  port standby that promotes with the replicated offsets.
- ``replbench.measure_adoption(device="cpu")``, marked ``slow`` as its
  reference counterpart (``tests/test_fleet.py``,
  ``test_autoscale_sigkill_adoption_live``) is.
"""

from __future__ import annotations

import http.client
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu_torch.models.detector import DetectorConfig
from opentelemetry_demo_tpu_torch.runtime import checkpoint
from opentelemetry_demo_tpu_torch.runtime.daemon import DetectorDaemon
from opentelemetry_demo_tpu_torch.runtime.kafka_broker import KafkaBroker
from opentelemetry_demo_tpu_torch.runtime.kafka_orders import Order, encode_order
from opentelemetry_demo_tpu_torch.runtime.otlp_export import encode_export_request
from opentelemetry_demo_tpu_torch.runtime.replication import ROLE_PRIMARY
from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanRecord

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_services=8, hll_p=8, cms_width=512)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _child_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("ANOMALY_") and k != "KAFKA_ADDR"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONUNBUFFERED"] = "1"
    env["OMP_NUM_THREADS"] = "1"
    env.update({
        "ANOMALY_OTLP_PORT": "0",
        "ANOMALY_OTLP_GRPC_PORT": "-1",
        "ANOMALY_METRICS_PORT": "0",
        "ANOMALY_QUERY_PORT": "0",
        "ANOMALY_BATCH": "256",
        "ANOMALY_ADAPTIVE_BATCH": "0",
        "ANOMALY_NUM_SERVICES": "8",
        "ANOMALY_CMS_WIDTH": "512",
        "ANOMALY_HLL_P": "8",
    })
    env.update(extra)
    return env


def _read_announce(proc, timeout_s: float = 120.0) -> str:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        out = proc.stdout.readline()
        if not out:
            if proc.poll() is not None:
                raise RuntimeError(f"daemon exited rc={proc.returncode}")
            time.sleep(0.05)
            continue
        if "anomaly-detector:" in out:
            return out
    raise RuntimeError("daemon never announced")


def _spans(service: str, n: int, rng, scale: float = 1.0) -> bytes:
    return encode_export_request([
        SpanRecord(
            service=service, duration_us=float(1000.0 * scale * rng.lognormal(0.0, 0.2)),
            trace_id=rng.bytes(8), is_error=False, attr="route",
        )
        for _ in range(n)
    ])


def _post(port: int, body: bytes) -> int:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10.0)
    conn.request("POST", "/v1/traces", body=body, headers={"Content-Type": "application/x-protobuf"})
    resp = conn.getresponse()
    resp.read()
    conn.close()
    return resp.status


def _scrape(port: int) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10.0)
    conn.request("GET", "/metrics")
    text = conn.getresponse().read().decode()
    conn.close()
    return text


def test_module_entry_point_on_the_cpu(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    proc = subprocess.Popen(
        [sys.executable, "-m", "opentelemetry_demo_tpu_torch", "--device", "cpu"],
        cwd=REPO, env=_child_env(ANOMALY_CHECKPOINT=ckpt, ANOMALY_CHECKPOINT_INTERVAL_S="3600"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        line = _read_announce(proc)
        otlp = int(re.search(r"otlp-http :(\d+)", line).group(1))
        metrics = int(re.search(r"metrics :(\d+)", line).group(1))
        assert "role primary" in line and otlp > 0
        rng = np.random.default_rng(1)
        for _ in range(30):  # past the CUSUM warm-up
            assert _post(otlp, _spans("cart", 256, rng)) == 200
            time.sleep(0.06)
        flag = 'app_anomaly_flags_total{service="cart"}'
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and flag not in _scrape(metrics):
            assert _post(otlp, _spans("cart", 256, rng, scale=10.0)) == 200
            time.sleep(0.06)
        text = _scrape(metrics)
        assert flag in text
        assert "app_anomaly_spans_processed_total" in text
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert checkpoint.exists(ckpt)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)


def test_module_entry_point_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    proc = subprocess.run(
        [sys.executable, "-m", "opentelemetry_demo_tpu_torch"],
        cwd=REPO, env=_child_env(ANOMALY_CHECKPOINT=str(tmp_path / "ckpt")),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "anomaly-detector:" not in proc.stdout


def _step_until(daemon, cond, timeout_s=20.0, poll_s=0.02):
    deadline = time.monotonic() + timeout_s
    t = 0.0
    while time.monotonic() < deadline:
        daemon.step(t)
        if cond():
            return
        t += 0.25
        time.sleep(poll_s)
    raise AssertionError("condition not reached before timeout")


def _order(i: int) -> bytes:
    return encode_order(Order(
        order_id=f"ord-{i}", tracking_id=f"trk-{i}", shipping_cost_units=5.0,
        item_count=1, product_ids=("EYE-PLO-25",), total_quantity=1,
    ))


def test_failover_drill_sigkill_primary(monkeypatch, tmp_path):
    """SIGKILL a port primary daemon process under live Kafka + OTLP
    load; the in-process port standby promotes with offset continuity
    and answers OTLP ingest."""
    pytest.importorskip("grpc")
    broker = KafkaBroker()
    broker.start()
    broker.ensure_topic("orders")
    env = _child_env(
        ANOMALY_OTLP_GRPC_PORT="0",  # the standby's health double-check target
        ANOMALY_BATCH="128",
        ANOMALY_PUMP_INTERVAL_S="0.05",
        ANOMALY_CHECKPOINT=str(tmp_path / "primary"),
        ANOMALY_CHECKPOINT_INTERVAL_S="1",
        ANOMALY_INGEST_WORKERS="0",  # serial: offsets confirm inline
        ANOMALY_ROLE="primary",
        ANOMALY_REPLICATION_PORT="0",
        ANOMALY_REPLICATION_INTERVAL_S="0.1",
        KAFKA_ADDR=f"127.0.0.1:{broker.port}",
    )
    proc = subprocess.Popen(
        [sys.executable, "-m", "opentelemetry_demo_tpu_torch.runtime.daemon", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    standby = None
    try:
        line = _read_announce(proc)
        otlp_port = int(re.search(r"otlp-http :(\d+)", line).group(1))
        grpc_port = int(re.search(r"otlp-grpc :(\d+)", line).group(1))
        repl_port = int(re.search(r"repl :(\d+)", line).group(1))
        assert repl_port > 0 and grpc_port > 0
        for i in range(12):
            broker.append("orders", _order(i))
        body = encode_export_request([
            SpanRecord(service="payment", duration_us=900.0, trace_id=os.urandom(8), is_error=False, attr="p")
            for _ in range(16)
        ])
        assert _post(otlp_port, body) == 200

        for k, v in {
            "ANOMALY_OTLP_PORT": "0", "ANOMALY_OTLP_GRPC_PORT": "-1", "ANOMALY_METRICS_PORT": "0",
            "ANOMALY_BATCH": "256", "ANOMALY_ADAPTIVE_BATCH": "0",
            "ANOMALY_CHECKPOINT": str(tmp_path / "standby"),
            "ANOMALY_ROLE": "standby",
            "ANOMALY_REPLICATION_TARGET": f"127.0.0.1:{repl_port}",
            "ANOMALY_FAILOVER_TIMEOUT_S": "2.0",
            "ANOMALY_PRIMARY_HEALTH_ADDR": f"127.0.0.1:{grpc_port}",
            "ANOMALY_INGEST_WORKERS": "0",
            "KAFKA_ADDR": f"127.0.0.1:{broker.port}",
        }.items():
            monkeypatch.setenv(k, v)
        monkeypatch.delenv("ANOMALY_REPLICATION_PORT", raising=False)
        standby = DetectorDaemon(DetectorConfig(**SMALL), device="cpu")
        standby.start()

        def replicated_offset() -> int:
            offs = standby.repl_standby.meta.get("offsets") or {}
            return max((int(o) for o in offs.values()), default=0)

        _step_until(standby, lambda: replicated_offset() >= 12, timeout_s=60.0)
        replicated = {int(p): int(o) for p, o in standby.repl_standby.meta["offsets"].items()}

        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        t_kill = time.monotonic()
        _step_until(standby, lambda: standby.role == ROLE_PRIMARY, timeout_s=30.0)
        assert time.monotonic() - t_kill < 15.0
        assert standby._offsets == replicated
        assert standby._fence.epoch >= 1
        for i in range(12, 15):
            broker.append("orders", _order(i))
        floor = replicated.get(0, 0)
        _step_until(standby, lambda: standby._offsets.get(0, 0) >= 15, timeout_s=30.0)
        assert standby._offsets.get(0, 0) >= max(floor, 15)
        assert _post(standby.receiver.port, body) == 200
        assert checkpoint.peek_epoch(str(tmp_path / "standby")) >= 1
    finally:
        if standby is not None:
            standby.shutdown()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)
        broker.stop()


@pytest.mark.slow
def test_autoscale_sigkill_adoption_live():
    """The elastic leg end to end with port daemon processes on the CPU
    (marked slow as the reference's own case is)."""
    from opentelemetry_demo_tpu_torch.runtime.replbench import measure_adoption

    out = measure_adoption(device="cpu")
    assert out["autoscale_ok"] is True, out.get("adoption_mismatch")
    assert out["autoscale_proposals_split"] >= 1
    assert out["adoption_bitexact"] is True
    assert out["adoption_answers_victim_keys"] is True
    assert out["adoption_no_oscillation"] is True
    assert out["autoscale_tta_s"] <= out["adoption_dead_after_s"] + out["adoption_heartbeat_s"] + 2.0


def test_reshard_live_on_the_cpu():
    """``measure_reshard_live``: a port victim daemon process SIGKILLed
    mid-load; the in-process survivor's adoption of its mirrored frame
    answers the victim's keys exactly as the frame alone does."""
    from opentelemetry_demo_tpu_torch.runtime.replbench import measure_reshard_live

    out = measure_reshard_live(dead_after_s=1.0, device="cpu")
    assert out["live_survivor_answers"] is True
    assert out["live_adoption_exact"] is True
    assert out["live_reshards_applied"] >= 1
