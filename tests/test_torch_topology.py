"""The port's process topologies on localhost sockets, on the CPU.

The process tiers of ``tests/test_cross_process.py`` and
``tests/test_kafka_live_topology.py`` with the port's entry points:

- compose: the port's daemon (``python -m opentelemetry_demo_tpu_torch
  --device cpu``) and ``python -m opentelemetry_demo_tpu_torch.serve_shop
  --device cpu --otlp-endpoint ...`` as two processes; ``paymentFailure``
  flipped through the shop's flag editor is flagged on the daemon's
  ``/metrics``, and the shop's error logs are stored there;
- Kafka: ``python -m opentelemetry_demo_tpu_torch.serve_kafka``,
  ``serve_shop --device cpu --kafka`` and the daemon with ``KAFKA_ADDR``
  as three processes; the ``kafkaQueueProblems`` flood flags
  ``checkout-orders`` and all three consumer groups commit, read over
  the wire with the port's ``KafkaConsumer``.

One module fixture per topology, at the reference fixtures' small
geometry (16 slots, CMS 512, HLL p=8) and warm-ups.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from opentelemetry_demo_tpu_torch.runtime.kafka_client import KafkaConsumer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"ANOMALY_NUM_SERVICES": "16", "ANOMALY_CMS_WIDTH": "512", "ANOMALY_HLL_P": "8"}


def _clean_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("ANOMALY_", "SHOP_")) and k not in ("KAFKA_ADDR", "OTEL_EXPORTER_OTLP_ENDPOINT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONUNBUFFERED"] = "1"
    return env


def _spawn(args: list[str], env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait_line(proc, pattern: str, timeout_s: float = 90.0) -> str:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(f"process exited rc={proc.returncode} before '{pattern}'")
            time.sleep(0.05)
            continue
        if re.search(pattern, line):
            return line
    raise TimeoutError(f"no line matching {pattern!r} within {timeout_s}s")


def _stop(procs) -> None:
    for proc in procs:
        if proc is not None:
            proc.terminate()
    for proc in procs:
        if proc is not None:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=15)


def _get(url: str, timeout: float = 10.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def _post_json(url: str, doc: dict, timeout: float = 10.0) -> int:
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        resp.read()
        return resp.status


def _metric(text: str, pattern: str) -> float:
    m = re.search(pattern, text, re.M)
    return float(m.group(1)) if m else 0.0


def _checkout(base: str, session: str) -> None:
    _post_json(f"{base}/api/cart", {"userId": session, "item": {"productId": "TEL-DOB-10", "quantity": 1}})
    try:
        _post_json(f"{base}/api/checkout", {"userId": session, "email": f"{session}@example.com",
                                            "currencyCode": "USD"})
    except urllib.error.HTTPError:
        pass  # paymentFailure phase: 500 is the expected shape


def _flag_doc(flag: str, on) -> dict:
    return {"data": {"flags": {flag: {"state": "ENABLED", "variants": {"on": on, "off": 0},
                                      "defaultVariant": "on"}}}}


# -- compose: shop → OTLP → daemon ---------------------------------------------------


@pytest.fixture(scope="module")
def topology():
    env = _clean_env()
    env.update(SMALL, ANOMALY_OTLP_PORT="0", ANOMALY_OTLP_GRPC_PORT="-1", ANOMALY_METRICS_PORT="0",
               ANOMALY_BATCH="128", ANOMALY_PUMP_INTERVAL_S="0.05", ANOMALY_WARMUP_BATCHES="8")
    daemon = _spawn(["opentelemetry_demo_tpu_torch", "--device", "cpu"], env)
    shop = None
    try:
        line = _wait_line(daemon, r"anomaly-detector: otlp-http :\d+")
        otlp_port = int(re.search(r"otlp-http :(\d+)", line).group(1))
        metrics_port = int(re.search(r"metrics :(\d+)", line).group(1))
        shop = _spawn(["opentelemetry_demo_tpu_torch.serve_shop", "--device", "cpu", "--host", "127.0.0.1",
                       "--port", "0", "--users", "0", "--otlp-endpoint", f"http://127.0.0.1:{otlp_port}"],
                      _clean_env())
        line = _wait_line(shop, r"shop gateway on http://")
        shop_port = int(re.search(r"http://[^:]+:(\d+)", line).group(1))
        yield {"shop": f"http://127.0.0.1:{shop_port}", "daemon_metrics": f"http://127.0.0.1:{metrics_port}"}
    finally:
        _stop([shop, daemon])


def test_fault_flag_lights_detector_across_process_boundary(topology):
    shop, metrics = topology["shop"], topology["daemon_metrics"]
    deadline = time.monotonic() + 60.0
    harvested = False
    i = 0
    while time.monotonic() < deadline and not harvested:
        _checkout(shop, f"warmup-{i}")
        i += 1
        harvested = bool(re.search(r"^app_anomaly_spans_processed_total \d", _get(f"{metrics}/metrics").decode(),
                                   re.M))
        time.sleep(0.3)
    assert harvested, "the daemon never harvested its first report"
    for i in range(16):
        _checkout(shop, f"user-{i}")
        time.sleep(0.07)
    deadline = time.monotonic() + 60.0
    spans_seen = 0.0
    while time.monotonic() < deadline and spans_seen < 100:
        spans_seen = _metric(_get(f"{metrics}/metrics").decode(), r"^app_anomaly_spans_processed_total (\d+\.?\d*)")
        time.sleep(0.5)
    assert spans_seen >= 100, "the daemon never ingested the shop's spans"
    assert _metric(_get(f"{metrics}/metrics").decode(), r'app_anomaly_flags_total\{service="payment"\} (\d+\.?\d*)') == 0
    assert _post_json(f"{shop}/feature/api/write-to-file", _flag_doc("paymentFailure", 1.0)) == 200
    for round_ in range(14):
        for j in range(4):
            _checkout(shop, f"fault-{round_}-{j}")
        time.sleep(0.07)
    deadline = time.monotonic() + 60.0
    flagged = 0.0
    while time.monotonic() < deadline and flagged < 1:
        flagged = _metric(_get(f"{metrics}/metrics").decode(), r'app_anomaly_flags_total\{service="payment"\} (\d+\.?\d*)')
        time.sleep(0.5)
    assert flagged >= 1, "paymentFailure never flagged across the process boundary"


def test_error_logs_cross_to_daemon_store(topology):
    shop, metrics = topology["shop"], topology["daemon_metrics"]
    deadline = time.monotonic() + 60.0
    seen = stored = 0.0
    i = 0
    while time.monotonic() < deadline:
        _checkout(shop, f"log-leg-{i}")
        i += 1
        text = _get(f"{metrics}/metrics").decode()
        seen = _metric(text, r"^app_anomaly_log_records_processed_total (\d+\.?\d*)")
        stored = _metric(text, r"^app_anomaly_log_docs_stored (\d+\.?\d*)")
        if seen >= 1 and stored >= 1:
            break
        time.sleep(0.4)
    assert seen >= 1, "no shop log record reached the daemon over /v1/logs"
    assert stored >= 1, "log records counted but none stored"


# -- Kafka: broker + shop + daemon ---------------------------------------------------


@pytest.fixture(scope="module")
def kafka_topology():
    broker = _spawn(["opentelemetry_demo_tpu_torch.serve_kafka", "--host", "127.0.0.1", "--port", "0"],
                    _clean_env())
    daemon = shop = None
    try:
        bootstrap = re.search(r"kafka broker on (\S+)", _wait_line(broker, r"kafka broker on \S+:\d+")).group(1)
        env = _clean_env()
        env.update(SMALL, KAFKA_ADDR=bootstrap, ANOMALY_OTLP_PORT="0", ANOMALY_OTLP_GRPC_PORT="-1",
                   ANOMALY_METRICS_PORT="0", ANOMALY_BATCH="128", ANOMALY_PUMP_INTERVAL_S="0.05",
                   ANOMALY_WARMUP_BATCHES="6", ANOMALY_Z_WARMUP_BATCHES="40")
        daemon = _spawn(["opentelemetry_demo_tpu_torch", "--device", "cpu"], env)
        shop = _spawn(["opentelemetry_demo_tpu_torch.serve_shop", "--device", "cpu", "--host", "127.0.0.1",
                       "--port", "0", "--users", "0", "--kafka", bootstrap], _clean_env())
        line = _wait_line(daemon, r"anomaly-detector: otlp-http :\d+")
        metrics_port = int(re.search(r"metrics :(\d+)", line).group(1))
        line = _wait_line(shop, r"shop gateway on http://")
        shop_port = int(re.search(r"http://[^:]+:(\d+)", line).group(1))
        yield {"bootstrap": bootstrap, "shop": f"http://127.0.0.1:{shop_port}",
               "daemon_metrics": f"http://127.0.0.1:{metrics_port}"}
    finally:
        _stop([shop, daemon, broker])


def test_flood_flag_lights_detector_through_the_broker(kafka_topology):
    shop, metrics = kafka_topology["shop"], kafka_topology["daemon_metrics"]
    deadline = time.monotonic() + 120.0
    ingested = 0.0
    i = 0
    while time.monotonic() < deadline and ingested < 55:
        _checkout(shop, f"warm-{i}")
        i += 1
        ingested = _metric(_get(f"{metrics}/metrics").decode(), r"^app_anomaly_spans_processed_total (\d+\.?\d*)")
        time.sleep(0.15)
    assert ingested >= 55, "the daemon never ingested orders off the broker"
    assert _post_json(f"{shop}/feature/api/write-to-file", _flag_doc("kafkaQueueProblems", 80)) == 200
    flagged = False
    deadline = time.monotonic() + 120.0
    j = 0
    while time.monotonic() < deadline and not flagged:
        _checkout(shop, f"flood-{j}")
        j += 1
        flagged = bool(re.search(r'app_anomaly_flags_total\{service="checkout-orders"\} [1-9]',
                                 _get(f"{metrics}/metrics").decode()))
        time.sleep(0.3)
    assert flagged, "the flood never lit the detector on the orders lane"
    for group in ("accounting", "fraud-detection", "anomaly-detector"):
        consumer = KafkaConsumer(kafka_topology["bootstrap"], group, "orders")
        try:
            assert sum(v for v in consumer.committed().values() if v > 0) > 0, group
        finally:
            consumer.close()
