"""Query-plane benchmark: read latency and QPS beside live ingest.

A real ``DetectorPipeline`` under steady span load, the HTTP query
service (``runtime.query``) over the pipeline's state snapshot, and
paced concurrent clients while ingest keeps pumping:

- ``query_p50_ms`` / ``query_p99_ms``: per-request wall time through
  the whole stack (HTTP parse → snapshot cache → numpy sketch reads →
  JSON);
- ``query_qps``: answered queries per second at that latency;
- ``ingest_ratio``: ingest spans/s with the clients running over a
  query-free baseline measured the same way in the same process.

``python -m opentelemetry_demo_tpu_torch.runtime.querybench`` prints one
JSON line (on the card).
"""

from __future__ import annotations

import http.client
import json
import threading
import time

import numpy as np

from ..models import AnomalyDetector, DetectorConfig
from .lagbench import make_columns
from .pipeline import DetectorPipeline
from .provenance import REASON_LATENCY, ProvenanceEngine
from .query import QueryEngine, QueryService

SERVICES = (
    "frontend", "cart", "checkout", "currency",
    "payment", "shipping", "email", "ad",
)


def state_snapshot_fn(pipe: DetectorPipeline):
    """The query plane's snapshot function over a live pipeline: the
    whole state copied off the device in stream order
    (``DetectorPipeline.state_snapshot``: the copy is enqueued under the
    dispatch lock and waited for outside it), and the meta block in the
    checkpoint's shape."""
    detector = pipe.detector

    def snapshot():
        arrays, clock_t_prev = pipe.state_snapshot()
        return arrays, {
            "offsets": {},
            "service_names": pipe.tensorizer.service_names,
            "clock_t_prev": clock_t_prev,
            "config": list(detector.config._replace(sketch_impl=None)),
            "query": pipe.query_meta(),
        }

    return snapshot


def measure_query(
    seconds: float = 2.0,
    batch: int = 256,
    pump_interval_s: float = 0.01,
    query_threads: int = 4,
    query_interval_s: float = 0.02,
    seed: int = 0,
    config: DetectorConfig | None = None,
    device: "str | None" = None,
) -> dict:
    """Ingest-alone baseline, then ingest + concurrent query clients.

    Both phases run the same pump loop in the same process, so
    ``ingest_ratio`` isolates the query plane's interference from
    run-to-run variance. Clients are paced (``query_interval_s`` between
    requests, a Grafana refresh cadence times a few panels): an unpaced
    hammer measures GIL starvation of the pump thread, not the query
    plane. Runs on the card unless ``device="cpu"``."""
    config = config or DetectorConfig(
        num_services=8, hll_p=8, cms_width=512
    )
    detector = AnomalyDetector(config, device=device)
    prov = ProvenanceEngine(config)
    pipe = DetectorPipeline(detector, batch_size=batch, provenance=prov)
    for name in SERVICES:
        pipe.tensorizer.service_id(name)
    # Seed the explain ring with bundles of realistic size (steady load
    # rarely flags), built by the real engine and landed the way a
    # restored query_meta block lands them.
    pipe.restore_query_meta({
        "explains": [
            prov.build(
                t_batch=float(i), seq=i, service=i % len(SERVICES),
                label=SERVICES[i % len(SERVICES)],
                signals=[REASON_LATENCY], exemplars=[], state=None,
                hh_candidates=[], trace_id=None,
            )
            for i in range(8)
        ],
    })
    engine = QueryEngine(
        snapshot_fn=state_snapshot_fn(pipe), max_staleness_s=0.5
    )
    service = QueryService(engine, host="127.0.0.1", port=0)
    service.start()
    rng = np.random.default_rng(seed)

    def feed(t0: float, run_s: float) -> float:
        """Pump at cadence for run_s; returns spans/s over the phase."""
        spans0 = pipe.stats.spans
        t = t0
        t_end = time.monotonic() + run_s
        t_wall0 = time.monotonic()
        while time.monotonic() < t_end:
            cols = make_columns(rng, batch)
            cols = cols._replace(
                svc=(cols.svc % len(SERVICES)).astype(np.int32)
            )
            pipe.submit_columns(cols)
            pipe.pump(t)
            t += pump_interval_s
            time.sleep(pump_interval_s)
        pipe.drain()
        wall = max(time.monotonic() - t_wall0, 1e-6)
        return (pipe.stats.spans - spans0) / wall, t

    # Warm-up, then the ingest-alone baseline.
    pipe.submit_columns(make_columns(rng, batch))
    pipe.pump(0.0)
    pipe.drain()
    baseline_rate, t_virtual = feed(pump_interval_s, seconds)

    # Query hammer beside live ingest.
    paths = [
        "/query/topk?service=frontend",
        "/query/cardinality?service=cart",
        "/query/zscore?service=checkout",
        "/query/anomalies?limit=10",
        "/query/explain?limit=5",
        "/query/services",
    ]
    latencies: list[float] = []
    explain_lat: list[float] = []
    errors = [0]
    lat_lock = threading.Lock()
    stop = threading.Event()

    def hammer(widx: int) -> None:
        conn = http.client.HTTPConnection(
            "127.0.0.1", service.port, timeout=5.0
        )
        i = widx
        while not stop.is_set():
            path = paths[i % len(paths)]
            i += 1
            t0 = time.perf_counter()
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                resp.read()
                ok = resp.status == 200
            except Exception:  # noqa: BLE001 — count, reconnect, go on
                ok = False
                conn.close()
                conn = http.client.HTTPConnection(
                    "127.0.0.1", service.port, timeout=5.0
                )
            dt = time.perf_counter() - t0
            with lat_lock:
                if ok:
                    latencies.append(dt)
                    # The explain leg gets its own percentile (bundles
                    # are the largest answers) and counts in the QPS.
                    if path.startswith("/query/explain"):
                        explain_lat.append(dt)
                else:
                    errors[0] += 1
            if query_interval_s > dt:
                time.sleep(query_interval_s - dt)
        conn.close()

    workers = [
        threading.Thread(target=hammer, args=(w,), daemon=True)
        for w in range(query_threads)
    ]
    t_q0 = time.monotonic()
    for w in workers:
        w.start()
    try:
        query_rate, _ = feed(t_virtual, seconds)
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=5.0)
        query_wall = max(time.monotonic() - t_q0, 1e-6)
        service.stop()
    lat_ms = np.asarray(latencies) * 1e3
    exp_ms = np.asarray(explain_lat) * 1e3
    return {
        "query_p50_ms": (
            round(float(np.percentile(lat_ms, 50)), 3) if len(lat_ms) else None
        ),
        "query_p99_ms": (
            round(float(np.percentile(lat_ms, 99)), 3) if len(lat_ms) else None
        ),
        "explain_p99_ms": (
            round(float(np.percentile(exp_ms, 99)), 3) if len(exp_ms) else None
        ),
        "explain_queries": int(len(exp_ms)),
        "query_qps": round(len(lat_ms) / query_wall, 1),
        "query_errors": int(errors[0]),
        "queries_total": int(len(lat_ms)),
        "query_threads": int(query_threads),
        "ingest_spans_per_sec": round(query_rate, 1),
        "ingest_spans_per_sec_baseline": round(baseline_rate, 1),
        "ingest_ratio": round(query_rate / max(baseline_rate, 1e-9), 3),
        "spans_fed": int(pipe.stats.spans),
    }


def main() -> None:
    print(json.dumps(measure_query()))


if __name__ == "__main__":
    main()
