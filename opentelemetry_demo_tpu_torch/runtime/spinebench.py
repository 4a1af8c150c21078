"""End-to-end ingest-spine benchmark: OTLP payload → flagged report.

The bench trajectory had two ISOLATED numbers — pooled host ingest
(~8M spans/s, ingestbench) and the device sketch kernel (~66M spans/s,
bench.py's matrix) — and an 8× gap between them that ROADMAP item 1
exists to close. This module measures the number that actually matters:
sustained spans/sec from raw OTLP protobuf bytes, through the parallel
decode pool (zero-copy ticketed scratch), the pipeline's bounded
admission, the device-put spine's staged ring, the donated one-pass
device step, and back out as harvested detector reports. One
methodology, two callers: ``make spinebench`` (the standalone sweep:
workers × ring depth) and ``bench.py`` (the ``e2e_spans_per_sec`` /
``e2e_ok`` artifact fields, gated at ≥90% of
``min(host_ingest, kernel)`` — transfer provably hidden behind
compute, not just asserted).

The pump runs on its own thread at a tight cadence while the driver
thread offers payloads as fast as admission accepts them — the daemon
loop's shape, minus the sockets (the receivers' HTTP/gRPC framing is
measured elsewhere; this is the Kafka/collector-facing span path).

Every ``measure_*`` runs on the card unless ``device="cpu"`` is passed.
As a script (``python -m opentelemetry_demo_tpu_torch.runtime.spinebench
[--explain] [--device cpu]``) it reads ``BENCH_SPINE_SECONDS`` through
``utils.config`` and prints one JSON line.
"""

from __future__ import annotations

import threading
import time

import torch

from ..models.detector import AnomalyDetector, DetectorConfig
from .ingest_pool import IngestPool, IngestPoolSaturated
from .ingestbench import make_payloads
from .pipeline import DetectorPipeline


def measure_kernel_ref(
    config: DetectorConfig, batch: int, steps: int = 120, device=None
) -> float:
    """Device-only spans/s at the SAME geometry and batch width the
    e2e run dispatches — the matched-basis denominator for
    ``e2e_vs_kernel`` (bench.py's headline kernel runs default
    geometry at BENCH_BATCH; comparing e2e against THAT would mix
    apples and oranges). Slope-of-two-regions with a terminating
    fetch, the repo's honest-timing rule (bench.py module doc): each
    region ends with the last report copied to the host and the card
    synchronised."""
    import numpy as np

    from .lagbench import make_columns

    det = AnomalyDetector(config, device=device)
    rng = np.random.default_rng(0)
    from .tensorize import SpanTensorizer

    tens = SpanTensorizer(
        num_services=config.num_services, batch_size=batch
    )
    packed = tens.pack_columns(make_columns(rng, batch), width=batch)
    t = 0.0
    det.observe_packed(packed, t)  # first step off the clock

    def region(k: int, t0: float) -> tuple[float, float]:
        start = time.perf_counter()
        t_local = t0
        for _ in range(k):
            t_local += 0.05
            rep = det.observe_packed(packed, t_local)
        rep.cpu()  # fetch forces the chain
        if det.device.type == "cuda":
            torch.cuda.synchronize(det.device)
        return time.perf_counter() - start, t_local

    k1 = max(steps // 4, 8)
    k2 = 3 * k1
    t1, t = region(k1, t)
    t2, t = region(k2, t)
    per_step = max((t2 - t1) / (k2 - k1), 1e-9)
    return batch / per_step


def measure_e2e(
    workers: int = 2,
    ring: int = 2,
    seconds: float = 4.0,
    batch: int = 2048,
    num_services: int = 16,
    hll_p: int = 8,
    cms_width: int = 1024,
    n_requests: int = 32,
    spans_per_request: int = 256,
    payloads: list[bytes] | None = None,
    kernel_ref: bool = True,
    selftrace: bool = False,
    selftrace_sample: float = 0.05,
    provenance: bool = False,
    device=None,
) -> dict | None:
    """One configuration's e2e rate, or None without the native decoder.

    Geometry defaults are CI-friendly (the protocol and overlap, not
    the kernel plateau, are under test here — bench.py reports the
    kernel's own rate beside this); on the card pass the production
    geometry. The port's spine has no overlap switch, so the reference's
    ``overlap`` argument is not here. Returns spans/sec measured
    payload-submit → report-harvest (everything drained before the
    clock stops), plus the
    attribution the spine's win is judged by: pool phase shares and
    the put-overlap ratio.
    """
    from . import native

    if not native.available():
        return None
    if payloads is None:
        payloads = make_payloads(n_requests, spans_per_request)
    config = DetectorConfig(
        num_services=num_services, hll_p=hll_p, cms_width=cms_width
    )
    det = AnomalyDetector(config, device=device)
    reports = [0]
    # Self-telemetry A/B leg (bench.py's selftrace_overhead_ratio):
    # the FULL production wiring — sampled tracer + phase histograms
    # into a real MetricRegistry — so the measured cost is what the
    # daemon actually pays, not a strawman.
    tracer = None
    phase_observe = None
    if selftrace:
        from ..telemetry.metrics import (
            ANOMALY_HARVEST_LAG,
            ANOMALY_PHASE_SECONDS,
            ANOMALY_SPINE_PUT_WAIT,
            MetricRegistry,
        )
        from .selftrace import (
            PHASE_BUCKETS,
            PHASE_HARVEST_LAG,
            PHASE_PUT_WAIT,
            SelfTracer,
        )

        registry = MetricRegistry()
        sink = {"n": 0, "bytes": 0}

        def _submit(body: bytes) -> None:
            sink["n"] += 1
            sink["bytes"] += len(body)

        tracer = SelfTracer(submit=_submit, sample=selftrace_sample)

        def phase_observe(phase: str, seconds_: float) -> None:
            metric = (
                ANOMALY_HARVEST_LAG if phase == PHASE_HARVEST_LAG
                else ANOMALY_SPINE_PUT_WAIT if phase == PHASE_PUT_WAIT
                else ANOMALY_PHASE_SECONDS
            )
            if metric is ANOMALY_PHASE_SECONDS:
                registry.histogram_observe(
                    metric, seconds_, PHASE_BUCKETS, phase=phase
                )
            else:
                registry.histogram_observe(metric, seconds_, PHASE_BUCKETS)

    # Provenance A/B leg (bench.py's explain_overhead_ratio): the real
    # engine wired the way the daemon wires it, so the steady-state
    # cost under measurement is the per-report trajectory ring — the
    # only provenance work that runs on every batch (bundle assembly
    # only fires on flags, which synthetic steady load rarely raises;
    # same sampled-measurement philosophy as the selftrace arm).
    prov = None
    if provenance:
        from .provenance import ProvenanceEngine

        prov = ProvenanceEngine(config)
    pipe = DetectorPipeline(
        det,
        on_report=lambda t, r, flagged: reports.__setitem__(
            0, reports[0] + 1
        ),
        batch_size=batch,
        spine_ring=ring,
        phase_observe=phase_observe,
        selftrace=tracer,
        provenance=prov,
    )
    pool = IngestPool(
        pipe.submit_columns,
        pipe.tensorizer,
        workers=workers,
        coalesce_max=64,
        max_pending=max(4 * n_requests, 256),
        phase_observe=phase_observe,
        selftrace=tracer,
    )
    stop = threading.Event()

    def pump_loop() -> None:
        while not stop.is_set():
            pipe.pump()
            time.sleep(0.0005)

    pump = threading.Thread(target=pump_loop, name="e2e-pump", daemon=True)
    try:
        # Warmup: size the scratch + compile the step off the clock.
        pool.submit(payloads[0]).result()
        pool.drain()
        pipe.pump()
        pipe.drain()
        pump.start()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            for p in payloads:
                try:
                    pool.submit(p)
                except IngestPoolSaturated:
                    time.sleep(0.001)  # bounded admission: back off
        pool.drain()
        stop.set()
        pump.join(timeout=10.0)
        pipe.drain()
        elapsed = time.perf_counter() - t0
    finally:
        stop.set()
        pool.close()
        pipe.close()
    st = pool.stats()
    from .ingest_pool import TOP_PHASES

    # TOP-level phases only: scan/extract are sub-phases INSIDE the
    # decode envelope (the two-pass scanner's split) — summing them
    # into the denominator would double-count decode time.
    phase = {k: st["phase_s"].get(k, 0.0) for k in TOP_PHASES}
    phase_total = sum(phase.values()) or 1.0
    spine = pipe.spine_stats()
    # Matched-basis kernel reference: device-only rate at THIS
    # geometry and batch width (measured after the e2e run so the
    # timed region never shares the machine with the pool threads).
    kernel_rate = (
        measure_kernel_ref(config, batch, device=device) if kernel_ref else None
    )
    return {
        "spans_per_sec": pipe.stats.spans / max(elapsed, 1e-9),
        "kernel_spans_per_sec": (
            round(kernel_rate, 1) if kernel_rate else None
        ),
        "spans": pipe.stats.spans,
        "batches": pipe.stats.batches,
        "reports": reports[0],
        "elapsed_s": round(elapsed, 3),
        "workers": workers,
        "ring": ring,
        "overlap_ratio": (
            round(spine["overlap_ratio"], 4) if spine else None
        ),
        "tickets_parked": st["tickets_parked"],
        "tickets_recycled": st["tickets_recycled"],
        "frames_corrupt": st["frames_corrupt"],
        # Flush-time attribution (fractions of pool wall time): the
        # zero-copy win shows as decode dominating; a fat tensorize/
        # submit share means the host glue is the bottleneck again.
        "phase_share": {
            k: round(v / phase_total, 4) for k, v in phase.items()
        },
        "selftrace_traces": (
            tracer.traces_exported if tracer is not None else None
        ),
        "explanations_built": (
            pipe.explanations_built if prov is not None else None
        ),
    }


def measure_selftrace_overhead(
    seconds: float = 2.0, rounds: int = 2, device=None, **kw
) -> dict | None:
    """Tracer-on vs tracer-off spinebench A/B — the overhead canary.

    Interleaved OFF/ON rounds on the SAME payload set (ABAB, so CPU
    drift hits both arms), full production wiring on the ON arm
    (sampled tracer + phase histograms into a real registry). Returns
    ``ratio`` = off_rate / on_rate — 1.0 means free, and bench.py
    gates it at ≤ 1.03. None without the native decoder."""
    payloads = kw.pop("payloads", None) or make_payloads(
        kw.get("n_requests", 32), kw.get("spans_per_request", 256)
    )
    rates = {True: [], False: []}
    traces = 0
    for _ in range(max(int(rounds), 1)):
        for on in (False, True):
            got = measure_e2e(
                seconds=seconds, payloads=payloads, kernel_ref=False,
                selftrace=on, device=device, **kw,
            )
            if got is None:
                return None
            rates[on].append(got["spans_per_sec"])
            if on:
                traces += got.get("selftrace_traces") or 0
    rate_off = sum(rates[False]) / len(rates[False])
    rate_on = sum(rates[True]) / len(rates[True])
    return {
        "ratio": round(rate_off / max(rate_on, 1e-9), 4),
        "spans_per_sec_on": round(rate_on, 1),
        "spans_per_sec_off": round(rate_off, 1),
        "traces_exported": traces,
    }


def measure_explain_overhead(
    seconds: float = 2.0, rounds: int = 2, device=None, **kw
) -> dict | None:
    """Provenance-on vs provenance-off spinebench A/B.

    Same ABAB discipline as ``measure_selftrace_overhead``: interleaved
    OFF/ON rounds over one payload set so CPU drift hits both arms,
    the real ``ProvenanceEngine`` on the ON arm. ``ratio`` =
    off_rate / on_rate; bench.py gates it at ≤ 1.03 — the evidence
    plane must ride the harvester for free. None without the native
    decoder."""
    payloads = kw.pop("payloads", None) or make_payloads(
        kw.get("n_requests", 32), kw.get("spans_per_request", 256)
    )
    rates = {True: [], False: []}
    built = 0
    for _ in range(max(int(rounds), 1)):
        for on in (False, True):
            got = measure_e2e(
                seconds=seconds, payloads=payloads, kernel_ref=False,
                provenance=on, device=device, **kw,
            )
            if got is None:
                return None
            rates[on].append(got["spans_per_sec"])
            if on:
                built += got.get("explanations_built") or 0
    rate_off = sum(rates[False]) / len(rates[False])
    rate_on = sum(rates[True]) / len(rates[True])
    return {
        "ratio": round(rate_off / max(rate_on, 1e-9), 4),
        "spans_per_sec_on": round(rate_on, 1),
        "spans_per_sec_off": round(rate_off, 1),
        "explanations_built": built,
    }


def measure_sweep(
    workers_list=(1, 2), rings=(0, 2, 4), seconds: float = 2.0,
    device=None, **kw,
) -> dict[str, float]:
    """workers × ring-depth grid of e2e rates ({} without native) —
    the ``make spinebench`` matrix: ring 0 is the inline pack+put
    BEFORE number, so the spine's delta is in the same artifact."""
    payloads = kw.pop("payloads", None) or make_payloads(
        kw.get("n_requests", 32), kw.get("spans_per_request", 256)
    )
    out: dict[str, float] = {}
    for w in workers_list:
        for r in rings:
            got = measure_e2e(
                workers=w, ring=r, seconds=seconds, payloads=payloads,
                kernel_ref=False, device=device, **kw,
            )
            if got is None:
                return {}
            out[f"w{w}r{r}"] = round(got["spans_per_sec"], 1)
    return out


def main(argv: list[str] | None = None) -> None:
    import argparse
    import json

    from ..utils.config import BENCH_KNOBS, env_float

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--explain", action="store_true",
                        help="the provenance canary alone")
    parser.add_argument("--device", default=None,
                        help="cpu for the plain path (default: the card)")
    args = parser.parse_args(argv)
    device = args.device
    seconds = env_float(
        "BENCH_SPINE_SECONDS", BENCH_KNOBS["BENCH_SPINE_SECONDS"][1]
    )
    if args.explain:
        # `make explainbench`: the provenance canary alone — the A/B
        # overhead ratio (gated ≤1.03 in bench.py) plus the explain
        # endpoint's own p99 from the querybench hammer.
        from .querybench import measure_query

        explain_ab = measure_explain_overhead(
            seconds=max(seconds / 3, 1.0), device=device
        )
        queryq = measure_query(device=device)
        print(
            json.dumps(
                {
                    "metric": "explain_overhead",
                    "explain_overhead_ratio": (
                        explain_ab.get("ratio") if explain_ab else None
                    ),
                    "explain_overhead": explain_ab or None,
                    "explain_p99_ms": queryq.get("explain_p99_ms"),
                    "explain_queries": queryq.get("explain_queries"),
                    "query_p99_ms": queryq.get("query_p99_ms"),
                }
            )
        )
        return
    headline = measure_e2e(seconds=seconds, device=device)
    sweep = measure_sweep(seconds=max(seconds / 3, 1.0), device=device)
    selftrace_ab = measure_selftrace_overhead(
        seconds=max(seconds / 3, 1.0), device=device
    )
    print(
        json.dumps(
            {
                "metric": "e2e_ingest_spine",
                "e2e_spans_per_sec": (
                    round(headline["spans_per_sec"], 1) if headline else None
                ),
                "unit": "spans/sec",
                "e2e_overlap_ratio": (
                    headline.get("overlap_ratio") if headline else None
                ),
                "e2e_phase_share": (
                    headline.get("phase_share") if headline else None
                ),
                "e2e_reports": headline.get("reports") if headline else None,
                "sweep": sweep or None,
                "selftrace_overhead_ratio": (
                    selftrace_ab.get("ratio") if selftrace_ab else None
                ),
                "selftrace_overhead": selftrace_ab or None,
            }
        )
    )


if __name__ == "__main__":
    main()
