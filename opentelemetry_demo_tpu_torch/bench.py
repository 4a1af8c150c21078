"""The flagship benchmark line of the detector, on the card.

Run as ``python -m opentelemetry_demo_tpu_torch.bench [--device cuda|cpu]``
(the card by default; with no card and no ``--device cpu`` it raises).
It measures what the reference's root ``bench.py`` measures, leg for
leg, through this package:

1. **Throughput**: sustained spans/s through the full single-device
   detector step (HLL + CMS + EWMA heads + heavy-hitter query + window
   rotation) on batches already on the device, at ``BENCH_BATCH``
   (2,097,152 by default), against the product target of 200,000
   spans/s; with the sketch-impl matrix beside it.
2. **Detection lag**: p99 of submit → harvested report through the real
   ``DetectorPipeline`` at the default Locust-profile rate, against the
   100 ms target, with the device-to-host fetch round trip beside it.

Then the ingest, spine, front-door, self-trace, provenance, replay,
replication, fleet, autoscale, query, quality, mitigation and stress
legs, in the reference's order, each read through ``BENCH_KNOBS``
(``utils/config.py``). It prints ONE JSON line whose keys are the
reference's, ``metric``, ``value``, ``unit`` and ``vs_baseline`` first.

Method: the slope. Two state-chained regions of k1 and k2 steps each end
in a real device-to-host fetch of ``step_idx`` and a synchronise, and
the per-step cost is (t2 - t1) / (k2 - k1): the fixed costs (the fetch,
the loop) cancel and the device work cannot hide. The state is updated
in place, where the reference donates it, and the window-rotation masks
cycle at the cadence a stream at the target rate would see.

Where the port differs from the reference:

- No leg swallows its failure. The reference turns each leg's exception
  into ``{}``; here a leg that raises ends the run with its traceback
  and a non-zero exit. A leg is left out only when its knob is ``0``,
  and the line lists that knob under ``legs_skipped``.
- The host-ingest verdict compares the pooled decode rate with three
  times the serial native rate of the same run (``host_ingest_ok``,
  ``host_ingest_vs_serial``). The reference held it to a fixed rate
  measured on another host, which this package does not carry.
- The quality and mitigation legs run as subprocesses of this package on
  the bench's device, as the reference runs them in subprocesses; a
  non-zero exit, a timeout or output that is not JSON raises with the
  tail of the child's stderr.
- The matrix runs on the card with both paths of this package:
  ``"pallas"`` (the fused-update kernel) and ``"xla"`` (the composed
  path, whose CMS count is the histogram kernel). Off the card it is
  ``{}``, as the reference's is off a TPU. Only running out of device
  memory turns an entry into ``nan``.
- The line carries ``device``: the card's name and power limit as
  ``nvidia-smi`` reports them (nulls on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .models import DetectorConfig, detector_init, detector_step
from .runtime.tensorize import SpanTensorizer
from .utils.config import BENCH_KNOBS, env_float, env_int

# Product targets (the reference's BASELINE.json): spans/s a single
# device must sustain, and the p99 detection lag.
BASELINE_SPANS_PER_SEC = 200_000.0
BASELINE_LAG_MS = 100.0
# The pooled decode engine must reach this multiple of the serial
# native decoder measured in the same run.
HOST_INGEST_SERIAL_MULTIPLE = 3.0
# The matrix's widths, the reference's: both sides of the crossover.
MATRIX_BATCHES = (2048, 16384, 65536, 524288)
MATRIX_IMPLS = ("pallas", "xla")
# The knobs whose 0 leaves a leg out, in the order the legs run.
LEG_KNOBS = (
    "BENCH_MATRIX", "BENCH_INGEST", "BENCH_SPINE", "BENCH_FRONTDOOR",
    "BENCH_SELFTRACE", "BENCH_EXPLAIN", "BENCH_REPLAY", "BENCH_REPL",
    "BENCH_FLEET", "BENCH_AUTOSCALE", "BENCH_QUERY", "BENCH_QUALITY",
    "BENCH_MITIG", "BENCH_SHADOW", "BENCH_LAG_STRESS",
)
_ROOT = Path(__file__).resolve().parent.parent


def bench_device(name: str) -> torch.device:
    """The device a bench runs on: ``"cuda"`` raises with no card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu for the plain path")
    return device


def bench_knobs() -> dict[str, int | float]:
    """Every ``BENCH_KNOBS`` entry from the environment, typed."""
    return {
        name: (env_int if kind == "int" else env_float)(name, default)
        for name, (kind, default, _help) in BENCH_KNOBS.items()
    }


def make_batch_pool(config: DetectorConfig, batch_size: int, n_pool: int, rng, device) -> list[tuple]:
    """``n_pool`` packed batches as :func:`detector_step` takes them, on
    ``device``: the reference's draws from the same ``rng``, so the
    columns are its bits (uint32 lanes as int32, ``valid`` as bool)."""
    tz = SpanTensorizer(num_services=config.num_services, batch_size=batch_size)
    pool = []
    for _ in range(n_pool):
        tb = tz.pack_arrays(
            svc=rng.integers(0, 20, size=batch_size),
            lat_us=rng.gamma(4.0, 250.0, size=batch_size).astype(np.float32),
            trace_id=rng.integers(0, 2**63, size=batch_size, dtype=np.uint64),
            is_error=(rng.random(batch_size) < 0.02).astype(np.float32),
            attr_key=rng.zipf(1.5, size=batch_size).astype(np.uint64),
        )
        pool.append(tuple(
            torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).to(device)
            for x in (tb.svc, tb.lat_us, tb.is_error, tb.trace_hi, tb.trace_lo,
                      tb.attr_hi, tb.attr_lo, tb.valid)
        ))
    return pool


def rotation_masks(batch_size: int) -> list[tuple[bool, bool, bool]]:
    """The (1 s, 10 s, 60 s) window-rotation masks a stream at the target
    rate sees, one per step, over at least a minute of steps."""
    steps_per_sec = max(int(1.0 / (batch_size / BASELINE_SPANS_PER_SEC)), 1)
    return [
        (i % steps_per_sec == 0, i % (steps_per_sec * 10) == 0, i % (steps_per_sec * 60) == 0)
        for i in range(max(steps_per_sec * 60, 240))
    ]


def device_masks(masks, device) -> list[torch.Tensor]:
    """``masks`` as bool tensors on ``device``, one tensor per distinct mask."""
    uniq = {m: torch.tensor(m, dtype=torch.bool, device=device) for m in set(masks)}
    return [uniq[m] for m in masks]


def run_chain(config: DetectorConfig, pool: list[tuple], masks: list[torch.Tensor], k: int, device,
              state=None):
    """``k`` chained detector steps, batch ``i % len(pool)`` with mask
    ``i % len(masks)``, from ``state`` (a fresh one when None), updated
    in place: ``(state, last report)``. Nothing is read on the host."""
    if state is None:
        state = detector_init(config, device)
    dt = torch.tensor(pool[0][0].shape[0] / BASELINE_SPANS_PER_SEC, dtype=torch.float32, device=device)
    report = None
    for i in range(k):
        state, report = detector_step(config, state, *pool[i % len(pool)], dt, masks[i % len(masks)])
    return state, report


def _fetch_step(state, device) -> int:
    """A real device-to-host fetch of ``step_idx``, then a synchronise."""
    step = int(state.step_idx.item())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return step


def measure_throughput(
    config: DetectorConfig,
    batch_size: int,
    rng,
    device,
    min_signal_s: float = 0.5,
    target_region_s: float = 2.0,
) -> float:
    """Slope-timed spans/s through the full detector step (module
    docstring). Raises when the inter-region signal stays under
    ``min_signal_s`` after retries."""
    device = torch.device(device)
    pool = make_batch_pool(config, batch_size, 4, rng, device)
    masks = device_masks(rotation_masks(batch_size), device)
    state = detector_init(config, device)
    # Warm-up step (the reference's compile), then a fetch.
    state, _ = run_chain(config, pool, masks[1:2], 1, device, state)
    _fetch_step(state, device)

    def region(k: int, state):
        t0 = time.perf_counter()
        state, _ = run_chain(config, pool, masks, k, device, state)
        _fetch_step(state, device)
        return time.perf_counter() - t0, state

    # k from a probe slope, bounded so a probe spike can neither hang the
    # bench nor shrink the regions to fetch jitter.
    ta, state = region(4, state)
    tb, state = region(12, state)
    per_step_est = max((tb - ta) / 8, 1e-5)
    k1 = min(max(int(target_region_s / per_step_est), 8), 2000)
    per_step = signal = 0.0
    for _attempt in range(4):
        k2 = 3 * k1
        t1, state = region(k1, state)
        t2, state = region(k2, state)
        per_step = (t2 - t1) / (k2 - k1)
        signal = t2 - t1
        if per_step > 0 and signal >= min_signal_s:
            break
        k1 = min(k1 * 4, 20_000)
    if per_step <= 0 or signal < min_signal_s:
        raise RuntimeError(
            f"slope {per_step!r} with only {signal:.3f}s of inter-region signal after "
            "retries: timing noise exceeded the signal; refusing to report"
        )
    return batch_size / per_step


def measure_impl_matrix(rng, device) -> dict[str, float]:
    """spans/s of each sketch path at each of ``MATRIX_BATCHES`` on the
    card (``{}`` elsewhere), with the looser floors of a regime
    comparison (0.3 s of signal, 0.8 s regions). An entry that runs out
    of device memory is ``nan``; any other failure raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    out: dict[str, float] = {}
    for impl in MATRIX_IMPLS:
        for batch in MATRIX_BATCHES:
            try:
                rate = measure_throughput(
                    DetectorConfig(sketch_impl=impl), batch, rng, device,
                    min_signal_s=0.3, target_region_s=0.8,
                )
            except torch.cuda.OutOfMemoryError:
                torch.cuda.empty_cache()
                out[f"{impl}@{batch}"] = float("nan")
                continue
            out[f"{impl}@{batch}"] = round(rate, 1)
    return out


def measure_module_subprocess(module: str, timeout_s: float, device) -> dict:
    """``python -m module --device <device>`` in a fresh interpreter: its
    last line of standard output as JSON. Raises on a non-zero exit, a
    timeout or a last line that is not JSON, quoting the child's stderr."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", module, "--device", str(device)]
    try:
        proc = subprocess.run(cmd, cwd=str(_ROOT), env=env, capture_output=True, text=True,
                              timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        err = e.stderr.decode(errors="replace") if isinstance(e.stderr, bytes) else (e.stderr or "")
        raise RuntimeError(f"{module} ran past {timeout_s} s; stderr tail:\n{err[-2000:]}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{module} exited {proc.returncode}; stderr tail:\n{proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    try:
        return json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError) as e:
        raise RuntimeError(
            f"{module} printed no JSON line (stdout tail {proc.stdout[-500:]!r}); "
            f"stderr tail:\n{proc.stderr[-2000:]}"
        ) from e


def measure_quality_subprocess(device, timeout_s: float = 900.0) -> dict:
    """Detection quality (``runtime.qualbench``) in a subprocess."""
    return measure_module_subprocess("opentelemetry_demo_tpu_torch.runtime.qualbench", timeout_s, device)


def measure_mitigation_subprocess(device, timeout_s: float = 1500.0) -> dict:
    """The closed-loop mitigation drill (``runtime.mitigbench``, with its
    pre-flight leg unless ``BENCH_SHADOW=0``) in a subprocess."""
    return measure_module_subprocess("opentelemetry_demo_tpu_torch.runtime.mitigbench", timeout_s, device)


def measure_fetch_rtt(device) -> float:
    """Median ms of a one-scalar device-to-host fetch with ``.item()``,
    each of a fresh value (the harvest's floor)."""
    device = torch.device(device)
    base = torch.zeros((), dtype=torch.int32, device=device)
    samples = []
    for i in range(7):
        fresh = base + i
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        int(fresh.item())
        samples.append((time.perf_counter() - t0) * 1000.0)
    samples.sort()
    return round(samples[len(samples) // 2], 3)


def measure_lag(knobs: dict, device) -> dict:
    """p99 submit → harvest lag through ``runtime.lagbench`` at the
    ``BENCH_LAG_RATE`` / ``BENCH_LAG_SECONDS`` knobs."""
    from .runtime.lagbench import measure_lag as run

    return run(rate=knobs["BENCH_LAG_RATE"], seconds=knobs["BENCH_LAG_SECONDS"], device=str(device))


def device_info(device) -> dict:
    """The card's name and power limit in W from ``nvidia-smi``; nulls
    off the card."""
    if torch.device(device).type != "cuda":
        return {"name": None, "power_limit_w": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"name": name.strip(), "power_limit_w": float(limit.strip().split()[0])}


def _leg(name: str, fn):
    """``fn()``, with its wall time on stderr."""
    t0 = time.perf_counter()
    out = fn()
    print(f"bench: {name} {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return out


def _required(name: str, got):
    """A spinebench result; None means no native decoder, which is a failure."""
    if got is None:
        from .runtime import native

        raise RuntimeError(f"{name}: native decoder unavailable: {native.load_error()}")
    return got


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the detector runs (default: the card)")
    args = parser.parse_args(argv)
    device = bench_device(args.device)
    dev = str(device)
    knobs = bench_knobs()
    skipped = [name for name in LEG_KNOBS if knobs[name] == 0]
    cores = os.cpu_count() or 1

    rng = np.random.default_rng(0)
    spans_per_sec = _leg("throughput", lambda: measure_throughput(DetectorConfig(), knobs["BENCH_BATCH"], rng, device))
    matrix = _leg("matrix", lambda: measure_impl_matrix(rng, device)) if knobs["BENCH_MATRIX"] else {}

    # Host ingest: OTLP bytes → columns, serial native and the pool's
    # worker sweep over one payload set.
    ingest_serial = ingest_rate = None
    ingest_scaling: dict[str, float] = {}
    ingest_detail: dict = {}
    if knobs["BENCH_INGEST"]:
        from .runtime import ingestbench

        def ingest():
            payloads = ingestbench.make_payloads()
            serial = ingestbench.measure_native(repeat=3, payloads=payloads)
            scaling = ingestbench.measure_scaling(
                workers_list=(1, 2, 3, 4), payloads=payloads, detail=ingest_detail,
            )
            return serial, scaling

        ingest_serial, ingest_scaling = _leg("ingest", ingest)
        ingest_rate = max(ingest_scaling.values())

    # End to end: payload → decode pool → admission → spine → step →
    # harvested report, with its own kernel-only reference.
    e2e: dict = {}
    if knobs["BENCH_SPINE"]:
        from .runtime import spinebench

        e2e = _leg("spine", lambda: _required("spine", spinebench.measure_e2e(
            seconds=knobs["BENCH_SPINE_SECONDS"], device=dev)))

    frontdoor: dict = {}
    frontdoor_soak: dict = {}
    churn_soak: dict = {}
    if knobs["BENCH_FRONTDOOR"]:
        from .runtime import frontdoorbench

        frontdoor = _leg("frontdoor", lambda: frontdoorbench.measure_frontdoor_vs_pool(
            seconds=knobs["BENCH_FRONTDOOR_SECONDS"]))
        frontdoor_soak = _leg("frontdoor_soak", lambda: frontdoorbench.measure_million_key_soak(
            target_keys=knobs["BENCH_FRONTDOOR_KEYS"], device=dev))
        churn_soak = _leg("churn_soak", lambda: frontdoorbench.measure_churn_soak(
            waves=knobs["BENCH_CHURN_WAVES"], device=dev))

    selftrace_ab: dict = {}
    if knobs["BENCH_SELFTRACE"]:
        from .runtime import spinebench

        selftrace_ab = _leg("selftrace", lambda: _required(
            "selftrace", spinebench.measure_selftrace_overhead(device=dev)))

    explain_ab: dict = {}
    if knobs["BENCH_EXPLAIN"]:
        from .runtime import spinebench

        explain_ab = _leg("explain", lambda: _required(
            "explain", spinebench.measure_explain_overhead(device=dev)))

    replay: dict = {}
    if knobs["BENCH_REPLAY"]:
        from .runtime.replaybench import measure_replay

        replay = _leg("replay", lambda: measure_replay(device=dev))

    repl: dict = {}
    if knobs["BENCH_REPL"]:
        from .runtime.replbench import measure_failover

        repl = _leg("repl", lambda: measure_failover(device=dev))

    fleet_drill: dict = {}
    if knobs["BENCH_FLEET"]:
        from .runtime.replbench import measure_reshard

        fleet_drill = _leg("fleet", lambda: measure_reshard(device=dev))

    autoscale_drill: dict = {}
    if knobs["BENCH_AUTOSCALE"]:
        from .runtime.replbench import measure_adoption

        autoscale_drill = _leg("autoscale", lambda: measure_adoption(device=dev))

    queryq: dict = {}
    if knobs["BENCH_QUERY"]:
        from .runtime.querybench import measure_query

        queryq = _leg("query", lambda: measure_query(device=dev))

    fetch_rtt_ms = _leg("fetch_rtt", lambda: measure_fetch_rtt(device))
    lag = _leg("lag", lambda: measure_lag(knobs, device))

    quality: dict = {}
    if knobs["BENCH_QUALITY"]:
        quality = _leg("quality", lambda: measure_quality_subprocess(device))

    mitig: dict = {}
    if knobs["BENCH_MITIG"]:
        mitig = _leg("mitigation", lambda: measure_mitigation_subprocess(device))

    # 10× the Locust profile with the async harvester and the adaptive
    # width, which bounds the report skip rate the stress gate checks.
    stress: dict = {}
    if knobs["BENCH_LAG_STRESS"]:
        from .runtime.lagbench import measure_lag as run_lag

        stress = _leg("stress", lambda: run_lag(
            rate=20_000.0, seconds=8.0, batch=1024, harvest_async=True, adaptive=True, device=dev))

    # ---- SLO verdicts --------------------------------------------------
    lag_net = lag.get("p99_net_ms")
    stress_skip = stress.get("skip_rate")
    e2e_rate = e2e.get("spans_per_sec")
    e2e_kernel = e2e.get("kernel_spans_per_sec") or spans_per_sec
    # The e2e's ingest basis is the sweep's rate at the e2e's own worker
    # count, else the sweep's best.
    e2e_ingest = (
        ingest_scaling.get(str(e2e.get("workers"))) or ingest_rate
        if ingest_scaling else ingest_rate
    )
    e2e_bound = min(e2e_ingest, e2e_kernel) if e2e_ingest else None
    decode_share_2w = (
        (ingest_detail.get("2") or {}).get("phase_share", {}).get("decode")
        if ingest_detail else None
    )
    slo = {
        "north_star_throughput_ok": bool(spans_per_sec >= BASELINE_SPANS_PER_SEC),
        "north_star_lag_ok": bool(lag_net < BASELINE_LAG_MS) if lag_net is not None else None,
        "north_star_lag_basis": "net_of_paired_rtt",
        "stress_skip_rate_ok": bool(stress_skip < 0.1) if stress_skip is not None else None,
        # A pool needs a second core to run beside anything: one core
        # leaves the pooled verdicts unmeasurable (None).
        "host_ingest_ok": (
            bool(ingest_rate >= HOST_INGEST_SERIAL_MULTIPLE * ingest_serial)
            if ingest_rate is not None and ingest_serial and cores >= 2 else None
        ),
        "decode_wall_ok": (
            bool(decode_share_2w <= 0.70)
            if decode_share_2w is not None and cores >= 2 else None
        ),
        "e2e_ok": (
            bool(e2e_rate >= 0.9 * e2e_bound)
            if e2e_rate is not None and e2e_bound is not None and cores >= 2 else None
        ),
        "selftrace_overhead_ok": (
            bool(selftrace_ab["ratio"] <= 1.03) if selftrace_ab.get("ratio") is not None else None
        ),
        "explain_overhead_ok": (
            bool(explain_ab["ratio"] <= 1.03) if explain_ab.get("ratio") is not None else None
        ),
        "replay_ok": replay.get("replay_ok"),
        "mitigation_ok": mitig.get("mitigation_ok"),
        "shadow_ok": mitig.get("shadow_ok"),
        "preflight_refusal_ok": mitig.get("preflight_refusal_ok"),
        "frontdoor_ok": (
            bool(frontdoor["frontdoor_spans_per_sec"] >= frontdoor["pool_spans_per_sec"])
            if frontdoor.get("pool_spans_per_sec") and cores >= 2 else None
        ),
        "frontdoor_soak_ok": frontdoor_soak.get("soak_ok"),
        "soak_rss_ok": frontdoor_soak.get("soak_rss_ok"),
        "churn_ok": churn_soak.get("churn_ok"),
    }

    line = {
        "metric": "sketch_update_throughput_single_chip",
        "value": round(spans_per_sec, 1),
        "unit": "spans/sec",
        "vs_baseline": round(spans_per_sec / BASELINE_SPANS_PER_SEC, 3),
        "lag_p99_ms": lag["p99_ms"],
        "lag_vs_baseline": round(BASELINE_LAG_MS / max(lag["p99_ms"], 1e-9), 3),
        "lag_p99_net_ms": lag.get("p99_net_ms"),
        "lag_p50_net_ms": lag.get("p50_net_ms"),
        "lag_net_vs_baseline": (
            round(BASELINE_LAG_MS / max(lag["p99_net_ms"], 1e-9), 3)
            if lag.get("p99_net_ms") is not None else None
        ),
        "lag_rtt_p50_ms": lag.get("rtt_p50_ms"),
        "lag_rtt_p99_ms": lag.get("rtt_p99_ms"),
        "lag_rtt_pairs": lag.get("rtt_pairs"),
        "lag_rate_spans_per_sec": lag["rate"],
        "lag_batches": lag["batches"],
        "lag_stress_p99_ms": stress.get("p99_ms"),
        "lag_stress_p99_net_ms": stress.get("p99_net_ms"),
        "lag_stress_rate_spans_per_sec": stress.get("rate"),
        "lag_stress_batches": stress.get("batches"),
        "lag_stress_reports_skipped": stress.get("reports_skipped"),
        "lag_stress_skip_rate": stress.get("skip_rate"),
        "lag_stress_final_batch_width": stress.get("final_batch_width"),
        **slo,
        "ttd_s": {name: entry.get("ttd_s") for name, entry in (quality.get("ttd") or {}).items()},
        "fp_rate": quality.get("fp_rate"),
        "paymentFailure_ttd_by_rate": quality.get("paymentFailure_ttd_by_rate"),
        "detection_quality": quality or None,
        "fetch_rtt_ms": fetch_rtt_ms,
        "host_ingest_spans_per_sec": round(ingest_rate, 1) if ingest_rate else None,
        "host_ingest_serial_spans_per_sec": round(ingest_serial, 1) if ingest_serial else None,
        "host_ingest_scaling": ingest_scaling or None,
        "host_ingest_vs_serial": (
            round(ingest_rate / ingest_serial, 3) if ingest_rate and ingest_serial else None
        ),
        "host_ingest_phase_share": (
            ingest_detail.get(max(ingest_scaling, key=lambda k: ingest_scaling[k]), {}).get("phase_share")
            if ingest_scaling else None
        ),
        "host_ingest_decode_share": decode_share_2w,
        "host_ingest_decode_split": (
            (ingest_detail.get("2") or {}).get("decode_split") if ingest_detail else None
        ),
        "e2e_spans_per_sec": round(e2e_rate, 1) if e2e_rate else None,
        "e2e_vs_kernel": round(e2e_rate / e2e_kernel, 3) if e2e_rate else None,
        "e2e_kernel_spans_per_sec": e2e.get("kernel_spans_per_sec"),
        "e2e_vs_host_ingest": round(e2e_rate / ingest_rate, 3) if e2e_rate and ingest_rate else None,
        "e2e_overlap_ratio": e2e.get("overlap_ratio"),
        "e2e_phase_share": e2e.get("phase_share"),
        "e2e_note": (
            "payload->flagged-report through decode pool + admission + device-put spine + "
            "in-place one-pass step; e2e_ok gates >=90% of min(host ingest, kernel at the "
            "spine bench's own geometry/batch). The decode workers, the pump and the "
            "harvester share the host's cores and its interpreter lock"
        ) if e2e else None,
        "frontdoor_spans_per_sec": frontdoor.get("frontdoor_spans_per_sec"),
        "frontdoor_pool_spans_per_sec": frontdoor.get("pool_spans_per_sec"),
        "frontdoor_vs_pool": frontdoor.get("frontdoor_vs_pool"),
        "frontdoor_soak_keys": frontdoor_soak.get("distinct_keys"),
        "frontdoor_soak_rss_per_million_keys_mb": frontdoor_soak.get("rss_per_million_keys_mb"),
        "frontdoor_soak_keys_per_sec": frontdoor_soak.get("keys_per_sec"),
        "frontdoor_soak_overflow_keys": frontdoor_soak.get("overflow_keys"),
        "churn_soak_evictions": churn_soak.get("evictions"),
        "churn_soak_generation": churn_soak.get("generation"),
        "churn_soak_distinct_streamed": churn_soak.get("distinct_streamed"),
        "churn_soak_rss_slope_mb": churn_soak.get("rss_slope_mb"),
        "selftrace_overhead_ratio": selftrace_ab.get("ratio"),
        "selftrace_spans_per_sec_on": selftrace_ab.get("spans_per_sec_on"),
        "selftrace_traces_exported": selftrace_ab.get("traces_exported"),
        "explain_overhead_ratio": explain_ab.get("ratio"),
        "explain_spans_per_sec_on": explain_ab.get("spans_per_sec_on"),
        "query_p99_ms": queryq.get("query_p99_ms"),
        "query_p50_ms": queryq.get("query_p50_ms"),
        "query_qps": queryq.get("query_qps"),
        "query_ingest_ratio": queryq.get("ingest_ratio"),
        "explain_p99_ms": queryq.get("explain_p99_ms"),
        "replay_speedup": replay.get("replay_speedup"),
        "replay_verdicts_identical": replay.get("replay_verdicts_identical"),
        "replay_batches": replay.get("replay_batches"),
        "history_range_query_p99_ms": replay.get("history_range_query_p99_ms"),
        "history_range_query_p50_ms": replay.get("history_range_query_p50_ms"),
        "time_to_mitigate_s": mitig.get("time_to_mitigate_s"),
        "mitigation_rollback_exercised": (
            mitig.get("rollback_drill", {}).get("rolled_back") if mitig else None
        ),
        "mitigation_no_oscillation": (
            mitig.get("no_oscillation", {}).get("ok") if mitig else None
        ),
        "mitigation_detail": mitig or None,
        "preflight_verdict_s": mitig.get("preflight_verdict_s"),
        "preflight_ttm_ratio": mitig.get("preflight_ttm_ratio"),
        "shadow_identical": mitig.get("shadow_identical"),
        "shadow_speedup": mitig.get("shadow_speedup"),
        "collector_keep_ratio": mitig.get("collector_keep_ratio"),
        "collector_storage_reduction": mitig.get("collector_storage_reduction"),
        "failover_ttd_s": repl.get("failover_ttd_s"),
        "replication_lag_p99_ms": repl.get("replication_lag_p99_ms"),
        "failover_converged_exact": repl.get("converged_exact"),
        "shard_reshard_ttd_s": fleet_drill.get("shard_reshard_ttd_s"),
        "fleet_ok": fleet_drill.get("fleet_ok"),
        "fleet_reshard_bitexact": fleet_drill.get("reshard_bitexact"),
        "fleet_partial_answer_ok": fleet_drill.get("partial_answer_ok"),
        "fleet_noisy_tenant_isolated": fleet_drill.get("noisy_tenant_isolated"),
        "autoscale_tta_s": autoscale_drill.get("autoscale_tta_s"),
        "autoscale_ok": autoscale_drill.get("autoscale_ok"),
        "autoscale_adoption_bitexact": autoscale_drill.get("adoption_bitexact"),
        "sketch_impl_matrix": matrix,
        "lag_note": (
            "gross p99 is submit-to-harvest through the real pipeline; each harvest ends in "
            "a device-to-host copy of the packed report over PCIe from the locally attached "
            "card (no tunnel). Each lag sample is paired with a 1-scalar fetch probe that "
            "runs beside that harvest's report copy; p99_net is the p99 of lag minus the "
            "paired round trip, and rtt_p50/p99 give the copy's floor and jitter"
        ),
        "device": device_info(device),
        "legs_skipped": skipped,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
