"""Detection-quality measurement: per-fault time-to-detect + FP rate.

Each fault shape mirrors one of the shop's flagd failure scenarios,
projected onto a synthetic span stream:

- ``paymentFailure``            → error-rate burst on one service,
  plus a sweep over the flag's variant ladder (10/25/50/75/90/100%)
- ``cartFailure``               → total error burst (every op fails)
- ``productCatalogFailure``     → partial error burst (one product)
- ``adFailure``                 → 1-in-10 error burst
- ``paymentUnreachable``        → service vanishes (full rate collapse)
- ``adHighCpu``                 → step latency degradation
- ``imageSlowLoad``             → step latency degradation on the
  image-serving tier
- ``adManualGc``                → periodic latency spikes
- ``recommendationCacheFailure``  → gradual latency ramp
- ``kafkaQueueProblems``        → throughput collapse (consumer stall)
- ``loadGeneratorFloodHomepage``  → traffic redistribution toward one
  service
- ``errorTrickle``              → sustained small error shift, below any
  single-batch threshold (the CUSUM case)
- ``traceCardinalityExplosion`` → trace-id churn at constant span rate
  (only the HLL cardinality head sees it)

Time-to-detect is virtual seconds from fault onset to the first batch
whose report flags the faulted service; the false-positive rate is
flagged batches / batches over a long clean run after warm-up. Both are
detector math: the same seeds give the same numbers on the card and on
the CPU, and the same as the reference package's. Every entry point runs
on the card unless ``device="cpu"`` is passed; each step reads its
report's flags back to the host.
"""

from __future__ import annotations

import numpy as np

from ..models import AnomalyDetector, DetectorConfig
from .tensorize import SpanTensorizer

S = 8
B = 256
DT_S = 0.25  # virtual seconds per batch (~1k spans/s at B=256)
WARM_STEPS = 120
FAULT_WINDOW_STEPS = 120  # give-up horizon after onset
QUIET_STEPS = 600


def _quality_config() -> DetectorConfig:
    """Reduced CMS width (fast compile), PRODUCTION thresholds/warmups
    AND production HLL precision — quality numbers with detuned
    thresholds would be fiction, and p=8's ~3% estimator noise alone
    can graze the 6σ cardinality threshold (measured: one card_z=6.1
    warmup spike that p=12's ~0.8% noise does not produce)."""
    return DetectorConfig(num_services=S, hll_p=12, cms_width=512)


def _flags(report) -> np.ndarray:
    """A report's per-service flags on the host."""
    return report.flags.cpu().numpy()


def _batch(rng, tz, mutate=None, step: int = 0):
    lat = rng.gamma(4.0, 250.0, size=B).astype(np.float32)
    svc = rng.integers(0, S, size=B)
    err = (rng.random(B) < 0.01).astype(np.float32)
    keep = np.ones(B, bool)
    # Baseline trace-id pool: sessions REUSE ids (browse traffic fans
    # several spans out of one trace), so per-window distinct counts sit
    # well below span counts — the decoupling that lets a cardinality
    # fault exist at constant throughput. 64 concurrent sessions across
    # ~128 spans/svc/window puts baseline distinct ≈ 55 with tight
    # variance; the explosion to ~128 unique ids is then an
    # unmistakable HLL jump at unchanged span rate.
    trace = rng.integers(0, 64, size=B, dtype=np.uint64) * 2654435761 + 1
    if mutate is not None:
        svc, lat, err, keep, trace = mutate(step, svc, lat, err, keep, trace)
    return tz.pack_arrays(
        svc=svc[keep],
        lat_us=lat[keep],
        trace_id=trace[keep],
        is_error=err[keep],
        attr_key=rng.zipf(1.5, size=int(keep.sum())).astype(np.uint64),
    )


def error_burst(rng, target: int, p: float):
    """Error-rate burst shape: fraction ``p`` of the target service's
    requests fail — paymentFailure's variant ladder, cartFailure at
    p=1.0 (the bad-store swap fails every op), productCatalogFailure
    at the flagged product's traffic share, adFailure at 1-in-10."""

    def mutate(step, svc, lat, err, keep, trace):
        hit = (rng.random(B) < p).astype(np.float32)
        return svc, lat, np.where(
            svc == target, np.maximum(err, hit), err
        ).astype(np.float32), keep, trace

    return mutate


def fault_shapes(rng):
    """name → (faulted service index,
    mutate(step, svc, lat, err, keep, trace) → same tuple)."""

    def latency_step(step, svc, lat, err, keep, trace):
        return (svc, np.where(svc == 1, lat * 3.0, lat).astype(np.float32),
                err, keep, trace)

    def image_slow_load(step, svc, lat, err, keep, trace):
        # imageSlowLoad's variants are 5000/10000 ms flat adds — vs a
        # ~1 ms base that is a ~10x latency step on the image tier.
        return (svc, np.where(svc == 7, lat * 10.0, lat).astype(np.float32),
                err, keep, trace)

    def manual_gc(step, svc, lat, err, keep, trace):
        # adManualGc: full collections every ~2s (8 batches at dt=0.25)
        # freeze the service for the batch; between pauses it is normal.
        if step % 8 < 2:
            lat = np.where(svc == 1, lat * 8.0, lat).astype(np.float32)
        return svc, lat, err, keep, trace

    def cache_ramp(step, svc, lat, err, keep, trace):
        scale = 1.10 ** min(step, 60)  # unbounded cache growth shape
        return (svc, np.where(svc == 2, lat * scale, lat).astype(np.float32),
                err, keep, trace)

    def rate_drop(step, svc, lat, err, keep, trace):
        # Consumer stall: 90% of the service's spans stop arriving.
        return (svc, lat, err,
                keep & ~((svc == 3) & (rng.random(B) < 0.9)), trace)

    def unreachable(step, svc, lat, err, keep, trace):
        # paymentUnreachable: the service VANISHES — checkout reroutes
        # to a dead address (main.go:475-479), so the payment span
        # stream stops entirely (full rate collapse, not errors).
        return svc, lat, err, keep & (svc != 7), trace

    def trickle(step, svc, lat, err, keep, trace):
        hit = (rng.random(B) < 0.06).astype(np.float32)
        return svc, lat, np.where(svc == 4, np.maximum(err, hit), err).astype(
            np.float32
        ), keep, trace

    def card_explosion(step, svc, lat, err, keep, trace):
        # Session/trace-id churn at CONSTANT throughput: the faulted
        # service's spans stop sharing the session pool and arrive with
        # unique trace ids — span rate unchanged, per-window distinct
        # count explodes. Only the HLL cardinality head can see this.
        fresh = rng.integers(1 << 32, 1 << 62, size=B, dtype=np.uint64)
        return svc, lat, err, keep, np.where(svc == 6, fresh, trace)

    def flood(step, svc, lat, err, keep, trace):
        # loadGeneratorFloodHomepage: the flood multiplies the
        # frontend's request rate; within a fixed-width batch that is a
        # traffic REDISTRIBUTION — most spans become frontend spans
        # (svc 0), its per-dt rate jumping ~5× while the rest starve.
        return (np.where(rng.random(B) < 0.6, 0, svc),
                lat, err, keep, trace)

    return {
        "paymentFailure": (5, error_burst(rng, 5, 0.25)),
        "cartFailure": (0, error_burst(rng, 0, 1.0)),
        # The reference fails exactly one product id; the featured
        # product draws ~1/8 of GetProduct traffic in the shop's mix.
        "productCatalogFailure": (2, error_burst(rng, 2, 0.125)),
        "adFailure": (1, error_burst(rng, 1, 0.10)),
        "paymentUnreachable": (7, unreachable),
        "adHighCpu": (1, latency_step),
        "adManualGc": (1, manual_gc),
        "imageSlowLoad": (7, image_slow_load),
        "recommendationCacheFailure": (2, cache_ramp),
        "kafkaQueueProblems": (3, rate_drop),
        "loadGeneratorFloodHomepage": (0, flood),
        "errorTrickle": (4, trickle),
        "traceCardinalityExplosion": (6, card_explosion),
    }


def measure_time_to_detect(name: str, fault_svc: int, mutate, seed: int = 0, device=None):
    """One fault scenario: clean warmup, onset, first correct flag."""
    rng = np.random.default_rng(seed)
    det = AnomalyDetector(_quality_config(), device=device)
    tz = SpanTensorizer(num_services=S, batch_size=B)
    false_before = 0
    for step in range(WARM_STEPS):
        report = det.observe(_batch(rng, tz), step * DT_S)
        if _flags(report).any():
            false_before += 1
    for k in range(FAULT_WINDOW_STEPS):
        step = WARM_STEPS + k
        report = det.observe(
            _batch(rng, tz, mutate=mutate, step=k), step * DT_S
        )
        flags = _flags(report)
        if flags[fault_svc]:
            return {
                "ttd_s": round((k + 1) * DT_S, 3),
                "ttd_batches": k + 1,
                "false_flags_warmup": false_before,
            }
    return {"ttd_s": None, "ttd_batches": None, "false_flags_warmup": false_before}


def measure_fp_rate(seed: int = 1, device=None):
    """Long clean run: flagged-batch fraction after warmup."""
    rng = np.random.default_rng(seed)
    det = AnomalyDetector(_quality_config(), device=device)
    tz = SpanTensorizer(num_services=S, batch_size=B)
    flagged = 0
    for step in range(WARM_STEPS + QUIET_STEPS):
        report = det.observe(_batch(rng, tz), step * DT_S)
        if step >= WARM_STEPS and _flags(report).any():
            flagged += 1
    return {
        "fp_rate": round(flagged / QUIET_STEPS, 5),
        "fp_batches": flagged,
        "quiet_batches": QUIET_STEPS,
    }


# The reference paymentFailure flag's variant ladder
# (demo.flagd.json: '10%' … '100%') — TTD is measured per rate.
PAYMENT_SWEEP = (0.10, 0.25, 0.50, 0.75, 0.90, 1.00)


def measure_payment_sweep(seed: int = 0, device=None) -> dict:
    """TTD as a function of the paymentFailure rate: the detector's
    sensitivity curve over the flag's own variant ladder."""
    out = {}
    for p in PAYMENT_SWEEP:
        rng = np.random.default_rng(seed)
        res = measure_time_to_detect(
            f"paymentFailure@{p:.0%}", 5, error_burst(rng, 5, p), seed=seed,
            device=device,
        )
        out[f"{p:.0%}"] = res["ttd_s"]
    return out


def measure_detection_quality(seed: int = 0, device=None) -> dict:
    rng = np.random.default_rng(seed)
    ttd = {}
    for name, (svc, mutate) in fault_shapes(rng).items():
        ttd[name] = measure_time_to_detect(name, svc, mutate, seed=seed, device=device)
    out = {"dt_s": DT_S, "batch": B, "ttd": ttd}
    out["paymentFailure_ttd_by_rate"] = measure_payment_sweep(seed=seed, device=device)
    out.update(measure_fp_rate(seed=seed + 1, device=device))
    return out


def main() -> None:
    import json

    print(json.dumps(measure_detection_quality()))


if __name__ == "__main__":
    main()
