"""History replay harness: recorded frames → the real pipeline, N×.

With span capture on, the history writer records every dispatched span
batch as a verified frame; this module re-feeds those frames through a
fresh, real ``DetectorPipeline`` (same admission, same tensorize/pack,
same step on the card, same harvest) under virtual-time clock
injection: ``pump(t)`` gets each batch's RECORDED timebase, so window
rotation and EWMA dt replay exactly while the wall clock runs as fast as
the machine allows.

Two numbers come out:

- ``replay_speedup`` — recorded virtual seconds per wall second of
  replay, gated at ≥ ``ANOMALY_HISTORY_REPLAY_RATE`` (default 10);
- **bit-identical verdicts** — the replayed run's per-batch flag vectors
  must equal the recording run's exactly (the same rows at the same
  width under the same ``t`` give the same step).

``measure_replay`` is self-contained: it records a synthetic incident (a
paymentFailure-shaped error burst over clean warm-up traffic) into a
temporary store, then replays it. ``history_range_query_p99_ms`` (range
reads over the just-written ladder) rides along. Every entry point runs
on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import tempfile
import time

import numpy as np

from ..models.detector import DetectorConfig
from . import history
from .tensorize import SpanColumns
from .timetravel import snapshot_fn

# Small geometry: the protocol (record → replay equivalence) is under
# test here; qualbench owns quality numbers.
S = 8
B = 256
DT_S = 0.25
WARM_STEPS = 60
FAULT_STEPS = 60
FAULT_SVC = 5


def _replay_config() -> DetectorConfig:
    return DetectorConfig(num_services=S, hll_p=8, cms_width=256)


def _make_cols(rng, step: int, faulted: bool) -> SpanColumns:
    """One batch of shop-shaped traffic; past onset the faulted
    service takes a 25% error burst plus a latency step — the
    paymentFailure projection qualbench measures TTD on."""
    svc = rng.integers(0, S, size=B).astype(np.int32)
    lat = rng.gamma(4.0, 250.0, size=B).astype(np.float32)
    err = (rng.random(B) < 0.01).astype(np.float32)
    trace = (
        rng.integers(0, 64, size=B, dtype=np.uint64) * np.uint64(2654435761)
        + np.uint64(1)
    )
    attr = rng.zipf(1.5, size=B).astype(np.uint64)
    if faulted:
        hit = (rng.random(B) < 0.25).astype(np.float32)
        err = np.where(svc == FAULT_SVC, np.maximum(err, hit), err)
        lat = np.where(svc == FAULT_SVC, lat * 3.0, lat).astype(np.float32)
    return SpanColumns(
        svc=svc, lat_us=lat, is_error=err, trace_key=trace, attr_crc=attr
    )


def _make_pipeline(
    collect: dict, device=None, config: DetectorConfig | None = None, batch_size: int = B,
) -> tuple[AnomalyDetector, DetectorPipeline]:
    # Delegates to the ONE shared constructor (runtime.shadow) so the
    # counterfactual pre-flight verifier and this harness can never
    # drift: same pipeline construction, same verdict keying.
    from .shadow import build_shadow_pipeline

    return build_shadow_pipeline(config or _replay_config(), batch_size, collect, device=device)


def record_incident(
    directory: str,
    seed: int = 0,
    warm_steps: int = WARM_STEPS,
    fault_steps: int = FAULT_STEPS,
    device=None,
) -> dict:
    """Drive the incident through a REAL pipeline while the history
    writer records both the span corpus and the bank ladder (the
    writer's snapshot is the pipeline's stream-ordered state copy);
    returns the recording run's verdicts keyed by batch timebase."""
    rng = np.random.default_rng(seed)
    verdicts: dict = {}
    _det, pipe = _make_pipeline(verdicts, device=device)
    store = history.HistoryStore(directory, retention_s=(86400.0, 86400.0))
    writer = history.HistoryWriter(
        store, snapshot_fn(pipe), rungs=(1.0, 60.0), capture_spans=True,
        span_queue_max=4 * (warm_steps + fault_steps),
    )
    pipe.history_capture = writer.capture
    wall0 = time.time()
    for step in range(warm_steps + fault_steps):
        t = step * DT_S
        pipe.submit_columns(_make_cols(rng, step, step >= warm_steps))
        pipe.pump(t)
        writer.tick(now=wall0 + t)
    pipe.drain()
    writer.close()
    pipe.close()
    return verdicts


def replay(
    directory: str, device=None, config: DetectorConfig | None = None, batch_size: int = B,
) -> tuple[dict, float, float, int]:
    """Re-feed the recorded span frames through a fresh real pipeline
    (``config`` and ``batch_size``: the recording's; the defaults are
    this module's incident) at max speed under the RECORDED virtual
    clock; returns (verdicts, virtual_span_s, wall_s, batches). The
    virtual span counts one batch interval past the last batch."""
    store = history.HistoryStore(directory)
    reader = history.HistoryReader(store, rungs=(1.0, 60.0))
    # First use off the clock: a throwaway detector at the same
    # geometry and batch width takes the kernel library's load, the
    # first launch and the allocator's growth, so the timed loop
    # measures REPLAY. It is discarded; close() joins what it started.
    warm_det, warm_pipe = _make_pipeline({}, device, config, batch_size)
    warm_pipe.submit_columns(_make_cols(np.random.default_rng(1), 0, False))
    warm_pipe.pump(0.0)
    warm_pipe.close()
    del warm_det
    verdicts: dict = {}
    _det, pipe = _make_pipeline(verdicts, device, config, batch_size)
    batches = 0
    t_first = t_last = None
    pending_t: float | None = None
    wall0 = time.perf_counter()
    for arrays, t_batch in reader.span_batches():
        cols = SpanColumns(
            **{
                name: np.asarray(arrays[name])
                for name in history.SPAN_CAPTURE_COLUMNS
            }
        )
        # One-batch lookahead: batch k pumps while batch k+1 already
        # sits in the queue, so the sync harvest keeps one report in
        # flight (the pipeline's normal overlap regime) instead of
        # waiting for the card per batch. Verdicts are computed on the
        # device from (batch, t) alone — harvest timing cannot change
        # them.
        pipe.submit_columns(cols)
        if pending_t is not None:
            pipe.pump(pending_t)
            batches += 1
        pending_t = t_batch
        t_first = t_batch if t_first is None else t_first
        t_last = t_batch
    if pending_t is not None:
        pipe.pump(pending_t)
        batches += 1
    pipe.drain()
    wall = time.perf_counter() - wall0
    pipe.close()
    virtual = (
        (t_last - t_first) * batches / max(batches - 1, 1) if t_first is not None else 0.0
    )
    return verdicts, virtual, wall, batches


def measure_range_queries(
    directory: str, samples: int = 50, seed: int = 0
) -> dict:
    """p50/p99 ms of range reads over the just-written ladder — the
    ``history_range_query_p99_ms`` artifact field."""
    store = history.HistoryStore(directory)
    reader = history.HistoryReader(store, rungs=(1.0, 60.0))
    recs = store.records(kind=history.KIND_BANK, rung=0)
    if not recs:
        return {}
    t0, t1 = recs[0].t_start, recs[-1].t_end
    rng = np.random.default_rng(seed)
    lat_ms = []
    for _ in range(samples):
        a, b = sorted(rng.uniform(t0, t1, size=2))
        start = time.perf_counter()
        reader.range_state(float(a), float(b) + 1.0)
        lat_ms.append((time.perf_counter() - start) * 1e3)
    lat = np.asarray(lat_ms)
    return {
        "history_range_query_p50_ms": round(float(np.percentile(lat, 50)), 3),
        "history_range_query_p99_ms": round(float(np.percentile(lat, 99)), 3),
        "history_range_query_samples": samples,
    }


def measure_replay(seed: int = 0, directory: str | None = None, device=None) -> dict:
    """Record → replay → compare; ONE result dict (the ``replay_*``
    fields)."""
    from ..utils.config import HISTORY_KNOBS, env_float

    target = env_float(
        "ANOMALY_HISTORY_REPLAY_RATE",
        HISTORY_KNOBS["ANOMALY_HISTORY_REPLAY_RATE"][1],
    )
    tmp = None
    if directory is None:
        tmp = tempfile.TemporaryDirectory(prefix="replaybench-")
        directory = tmp.name
    try:
        recorded = record_incident(directory, seed=seed, device=device)
        replayed, virtual, wall, batches = replay(directory, device=device)
        identical = recorded == replayed
        speedup = virtual / max(wall, 1e-9)
        out = {
            "replay_speedup": round(speedup, 2),
            "replay_rate_target": target,
            "replay_ok": bool(identical and speedup >= target),
            "replay_verdicts_identical": identical,
            "replay_batches": batches,
            "replay_virtual_s": round(virtual, 3),
            "replay_wall_s": round(wall, 4),
            "replay_flagged_batches": sum(
                1 for flags in recorded.values() if any(flags)
            ),
        }
        out.update(measure_range_queries(directory, seed=seed))
        return out
    finally:
        if tmp is not None:
            tmp.cleanup()


def main() -> None:
    import json

    out = {"metric": "history_replay", "unit": "x_wall_clock"}
    out.update(measure_replay())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
