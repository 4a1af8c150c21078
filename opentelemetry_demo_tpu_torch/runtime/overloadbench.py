"""Overload saturation bench: the pipeline at a multiple of its drain
capacity, then the pressure cut, measuring the degradation contract:

- the pending queue never exceeds its row budget;
- error-lane rows are never shed, and after a full drain dispatched
  spans == fed − shed − brownout exactly;
- sustained saturation engages the brownout ladder, and once the
  pressure clears the ladder relaxes to level 0 with the queue under the
  low watermark within a bounded recovery window.

The feed asks ``admission_retry_after`` before each chunk, as a receiver
does, but feeds whatever it answers; ``retry_hints_derived`` and
``retry_hint_s_sum`` count the answers below ``retry_after_s``.

Runs on the card unless ``device="cpu"`` is passed. As a script it
prints the result as one JSON line::

    python -m opentelemetry_demo_tpu_torch.runtime.overloadbench [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from ..models import AnomalyDetector, DetectorConfig
from .lagbench import make_columns
from .pipeline import DetectorPipeline
from .tensorize import SpanColumns


def _mark_errors(cols: SpanColumns, error_fraction: float, rng) -> SpanColumns:
    """Re-stamp the error lane at ``error_fraction``."""
    err = (rng.random(cols.rows) < error_fraction).astype(np.float32)
    return cols._replace(is_error=err)


def measure_overload(
    over_factor: float = 5.0,
    seconds: float = 3.0,
    batch: int = 256,
    queue_max_rows: int = 2048,
    high_watermark: float = 0.85,
    low_watermark: float = 0.5,
    brownout_hold_s: float = 0.25,
    brownout_max_level: int = 4,
    error_fraction: float = 0.02,
    pump_interval_s: float = 0.02,
    recovery_timeout_s: float = 30.0,
    seed: int = 0,
    config: DetectorConfig | None = None,
    device=None,
) -> dict:
    """Feed ``over_factor`` × ``batch`` rows per pump interval for
    ``seconds``, then let the pipeline recover; return the ledger.

    Capacity is structural: the pump dispatches at most ``batch`` rows
    per ``pump_interval_s``, so the feed is an ``over_factor``× overload
    by construction, with no calibration run.
    """
    detector = AnomalyDetector(config or DetectorConfig(), device=device)
    pipe = DetectorPipeline(
        detector,
        batch_size=batch,
        queue_max_rows=queue_max_rows,
        high_watermark=high_watermark,
        low_watermark=low_watermark,
        brownout_hold_s=brownout_hold_s,
        brownout_max_level=brownout_max_level,
    )
    rng = np.random.default_rng(seed)
    chunk_rows = max(int(over_factor * batch), 1)
    chunks = [
        _mark_errors(make_columns(rng, chunk_rows), error_fraction, rng)
        for _ in range(8)
    ]

    # The first step runs off the timed path.
    pipe.submit_columns(make_columns(rng, batch))
    pipe.pump(time.monotonic())
    pipe.drain()

    fed = fed_errors = 0
    max_pending = 0
    brownout_max = 0
    t_end = time.monotonic() + seconds
    i = 0
    while time.monotonic() < t_end:
        cols = chunks[i % len(chunks)]
        i += 1
        fed += cols.rows
        fed_errors += int((cols.is_error > 0).sum())
        # A receiver asks before each body; the feed is forced, so the
        # answer only counts (``retry_hints_derived``).
        pipe.admission_retry_after()
        pipe.submit_columns(cols)
        pipe.pump(time.monotonic())
        max_pending = max(max_pending, pipe.pending_rows())
        brownout_max = max(brownout_max, pipe.brownout_level)
        time.sleep(pump_interval_s)
    saturated_under_load = pipe.saturated

    # Recovery: the ladder back at 0 and the queue under the low watermark.
    t0 = time.monotonic()
    recovery_s = None
    while time.monotonic() - t0 < recovery_timeout_s:
        pipe.pump(time.monotonic())
        max_pending = max(max_pending, pipe.pending_rows())
        if pipe.brownout_level == 0 and not pipe.saturated and pipe.pending_rows() <= pipe._low_rows:
            recovery_s = round(time.monotonic() - t0, 3)
            break
        time.sleep(pump_interval_s)
    pipe.drain()
    dispatched = pipe.stats.spans
    pipe.close()

    shed_ok = pipe.stats.shed_rows["ok"]
    shed_error = pipe.stats.shed_rows["error"]
    brownout_rows = pipe.stats.brownout_rows
    return {
        "over_factor": over_factor,
        "queue_max_rows": queue_max_rows,
        "max_pending_rows": max_pending,
        "fed_rows": fed,
        "fed_error_rows": fed_errors,
        "dispatched_rows": dispatched,
        "shed_ok_rows": shed_ok,
        "shed_error_rows": shed_error,
        "brownout_rows": brownout_rows,
        # Every fed row is dispatched, shed or sampled away (+ batch: the
        # first chunk also dispatched).
        "conserved": bool(dispatched + shed_ok + shed_error + brownout_rows == fed + batch),
        "saturated_under_load": bool(saturated_under_load),
        "saturation_events": pipe.stats.saturation_events,
        "retry_hints_derived": pipe.stats.retry_hints_derived,
        "retry_hint_s_sum": round(pipe.stats.retry_hint_s_sum, 6),
        "brownout_max_level": brownout_max,
        "recovery_s": recovery_s,
        "lag_p99_ms": round(pipe.stats.lag_p99_ms(), 3),
    }


def main() -> None:
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--over-factor", type=float, default=5.0)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--queue-max-rows", type=int, default=2048)
    parser.add_argument("--error-fraction", type=float, default=0.02)
    parser.add_argument("--device", default=None, help="cpu for the plain path (default: the card)")
    args = parser.parse_args()
    out = measure_overload(
        over_factor=args.over_factor,
        seconds=args.seconds,
        batch=args.batch,
        queue_max_rows=args.queue_max_rows,
        error_fraction=args.error_fraction,
        # Small geometry: the bench measures flow control, not kernels.
        config=DetectorConfig(num_services=8, hll_p=8, cms_width=512),
        device=args.device,
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
