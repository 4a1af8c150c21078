"""Detection-lag measurement through the real ``DetectorPipeline``.

The p99 submit→harvest lag at a paced span rate, against the <100 ms
budget. Every harvest ends in a real device→host copy of the packed
report, so the lag samples end when the report is on the host. With
``rtt_probe`` each harvest also times a one-scalar copy from the card
beside its report, and the result carries the lag less that round trip.

Runs on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import time

import numpy as np

from ..models import AnomalyDetector, DetectorConfig
from .pipeline import DetectorPipeline
from .tensorize import SpanColumns

BASELINE_LAG_MS = 100.0


def make_columns(rng, rows: int) -> SpanColumns:
    return SpanColumns(
        svc=rng.integers(0, 20, size=rows).astype(np.int32),
        lat_us=rng.gamma(4.0, 250.0, size=rows).astype(np.float32),
        is_error=(rng.random(rows) < 0.02).astype(np.float32),
        trace_key=rng.integers(0, 2**63, size=rows, dtype=np.uint64),
        attr_crc=rng.zipf(1.5, size=rows).astype(np.uint64),
    )


def measure_lag(
    rate: float = 2_000.0,
    seconds: float = 12.0,
    batch: int = 256,
    harvest_interval_s: float = 0.0,
    harvest_async: bool = False,
    rtt_probe: bool = True,
    seed: int = 0,
    config: DetectorConfig | None = None,
    adaptive: bool = False,
    max_batch_growth: int = 8,
    settle_s: float = 3.0,
    device=None,
) -> dict:
    """Drive the pipeline at ``rate`` spans/s; return lag statistics.

    The default rate is the shop's default load profile (a few users,
    10²-10³ spans/s); pass ``rate=200_000, harvest_async=True`` for the
    throughput regime. With ``adaptive`` the width controller is given
    ``settle_s`` to find its operating point before the measured window.
    """
    detector = AnomalyDetector(config or DetectorConfig(), device=device)
    pipe = DetectorPipeline(
        detector,
        batch_size=batch,
        harvest_interval_s=harvest_interval_s,
        harvest_async=harvest_async,
        rtt_probe=rtt_probe,
        adaptive_batching=adaptive,
        max_batch_growth=max_batch_growth,
    )
    rng = np.random.default_rng(seed)
    # Pre-built chunks keep generation off the timed path.
    chunks = [make_columns(rng, batch) for _ in range(16)]
    interval = batch / rate

    # The first step (and every ladder width, when adaptive) runs before
    # the measured window and is scrubbed from every stat.
    pipe.submit_columns(chunks[0])
    pipe.pump(time.monotonic())
    pipe.drain()
    pipe.warm_widths()

    def paced_loop(duration_s: float, i0: int = 0) -> int:
        end = time.monotonic() + duration_s
        next_at = time.monotonic()
        i = i0
        while time.monotonic() < end:
            now = time.monotonic()
            if now < next_at:
                time.sleep(min(next_at - now, interval))
                continue
            next_at += interval
            pipe.submit_columns(chunks[i % len(chunks)])
            pipe.pump(time.monotonic())
            i += 1
        return i

    i = 0
    if adaptive and settle_s > 0:
        i = paced_loop(settle_s)
        pipe.drain()  # the settle phase's reports stay out of the window

    pipe.stats.lag_ms.clear()
    pipe.stats.rtt_ms.clear()
    base_batches = pipe.stats.batches
    base_spans = pipe.stats.spans
    base_skipped = pipe.stats.reports_skipped
    base_caught_up = pipe.stats.pumps_caught_up
    base_widened = pipe.stats.pumps_widened
    base_same_pump = pipe.stats.reports_same_pump

    paced_loop(seconds, i)
    pipe.close()

    batches = pipe.stats.batches - base_batches
    skipped = pipe.stats.reports_skipped - base_skipped
    out = {
        "p99_ms": round(pipe.stats.lag_p99_ms(), 3),
        "rate": rate,
        "batches": batches,
        "spans": pipe.stats.spans - base_spans,
        "reports_skipped": skipped,
        # Pumps that found their input caught up, takes the backlog
        # widened, and reports read in the pump that dispatched them
        # (``pipeline.PipelineStats``).
        "pumps_caught_up": pipe.stats.pumps_caught_up - base_caught_up,
        "pumps_widened": pipe.stats.pumps_widened - base_widened,
        "reports_same_pump": pipe.stats.reports_same_pump - base_same_pump,
        "skip_rate": round(skipped / batches, 4) if batches else None,
        "final_batch_width": pipe.batch_width,
        "settle_s": settle_s if adaptive else None,
    }
    net = pipe.stats.lag_net_samples()
    rtt = np.asarray(pipe.stats.rtt_ms, dtype=np.float64)
    rtt = rtt[~np.isnan(rtt)]  # a timed-out probe appends NaN
    if net.size and rtt.size:
        out.update(
            p99_net_ms=round(float(np.percentile(net, 99)), 3),
            p50_net_ms=round(float(np.percentile(net, 50)), 3),
            rtt_p50_ms=round(float(np.percentile(rtt, 50)), 3),
            rtt_p99_ms=round(float(np.percentile(rtt, 99)), 3),
            rtt_pairs=int(net.size),
        )
    return out
