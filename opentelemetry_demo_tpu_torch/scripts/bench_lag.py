"""Detection-lag benchmark CLI: the second north-star metric.

An argument front end over ``runtime.lagbench`` (also what
``opentelemetry_demo_tpu_torch.bench`` runs for its line). Prints one
JSON line:

    {"metric": "detection_lag_p99", "value": N, "unit": "ms",
     "vs_baseline": <100 ms target / p99>, ...}

Usage: python -m opentelemetry_demo_tpu_torch.scripts.bench_lag
       [--rate 2000] [--seconds 8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

from ..bench import bench_device
from ..runtime.lagbench import BASELINE_LAG_MS, measure_lag


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rate", type=float, default=2_000.0,
                        help="spans/sec to sustain (default models the default Locust "
                        "profile; 200000 = stress config)")
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--harvest-interval", type=float, default=0.0,
                        help="report readback cadence, s (0 = every batch)")
    parser.add_argument("--harvest-async", action="store_true",
                        help="fetch reports on a background thread")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the detector runs (default: the card)")
    args = parser.parse_args(argv)

    stats = measure_lag(
        rate=args.rate,
        seconds=args.seconds,
        batch=args.batch,
        harvest_interval_s=args.harvest_interval,
        harvest_async=args.harvest_async,
        device=str(bench_device(args.device)),
    )
    out = {
        "metric": "detection_lag_p99",
        "value": stats["p99_ms"],
        "unit": "ms",
        "vs_baseline": round(BASELINE_LAG_MS / max(stats["p99_ms"], 1e-9), 3),
        "rate_spans_per_sec": stats["rate"],
        "batches": stats["batches"],
        "spans": stats["spans"],
        "reports_skipped": stats["reports_skipped"],
        "pumps_caught_up": stats["pumps_caught_up"],
        "pumps_widened": stats["pumps_widened"],
        "reports_same_pump": stats["reports_same_pump"],
    }
    # The paired-probe fields: lag less the round trip of a one-scalar
    # fetch made beside each harvest.
    for key in ("p99_net_ms", "p50_net_ms", "rtt_p50_ms", "rtt_p99_ms", "rtt_pairs"):
        if key in stats:
            out[key] = stats[key]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
