"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json`` ``workloads``)
names a configuration (``benchmark/configs/<name>.json``) and a traffic
mix (``benchmark/traffic/<name>.json``); the run builds the detector
daemon's served path with that configuration on the card, sends the mix
for ``--seconds`` and prints, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: every
number compared against the plain reference beside its limit (also the
last lines of standard error).

``--control 1`` also runs the reference in bfloat16 in the program's
place over the same batches and prints what the comparison reads for
it (the control every limit is set against); a measured run leaves it
off. With no card, or fewer cards than the cell asks for, the run exits
2 and prints no result.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """perf_counter seconds at which this process started."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


PROCESS_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

import numpy as np  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# Kernel and compiler caches live inside the checkout, at fixed paths.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness import guard, measures  # noqa: E402
from benchmark.harness.spec import metric_reader  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    args = parse(argv)
    cell, cfg, mix, bench = cells.load(ROOT, args.workload)
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    run = cells.run(cell, cfg, mix, args.seed, args.seconds, bool(args.trace), "cuda",
                    PROCESS_START, control=bool(args.control))
    found = guard.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    rec = measures.record(run)
    e2e = measures.end_to_end(rec)
    name = args.workload
    if args.trace:
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, name):
                v = metric_reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, name)}
    verdict = run["verdict"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": run["window"]["peak"]}
    dev = rec["device"]
    if dev:
        device["busy_s"] = dev["busy_s"]
        device["window_s"] = dev["window_s"]
    st0, st1 = rec["stats"]
    info = {
        "card": card_line(), "spans_per_s": rec["spans_per_s"], "lag_p50_ms": e2e["lag_p50_ms"],
        "lag_p99_ms": e2e["lag_p99_ms"], "lag_samples": int(rec["lag_ms"].size),
        "bodies": rec["bodies"], "refusals": rec["refusals"],
        "batches": st1["batches"] - st0["batches"], "reports_skipped": st1["skipped"] - st0["skipped"],
        "saturation_events": st1["saturation"] - st0["saturation"], "shed_rows": rec["failed"], "backlog_at_close": rec["backlog"],
        "widths": sorted({int(x) for x in rec["batch_width"]}), "setup_s": rec["setup_s"],
        "judge": {k: verdict[k] for k in ("rows", "batches", "reports", "decode")},
    }
    flagged = [int(r[2].sum()) for r in run["window"]["report_flags"]]
    info["flagged_pairs"] = sum(flagged)
    info["flagged_max_report"] = max(flagged, default=0)
    pumps = np.array([b - a for a, b in rec["pump_spans"]]) if rec["pump_spans"] else np.zeros(1)
    info["pump_ms"] = {"n": int(pumps.size), "mean": float(pumps.mean()) * 1e3, "max": float(pumps.max()) * 1e3}
    info["phase_ms"] = {p: measures.phase_mean(rec, p) for p in ("dispatch", "harvest", "flag", "stage", "put_wait")}
    if dev:
        info["k1"] = {"launches": dev["k1_launches"], "seconds": dev["k1_s"], "device_ops": dev["ops"],
                      "slices": dev["slices"]}
    if "control" in verdict:
        info["control"] = verdict["control"]
    print("benchmark: " + json.dumps(info, default=float), file=sys.stderr)
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in verdict["numbers"].items()}
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    line = {"correct": bool(verdict["correct"]), "attempted": rec["attempted"], "failed": rec["failed"],
            "metrics": metrics, "device": device}
    if dev:
        line["breakdown"] = {"device_ops": [[n[:160], s] for n, s in dev["device_ops"]],
                             "idle_gaps": dev["idle_gaps"]}
    line["checks"] = checks
    print(json.dumps(line, default=_num))
    return 0


def _num(x):
    x = float(x)
    return x if math.isfinite(x) else str(x)


if __name__ == "__main__":
    sys.exit(main())
