"""Count how often ``RemediationController.drain`` returns while a
pre-flight job is still running, in the reference and in the port.

Each trial parks one act behind a pre-flight gate that takes 20 ms, then
drains. A drain that returns before the gate's verdict is recorded took a
popped job for a finished one: the reference reads "worker idle" and
"queue empty" apart, and a job the worker pops between the two readings
passes for done; the port takes both readings at once under the
controller's lock. How often the early return shows depends on how the
host schedules the worker thread.

    python tests/torch_drain_race_probe.py [--trials 200]

Prints one line per package: ``<module> early drains <n> of <trials>``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opentelemetry_demo_tpu.runtime import remediation as jremediation  # noqa: E402
from opentelemetry_demo_tpu_torch.runtime import remediation  # noqa: E402
from opentelemetry_demo_tpu_torch.utils.flags import FlagEvaluator  # noqa: E402

FLAG = "f"
DOC = {"flags": {FLAG: {"state": "ENABLED", "variants": {"on": True, "off": False}, "defaultVariant": "on"}}}


def drains_early(mod) -> bool:
    """One trial: True when ``drain`` returned before the pre-flight's
    verdict was recorded."""
    store = FlagEvaluator(DOC)

    def gate(_svc):
        time.sleep(0.02)
        return True

    ctrl = mod.RemediationController(
        [mod.FlagdActuator(store=store, policy={"s": (FLAG,)})], enabled=True, act_batches=2, preflight=gate)
    try:
        ctrl.observe(0.0, ["s"], services=["s"])
        ctrl.observe(0.25, ["s"], services=["s"])
        ctrl.drain(5.0)
        return not ctrl.stats()["preflight_verdicts"]
    finally:
        ctrl.close()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=200)
    args = ap.parse_args()
    for mod in (jremediation, remediation):
        early = sum(drains_early(mod) for _ in range(args.trials))
        print(f"{mod.__name__} early drains {early} of {args.trials}", flush=True)


if __name__ == "__main__":
    main()
