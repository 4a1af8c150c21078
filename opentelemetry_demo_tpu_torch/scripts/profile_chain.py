"""Why chained steps cost what they cost: five runs of the detector step.

The counterpart of the reference's ``scripts/profile_chain.py``, whose
"donate" is this package's in-place state and whose "no-donate" is a
clone of the state for each step: a fixed or a chained state, a fixed
or a varying rotation mask (every 7th step rotates the 1 s window), and
the report's flags copied to the host after each step. Each run times
``ITERS`` steps after one warm-up step, ending in a synchronise, and
prints µs a step.

Usage: python -m opentelemetry_demo_tpu_torch.scripts.profile_chain [B]
       [--device cuda|cpu]   (B defaults to 2048)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..bench import BASELINE_SPANS_PER_SEC, bench_device, make_batch_pool
from ..models import DetectorConfig, detector_init, detector_step
from ..models.detector import DetectorState

ITERS = 300


def clone_state(state: DetectorState) -> DetectorState:
    return DetectorState(*(t.clone() for t in state))


def main(argv: list[str] | None = None) -> dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=2048)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the step runs (default: the card)")
    args = parser.parse_args(argv)
    device = bench_device(args.device)
    config = DetectorConfig()
    b = args.batch
    pool = make_batch_pool(config, b, 4, np.random.default_rng(0), device)
    dt = torch.tensor(b / BASELINE_SPANS_PER_SEC, dtype=torch.float32, device=device)
    rot = torch.tensor([False, False, False], device=device)
    rot_t = torch.tensor([True, False, False], device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(name, donate, chain, vary_mask, fetch_flags=False):
        state, _ = detector_step(config, detector_init(config, device), *pool[0], dt, rot)
        sync()
        s = state
        t0 = time.perf_counter()
        for i in range(ITERS):
            mask = rot_t if (vary_mask and i % 7 == 0) else rot
            src = s if chain else state
            out, rep = detector_step(config, src if donate else clone_state(src), *pool[i % 4], dt, mask)
            if chain:
                s = out
            if fetch_flags:
                rep.flags.cpu()
        sync()
        per = (time.perf_counter() - t0) / ITERS
        print(f"{name:45s} {per*1e6:9.1f} us/step")
        return per

    return {
        "no-donate, no-chain, fixed mask": run("no-donate, no-chain, fixed mask", False, False, False),
        "no-donate, chain, fixed mask": run("no-donate, chain, fixed mask", False, True, False),
        "donate, chain, fixed mask": run("donate, chain, fixed mask", True, True, False),
        "donate, chain, varying mask": run("donate, chain, varying mask", True, True, True),
        "donate, chain, vary mask, fetch flags": run(
            "donate, chain, vary mask, fetch flags", True, True, True, True),
    }


if __name__ == "__main__":
    main()
