"""Shared fixtures of the benchmark's own tests (CPU; the `gpu` ones
skip without a card)."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "benchmark"


def small_config(name: str = "shop") -> dict:
    """A configuration file as committed; the CPU runs cut the traffic,
    not the configuration."""
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


CLOSED = {"loop": "closed", "in_flight": 4, "spans_per_body": 512, "pool_bodies": 12,
          "warmup_bodies": [512] * 4, "warmup_groups": [[0], [1, 2], [3]]}
PACED = {"loop": "paced", "agents": 4, "flush_s": 0.2, "rate_spans_s": 4000, "cap": 8192,
         "warmup_bodies": [100] * 4, "warmup_groups": [[0], [1, 2, 3]]}


def run_small(cfg=None, mix=None, seed=2**31 + 99, seconds=2.0, control=False):
    """One whole run of the harness on the CPU (the card check skipped)."""
    from benchmark.harness import cell as cells

    return cells.run({"name": "test", "chips": 1}, cfg or small_config(), mix or CLOSED, seed,
                     seconds, False, "cpu", time.perf_counter(), control=control)


@pytest.fixture
def cuda_device():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
