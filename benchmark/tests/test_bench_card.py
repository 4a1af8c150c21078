"""A short run of a cell on the card through the benchmark's own
command (skips without a card)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["shop.saturate", "shop.paced"])
def test_a_short_run_on_the_card_is_correct(cuda_device, workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "2147483700",
         "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


def test_without_a_card_the_run_prints_no_result():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "shop.saturate", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
