"""The port's spinebench against the reference's, on the CPU.

``measure_e2e`` (payloads → decode pool → spine → harvested reports)
returns the reference's keys with its spans conserved (every span of an
admitted payload reaches the pipeline once, in batches of at most B);
``measure_kernel_ref`` takes ``device=`` and ends each region with the
report fetched; ``main`` reads ``BENCH_SPINE_SECONDS`` through
``utils.config``, refusing a malformed value with the reference's error.
Times here are the CPU's and are not compared.
"""

from __future__ import annotations

import pytest
import torch

from opentelemetry_demo_tpu.runtime import spinebench as ref_spinebench
from opentelemetry_demo_tpu.utils.config import ConfigError as RefConfigError
from opentelemetry_demo_tpu_torch.models import DetectorConfig
from opentelemetry_demo_tpu_torch.runtime import spinebench
from opentelemetry_demo_tpu_torch.utils.config import ConfigError

REFERENCE_KEYS = {
    "spans_per_sec", "kernel_spans_per_sec", "spans", "batches", "reports", "elapsed_s", "workers", "ring",
    "overlap_ratio", "tickets_parked", "tickets_recycled", "frames_corrupt", "phase_share",
    "selftrace_traces", "explanations_built",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_measure_e2e_returns_the_references_keys_and_conserves_spans():
    got = spinebench.measure_e2e(seconds=1, device="cpu", n_requests=8, spans_per_request=64)
    want = ref_spinebench.measure_e2e(seconds=0.2, n_requests=8, spans_per_request=64, kernel_ref=False)
    assert set(got) == set(want) == REFERENCE_KEYS
    assert got["spans"] > 0 and got["spans"] % 64 == 0  # whole payloads, each once
    assert got["spans"] <= got["batches"] * 2048 and 0 < got["reports"] <= got["batches"]
    assert got["frames_corrupt"] == 0
    assert got["tickets_parked"] == got["tickets_recycled"]
    assert got["kernel_spans_per_sec"] > 0
    assert set(got["phase_share"]) == set(want["phase_share"])


@pytest.mark.parametrize("harness", ["selftrace", "explain"])
def test_overhead_harnesses_take_a_device(harness):
    fn = getattr(spinebench, f"measure_{harness}_overhead")
    got = fn(seconds=0.3, rounds=1, device="cpu", n_requests=4, spans_per_request=32)
    assert got["ratio"] > 0 and got["spans_per_sec_on"] > 0 and got["spans_per_sec_off"] > 0


def test_kernel_reference_runs_on_the_named_device():
    cfg = DetectorConfig(num_services=8, hll_p=8, cms_width=512)
    assert spinebench.measure_kernel_ref(cfg, batch=256, steps=32, device="cpu") > 0


def test_bench_seconds_knob_is_read_through_config(monkeypatch):
    monkeypatch.setenv("BENCH_SPINE_SECONDS", "soon")
    with pytest.raises(ConfigError) as got:
        spinebench.main(["--device", "cpu"])
    with pytest.raises(RefConfigError) as want:
        ref_spinebench.main()
    assert str(got.value) == str(want.value)
