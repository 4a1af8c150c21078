"""The port's detection-quality and mitigation benches against the
reference.

qualbench's thirteen fault shapes, its payment sweep and its
false-positive run go through both packages' detectors on the same
seeds, at reduced horizons (40 warm-up batches, a 40-batch give-up
window, 120 quiet batches, as ``tests/test_e2e_detection.py`` reduces
them): per scenario the time to detect, the batches to detect and the
warm-up false flags must be equal, and so must the FP rate. mitigbench's
closed loop (``run_scenario``) gives equal TTD and TTM, the rollback
drill rolls back alike, the clean run writes no flag in either package,
and the shadow leg's pre-flight loops release and refuse alike.

Tolerance: every compared number is a count of batches or a multiple of
the virtual batch interval and compares exactly; wall-clock fields
(``preflight_verdict_s``) are dropped. The flight recorder spaces its
dumps of one reason by a wall-clock cooldown (2 s), so how many refusal
dumps a pre-flight loop leaves depends on the host's speed: the
pre-flight tests give both packages' recorders a cooldown longer than
the run (:func:`one_dump_per_reason`), and the refusal events, which no
cooldown gates, are still counted exactly.

The reference's ``RemediationController.drain`` reads "worker idle" and
"queue empty" apart, so a job the worker pops between the two readings
passes for done and the loop observes its next batch early (ROADMAP §C).
The closed-loop tests give the reference's controller the port's one
reading under the lock (:func:`steady_reference_drain`), so the
comparison does not depend on how the host schedules the worker.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.runtime import mitigbench as jmitigbench
from opentelemetry_demo_tpu.runtime import qualbench as jqualbench
from opentelemetry_demo_tpu.runtime import remediation as jremediation
from opentelemetry_demo_tpu_torch.runtime import mitigbench, qualbench, remediation

SCENARIOS = list(qualbench.fault_shapes(np.random.default_rng(0)))


@pytest.fixture
def short(monkeypatch):
    for mod in (qualbench, jqualbench, mitigbench, jmitigbench):
        monkeypatch.setattr(mod, "WARM_STEPS", 40)
    for mod in (qualbench, jqualbench):
        monkeypatch.setattr(mod, "FAULT_WINDOW_STEPS", 40)
        monkeypatch.setattr(mod, "QUIET_STEPS", 120)
    for mod in (mitigbench, jmitigbench):
        monkeypatch.setattr(mod, "QUIET_STEPS", 120)
        monkeypatch.setattr(mod, "MITIGATE_WINDOW_STEPS", 80)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """qualbench's geometry is small (S=8, B=256): torch's intra-op
    thread pool gains nothing there and spins against XLA's pool in the
    same process, which made this file five times slower after other
    files had started JAX's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def one_dump_per_reason(monkeypatch):
    for mod in (mitigbench, jmitigbench):
        monkeypatch.setattr(mod, "FlightRecorder", functools.partial(mod.FlightRecorder, dump_cooldown_s=1e9))


@pytest.fixture
def steady_reference_drain(monkeypatch):
    monkeypatch.setattr(jremediation.RemediationController, "drain", remediation.RemediationController.drain)


def test_the_fault_shapes_are_the_references():
    assert SCENARIOS == list(jqualbench.fault_shapes(np.random.default_rng(0)))
    assert len(SCENARIOS) == 13
    assert (qualbench.S, qualbench.B, qualbench.DT_S) == (jqualbench.S, jqualbench.B, jqualbench.DT_S)
    assert qualbench._quality_config() == jqualbench._quality_config()
    assert qualbench.PAYMENT_SWEEP == jqualbench.PAYMENT_SWEEP


@pytest.mark.parametrize("name", SCENARIOS)
def test_time_to_detect_equals_the_reference(short, name):
    got_svc, got_mut = qualbench.fault_shapes(np.random.default_rng(0))[name]
    want_svc, want_mut = jqualbench.fault_shapes(np.random.default_rng(0))[name]
    assert got_svc == want_svc
    got = qualbench.measure_time_to_detect(name, got_svc, got_mut, seed=0, device="cpu")
    want = jqualbench.measure_time_to_detect(name, want_svc, want_mut, seed=0)
    assert got == want
    assert got["false_flags_warmup"] == 0


def test_the_fp_rate_equals_the_reference(short):
    got = qualbench.measure_fp_rate(seed=1, device="cpu")
    want = jqualbench.measure_fp_rate(seed=1)
    assert got == want and got["quiet_batches"] == 120


@pytest.mark.parametrize("name,heal", [("paymentFailure", True), ("kafkaQueueProblems", True),
                                       ("paymentFailure", False)])
def test_the_closed_loop_mitigates_as_the_reference(short, steady_reference_drain, name, heal):
    kw = {} if heal else {"deadline_s": mitigbench.ROLLBACK_DEADLINE_S}
    got = mitigbench.run_scenario(name, heal=heal, seed=0, device="cpu", **kw)
    want = jmitigbench.run_scenario(name, heal=heal, seed=0, **kw)
    assert got == want
    if heal:
        assert got["verified"] and got["time_to_mitigate_s"] >= got["ttd_s"]
    else:
        assert got["rolled_back"] and got["flag_state_end"] == "ENABLED"


def test_no_flag_flips_on_a_clean_run_in_either_package(short, steady_reference_drain):
    got = mitigbench.measure_no_oscillation(seed=1, device="cpu")
    want = jmitigbench.measure_no_oscillation(seed=1)
    assert got == want and got["ok"] and got["flag_writes"] == 0


@pytest.mark.parametrize("wired,refuse", [(False, False), (True, False), (True, True)])
def test_the_preflight_loops_release_and_refuse_as_the_reference(steady_reference_drain, one_dump_per_reason,
                                                                 wired, refuse):
    got = mitigbench._preflight_loop(wired, refuse=refuse, seed=0, device="cpu")
    want = jmitigbench._preflight_loop(wired, refuse=refuse, seed=0)
    for d in (got, want):
        d.pop("preflight_verdict_s")
    assert got == want
    if refuse:
        assert got["refused"] >= 1 and got["flag_writes"] == 0 and got["doc_unchanged"]
        assert got["flight_refused_dumps"] == 1 and got["flight_refused_events"] == got["refused"]
    else:
        assert got["verified"]


def test_the_collector_leg_measures_as_the_reference():
    assert mitigbench.measure_collector(seed=0) == jmitigbench.measure_collector(seed=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_qualbench_on_the_card_equals_the_cpu(short, cuda_device):
    for name in ("paymentFailure", "traceCardinalityExplosion", "errorTrickle"):
        svc, mut = qualbench.fault_shapes(np.random.default_rng(0))[name]
        card = qualbench.measure_time_to_detect(name, svc, mut, device=cuda_device)
        svc, mut = qualbench.fault_shapes(np.random.default_rng(0))[name]
        assert card == qualbench.measure_time_to_detect(name, svc, mut, device="cpu")
    assert qualbench.measure_fp_rate(device=cuda_device) == qualbench.measure_fp_rate(device="cpu")
