"""The port's component supervisor against the reference.

Each of the reference's supervisor cases (backoff with jitter, skip
during backoff, crash loop into DEGRADED, probe-driven restart,
per-component health) is written once and run through both packages on
the same virtual clock. The reference's assertions hold for each
package, and the two packages' records (the waits between attempts,
the states, the rendered ``anomaly_component_*`` and
``anomaly_degraded`` families) must be equal. Both supervisors seed
their jitter from the same fixed ``random.Random``, so the waits compare
exactly.
"""

from __future__ import annotations

import types

import pytest

from opentelemetry_demo_tpu.runtime import supervision as jsupervision
from opentelemetry_demo_tpu.telemetry import metrics as jmetrics
from opentelemetry_demo_tpu_torch.runtime import supervision
from opentelemetry_demo_tpu_torch.telemetry import metrics

PKGS = {
    "port": types.SimpleNamespace(sup=supervision, metrics=metrics),
    "reference": types.SimpleNamespace(sup=jsupervision, metrics=jmetrics),
}


def _clock():
    state = {"t": 0.0}

    def advance(dt):
        state["t"] += dt

    return (lambda: state["t"]), advance


def backoff_grows_bounded_with_jitter(m) -> dict:
    now, advance = _clock()
    reg = m.metrics.MetricRegistry()
    sup = m.sup.Supervisor(registry=reg, time_fn=now)
    sup.register("flaky", base_backoff_s=1.0, max_backoff_s=8.0,
                 restart_budget=100, budget_window_s=1e9)
    waits = []
    for _ in range(6):
        sup.run_step("flaky", lambda: 1 / 0)
        c = sup._components["flaky"]
        waits.append(c.next_attempt_at - now())
        advance(waits[-1] + 0.01)  # sit out the backoff window
    # Jittered exponential: each wait sits in [0.5, 1.5)x its base
    # rung, bases doubling 1,2,4,8 then clamped at 8.
    for wait, base in zip(waits, (1, 2, 4, 8, 8, 8)):
        assert 0.5 * base <= wait < 1.5 * base
    text = reg.render()
    assert 'anomaly_component_restarts_total{component="flaky"} 6.0' in text
    assert 'anomaly_component_up{component="flaky"} 0.0' in text
    return {"waits": waits, "metrics": text}


def run_step_skips_during_backoff_and_recovers(m) -> dict:
    now, advance = _clock()
    sup = m.sup.Supervisor(time_fn=now)
    sup.register("c", base_backoff_s=2.0)
    calls = []

    def boom():
        calls.append("x")
        raise RuntimeError("transient")

    assert sup.run_step("c", boom) is None
    states = [sup.state("c")]
    assert states[-1] == m.sup.BACKOFF
    # Inside the backoff window the function is not invoked.
    assert sup.run_step("c", boom) is None
    assert calls == ["x"]
    advance(4.0)
    assert sup.run_step("c", lambda: 42) == 42
    states.append(sup.state("c"))
    assert states[-1] == m.sup.UP
    return {"states": states, "calls": calls}


def crash_loop_degrades_but_keeps_retrying(m) -> dict:
    now, advance = _clock()
    reg = m.metrics.MetricRegistry()
    sup = m.sup.Supervisor(registry=reg, time_fn=now)
    sup.register("loop", base_backoff_s=0.1, max_backoff_s=1.0,
                 restart_budget=3, budget_window_s=60.0)
    for _ in range(5):
        sup.run_step("loop", lambda: 1 / 0)
        advance(2.0)
    assert sup.state("loop") == m.sup.DEGRADED
    assert sup.degraded()
    degraded = reg.render()
    assert "anomaly_degraded 1.0" in degraded
    # Degraded is not abandoned: the component still answers retries
    # and recovers the moment the fault clears.
    advance(2.0)
    assert sup.run_step("loop", lambda: "ok") == "ok"
    assert sup.state("loop") == m.sup.UP
    assert not sup.degraded()
    recovered = reg.render()
    assert "anomaly_degraded 0.0" in recovered
    return {"degraded": degraded, "recovered": recovered}


def probe_failure_triggers_restart(m) -> dict:
    now, advance = _clock()
    sup = m.sup.Supervisor(time_fn=now)
    healthy = {"v": False}
    restarts = []
    sup.register(
        "svc",
        restart=lambda: restarts.append(1) or healthy.update(v=True),
        probe=lambda: healthy["v"],
        base_backoff_s=0.1,
    )
    advance(0.01)
    sup.tick()  # probe fails → crash recorded
    states = [sup.state("svc")]
    assert states[-1] == m.sup.BACKOFF
    advance(1.0)
    sup.tick()  # due → restart() runs and succeeds
    assert restarts == [1]
    states.append(sup.state("svc"))
    assert states[-1] == m.sup.UP
    return {"states": states, "restarts": restarts}


def health_status_per_component(m) -> dict:
    sup = m.sup.Supervisor()
    sup.register("kafka-orders")
    out = [sup.health_status("anomaly.component.kafka-orders")]
    assert out[-1] == m.sup.SERVING
    sup.report_crash("kafka-orders", RuntimeError("down"))
    out.append(sup.health_status("anomaly.component.kafka-orders"))
    assert out[-1] == m.sup.NOT_SERVING
    out.append(sup.health_status("anomaly.component.nope"))
    out.append(sup.health_status("oteldemo.CartService"))
    assert out[-2:] == [None, None]
    return {"health": out}


CASES = [
    backoff_grows_bounded_with_jitter,
    run_step_skips_during_backoff_and_recovers,
    crash_loop_degrades_but_keeps_retrying,
    probe_failure_triggers_restart,
    health_status_per_component,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_supervisor_case_runs_as_the_reference_runs_it(case):
    records = {name: case(ns) for name, ns in PKGS.items()}
    assert records["port"] == records["reference"]


def test_states_and_constants_are_the_references():
    for name in ("UP", "BACKOFF", "DEGRADED", "SERVING", "NOT_SERVING"):
        assert getattr(supervision, name) == getattr(jsupervision, name), name
