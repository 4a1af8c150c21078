"""Closed-loop mitigation bench: time-to-mitigate beside time-to-detect.

qualbench measures how fast the detector *sees* each flagd failure
scenario; this harness measures how fast the remediation controller
*fixes* it, through the real control seam: the fault is gated by a live
flagd-schema flag (how every shop service evaluates its fault flags),
the controller's :class:`~.remediation.FlagdActuator` disables that flag
through the store's atomic write path, and the loop then VERIFIES
recovery with the detector's own heads.

Per scenario (virtual time, ``DT_S`` per batch — the qualbench
timebase, so TTM and TTD are directly comparable):

- clean warm-up → fault flag on → the fault shape from
  ``qualbench.fault_shapes`` mutates the stream while the flag evaluates
  truthy;
- the controller acts after its flagged-batch hysteresis; mitigation
  disables the flag, the injector (reading the same store) stops, the
  heads clear, and the clean-streak verification records
  ``time_to_mitigate_s`` = fault onset → verified recovery;
- the **rollback drill** runs one scenario whose injector IGNORES the
  mitigation: the recovery deadline expires, the actuation rolls back to
  the exact prior flag state, and the service parks in
  ``MITIGATION_FAILED``;
- the **no-oscillation gate** runs a long clean stream with remediation
  enabled and every scenario flag present: zero actuator writes and zero
  flag flips is the pass condition.

The **shadow leg** (``--shadow``, or ``BENCH_SHADOW`` unset or non-zero)
proves the counterfactual gate live, both directions: a closed loop
records its own span corpus through a real ``DetectorPipeline`` +
``HistoryWriter`` while a preflighted controller replays it through
``runtime.shadow`` before every act — a would-help mitigation is
released (TTM within 2× the ungated baseline), a mitigation mapped to
the WRONG service is refused before any actuator write (zero flag-store
mutations, budget token refunded, ``preflight_refused`` flight evidence
+ dump on disk) — plus the shadow-vs-replaybench bit-identity at ≥
``ANOMALY_SHADOW_RATE`` (default 10) × wall and the collector-steering
keep-ratio measurement with exact-state revert.

Every detector here runs on the card unless ``device="cpu"`` is passed.
``main`` prints one JSON line.
"""

from __future__ import annotations

import glob
import os
import tempfile
import time

import numpy as np

from ..models import AnomalyDetector
from ..utils.flags import FlagEvaluator
from . import history, qualbench, replaybench, shadow
from .flightrec import FlightRecorder
from .qualbench import B, DT_S, S, WARM_STEPS, _batch, _flags, _quality_config
from .remediation import (
    STATE_FAILED,
    CollectorActuator,
    FlagdActuator,
    RemediationController,
    SamplingActuator,
)
from .tensorize import SpanTensorizer
from .timetravel import snapshot_fn

# Mitigation loop horizon after fault onset: hysteresis + actuation +
# clean-streak verification all happen inside it (virtual batches).
MITIGATE_WINDOW_STEPS = 240
QUIET_STEPS = 600

# Bench-scale guardrails (virtual seconds): tight enough to finish in
# the window, shaped like production's (act hysteresis > 1 batch,
# verification clean-streak > 1 batch, deadline ≫ verify time).
ACT_BATCHES = 2
CLEAR_BATCHES = 4
DEADLINE_S = 10.0
ROLLBACK_DEADLINE_S = 4.0

# The ≥3 scenarios measured with verified recovery (names must exist in
# qualbench.fault_shapes), plus the rollback drill's scenario.
HEALING_SCENARIOS = (
    "paymentFailure", "recommendationCacheFailure", "kafkaQueueProblems",
)
ROLLBACK_SCENARIO = "paymentFailure"


def _scenario_store(flag_keys) -> FlagEvaluator:
    """A flagd-schema store carrying each scenario flag, fault OFF."""
    return FlagEvaluator({
        "flags": {
            key: {
                "state": "ENABLED",
                "variants": {"on": True, "off": False},
                "defaultVariant": "off",
            }
            for key in flag_keys
        }
    })


def _set_fault(store: FlagEvaluator, key: str, on: bool) -> None:
    doc = store.snapshot()
    doc["flags"][key]["defaultVariant"] = "on" if on else "off"
    store.replace(doc)


def run_scenario(
    name: str,
    heal: bool = True,
    seed: int = 0,
    deadline_s: float = DEADLINE_S,
    device=None,
) -> dict:
    """One closed-loop drill; ``heal=False`` is the rollback drill
    (the injector ignores the mitigation — flag flip does not heal)."""
    rng = np.random.default_rng(seed)
    shapes = qualbench.fault_shapes(rng)
    fault_svc, mutate = shapes[name]
    det = AnomalyDetector(_quality_config(), device=device)
    tz = SpanTensorizer(num_services=S, batch_size=B)
    names = [f"svc{i}" for i in range(S)]
    for n in names:
        tz.service_id(n)
    store = _scenario_store([name])
    sampling_policy: dict = {}

    def publish(policy, seeds):
        sampling_policy.clear()
        sampling_policy.update(policy)

    flagd = FlagdActuator(
        store=store, policy={names[fault_svc]: (name,)}
    )
    sampler = SamplingActuator(
        publish=publish, base_policy={"*": 0.05},
        exemplar_fn=lambda svc: ["00deadbeef"],
    )
    ctrl = RemediationController(
        [flagd, sampler], enabled=True,
        act_batches=ACT_BATCHES, clear_batches=CLEAR_BATCHES,
        budget=4, budget_refill_s=1e9, deadline_s=deadline_s,
        rollback=True,
    )
    out: dict = {
        "ttd_s": None, "time_to_mitigate_s": None,
        "act_to_recover_s": None, "verified": False,
        "rolled_back": False, "sampling_promoted": False,
    }
    try:
        for step in range(WARM_STEPS):
            det.observe(_batch(rng, tz), step * DT_S)
        _set_fault(store, name, True)
        fault_steps = 0
        for k in range(MITIGATE_WINDOW_STEPS):
            t = (WARM_STEPS + k) * DT_S
            active = True if not heal else bool(
                store.evaluate(name, False)
            )
            if active:
                batch = _batch(rng, tz, mutate=mutate, step=fault_steps)
                fault_steps += 1
            else:
                batch = _batch(rng, tz)
            report = det.observe(batch, t)
            flags_np = _flags(report)
            flagged = [names[i] for i in np.nonzero(flags_np)[0]]
            if out["ttd_s"] is None and flags_np[fault_svc]:
                out["ttd_s"] = round((k + 1) * DT_S, 3)
            ctrl.observe(t, flagged, services=names)
            ctrl.drain(5.0)  # serialize actuator writes per batch
            if sampling_policy.get(names[fault_svc]) == 1.0:
                out["sampling_promoted"] = True
            samples = ctrl.take_ttm_samples()
            if samples:
                ttm, act_to_recover = samples[0]
                # TTM on the onset basis: fault ONSET→verified, like
                # ttd_s is onset→first flag (the controller's own
                # sample runs first-flag→verified; onset adds the TTD).
                out["time_to_mitigate_s"] = round(
                    ttm + (out["ttd_s"] or 0.0) - DT_S, 3
                )
                out["act_to_recover_s"] = round(act_to_recover, 3)
                out["verified"] = True
                break
            if ctrl.state_of(names[fault_svc]) == STATE_FAILED:
                out["rolled_back"] = True
                break
        ctrl.drain(5.0)
        st = ctrl.stats()
        out.update({
            "flag_writes": flagd.writes,
            "actions": st["actions"],
            "failed": st["failed"],
            "rollbacks": st["rollbacks"],
            # The revert/rollback contract: the flag's spec is back to
            # its pre-mitigation state (ENABLED — the doc the operator
            # owns), proven, not assumed.
            "flag_state_end": (store.flag_spec(name) or {}).get("state"),
            "sampling_policy_end": dict(sampling_policy),
        })
    finally:
        ctrl.close()
    return out


def measure_no_oscillation(seed: int = 1, device=None) -> dict:
    """Long clean run with remediation ENABLED and every scenario flag
    present: the pass condition is ZERO actuator writes (no flag ever
    flips on quiet traffic) — the bench's anti-flap gate."""
    rng = np.random.default_rng(seed)
    det = AnomalyDetector(_quality_config(), device=device)
    tz = SpanTensorizer(num_services=S, batch_size=B)
    names = [f"svc{i}" for i in range(S)]
    for n in names:
        tz.service_id(n)
    all_flags = list(qualbench.fault_shapes(rng))
    store = _scenario_store(all_flags)
    doc_before = store.snapshot()
    flagd = FlagdActuator(
        store=store,
        policy={names[i]: tuple(all_flags) for i in range(S)},
    )
    ctrl = RemediationController(
        [flagd], enabled=True, act_batches=ACT_BATCHES,
        clear_batches=CLEAR_BATCHES, budget=4, budget_refill_s=1e9,
        deadline_s=DEADLINE_S, rollback=True,
    )
    flagged_batches = 0
    try:
        for step in range(WARM_STEPS + QUIET_STEPS):
            t = step * DT_S
            report = det.observe(_batch(rng, tz), t)
            flags_np = _flags(report)
            if step >= WARM_STEPS and flags_np.any():
                flagged_batches += 1
            ctrl.observe(
                t, [names[i] for i in np.nonzero(flags_np)[0]],
                services=names,
            )
        ctrl.drain(5.0)
    finally:
        ctrl.close()
    return {
        "quiet_batches": QUIET_STEPS,
        "flagged_batches": flagged_batches,
        "flag_writes": flagd.writes,
        "doc_unchanged": store.snapshot() == doc_before,
        "ok": flagd.writes == 0 and store.snapshot() == doc_before,
    }


def measure_mitigation(seed: int = 0, device=None) -> dict:
    scenarios = {}
    ttm = {}
    for name in HEALING_SCENARIOS:
        res = run_scenario(name, heal=True, seed=seed, device=device)
        scenarios[name] = res
        ttm[name] = res["time_to_mitigate_s"]
    rollback = run_scenario(
        ROLLBACK_SCENARIO, heal=False, seed=seed,
        deadline_s=ROLLBACK_DEADLINE_S, device=device,
    )
    no_osc = measure_no_oscillation(seed=seed + 1, device=device)
    verified_n = sum(1 for r in scenarios.values() if r["verified"])
    return {
        "dt_s": DT_S,
        "act_batches": ACT_BATCHES,
        "clear_batches": CLEAR_BATCHES,
        "time_to_mitigate_s": ttm,
        "scenarios": scenarios,
        "rollback_drill": rollback,
        "no_oscillation": no_osc,
        "mitigation_ok": bool(
            verified_n >= 3
            and rollback["rolled_back"]
            and rollback["flag_state_end"] == "ENABLED"
            and no_osc["ok"]
        ),
    }


# -- the shadow leg ----------------------------------------------------

# The counterfactual drills run at the REPLAYBENCH geometry (S=8,
# B=256, dt=0.25 — the recorded-corpus protocol under test, not
# detection quality) with the paymentFailure-shaped flag gate.
PREFLIGHT_FLAG = "paymentFailure"
PREFLIGHT_WINDOW_STEPS = 160
PREFLIGHT_CLEAR_TAIL = 4


def _preflight_loop(
    preflight_wired: bool, refuse: bool = False, seed: int = 0, device=None,
) -> dict:
    """One closed loop at replaybench geometry: a REAL pipeline feeds
    a live detector AND records its span corpus (HistoryWriter), the
    fault is gated by a live flagd-schema flag, and — when wired — a
    ShadowVerifier replays the recorded window before every act.
    ``refuse=True`` models a mitigation mapped to the WRONG service:
    its counterfactual transform suppresses a healthy service, so the
    flagged service never clears in the shadow and the act is refused.
    ``preflight_wired=False`` is the ungated baseline the TTM gate
    compares against. The live pipeline and the shadow's share the
    device."""
    rng = np.random.default_rng(seed)
    names = [f"svc{i}" for i in range(replaybench.S)]
    fault_name = names[replaybench.FAULT_SVC]
    out: dict = {
        "ttd_s": None, "time_to_mitigate_s": None, "verified": False,
        "preflight_verdict_s": None, "refused": 0, "released": 0,
        "refused_reason": None, "flag_writes": 0,
        "doc_unchanged": None, "tokens_refunded": None,
        "flight_refused_events": 0, "flight_refused_dumps": 0,
    }
    with tempfile.TemporaryDirectory(prefix="shadowbench-") as directory:
        live: dict = {}
        _det, pipe = shadow.build_shadow_pipeline(
            replaybench._replay_config(), replaybench.B, live, device=device
        )
        store_h = history.HistoryStore(
            directory, retention_s=(86400.0, 86400.0)
        )
        writer = history.HistoryWriter(
            store_h, snapshot_fn(pipe), rungs=(1.0, 60.0), capture_spans=True,
            span_queue_max=4 * (
                replaybench.WARM_STEPS + PREFLIGHT_WINDOW_STEPS
            ),
        )
        pipe.history_capture = writer.capture
        reader = history.HistoryReader(store_h, rungs=(1.0, 60.0))
        flag_store = _scenario_store([PREFLIGHT_FLAG])
        doc_before = flag_store.snapshot()
        wall0 = time.time()
        t_cur = [0.0]
        flight = FlightRecorder(dump_dir=directory)
        preflight_fn = None
        if preflight_wired:
            # The WRONG-mitigation drill suppresses a healthy service
            # in the counterfactual; the verdict still asks whether
            # the FLAGGED service clears.
            target = (
                (replaybench.FAULT_SVC + 1) % replaybench.S
                if refuse else replaybench.FAULT_SVC
            )
            verifier = shadow.ShadowVerifier(
                reader, replaybench._replay_config(),
                batch_size=replaybench.B, window_s=90.0,
                deadline_s=30.0, min_records=8,
                clear_tail=PREFLIGHT_CLEAR_TAIL, flight=flight,
                now_fn=lambda: wall0 + t_cur[0], device=device,
            )

            def preflight_fn(_svc):
                return verifier.verify(
                    replaybench.FAULT_SVC,
                    shadow.suppress_transform(target),
                )

        flagd = FlagdActuator(
            store=flag_store, policy={fault_name: (PREFLIGHT_FLAG,)}
        )
        ctrl = RemediationController(
            [flagd], enabled=True, act_batches=ACT_BATCHES,
            clear_batches=CLEAR_BATCHES, budget=2, budget_refill_s=1e9,
            deadline_s=DEADLINE_S, rollback=True, flight=flight,
            preflight=preflight_fn,
        )
        try:
            for step in range(
                replaybench.WARM_STEPS + PREFLIGHT_WINDOW_STEPS
            ):
                t = step * replaybench.DT_S
                t_cur[0] = t
                if step == replaybench.WARM_STEPS:
                    _set_fault(flag_store, PREFLIGHT_FLAG, True)
                    # The zero-mutation gate compares against the doc
                    # WITH the fault injected: only actuator writes
                    # may change it from here.
                    doc_before = flag_store.snapshot()
                faulted = step >= replaybench.WARM_STEPS and bool(
                    flag_store.evaluate(PREFLIGHT_FLAG, False)
                )
                pipe.submit_columns(
                    replaybench._make_cols(rng, step, faulted)
                )
                pipe.pump(t)
                pipe.drain()  # this batch's report, synchronously
                writer.tick(now=wall0 + t)
                flags = live.get(round(t, 6)) or ()
                flagged = [
                    names[i] for i, f in enumerate(flags) if f
                ]
                k = step - replaybench.WARM_STEPS
                if (
                    out["ttd_s"] is None and k >= 0
                    and replaybench.FAULT_SVC < len(flags)
                    and flags[replaybench.FAULT_SVC]
                ):
                    out["ttd_s"] = round((k + 1) * replaybench.DT_S, 3)
                ctrl.observe(t, flagged, services=names)
                # Serialize the worker (preflight replay + actuator
                # writes) inside this virtual batch, so TTM stays
                # comparable across gated and ungated runs.
                ctrl.drain(60.0)
                for verdict_s in ctrl.take_preflight_samples():
                    out["preflight_verdict_s"] = round(verdict_s, 4)
                samples = ctrl.take_ttm_samples()
                if samples:
                    ttm, _a2r = samples[0]
                    out["time_to_mitigate_s"] = round(
                        ttm + (out["ttd_s"] or 0.0) - replaybench.DT_S, 3
                    )
                    out["verified"] = True
                    break
                st = ctrl.stats()
                if refuse and st["preflight_verdicts"].get(
                    "refused", 0
                ) >= 2:
                    break  # two refusals prove the gate holds; stop
            ctrl.drain(60.0)
            st = ctrl.stats()
            out.update({
                "released": st["preflight_verdicts"].get("released", 0),
                "refused": st["preflight_verdicts"].get("refused", 0),
                "refused_reason": (
                    max(
                        st["preflight_refused"],
                        key=st["preflight_refused"].get,
                    )
                    if st["preflight_refused"] else None
                ),
                "flag_writes": flagd.writes,
                "doc_unchanged": flag_store.snapshot() == doc_before,
                "tokens_refunded": abs(ctrl.bucket.tokens - 2.0) < 1e-6,
                "flight_refused_events": flight.events_total.get(
                    "preflight_refused", 0
                ),
                "flight_refused_dumps": len(glob.glob(
                    os.path.join(directory, "flight-preflight-refused-*")
                )),
            })
        finally:
            ctrl.close()
            writer.close()
            pipe.close()
    return out


def measure_shadow_identity(seed: int = 0, rate_target: float = 10.0, device=None) -> dict:
    """Record an incident with replaybench's own recorder, replay it
    BOTH ways — ``replaybench.replay`` and a transform-less
    ``ShadowVerifier`` pass — and pin all three verdict maps equal
    (recording run, replaybench replay, shadow replay) at ≥ the rate
    target. One shared pipeline constructor makes drift structurally
    impossible; this gate proves it stays that way."""
    with tempfile.TemporaryDirectory(prefix="shadowident-") as directory:
        recorded = replaybench.record_incident(directory, seed=seed, device=device)
        replayed, _virtual, _wall, _batches = replaybench.replay(directory, device=device)
        store = history.HistoryStore(directory)
        reader = history.HistoryReader(store, rungs=(1.0, 60.0))
        recs = reader.span_records()
        now = recs[-1].t_end + 1.0
        verifier = shadow.ShadowVerifier(
            reader, replaybench._replay_config(),
            batch_size=replaybench.B,
            window_s=now - recs[0].t_start + 1.0,
            deadline_s=300.0, rate_target=rate_target, min_records=1,
            device=device,
        )
        v = verifier.verify(replaybench.FAULT_SVC, None, now=now)
    identical = v.verdicts == recorded == replayed
    return {
        "shadow_identical": bool(identical),
        "shadow_speedup": v.speedup,
        "shadow_batches": v.batches,
        "shadow_wall_s": v.wall_s,
        "shadow_would_help": v.would_help,  # no transform: still flagged
    }


def measure_collector(seed: int = 0) -> dict:
    """The collector-steering leg: push a tail-sampling policy for the
    flagged service, MEASURE the row-level keep fraction the policy
    implies on a replaybench-shaped stream (promoted service keeps
    every row, quiet services head-sample deterministically by trace
    key), then prove the exact-state revert (the policy file did not
    exist before the first hold → it is GONE after the last release)."""
    names = [f"svc{i}" for i in range(replaybench.S)]
    promoted = names[replaybench.FAULT_SVC]
    with tempfile.TemporaryDirectory(prefix="collbench-") as directory:
        path = os.path.join(directory, "tail-sampling-policy.json")
        col = CollectorActuator(
            policy_path=path, base_keep=0.1,
            exemplar_fn=lambda svc: ["00deadbeef"],
            services_fn=lambda: names,
        )
        token = col.apply(promoted)
        pushed = os.path.exists(path)
        implied = col.keep_ratio()
        policy_names = [
            p["name"] for p in col.render_policy()["processors"][
                "tail_sampling/anomaly"
            ]["policies"]
        ]
        # Row-level measurement: apply the pushed policy's semantics
        # to the recorded-shape stream (keep-all on the promoted
        # service, threshold-by-trace-key at base_keep elsewhere —
        # all spans of one trace land or drop together).
        rng = np.random.default_rng(seed)
        kept = total = 0
        for step in range(60):
            cols = replaybench._make_cols(rng, step, step >= 30)
            svc = np.asarray(cols.svc)
            key = np.asarray(cols.trace_key, dtype=np.uint64)
            u = (
                (key * np.uint64(0x9E3779B97F4A7C15))
                >> np.uint64(40)
            ).astype(np.float64) / float(1 << 24)
            keep = (svc == replaybench.FAULT_SVC) | (u < 0.1)
            kept += int(keep.sum())
            total += int(svc.size)
        measured = kept / max(total, 1)
        col.revert(promoted, token)
        revert_exact = not os.path.exists(path)
    return {
        "collector_keep_ratio": round(measured, 4),
        "collector_keep_ratio_policy": round(implied, 4),
        "collector_storage_reduction": round(1.0 - measured, 4),
        "collector_pushed": bool(pushed),
        "collector_policy_names": policy_names,
        "collector_revert_exact": bool(revert_exact),
    }


def measure_shadow(seed: int = 0, device=None) -> dict:
    """The ``--shadow`` block: both verdict directions live,
    bit-identity + speedup, and the collector keep/drop ratio."""
    rate_target = float(os.environ.get("ANOMALY_SHADOW_RATE") or 10.0)
    ident = measure_shadow_identity(seed=seed, rate_target=rate_target, device=device)
    baseline = _preflight_loop(False, seed=seed, device=device)
    released = _preflight_loop(True, refuse=False, seed=seed, device=device)
    refusal = _preflight_loop(True, refuse=True, seed=seed, device=device)
    base_ttm = baseline["time_to_mitigate_s"]
    gated_ttm = released["time_to_mitigate_s"]
    ttm_ratio = (
        round(gated_ttm / base_ttm, 3)
        if base_ttm and gated_ttm else None
    )
    refusal_ok = bool(
        refusal["refused"] >= 1
        and not refusal["verified"]
        and refusal["flag_writes"] == 0
        and refusal["doc_unchanged"]
        and refusal["tokens_refunded"]
        and refusal["flight_refused_events"] >= 1
        and refusal["flight_refused_dumps"] >= 1
    )
    released_ok = bool(
        released["verified"]
        and released["released"] >= 1
        and ttm_ratio is not None and ttm_ratio <= 2.0
    )
    return {
        **ident,
        "shadow_rate_target": rate_target,
        "preflight_baseline_ttm_s": base_ttm,
        "preflight_ttm_s": gated_ttm,
        "preflight_ttm_ratio": ttm_ratio,
        "preflight_verdict_s": released["preflight_verdict_s"],
        "preflight_released": released,
        "preflight_refusal": refusal,
        "preflight_refusal_ok": refusal_ok,
        **measure_collector(seed=seed),
        "shadow_ok": bool(
            ident["shadow_identical"]
            and ident["shadow_speedup"] >= rate_target
            and released_ok and refusal_ok
        ),
    }


def main() -> None:
    import json
    import sys

    shadow_only = "--shadow" in sys.argv[1:]
    out: dict = {}
    if not shadow_only:
        out.update(measure_mitigation())
    if shadow_only or int(os.environ.get("BENCH_SHADOW") or 1):
        out.update(measure_shadow())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
