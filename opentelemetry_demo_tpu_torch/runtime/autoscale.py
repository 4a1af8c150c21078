"""Saturation-driven fleet autoscaler: the elastic half of the fleet tier.

The detector already *emits* every signal an autoscaler needs — the
admission watermarks and shed counters, the brownout ladder
level, the spine overlap ratio — and the fleet's membership tier
already knows how to change the ring under guardrails. This module
closes the loop: a supervised, STRICTLY OPT-IN controller
(:class:`AutoscaleController`) that watches a per-window saturation
score and proposes **shard split** on sustained brownout and **shard
join** on sustained idle.

Guardrails are the remediation construction, reused verbatim:

- **Two-edge hysteresis**: a window at/above ``high_water`` extends
  the split streak, at/below ``low_water`` the join streak; the dead
  band between the edges resets BOTH. Proposals need ``act_batches``
  (split) / ``clear_batches`` (join) consecutive windows — one noisy
  window never resizes a production ring.
- **Token-bucket budget** (:class:`~.remediation.TokenBucket`,
  observed timebase): a flapping load shape exhausts the bucket and
  the ring FREEZES in its last shape — proposals refused and counted,
  never oscillation.
- **Role + epoch gating**: only a PRIMARY proposes, and every
  decision passes ``fence.check(path="autoscale")`` — the SIXTH
  fenced path (checkpoint, offsets, frame, history, remediation,
  autoscale): a resurrected stale primary's resize proposal is
  refused and counted, never applied.
- **Opt-in**: ``enabled=False`` (the default) is observe-only — the
  controller tracks streaks, exports metrics and flight-records what
  it WOULD have proposed, but never calls the propose hook.

Every applied decision is flight-recorded and evidence-dumped (the
last observation window rides along), so a 3am "why did the fleet
grow" has its answer on disk.

The controller itself never touches detector state, sockets or disk —
``propose`` is a caller-owned hook (the daemon exports the decision
for the deployment layer, where a resize is one ``FLEET_KNOBS`` change
end-to-end; the bench applies it to a live in-proc ring).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable

from .remediation import TokenBucket
from .replication import StaleEpochError

DECISION_SPLIT = "split"
DECISION_JOIN = "join"

# Bounded evidence ring: enough context to explain a decision, small
# enough to dump whole.
EVIDENCE_KEEP = 64


class AutoscaleController:
    """Guardrailed split/join proposer over a saturation-score stream.

    Drive it with :meth:`observe` once per observation window (the
    daemon's 1 s self-report cadence) and :meth:`tick` for budget
    housekeeping; read :meth:`stats` for the metric surface.

    ``signals``: name → value in [0, 1] (watermark fraction, shed
    activity, brownout level, ...). The window's saturation score is
    their max — any one saturated axis is saturation.

    ``shards_fn``: current live shard count (the proposal's base).
    ``propose``: applied-decision hook; only called when ``enabled``
    and every gate passed. Return False to report the proposal could
    not be applied (refunds the budget token).
    """

    def __init__(
        self,
        *,
        enabled: bool = False,
        act_batches: int = 5,
        clear_batches: int = 30,
        budget: int = 2,
        refill_s: float = 300.0,
        high_water: float = 0.75,
        low_water: float = 0.15,
        min_shards: int = 2,
        max_shards: int = 8,
        shards_fn: Callable[[], int] | None = None,
        role_fn: Callable[[], str] | None = None,
        fence=None,
        flight=None,
        propose: Callable[[dict], bool] | None = None,
    ):
        self.enabled = bool(enabled)
        self.act_batches = max(int(act_batches), 1)
        self.clear_batches = max(int(clear_batches), 1)
        self.high_water = float(high_water)
        self.low_water = float(low_water)
        self.min_shards = max(int(min_shards), 1)
        self.max_shards = max(int(max_shards), self.min_shards)
        self._shards_fn = shards_fn
        self._role_fn = role_fn
        self._fence = fence
        self._flight = flight
        self._propose = propose
        self.bucket = TokenBucket(budget, refill_s)
        self._lock = threading.Lock()
        self._hot = 0          # consecutive windows >= high_water
        self._idle = 0         # consecutive windows <= low_water
        self._score = 0.0
        self._target: int | None = None  # last proposed fleet size
        self._evidence: deque = deque(maxlen=EVIDENCE_KEEP)
        # One "observe_only"/"budget_exhausted" note per episode, not
        # per window (the remediation ep["noted"] discipline).
        self._noted: set[str] = set()
        self.counters = {
            "proposals_split": 0,
            "proposals_join": 0,
            "refused_disabled": 0,
            "refused_role": 0,
            "refused_fenced": 0,
            "refused_bounds": 0,
            "refused_budget": 0,
            "refused_apply": 0,
        }

    # -- hot path -------------------------------------------------------

    def observe(self, t_now: float, signals: dict[str, float]) -> float:
        """One observation window; returns the saturation score.

        Dict work under one lock, never I/O — the propose hook (and
        flight dump) run after the streak bookkeeping, still on the
        caller's thread: a decision is rare by construction (budget),
        so the pump pays for it only when the fleet actually resizes.
        """
        score = 0.0
        for v in signals.values():
            v = float(v)
            if v > score:
                score = min(v, 1.0)
        decision: dict | None = None
        with self._lock:
            self.bucket.advance(t_now)
            self._score = score
            self._evidence.append(
                {"t": t_now, "score": round(score, 4), **{
                    k: round(float(v), 4) for k, v in signals.items()
                }}
            )
            if score >= self.high_water:
                self._hot += 1
                self._idle = 0
            elif score <= self.low_water:
                self._idle += 1
                self._hot = 0
            else:
                # The dead band: a shape bouncing between the edges
                # resets BOTH streaks — freeze beats oscillation.
                self._hot = 0
                self._idle = 0
            if self._hot >= self.act_batches:
                decision = self._decide_locked(DECISION_SPLIT, t_now)
                self._hot = 0
            elif self._idle >= self.clear_batches:
                decision = self._decide_locked(DECISION_JOIN, t_now)
                self._idle = 0
        if decision is not None:
            self._apply(decision)
        return score

    def _decide_locked(self, action: str, t_now: float) -> dict | None:
        """Gate one would-be decision; returns the decision dict only
        when every guardrail passed (the remediation gate order:
        enabled → role → fence → bounds → budget)."""
        shards = self._current_shards()
        target = shards + 1 if action == DECISION_SPLIT else shards - 1
        base = {
            "action": action,
            "shards": shards,
            "target": target,
            "t": t_now,
            "score": self._score,
        }
        if not self.enabled:
            self.counters["refused_disabled"] += 1
            self._note("observe_only", base)
            return None
        if self._role_fn is not None and self._role_fn() != "primary":
            self.counters["refused_role"] += 1
            return None
        if self._fence is not None:
            try:
                self._fence.check(path="autoscale")
            except StaleEpochError:
                self.counters["refused_fenced"] += 1
                return None
        if not self.min_shards <= target <= self.max_shards:
            self.counters["refused_bounds"] += 1
            self._note(f"bounds_{action}", base)
            return None
        if not self.bucket.take():
            self.counters["refused_budget"] += 1
            self._note("budget_exhausted", base)
            return None
        self._noted.clear()  # a landed decision starts a new episode
        self._target = target
        base["evidence"] = list(self._evidence)
        return base

    def _note(self, key: str, decision: dict) -> None:
        """Flight-record a refusal ONCE per episode (not per window)."""
        if key in self._noted or self._flight is None:
            return
        self._noted.add(key)
        try:
            self._flight.record(
                "autoscale-refused", reason=key,
                action=decision["action"], shards=decision["shards"],
                target=decision["target"], score=decision["score"],
            )
        except Exception:  # noqa: BLE001 — evidence must not gate
            pass

    def _current_shards(self) -> int:
        if self._shards_fn is None:
            return self.min_shards
        try:
            return max(int(self._shards_fn()), 1)
        except Exception:  # noqa: BLE001 — a broken view proposes
            return self.min_shards  # nothing expansive

    def _apply(self, decision: dict) -> None:
        """Record + hand one gated decision to the propose hook."""
        self.counters[f"proposals_{decision['action']}"] += 1
        if self._flight is not None:
            try:
                self._flight.record(
                    "autoscale", action=decision["action"],
                    shards=decision["shards"],
                    target=decision["target"],
                    score=decision["score"],
                )
                self._flight.dump(
                    f"autoscale-{decision['action']}",
                    decision=decision,
                )
            except Exception:  # noqa: BLE001 — evidence must not gate
                pass
        if self._propose is None:
            return
        try:
            ok = self._propose(dict(decision))
        except Exception:  # noqa: BLE001 — a broken hook refunds
            ok = False
        if not ok:
            with self._lock:
                self.counters["refused_apply"] += 1
                self.bucket.tokens = min(
                    self.bucket.tokens + 1.0, float(self.bucket.capacity)
                )

    # -- housekeeping / surfaces ----------------------------------------

    def tick(self, t_now: float | None = None) -> None:
        with self._lock:
            self.bucket.advance(
                time.monotonic() if t_now is None else t_now
            )

    @property
    def frozen(self) -> bool:
        """True while the proposal budget is exhausted — the ring
        holds its last shape and decisions are refused (counted)."""
        return self.bucket.tokens < 1.0

    def stats(self) -> dict:
        with self._lock:
            return {
                **self.counters,
                "enabled": self.enabled,
                "score": self._score,
                "hot_streak": self._hot,
                "idle_streak": self._idle,
                "frozen": self.bucket.tokens < 1.0,
                "tokens": self.bucket.tokens,
                "target_shards": self._target,
            }

    # Trivial lifecycle so the supervision tree can own the component
    # like every other leg (no thread of its own: observations ride
    # the daemon pump, decisions are synchronous records).
    def start(self) -> None:
        pass

    def alive(self) -> bool:
        return True

    def close(self) -> None:
        pass
