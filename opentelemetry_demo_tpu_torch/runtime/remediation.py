"""Closed-loop auto-mitigation: the verified remediation controller.

The controller subscribes to the pipeline's per-service anomaly verdicts
(the flag reports the query plane serves) and drives actuators behind
one interface, through the system's two control seams: every shop
service evaluates its fault flags live from the flagd store
(``utils.flags``), and the span stream is sampled by policy.

- :class:`FlagdActuator` — flips per-scenario mitigation flags through
  the flag store's one atomic write primitive (``flags.atomic_write_doc``;
  remote mode posts to the flag editor's ``/api/*`` surface with bounded
  timeouts). Mitigation = set the fault flag's ``state`` to ``DISABLED``
  (every service evaluates fault flags with a falsy default, so a
  disabled flag IS the healthy path); revert restores the exact prior
  state/defaultVariant.
- :class:`SamplingActuator` — promotes a flagged service to keep-100%
  span capture (seeded with its flag-time exemplar trace ids) while
  quiet services keep the configured head-sampling policy, publishing
  the merged policy through one callback (wired to
  ``HistoryWriter.set_span_sample``).
- :class:`CollectorActuator` — steers a real collector: pushes a
  tail-sampling policy document (keep 100% of the flagged service,
  exemplar-seeded; head-sample quiet services at a base rate) to a
  policy file (atomic write + reloader sidecar) or an HTTP endpoint,
  with refcounted holds and exact-state revert.

When a counterfactual pre-flight verifier (``runtime.shadow``) is wired
via ``preflight=``, an act that passed every guardrail below is not
released at once: the episode parks in ``STATE_PREFLIGHT`` while the
worker replays the last minutes of recorded history with the proposed
mitigation applied — released to ACTIVE only if the shadow's heads
clear; refused otherwise (budget token refunded, flag streak reset,
``preflight_refused`` flight evidence + dump).

A control loop that can touch production flags must be unable to make
an outage worse. The guardrails:

- **Hysteresis** — N consecutive flagged batches to act, M consecutive
  clean batches to verify recovery and revert.
- **Token-bucket budget** — a flapping detector exhausts the bucket and
  the flags stay put in their last state; refill bounds the sustained
  actuation rate.
- **Role/epoch gating** — only the PRIMARY actuates; a standby observes
  episodes without writing; a fenced process's actuator writes are
  refused by ``fence.check(path="remediation")``.
- **Verified recovery** — after acting, the controller watches its own
  detection heads: M clean batches within the deadline = VERIFIED
  (time-to-mitigate recorded, actuation reverted); deadline expiry =
  automatic rollback plus a sticky ``MITIGATION_FAILED`` state and a
  flight evidence dump.
- **Hard fail-safety** — :meth:`RemediationController.observe` is the
  only hot-path entry and does dictionary work under one lock, never
  I/O. Actuator writes run on a dedicated worker thread with bounded
  per-write timeouts and capped jittered retry; the job queue is bounded
  (overflow = action dropped and counted, fail closed). A dead, slow or
  torn-writing flagd can cost queued actions, never an ingest stall.

A copy of the reference package's module with its imports switched to
this package; ``runtime.mitigbench`` measures it.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.request
from collections import deque
from typing import Callable, Iterable

from ..utils.flags import (
    FlagFileStore,
    atomic_write_doc,
    capped_jitter_backoff,
)
from .checkpoint import StaleEpochError

log = logging.getLogger(__name__)

# Episode states (per service). FAILED is the DEGRADED-analogue: the
# mitigation did not recover the system within the deadline; it was
# rolled back (when enabled) and the service is sticky-failed until a
# full clean streak passes. PREFLIGHT sits between PENDING and ACTIVE
# when a counterfactual verifier (runtime.shadow) is wired: the budget
# token is already taken, the actuator writes are NOT yet enqueued,
# and the shadow replay's verdict decides release (→ ACTIVE) or
# refusal (→ back to PENDING, token refunded, flight evidence).
STATE_IDLE = "idle"
STATE_PENDING = "pending"
STATE_PREFLIGHT = "preflight"
STATE_ACTIVE = "active"
STATE_FAILED = "mitigation_failed"

# Per-scenario mitigation map: detector service name → the flagd fault
# flags whose evaluating code paths that service owns. Disabling the
# flag disables the faulty path (cache, flood, GC pressure, …) because
# every service evaluates these with a falsy default — the reference's
# own mitigation seam. Deployments with different service names pass
# their own map; mitigbench builds one per scenario.
DEFAULT_FLAG_POLICY: dict[str, tuple[str, ...]] = {
    "payment": ("paymentFailure", "paymentUnreachable"),
    "cart": ("cartFailure",),
    "product-catalog": ("productCatalogFailure",),
    "ad": ("adFailure", "adHighCpu", "adManualGc"),
    "recommendation": ("recommendationCacheFailure",),
    "frontend": ("imageSlowLoad", "loadGeneratorFloodHomepage"),
    "checkout": ("kafkaQueueProblems",),
    "fraud-detection": ("kafkaQueueProblems",),
}

# Time-to-mitigate histogram ladder (seconds): TTD sits at 0.25–1.75 s,
# actuation + recovery verification adds hysteresis batches, so the
# interesting band runs ~1 s to ~2 min.
TTM_BUCKETS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 30.0, 60.0, 120.0)


class ActuationError(RuntimeError):
    """An actuator write failed after its transport retries."""


class FlagdActuator:
    """Mitigation-flag actuator over the flagd control seam.

    Two write paths, one policy: a local store (``FlagFileStore`` →
    ``atomic_write_doc`` on the shared file every service hot-reloads;
    plain ``FlagEvaluator`` → in-memory ``replace``) or a remote flag
    editor (``url`` mode: GET ``/api/read-file``, POST
    ``/api/write-to-file`` with bounded timeouts — the flagd-ui write
    surface the gateway mounts at ``/feature``). ``apply`` returns a
    revert token holding each touched flag's exact prior
    ``state``/``defaultVariant``; ``revert``/rollback restores it.
    """

    name = "flagd"

    def __init__(
        self,
        store=None,
        url: str = "",
        policy: dict[str, tuple[str, ...]] | None = None,
        timeout_s: float = 1.0,
    ):
        if store is None and not url:
            raise ValueError("FlagdActuator needs a store or a url")
        self.store = store
        self.url = url.rstrip("/") if url else ""
        self.policy = dict(policy if policy is not None else DEFAULT_FLAG_POLICY)
        self.timeout_s = float(timeout_s)
        self.writes = 0
        # Per-flag holds (refcounted): two services can map the same
        # fault flag (checkout and fraud-detection both own
        # kafkaQueueProblems), and the FIRST verified recovery must
        # not re-enable a flag another service's episode still relies
        # on — the flag re-enables only when the LAST hold releases,
        # restoring the prior recorded at first disable. Guarded by a
        # lock although the single worker thread is the only caller
        # today (the refcount must not silently break if a second
        # worker ever appears).
        self._holds_lock = threading.Lock()
        self._holds: dict[str, dict] = {}  # flag → {count, prior}

    # -- doc IO (each call bounded; retries live in the worker) --------

    def _read_doc(self) -> dict:
        if self.url:
            with urllib.request.urlopen(
                f"{self.url}/api/read-file", timeout=self.timeout_s
            ) as resp:
                return json.load(resp)
        return self.store.snapshot()

    def _write_doc(self, doc: dict) -> None:
        self.writes += 1
        if self.url:
            body = json.dumps({"data": doc}).encode()
            req = urllib.request.Request(
                f"{self.url}/api/write-to-file", data=body,
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                return
        if isinstance(self.store, FlagFileStore):
            atomic_write_doc(self.store.path, doc)
            self.store._maybe_reload(force=True)
        else:
            self.store.replace(doc)

    # -- actuation -----------------------------------------------------

    def apply(self, service: str):
        """Disable the service's fault flags; returns the revert token
        (the tuple of flag keys this service now HOLDS) or None when
        nothing was actuated (no mapped flags in the doc, or every
        mapped flag was operator-disabled already). A flag another
        episode already holds is joined (refcount++), not rewritten."""
        keys = self.policy.get(service, ())
        if not keys:
            return None
        doc = self._read_doc()
        flags = doc.get("flags", {})
        held: list[str] = []
        changed = False
        with self._holds_lock:
            for key in keys:
                spec = flags.get(key)
                if not isinstance(spec, dict):
                    continue
                hold = self._holds.get(key)
                if hold is not None:
                    # Another service's episode already disabled this
                    # flag: join the hold, write nothing.
                    hold["count"] += 1
                    held.append(key)
                    continue
                if str(spec.get("state", "ENABLED")).upper() == "DISABLED":
                    continue  # operator-disabled: not ours to manage
                self._holds[key] = {
                    "count": 1,
                    "prior": {
                        "state": spec.get("state", "ENABLED"),
                        "defaultVariant": spec.get("defaultVariant"),
                    },
                }
                spec["state"] = "DISABLED"
                held.append(key)
                changed = True
        if changed:
            try:
                self._write_doc(doc)
            except BaseException:
                # The write never landed: release the holds this call
                # minted so the worker's retry re-takes them cleanly.
                with self._holds_lock:
                    for key in held:
                        hold = self._holds.get(key)
                        if hold is None:
                            continue
                        hold["count"] -= 1
                        if hold["count"] <= 0:
                            del self._holds[key]
                raise
        return tuple(held) or None

    def revert(self, service: str, token) -> None:
        """Release this service's holds; each flag restores to its
        recorded prior state when (and only when) its LAST hold
        releases (rollback and verified-recovery revert share this)."""
        if not token:
            return
        with self._holds_lock:
            restore: dict[str, dict] = {}
            decremented: list[str] = []
            for key in token:
                hold = self._holds.get(key)
                if hold is None:
                    continue
                hold["count"] -= 1
                decremented.append(key)
                if hold["count"] <= 0:
                    restore[key] = hold["prior"]
        if not restore:
            return
        try:
            doc = self._read_doc()
            flags = doc.get("flags", {})
            changed = False
            for key, prior in restore.items():
                spec = flags.get(key)
                if not isinstance(spec, dict):
                    continue  # flag deleted since: nothing to restore
                spec["state"] = prior["state"]
                if prior["defaultVariant"] is not None:
                    spec["defaultVariant"] = prior["defaultVariant"]
                changed = True
            if changed:
                self._write_doc(doc)
            with self._holds_lock:
                for key in restore:
                    self._holds.pop(key, None)
        except BaseException:
            # The restore never landed: re-take the decrements so the
            # worker's retry releases them again (idempotent retry).
            with self._holds_lock:
                for key in decremented:
                    hold = self._holds.get(key)
                    if hold is not None:
                        hold["count"] += 1
            raise


class SamplingActuator:
    """Exemplar-guided sampling-policy actuator.

    Keeps the set of promoted (keep-100%) services and publishes the
    merged per-service policy — base head-sampling rates from
    ``ANOMALY_HISTORY_SPANS`` with every promoted service raised to
    1.0 — through one ``publish(policy, seeds)`` callback (the daemon
    wires it to the history writer's span-capture sampler; the same
    shape a collector tail-sampling push would take). ``seeds`` carries
    each promoted service's flag-time exemplar trace ids — the
    replay-corpus anchor linking the recorded drill to Jaeger traces.
    """

    name = "sampling"

    def __init__(
        self,
        publish: Callable[[dict[str, float], dict[str, list]], None],
        base_policy: dict[str, float] | None = None,
        exemplar_fn: Callable[[str], list] | None = None,
    ):
        self._publish = publish
        self.base_policy = dict(base_policy or {})
        self._exemplar_fn = exemplar_fn
        self._promoted: dict[str, list] = {}
        self._lock = threading.Lock()
        self.publishes = 0

    def policy(self) -> dict[str, float]:
        with self._lock:
            merged = dict(self.base_policy)
            for svc in self._promoted:
                merged[svc] = 1.0
            return merged

    def _push(self) -> None:
        with self._lock:
            merged = dict(self.base_policy)
            seeds = {}
            for svc, ex in self._promoted.items():
                merged[svc] = 1.0
                seeds[svc] = list(ex)
            self.publishes += 1
        self._publish(merged, seeds)

    def apply(self, service: str):
        exemplars = []
        if self._exemplar_fn is not None:
            try:
                exemplars = list(self._exemplar_fn(service) or [])
            except Exception:  # noqa: BLE001 — exemplar seeds are
                # best-effort garnish; a raced ring read must not fail
                # the sampling promotion itself.
                exemplars = []
        with self._lock:
            self._promoted[service] = exemplars
        self._push()
        return True

    def revert(self, service: str, token) -> None:
        with self._lock:
            self._promoted.pop(service, None)
        self._push()


_PRIOR_ABSENT = object()  # CollectorActuator: "no policy file existed"


class CollectorActuator:
    """Tail-sampling steering for a REAL collector —
    the sampling seam driven by the detector.

    When a service flags, this actuator renders a tail-sampling policy
    document that keeps 100% of the flagged service's traces
    (``string_attribute(service.name)`` ∧ ``always_sample``, seeded
    with its flag-time exemplar trace ids) while every quiet service
    head-samples at ``base_keep`` (probabilistic) — the
    ``deploy/otelcol-config-anomaly.yml`` tail-sampling block's shape,
    so an `otelcol` config reloader can merge it verbatim. Two
    transports, same policy: ``policy_path`` writes the rendered JSON
    through the flag plane's ONE atomic write primitive
    (``atomic_write_doc``; a file watcher/reloader sidecar
    picks it up), or ``url`` POSTs it with a bounded timeout (a torn
    or dead endpoint raises → the worker's capped jittered retry).

    Guardrails match :class:`FlagdActuator`: per-service refcounted
    holds (two episodes on one service join, not rewrite), exact-state
    revert (the pre-actuation file content — or its ABSENCE — is
    recorded at first hold and restored when the LAST hold releases),
    and every write runs behind the controller's epoch fence + token
    budget. ``keep_ratio()`` reports the policy-implied storage
    fraction (promoted·1.0 + quiet·base_keep over all services) — the
    ``anomaly_collector_keep_ratio`` gauge; mitigbench measures the
    row-level ratio on real replayed traffic beside it.
    """

    name = "collector"

    def __init__(
        self,
        policy_path: str = "",
        url: str = "",
        base_keep: float = 0.1,
        exemplar_fn: Callable[[str], list] | None = None,
        services_fn: Callable[[], list] | None = None,
        timeout_s: float = 1.0,
    ):
        if not policy_path and not url:
            raise ValueError(
                "CollectorActuator needs a policy_path or a url"
            )
        self.policy_path = policy_path
        self.url = url.rstrip("/") if url else ""
        self.base_keep = min(max(float(base_keep), 0.0), 1.0)
        self._exemplar_fn = exemplar_fn
        self._services_fn = services_fn
        self.timeout_s = float(timeout_s)
        self.writes = 0
        self._holds_lock = threading.Lock()
        self._holds: dict[str, dict] = {}  # svc → {count, exemplars}
        self._prior = _PRIOR_ABSENT  # captured at FIRST hold only

    # -- policy rendering ----------------------------------------------

    def render_policy(self) -> dict:
        """The merged policy doc for the CURRENT hold set (JSON — a
        strict YAML subset, so collector config tooling reads it
        as-is): one and(service-match, always_sample) tail policy per
        promoted service, one probabilistic baseline for everyone
        else, plus the exemplar seeds under a vendor block."""
        with self._holds_lock:
            promoted = {
                svc: list(h["exemplars"]) for svc, h in self._holds.items()
            }
        policies = [
            {
                "name": f"anomaly-keep-{svc}",
                "type": "and",
                "and": {"and_sub_policy": [
                    {
                        "name": f"svc-{svc}",
                        "type": "string_attribute",
                        "string_attribute": {
                            "key": "service.name", "values": [svc],
                        },
                    },
                    {"name": "always", "type": "always_sample"},
                ]},
            }
            for svc in sorted(promoted)
        ]
        policies.append({
            "name": "anomaly-baseline-head",
            "type": "probabilistic",
            "probabilistic": {
                "sampling_percentage": round(self.base_keep * 100.0, 4),
            },
        })
        return {
            "processors": {
                "tail_sampling/anomaly": {
                    "decision_wait": "2s",
                    "policies": policies,
                },
            },
            "anomaly": {
                "promoted": sorted(promoted),
                "base_keep": self.base_keep,
                "exemplar_seeds": promoted,
            },
        }

    def _push(self, doc: dict) -> None:
        self.writes += 1
        if self.url:
            body = json.dumps(doc).encode()
            req = urllib.request.Request(
                f"{self.url}/api/sampling-policy", data=body,
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                return
        atomic_write_doc(self.policy_path, doc)

    def _capture_prior_locked(self) -> None:
        """Record the pre-actuation policy file EXACTLY (or its
        absence) at the first hold — the revert target. An existing
        file this actuator cannot parse is refused (raise → retry →
        counted): never steer a collector whose config can't be
        restored byte-for-byte-equivalent."""
        if self._holds or not self.policy_path:
            return
        try:
            with open(self.policy_path, "r") as f:
                self._prior = json.load(f)
        except FileNotFoundError:
            self._prior = _PRIOR_ABSENT
        except (OSError, ValueError) as e:
            raise ActuationError(
                f"collector policy at {self.policy_path} is not "
                f"restorable: {e}"
            )

    # -- actuation -----------------------------------------------------

    def apply(self, service: str):
        exemplars = []
        if self._exemplar_fn is not None:
            try:
                exemplars = list(self._exemplar_fn(service) or [])
            except Exception:  # noqa: BLE001 — best-effort garnish,
                # same contract as SamplingActuator.
                exemplars = []
        with self._holds_lock:
            self._capture_prior_locked()
            hold = self._holds.get(service)
            if hold is not None:
                hold["count"] += 1
                return service  # joined: policy already keeps 100%
            self._holds[service] = {"count": 1, "exemplars": exemplars}
        try:
            self._push(self.render_policy())
        except BaseException:
            # The push never landed: release the hold this call minted
            # so the worker's retry re-takes it cleanly.
            with self._holds_lock:
                hold = self._holds.get(service)
                if hold is not None:
                    hold["count"] -= 1
                    if hold["count"] <= 0:
                        del self._holds[service]
            raise
        return service

    def revert(self, service: str, token) -> None:
        if not token:
            return
        with self._holds_lock:
            hold = self._holds.get(service)
            if hold is None:
                return
            hold["count"] -= 1
            if hold["count"] > 0:
                return  # another episode still holds this service
            del self._holds[service]
            last = not self._holds
            prior = self._prior
        try:
            if not last:
                # Other services still promoted: re-render without
                # this one.
                self._push(self.render_policy())
            elif self.url:
                self._push({"reset": True})
            elif prior is _PRIOR_ABSENT:
                # Exact-state revert: the file did not exist before the
                # first hold, so the LAST release removes it.
                self.writes += 1
                try:
                    os.remove(self.policy_path)
                except FileNotFoundError:
                    pass
            else:
                self.writes += 1
                atomic_write_doc(self.policy_path, prior)
        except BaseException:
            # The restore never landed: re-take the hold so the
            # worker's retry releases it again (idempotent retry).
            with self._holds_lock:
                re = self._holds.setdefault(
                    service, {"count": 0, "exemplars": []}
                )
                re["count"] += 1
            raise
        if last:
            with self._holds_lock:
                if not self._holds:
                    self._prior = _PRIOR_ABSENT

    def keep_ratio(self) -> float:
        """Policy-implied storage fraction over the known service set
        (1.0 per promoted, ``base_keep`` per quiet) — what the current
        policy would keep of a uniform stream; the exported gauge."""
        services = list(self._services_fn() or []) if (
            self._services_fn is not None
        ) else []
        with self._holds_lock:
            promoted = set(self._holds)
        universe = set(services) | promoted
        if not universe:
            return self.base_keep
        kept = sum(
            1.0 if svc in promoted else self.base_keep for svc in universe
        )
        return kept / len(universe)


class TokenBucket:
    """Actuation budget: ``capacity`` burst, one token per
    ``refill_s`` observed-timebase seconds sustained."""

    def __init__(self, capacity: int, refill_s: float):
        self.capacity = max(int(capacity), 1)
        self.refill_s = float(refill_s)
        self.tokens = float(self.capacity)
        self._t: float | None = None

    def advance(self, t: float) -> None:
        if self._t is not None and t > self._t:
            self.tokens = min(
                self.tokens + (t - self._t) / self.refill_s,
                float(self.capacity),
            )
        if self._t is None or t > self._t:
            self._t = t

    def take(self) -> bool:
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class RemediationController:
    """The supervised control loop (module docstring for the contract).

    ``observe(t, flagged)`` is the hot-path entry (harvester/pump
    thread): per-service streak bookkeeping under one lock, never I/O.
    ``tick(t)`` (pump cadence) advances deadlines/budget when no
    reports arrive. Actuator writes run on the worker thread with
    fencing, bounded timeouts and capped jittered retry.
    """

    def __init__(
        self,
        actuators: Iterable,
        enabled: bool = False,
        act_batches: int = 3,
        clear_batches: int = 8,
        budget: int = 4,
        budget_refill_s: float = 60.0,
        deadline_s: float = 30.0,
        rollback: bool = True,
        role_fn: Callable[[], str] | None = None,
        fence=None,
        flight=None,
        queue_max: int = 64,
        retry_attempts: int = 4,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 1.0,
        preflight: Callable[[str], object] | None = None,
        bundle_fn: Callable[[str], str | None] | None = None,
    ):
        self.actuators = list(actuators)
        self.enabled = bool(enabled)
        self.act_batches = max(int(act_batches), 1)
        self.clear_batches = max(int(clear_batches), 1)
        self.deadline_s = float(deadline_s)
        self.rollback = bool(rollback)
        self._role_fn = role_fn
        self._fence = fence
        self._flight = flight
        # Counterfactual pre-flight gate (runtime.shadow): called with
        # the service name ON THE WORKER THREAD (it replays minutes of
        # recorded frames — never the hot path), returning an object
        # with ``would_help``/``reason`` (PreflightVerdict) or a bare
        # bool. None = no gate: act immediately.
        self._preflight = preflight
        # Provenance citation hook (runtime.provenance via the daemon):
        # newest evidence-bundle id for a service, stamped into the
        # act/pre-flight flight records so every mitigation names the
        # verdict it answers. None = records carry no citation.
        self._bundle_fn = bundle_fn
        self.bucket = TokenBucket(budget, budget_refill_s)
        self._retry_attempts = max(int(retry_attempts), 1)
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_cap_s = float(backoff_cap_s)

        self._lock = threading.Lock()
        self._episodes: dict[str, dict] = {}
        # Applied revert tokens, (service, actuator name) → token;
        # written by the worker, read by revert/rollback jobs.
        self._applied: dict[tuple[str, str], object] = {}
        self._jobs: deque = deque()
        self._queue_max = max(int(queue_max), 1)
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop_event = threading.Event()
        self._worker: threading.Thread | None = None
        self._closed = False

        # Counters (exported by the daemon as deltas).
        self.actions_total: dict[str, int] = {}      # by actuator
        self.rollbacks_total = 0
        self.verified_total = 0
        self.failed_total = 0
        self.refused_role = 0
        self.refused_fenced = 0
        self.budget_exhausted = 0
        self.actuator_errors = 0
        self.queue_dropped = 0
        self._ttm_samples: list[tuple[float, float]] = []  # (ttm, act→recover)
        # Pre-flight bookkeeping (daemon-exported as deltas):
        # verdicts by direction, refusals by reason, act→verdict
        # wall intervals.
        self.preflight_verdicts: dict[str, int] = {}
        self.preflight_refused: dict[str, int] = {}
        self._preflight_samples: list[float] = []
        self._t_now = 0.0  # last observed timebase (release stamps t_act)

    # -- hot path ------------------------------------------------------

    def observe(
        self, t_now: float, flagged: Iterable[str],
        services: Iterable[str] | None = None,
    ) -> None:
        """One flag report (hot path: dict work under the lock only).

        ``flagged`` is the report's per-service verdict list;
        ``services`` optionally names every service the report covered
        (defaults to flagged ∪ services with open episodes — enough,
        since a clean streak only matters once an episode exists).
        """
        flagged_set = set(flagged)
        with self._lock:
            self._t_now = t_now
            self.bucket.advance(t_now)
            universe = set(self._episodes) | flagged_set
            if services is not None:
                universe |= set(services)
            for svc in universe:
                ep = self._episodes.get(svc)
                if svc in flagged_set:
                    if ep is None:
                        ep = self._episodes[svc] = {
                            "state": STATE_IDLE, "flag_streak": 0,
                            "clean_streak": 0, "t_first_flag": t_now,
                            "t_act": None, "t_first_clean": None,
                            "noted": set(),
                        }
                    if ep["flag_streak"] == 0:
                        ep["t_first_flag"] = (
                            t_now if ep["state"] in (STATE_IDLE,)
                            else ep["t_first_flag"]
                        )
                    ep["flag_streak"] += 1
                    ep["clean_streak"] = 0
                    if ep["state"] == STATE_IDLE:
                        ep["state"] = STATE_PENDING
                    if (
                        ep["state"] == STATE_PENDING
                        and ep["flag_streak"] >= self.act_batches
                    ):
                        self._maybe_act_locked(svc, ep, t_now)
                elif ep is not None:
                    ep["flag_streak"] = 0
                    ep["clean_streak"] += 1
                    if ep["state"] == STATE_ACTIVE:
                        if ep["clean_streak"] == 1:
                            ep["t_first_clean"] = t_now
                        if ep["clean_streak"] >= self.clear_batches:
                            self._verify_locked(svc, ep, t_now)
                    elif ep["clean_streak"] >= self.clear_batches:
                        # PENDING that never acted, or sticky FAILED:
                        # a full clean streak closes the episode. A
                        # PREFLIGHT episode closing this way (the
                        # incident cleared on its own while the shadow
                        # replay ran) refunds the token the act
                        # decision took — the in-flight verdict finds
                        # the episode gone and is discarded.
                        if ep["state"] == STATE_PREFLIGHT:
                            self.bucket.tokens = min(
                                self.bucket.tokens + 1.0,
                                float(self.bucket.capacity),
                            )
                        del self._episodes[svc]
            expired = self._deadline_scan_locked(t_now)
        self._dump_expired(expired)
        self._wake.set()

    def tick(self, t_now: float) -> None:
        """Deadline/budget housekeeping when no reports arrive (pump
        cadence; observed timebase, same clock as observe)."""
        with self._lock:
            self._t_now = t_now
            self.bucket.advance(t_now)
            expired = self._deadline_scan_locked(t_now)
        self._dump_expired(expired)
        self._wake.set()

    # -- locked transitions --------------------------------------------

    def _record(self, kind_detail: dict) -> None:
        if self._flight is not None:
            self._flight.record("mitigation", **kind_detail)

    def _maybe_act_locked(self, svc: str, ep: dict, t_now: float) -> None:
        if not self.enabled:
            if "observe_only" not in ep["noted"]:
                ep["noted"].add("observe_only")
                self._record({
                    "op": "observe_only", "service": svc,
                    "streak": ep["flag_streak"],
                })
            return
        role = self._role_fn() if self._role_fn is not None else "primary"
        if role != "primary":
            if "refused_role" not in ep["noted"]:
                ep["noted"].add("refused_role")
                self.refused_role += 1
                self._record({
                    "op": "refused", "service": svc, "role": role,
                })
            return
        if not self.bucket.take():
            self.budget_exhausted += 1
            if "budget" not in ep["noted"]:
                ep["noted"].add("budget")
                self._record({
                    "op": "budget_exhausted", "service": svc,
                    "tokens": self.bucket.tokens,
                })
            return
        if (
            self._closed
            or len(self._jobs) + len(self.actuators) > self._queue_max
        ):
            # The worker queue cannot take every apply job (a wedged
            # actuator backed it up): do NOT act half-way — refund the
            # token, count the refusal, stay PENDING and retry on a
            # later batch. Counting an action whose write never even
            # enqueued would lie to the metrics AND to the episode
            # state machine (its deadline would later "roll back" a
            # no-op).
            self.bucket.tokens = min(
                self.bucket.tokens + 1.0, float(self.bucket.capacity)
            )
            self.queue_dropped += len(self.actuators)
            if "queue_full" not in ep["noted"]:
                ep["noted"].add("queue_full")
                self._record({
                    "op": "queue_full", "service": svc,
                    "depth": len(self._jobs),
                })
            return
        ep["noted"].discard("budget")
        # Evidence citation: stamp the episode with the newest bundle
        # id for this service ONCE, at escalation — the id every
        # downstream record (act, preflight park/refusal) carries.
        ep["bundle"] = self._cite(svc)
        if self._preflight is not None:
            # Counterfactual gate: hold the token, park the episode in
            # PREFLIGHT, and let the worker replay recorded history
            # with the proposed mitigation applied before ANY actuator
            # write is even enqueued. The wall stamp starts the
            # act→verdict interval (``anomaly_preflight_seconds``).
            ep["state"] = STATE_PREFLIGHT
            ep["t_act"] = None
            ep["w_preflight"] = time.monotonic()
            self._enqueue_locked(("preflight", None, svc))
            self._record({
                "op": "preflight", "service": svc, "t": t_now,
                "streak": ep["flag_streak"],
                "bundle": ep.get("bundle"),
            })
            return
        self._act_locked(svc, ep, t_now)

    def _cite(self, svc: str) -> str | None:
        """Newest evidence-bundle id for ``svc`` via the daemon hook
        (pipeline query lock only — cheap dict copy, no I/O; a hook
        failure costs the citation, never the episode)."""
        if self._bundle_fn is None:
            return None
        try:
            return self._bundle_fn(svc)
        except Exception:  # noqa: BLE001 — citation is best-effort
            return None

    def _act_locked(self, svc: str, ep: dict, t_now: float) -> None:
        """Release the act: enqueue every actuator's apply (directly
        from hysteresis when no pre-flight gate is wired; from the
        worker's released verdict otherwise)."""
        ep["state"] = STATE_ACTIVE
        ep["t_act"] = t_now
        ep["applied"] = 0       # actuator applies that LANDED
        ep["apply_failed"] = 0  # applies that exhausted their retries
        for act in self.actuators:
            # actions_total counts on worker SUCCESS (not here): an
            # apply that fails every retry must not mint a phantom
            # action for the dashboards/bench to report.
            self._enqueue_locked(("apply", act, svc))
        self._record({
            "op": "act", "service": svc, "t": t_now,
            "streak": ep["flag_streak"],
            "actuators": [a.name for a in self.actuators],
            "tokens_left": self.bucket.tokens,
            "bundle": ep.get("bundle"),
        })

    def _verify_locked(self, svc: str, ep: dict, t_now: float) -> None:
        ttm = float(ep["t_first_clean"] - ep["t_first_flag"])
        act_to_recover = float(ep["t_first_clean"] - (ep["t_act"] or t_now))
        self.verified_total += 1
        self._ttm_samples.append((ttm, act_to_recover))
        for act in self.actuators:
            self._enqueue_locked(("revert", act, svc))
        self._record({
            "op": "verified", "service": svc,
            "time_to_mitigate_s": round(ttm, 3),
            "act_to_recover_s": round(act_to_recover, 3),
            "clean_batches": ep["clean_streak"],
        })
        del self._episodes[svc]

    def _deadline_scan_locked(self, t_now: float) -> list[tuple[str, bool]]:
        """Expire missed-deadline episodes; returns the (service,
        rolled_back) list for the CALLER to dump evidence on — the
        dump is file I/O and must happen outside the controller lock
        (observe()'s no-I/O contract)."""
        expired: list[tuple[str, bool]] = []
        fenced = self._fence is not None and self._fence.stale()
        for svc, ep in list(self._episodes.items()):
            if ep["state"] != STATE_ACTIVE or ep["t_act"] is None:
                continue
            if t_now - ep["t_act"] <= self.deadline_s:
                continue
            # No verified recovery inside the deadline: the mitigation
            # did not work. Roll it back (unless configured sticky) and
            # park the service in the DEGRADED-style FAILED state.
            self.failed_total += 1
            ep["state"] = STATE_FAILED
            ep["clean_streak"] = 0
            rolling = self.rollback and not fenced
            if rolling:
                self.rollbacks_total += 1
                for act in self.actuators:
                    self._enqueue_locked(("revert", act, svc))
            op = "rollback" if self.rollback else "failed_sticky"
            if self.rollback and fenced:
                # A fenced daemon CANNOT restore the flag — every
                # actuator write is fence-refused, and pretending a
                # rollback happened would lie to the metrics. The
                # successor primary owns the store now (and will act
                # on its own verdicts if the incident persists); this
                # daemon records the refusal honestly.
                op = "rollback_refused_fenced"
            self._record({
                "op": op, "service": svc,
                "deadline_s": self.deadline_s,
                "acted_at": ep["t_act"], "t": t_now,
            })
            expired.append((svc, rolling))
        return expired

    def _dump_expired(self, expired: list[tuple[str, bool]]) -> None:
        """Evidence dumps for deadline expiries (outside the lock:
        FlightRecorder.dump writes a file, and a slow disk must stall
        neither observe() nor any thread waiting on the controller)."""
        if self._flight is None:
            return
        for svc, rolled_back in expired:
            self._flight.dump(
                "mitigation-failed", service=svc,
                rolled_back=rolled_back,
            )

    def _enqueue_locked(self, job: tuple) -> None:
        if self._closed:
            self.queue_dropped += 1
            return
        if len(self._jobs) >= self._queue_max:
            # Fail closed: the action is dropped and counted — a wedged
            # flagd must cost actions, never memory or the hot path.
            self.queue_dropped += 1
            return
        self._jobs.append(job)
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._work_loop, name="remediation-worker",
                daemon=True,
            )
            self._worker.start()

    # -- worker --------------------------------------------------------

    def _retry_delay(self, attempt: int) -> float:
        return capped_jitter_backoff(
            attempt, self._backoff_base_s, self._backoff_cap_s
        )

    def _work_loop(self) -> None:
        while True:
            self._wake.wait(timeout=0.2)
            self._wake.clear()
            while True:
                with self._lock:
                    if not self._jobs:
                        self._idle.set()
                        if self._closed:
                            return
                        break
                    self._idle.clear()
                    op, act, svc = self._jobs.popleft()
                self._run_job(op, act, svc)

    def _run_job(self, op: str, act, svc: str) -> None:
        for attempt in range(self._retry_attempts):
            try:
                if self._fence is not None:
                    # The fifth fenced write path: a superseded daemon
                    # must not touch production flags, not even to
                    # revert — the new primary owns the loop now.
                    self._fence.check(path="remediation")
                if op == "preflight":
                    # Past the fence check: a fenced daemon never even
                    # replays (the StaleEpochError branch below refunds
                    # and parks the episode). The verdict path handles
                    # its own failures fail-closed — no retry loop.
                    self._finish_preflight(svc)
                    return
                if op == "apply":
                    token = act.apply(svc)
                    with self._lock:
                        if token is not None:
                            self._applied[(svc, act.name)] = token
                        self.actions_total[act.name] = (
                            self.actions_total.get(act.name, 0) + 1
                        )
                        ep = self._episodes.get(svc)
                        if ep is not None and "applied" in ep:
                            ep["applied"] += 1
                else:
                    # Read WITHOUT popping: a transient revert failure
                    # must keep the token for the retry — popping
                    # first would turn the retry into a silent no-op
                    # and leave the mitigation in place forever.
                    with self._lock:
                        token = self._applied.get((svc, act.name))
                    act.revert(svc, token)
                    with self._lock:
                        self._applied.pop((svc, act.name), None)
                return
            except StaleEpochError:
                with self._lock:
                    self.refused_fenced += 1
                    if op == "preflight":
                        # The fenced daemon's act decision is void:
                        # refund the token and park the episode back
                        # in PENDING (the successor primary owns the
                        # loop — it will run its OWN pre-flight).
                        ep = self._episodes.get(svc)
                        if (
                            ep is not None
                            and ep.get("state") == STATE_PREFLIGHT
                        ):
                            self.bucket.tokens = min(
                                self.bucket.tokens + 1.0,
                                float(self.bucket.capacity),
                            )
                            ep["state"] = STATE_PENDING
                            ep["t_act"] = None
                self._record({
                    "op": "fenced", "service": svc,
                    "actuator": act.name if act is not None else "preflight",
                })
                return
            except Exception:  # noqa: BLE001 — actuator transport
                # faults (dead/slow/RST flagd, torn endpoint) are the
                # chaos this worker exists to absorb: capped jittered
                # retry, then count + log, never a dead worker thread.
                if attempt + 1 >= self._retry_attempts:
                    with self._lock:
                        self.actuator_errors += 1
                        if op == "apply":
                            ep = self._episodes.get(svc)
                            if (
                                ep is not None
                                and ep.get("state") == STATE_ACTIVE
                                and "apply_failed" in ep
                            ):
                                ep["apply_failed"] += 1
                                if (
                                    ep["apply_failed"]
                                    >= len(self.actuators)
                                    and ep.get("applied", 0) == 0
                                ):
                                    # EVERY actuator's apply died:
                                    # nothing was actuated. Refund
                                    # the budget token and fall back
                                    # to PENDING — no phantom action,
                                    # no phantom rollback later, and
                                    # the episode may retry acting on
                                    # a later flagged batch.
                                    self.bucket.tokens = min(
                                        self.bucket.tokens + 1.0,
                                        float(self.bucket.capacity),
                                    )
                                    ep["state"] = STATE_PENDING
                                    ep["t_act"] = None
                    self._record({
                        "op": "actuator_error", "service": svc,
                        "actuator": act.name, "job": op,
                        "attempts": attempt + 1,
                    })
                    log.exception(
                        "remediation %s via %s for %s failed after %d "
                        "attempts", op, act.name, svc, attempt + 1,
                    )
                    return
                if self._stop_event.wait(self._retry_delay(attempt)):
                    return  # closing: abandon the backoff sleep

    def _finish_preflight(self, svc: str) -> None:
        """Worker-side verdict: run the counterfactual replay (outside
        the controller lock — it decodes minutes of frames), then
        release the act or refuse it. Fail closed: a verifier that
        raised has proven nothing, so the act is refused."""
        with self._lock:
            ep = self._episodes.get(svc)
            if ep is None or ep.get("state") != STATE_PREFLIGHT:
                return  # episode closed while queued: token already refunded
            w0 = ep.get("w_preflight") or time.monotonic()
        try:
            verdict = self._preflight(svc)
        except Exception as e:  # noqa: BLE001 — any verifier fault
            # refuses the act; the evidence names the exception.
            verdict = None
            error = f"{type(e).__name__}: {e}"
        else:
            error = None
        verdict_s = time.monotonic() - w0
        would_help = bool(getattr(verdict, "would_help", verdict))
        reason = str(
            getattr(verdict, "reason", "cleared" if would_help else "refused")
        )
        if error is not None:
            reason = "error"
        detail = {
            k: getattr(verdict, k)
            for k in (
                "batches", "records", "corrupt", "virtual_s", "wall_s",
                "speedup", "flagged_tail", "clear_tail",
            )
            if hasattr(verdict, k)
        }
        refused_dump = False
        bundle = None
        with self._lock:
            ep = self._episodes.get(svc)
            stale = ep is None or ep.get("state") != STATE_PREFLIGHT
            if ep is not None:
                bundle = ep.get("bundle")
            if not stale:
                self._preflight_samples.append(verdict_s)
                if would_help:
                    self.preflight_verdicts["released"] = (
                        self.preflight_verdicts.get("released", 0) + 1
                    )
                    self._act_locked(svc, ep, self._t_now)
                else:
                    # Refusal: the mitigation would NOT have helped.
                    # Refund the token, reset the streak (a fresh
                    # act_batches run of flagged reports is needed
                    # before the next attempt), stay PENDING.
                    self.preflight_verdicts["refused"] = (
                        self.preflight_verdicts.get("refused", 0) + 1
                    )
                    self.preflight_refused[reason] = (
                        self.preflight_refused.get(reason, 0) + 1
                    )
                    self.bucket.tokens = min(
                        self.bucket.tokens + 1.0,
                        float(self.bucket.capacity),
                    )
                    ep["state"] = STATE_PENDING
                    ep["t_act"] = None
                    ep["flag_streak"] = 0
                    refused_dump = True
        if stale:
            return
        if would_help:
            self._record({
                "op": "preflight_released", "service": svc,
                "verdict_s": round(verdict_s, 4), **detail,
            })
            return
        # Evidence OUTSIDE the lock (dump writes a file).
        if self._flight is not None:
            self._flight.record(
                "preflight_refused", service=svc, reason=reason,
                verdict_s=round(verdict_s, 4), bundle=bundle,
                **({"error": error} if error else {}), **detail,
            )
        if refused_dump and self._flight is not None:
            # NB: ``reason`` is dump()'s positional parameter (the
            # file-name stem) — the verdict's reason rides as
            # ``refusal_reason`` context.
            self._flight.dump(
                "preflight-refused", service=svc, refusal_reason=reason,
                verdict_s=round(verdict_s, 4), bundle=bundle, **detail,
            )

    # -- surface -------------------------------------------------------

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Wait for the worker queue to empty (tests/bench only) —
        the BackgroundPoster.flush discipline: queue empty AND the
        worker idle, polled, so a just-enqueued job can't hide behind
        a stale idle flag."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            # One reading under the lock: the worker clears ``_idle`` under
            # it as it pops a job, so a job popped between two separate
            # readings (idle, then an empty queue) cannot pass for done.
            with self._lock:
                done = not self._jobs and (self._worker is None or self._idle.is_set())
            if done:
                return True
            self._wake.set()
            time.sleep(0.002)
        return False

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._jobs)

    def active_count(self) -> int:
        with self._lock:
            return sum(
                1 for ep in self._episodes.values()
                if ep["state"] in (STATE_ACTIVE, STATE_FAILED)
            )

    def state_of(self, service: str) -> str:
        with self._lock:
            ep = self._episodes.get(service)
            return ep["state"] if ep is not None else STATE_IDLE

    def failed_services(self) -> list[str]:
        with self._lock:
            return sorted(
                svc for svc, ep in self._episodes.items()
                if ep["state"] == STATE_FAILED
            )

    def take_ttm_samples(self) -> list[tuple[float, float]]:
        """Drain (ttm_s, act_to_recover_s) pairs accumulated since the
        last call — the daemon turns them into histogram observations."""
        with self._lock:
            samples, self._ttm_samples = self._ttm_samples, []
            return samples

    def take_preflight_samples(self) -> list[float]:
        """Drain act→verdict wall intervals accumulated since the last
        call (``anomaly_preflight_seconds`` observations)."""
        with self._lock:
            samples, self._preflight_samples = self._preflight_samples, []
            return samples

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "actions": dict(self.actions_total),
                "rollbacks": self.rollbacks_total,
                "verified": self.verified_total,
                "failed": self.failed_total,
                "refused_role": self.refused_role,
                "refused_fenced": self.refused_fenced,
                "budget_exhausted": self.budget_exhausted,
                "actuator_errors": self.actuator_errors,
                "queue_dropped": self.queue_dropped,
                "queue_depth": len(self._jobs),
                "preflight_verdicts": dict(self.preflight_verdicts),
                "preflight_refused": dict(self.preflight_refused),
                "tokens": round(self.bucket.tokens, 3),
                "active": sum(
                    1 for ep in self._episodes.values()
                    if ep["state"] in (STATE_ACTIVE, STATE_FAILED)
                ),
                "states": {
                    svc: ep["state"]
                    for svc, ep in self._episodes.items()
                },
            }

    def close(self) -> None:
        with self._lock:
            self._closed = True
            worker = self._worker
        self._stop_event.set()
        self._wake.set()
        if worker is not None:
            worker.join(timeout=3.0)
