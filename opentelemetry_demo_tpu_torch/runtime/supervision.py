"""Component supervision: the sidecar outlives its own failures.

The reference drives every *shop-side* failure through flagd fault
flags, and the detector measures time-to-detect for all of them — but a
detector whose own ingest thread dies on a broker restart is blind in
exactly the incident it exists for. This module is the supervision tree
for the daemon's components (Kafka orders pump, OTLP receivers, report
harvester, checkpoint writer): each is registered with a restart hook
and/or a liveness probe, crashes trigger bounded exponential backoff
with jitter, and a restart budget detects crash loops.

Design rules:

- **Never give up.** A component that exhausts its restart budget is
  marked DEGRADED (gauge + per-component gRPC health NOT_SERVING), and
  retries continue at the max backoff — an always-on sidecar that stops
  retrying has turned a transient fault into a permanent outage.
- **No supervisor thread.** Restarts run on the daemon's pump thread
  via :meth:`tick` (called every step) and :meth:`run_step` (guarded
  inline calls). A supervisor with its own thread would itself need
  supervising.
- **Health is observable.** State surfaces three ways: Prometheus
  (``anomaly_component_restarts_total{component=...}``,
  ``anomaly_component_up{component=...}``, ``anomaly_degraded``), the
  gRPC health service (service name ``anomaly.component.<name>`` —
  probe with ``runtime.health_probe --component <name>``), and logs.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from typing import Callable

from .grpc_health import NOT_SERVING, SERVING

log = logging.getLogger(__name__)

# Component states.
UP = "up"
BACKOFF = "backoff"  # crashed; a restart attempt is scheduled
DEGRADED = "degraded"  # crash loop: restart budget exhausted in-window
# Daemon-level state (not a per-component one): the pipeline is
# deliberately shedding/throttling under overload. Distinct from
# DEGRADED — nothing is crashing, the runtime is executing its overload
# plan — and ORDERED below it: a crash loop is always the worse news,
# so overall_state() reports DEGRADED even while also saturated.
SATURATED = "saturated"

# gRPC health service-name prefix for per-component status.
HEALTH_PREFIX = "anomaly.component."


class _Component:
    __slots__ = (
        "name", "restart", "probe", "probe_interval_s", "base_backoff_s",
        "max_backoff_s", "restart_budget", "budget_window_s",
        "consecutive_failures", "crash_times", "next_attempt_at",
        "next_probe_at", "state", "restarts", "last_error",
    )

    def __init__(self, name, restart, probe, probe_interval_s,
                 base_backoff_s, max_backoff_s, restart_budget,
                 budget_window_s, now):
        self.name = name
        self.restart = restart
        self.probe = probe
        self.probe_interval_s = probe_interval_s
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self.restart_budget = restart_budget
        self.budget_window_s = budget_window_s
        self.consecutive_failures = 0
        self.crash_times: deque = deque()
        self.next_attempt_at = 0.0
        # First probe one interval out: the component just booted and a
        # probe raced against its own startup would count a false crash.
        self.next_probe_at = now + probe_interval_s
        self.state = UP
        self.restarts = 0
        self.last_error: str | None = None


class Supervisor:
    """Registry of supervised components with backoff'd restarts.

    ``registry`` is a :class:`telemetry.metrics.MetricRegistry` (or
    None); ``time_fn``/``rng`` are injectable for tests so backoff and
    budget windows run on a virtual clock.
    """

    def __init__(self, registry=None, time_fn: Callable[[], float] = time.monotonic,
                 rng: random.Random | None = None):
        self._registry = registry
        self._time = time_fn
        self._rng = rng or random.Random(0xC0FFEE)
        self._components: dict[str, _Component] = {}
        self._lock = threading.RLock()
        self._saturation_probe: Callable[[], bool] | None = None
        self._last_saturated: bool | None = None
        self._role_probe: Callable[[], tuple[str, int]] | None = None
        self._last_role: tuple[str, int] | None = None
        self._roles_seen: set[str] = set()

    # -- registration ---------------------------------------------------

    def register(
        self,
        name: str,
        restart: Callable[[], None] | None = None,
        probe: Callable[[], bool] | None = None,
        probe_interval_s: float = 0.0,
        base_backoff_s: float = 0.5,
        max_backoff_s: float = 30.0,
        restart_budget: int = 5,
        budget_window_s: float = 60.0,
    ) -> None:
        """Register a component.

        ``restart()`` re-creates/starts the component (may raise — that
        counts as another crash). ``probe()`` returns True while the
        component is healthy; probed from :meth:`tick` every
        ``probe_interval_s``. Components driven through
        :meth:`run_step` need neither — the guarded call itself is the
        probe. More than ``restart_budget`` crashes inside
        ``budget_window_s`` is a crash loop → DEGRADED.
        """
        with self._lock:
            self._components[name] = _Component(
                name, restart, probe, probe_interval_s, base_backoff_s,
                max_backoff_s, restart_budget, budget_window_s, self._time(),
            )

    def registered(self, name: str) -> bool:
        """True if ``name`` is already registered.

        Re-registering would mint a fresh crash/backoff budget, so
        callers whose start path can run more than once (promotion,
        restart-after-failure) gate on this to stay idempotent."""
        with self._lock:
            return name in self._components
        self._export(self._components[name])

    # -- crash accounting ----------------------------------------------

    def _crashed(self, c: _Component, err: BaseException | str) -> None:
        now = self._time()
        c.consecutive_failures += 1
        c.restarts += 1
        c.last_error = f"{type(err).__name__}: {err}" if isinstance(
            err, BaseException) else str(err)
        c.crash_times.append(now)
        while c.crash_times and now - c.crash_times[0] > c.budget_window_s:
            c.crash_times.popleft()
        in_loop = len(c.crash_times) > c.restart_budget
        # Bounded exponential backoff with full jitter in [0.5x, 1.5x):
        # synchronized thundering-herd reconnects are exactly what a
        # recovering broker does not need. A crash-looping component is
        # pinned at max backoff.
        base = c.max_backoff_s if in_loop else min(
            c.base_backoff_s * (2.0 ** (c.consecutive_failures - 1)),
            c.max_backoff_s,
        )
        c.next_attempt_at = now + base * (0.5 + self._rng.random())
        prev = c.state
        c.state = DEGRADED if in_loop else BACKOFF
        if c.state == DEGRADED and prev != DEGRADED:
            log.error(
                "component %s entered crash loop (%d crashes in %.0fs): %s",
                c.name, len(c.crash_times), c.budget_window_s, c.last_error,
            )
        else:
            log.warning(
                "component %s crashed (%s); restart #%d in %.2fs",
                c.name, c.last_error, c.restarts,
                c.next_attempt_at - now,
            )
        if self._registry is not None:
            from ..telemetry import metrics as tm

            self._registry.counter_add(
                tm.ANOMALY_COMPONENT_RESTARTS, 1.0, component=c.name
            )
        self._export(c)

    def _recovered(self, c: _Component) -> None:
        if c.state == UP and c.consecutive_failures == 0:
            return
        if c.state != UP:
            log.info("component %s recovered after %d restarts",
                     c.name, c.consecutive_failures)
        c.consecutive_failures = 0
        c.state = UP
        self._export(c)

    def _export(self, c: _Component) -> None:
        if self._registry is None:
            return
        from ..telemetry import metrics as tm

        self._registry.gauge_set(
            tm.ANOMALY_COMPONENT_UP, 1.0 if c.state == UP else 0.0,
            component=c.name,
        )
        self._registry.gauge_set(
            tm.ANOMALY_DEGRADED,
            1.0 if any(x.state == DEGRADED for x in self._components.values())
            else 0.0,
        )

    # -- driving --------------------------------------------------------

    def run_step(self, name: str, fn: Callable, *args, **kwargs):
        """Guarded inline call: ``fn(*args)`` with crashes quarantined.

        Returns ``fn``'s result; returns None (without calling) while
        the component sits in its backoff window, and None when the call
        raises (the exception is recorded, never propagated — one bad
        poll must not kill the pump loop).
        """
        with self._lock:
            c = self._components[name]
            if c.state != UP and self._time() < c.next_attempt_at:
                return None
        try:
            out = fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — quarantine IS the point
            with self._lock:
                self._crashed(c, e)
            return None
        with self._lock:
            self._recovered(c)
        return out

    def report_crash(self, name: str, err: BaseException | str) -> None:
        """External crash report (e.g. a receiver thread's last words)."""
        with self._lock:
            self._crashed(self._components[name], err)

    def tick(self, now: float | None = None) -> None:
        """One supervision pass: restart due components, run due probes.

        Called from the daemon's pump loop — cheap when nothing is
        wrong (a dict scan and a few clock reads).
        """
        now = self._time() if now is None else now
        if self._registry is not None and self._saturation_probe is not None:
            sat = self.saturated()
            if sat != self._last_saturated:  # edge-triggered gauge write
                self._last_saturated = sat
                from ..telemetry import metrics as tm

                self._registry.gauge_set(
                    tm.ANOMALY_SATURATED, 1.0 if sat else 0.0
                )
        if self._registry is not None and self._role_probe is not None:
            role_epoch = self.role()
            if role_epoch is not None and role_epoch != self._last_role:
                # Edge-triggered like saturation: role flips are rare
                # (failover), scrapes are not.
                self._last_role = role_epoch
                role, epoch = role_epoch
                self._roles_seen.add(role)
                from ..telemetry import metrics as tm

                for seen in self._roles_seen:
                    self._registry.gauge_set(
                        tm.ANOMALY_ROLE, 1.0 if seen == role else 0.0,
                        role=seen,
                    )
                self._registry.gauge_set(tm.ANOMALY_EPOCH, float(epoch))
        with self._lock:
            comps = list(self._components.values())
        for c in comps:
            with self._lock:
                due_restart = (
                    c.state != UP and c.restart is not None
                    and now >= c.next_attempt_at
                )
            if due_restart:
                try:
                    c.restart()
                except Exception as e:  # noqa: BLE001 — failed restart = crash
                    with self._lock:
                        self._crashed(c, e)
                    continue
                with self._lock:
                    self._recovered(c)
                    c.next_probe_at = now + c.probe_interval_s
                continue
            if c.probe is not None and c.state == UP and now >= c.next_probe_at:
                c.next_probe_at = now + c.probe_interval_s
                try:
                    ok = bool(c.probe())
                except Exception:  # noqa: BLE001 — a raising probe = down
                    ok = False
                if not ok:
                    with self._lock:
                        self._crashed(c, "probe failed")
                else:
                    with self._lock:
                        self._recovered(c)

    # -- saturation (overload, not crashes) -----------------------------

    def set_saturation_probe(self, probe: Callable[[], bool]) -> None:
        """Register the overload signal (``pipeline.saturated``): the
        supervisor doesn't own backpressure, it REPORTS it — on
        ``overall_state()``, the /healthz surface, and the
        ``anomaly_saturated`` gauge exported from :meth:`tick`."""
        self._saturation_probe = probe

    def saturated(self) -> bool:
        if self._saturation_probe is None:
            return False
        try:
            return bool(self._saturation_probe())
        except Exception:  # noqa: BLE001 — a broken probe must not kill tick
            return False

    # -- replication role (failover, not crashes) -----------------------

    def set_role_probe(self, probe: Callable[[], tuple[str, int]]) -> None:
        """Register the replication-role signal (``(role, epoch)`` from
        the daemon's state machine — runtime.replication role
        constants). Like saturation, the supervisor doesn't own
        failover, it REPORTS it: ``anomaly_role{role=...}`` /
        ``anomaly_epoch`` from :meth:`tick`, and ``role()`` for the
        /healthz surface. A promotion (the standby watchdog firing) is
        driven by the daemon's supervised pump step, so the promotion
        path inherits the same crash quarantine every component gets."""
        self._role_probe = probe

    def role(self) -> tuple[str, int] | None:
        """Current ``(role, epoch)``, or None when replication is off
        (single-process deployments never see the role family)."""
        if self._role_probe is None:
            return None
        try:
            role, epoch = self._role_probe()
            return str(role), int(epoch)
        except Exception:  # noqa: BLE001 — a broken probe must not kill tick
            return None

    def overall_state(self) -> str:
        """One word for the whole daemon: DEGRADED beats SATURATED
        beats UP (a crash loop is strictly worse news than deliberate
        load shedding — see the state constants)."""
        if self.degraded():
            return DEGRADED
        if self.saturated():
            return SATURATED
        return UP

    # -- introspection --------------------------------------------------

    def state(self, name: str) -> str:
        return self._components[name].state

    def states(self) -> dict[str, str]:
        with self._lock:
            return {n: c.state for n, c in self._components.items()}

    def restarts(self, name: str) -> int:
        return self._components[name].restarts

    def degraded(self) -> bool:
        with self._lock:
            return any(c.state == DEGRADED for c in self._components.values())

    def health_status(self, service: str) -> int | None:
        """grpc.health.v1 hook: SERVING/NOT_SERVING for
        ``anomaly.component.<name>`` service names, None for others
        (the health service then falls back to its known-set rules)."""
        if not service.startswith(HEALTH_PREFIX):
            return None
        c = self._components.get(service[len(HEALTH_PREFIX):])
        if c is None:
            return None
        return SERVING if c.state == UP else NOT_SERVING
