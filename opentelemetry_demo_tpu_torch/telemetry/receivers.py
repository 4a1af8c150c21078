"""Pull receivers: httpcheck, store-stats, and per-service resource
stats (the redis + docker_stats receiver analogues).

The reference collector scrapes three more receiver families beyond
hostmetrics (the upstream demo's src/otel-collector/otelcol-config.yml):
``httpcheck`` probing the frontend-proxy (:15-17), ``redis`` reading
the cart store's server stats (:20-23), and ``docker_stats`` (:18-19)
reporting per-container cpu/memory/etc. Same capabilities here as
scrape-cadence pull receivers on a :class:`~.metrics.MetricRegistry`
(register via ``Collector.add_scrape_target(..., before=recv.scrape)``).
"""

from __future__ import annotations

import os
import threading
import time
import urllib.error
import urllib.request
from typing import Callable

from .hostmetrics import self_rss_bytes
from .metrics import MetricRegistry


class HttpCheckReceiver:
    """Probes HTTP endpoints; emits httpcheck.* metrics.

    ``targets`` maps a name to either a URL (real HTTP GET, used when
    the gateway serves on a socket) or a zero-arg callable returning an
    HTTP status int (in-proc probing on the virtual clock).

    URL targets are probed on a background thread and ``scrape()``
    publishes the last completed result: the scraper runs inside
    ``Shop.pump`` while the gateway holds its request lock, so a
    blocking GET against an unreachable target would stall every locked
    HTTP route for up to ``timeout_s`` per cycle. Callable targets stay
    synchronous (in-proc, no network).
    """

    def __init__(self, registry: MetricRegistry | None = None, timeout_s: float = 5.0):
        self.registry = registry or MetricRegistry()
        self.timeout_s = timeout_s
        self._targets: dict[str, str | Callable[[], int]] = {}
        self._url_lock = threading.Lock()
        self._url_results: dict[str, tuple[int, float]] = {}
        self._url_inflight: set[str] = set()

    def add_target(self, name: str, target: str | Callable[[], int]) -> None:
        self._targets[name] = target

    def _probe(self, target) -> tuple[int, float]:
        t0 = time.monotonic()
        if callable(target):
            status = int(target())
        else:
            try:
                with urllib.request.urlopen(target, timeout=self.timeout_s) as r:
                    status = r.status
            except urllib.error.HTTPError as e:
                status = e.code
            except Exception:
                status = 0  # unreachable
        return status, (time.monotonic() - t0) * 1000.0

    def _probe_url_async(self, name: str, target: str) -> None:
        def run():
            result = self._probe(target)
            with self._url_lock:
                self._url_results[name] = result
                self._url_inflight.discard(name)

        threading.Thread(
            target=run, name=f"httpcheck-{name}", daemon=True
        ).start()

    def scrape(self) -> None:
        for name, target in self._targets.items():
            if callable(target):
                status, ms = self._probe(target)
            else:
                with self._url_lock:
                    last = self._url_results.get(name)
                    kick = name not in self._url_inflight
                    if kick:
                        self._url_inflight.add(name)
                if kick:
                    try:
                        self._probe_url_async(name, target)
                    except Exception:
                        # A failed thread start must not wedge the
                        # target in the inflight set forever.
                        with self._url_lock:
                            self._url_inflight.discard(name)
                        raise
                if last is None:
                    continue  # first probe still in flight
                status, ms = last
            ok = 1.0 if 200 <= status < 400 else 0.0
            # Status code is a VALUE, not a label: gauges keyed by a
            # changing code would leave the stale series (old code, old
            # up/down value) exported forever beside the new one.
            self.registry.gauge_set("httpcheck_status", ok, endpoint=name)
            self.registry.gauge_set(
                "httpcheck_http_status_code", float(status), endpoint=name
            )
            self.registry.gauge_set("httpcheck_duration_ms", ms, endpoint=name)
            if not ok:
                self.registry.counter_add("httpcheck_error_total", 1.0, endpoint=name)


class StoreStatsReceiver:
    """Cart-store stats: the redis receiver analogue.

    The reference scrapes Valkey server stats (keys, memory, ops) from
    the cart store. Here the store is in-proc, so the receiver reads it
    directly: key count (users with carts), total items, and cumulative
    op counters if the store exposes them.
    """

    def __init__(self, store, registry: MetricRegistry | None = None):
        self.store = store
        self.registry = registry or MetricRegistry()

    def scrape(self) -> None:
        keys, items = self.store.stats()
        self.registry.gauge_set("store_db_keys", float(keys))
        self.registry.gauge_set("store_items_total", float(items))


class ProcessStatsReceiver:
    """Per-service resource stats: the docker_stats receiver analogue.

    The reference's ``docker_stats`` receiver (otelcol-config.yml:18-19)
    reports per-CONTAINER cpu/memory, one container per service. This
    framework's deployment maps the same way — each compose/k8s service
    (shop, kafka, anomaly-detector) is its own OS process — so each
    process exports ``container_*``-shaped self stats labeled with its
    service name, from /proc (no docker socket needed; works identically
    inside and outside a container):

    - ``container_cpu_usage_seconds_total``  user+system CPU (os.times)
    - ``container_memory_usage_bytes``       RSS (/proc/self/statm)
    - ``container_threads``                  live thread count
    - ``container_open_fds``                 open descriptor count

    In the single-process simulation the whole shop is one "container";
    the per-BUSINESS-service breakdown (request rates, latencies,
    per-store sizes) is the spanmetrics/store-stats layer's job — a
    process cannot honestly split its own RSS between in-proc services,
    and pretending otherwise would be fabricated data.
    """

    def __init__(self, name: str, registry: MetricRegistry | None = None):
        self.name = name
        self.registry = registry or MetricRegistry()

    def _open_fds(self) -> float:
        try:
            return float(len(os.listdir("/proc/self/fd")))
        except OSError:
            return 0.0

    def scrape(self) -> None:
        t = os.times()
        self.registry.gauge_set(
            "container_cpu_usage_seconds_total", t.user + t.system,
            container_name=self.name,
        )
        self.registry.gauge_set(
            "container_memory_usage_bytes", self_rss_bytes(),
            container_name=self.name,
        )
        self.registry.gauge_set(
            "container_threads", float(threading.active_count()),
            container_name=self.name,
        )
        self.registry.gauge_set(
            "container_open_fds", self._open_fds(),
            container_name=self.name,
        )
