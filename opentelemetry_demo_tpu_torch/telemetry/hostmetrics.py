"""Host metrics receiver: the collector's hostmetrics scraper analogue.

The reference collector scrapes cpu / load / memory / filesystem /
network / paging / process counters from the host
(the upstream demo's src/otel-collector/otelcol-config.yml:24-81) into the
metrics pipeline. This receiver reads the same signals straight from
``/proc`` (no psutil in the image) and publishes them as gauges on a
:class:`~.metrics.MetricRegistry`, which the collector's scrape cycle
then pulls into the TSDB under job ``hostmetrics``.
"""

from __future__ import annotations

import os

from .metrics import MetricRegistry


def self_rss_bytes(proc_root: str = "/proc") -> float:
    """This process's resident set size from {proc_root}/self/statm
    (field 1 × page size); 0.0 when /proc is unavailable. THE one statm
    parse — hostmetrics' process scraper and the docker_stats-analogue
    receiver both call it (``proc_root`` override is the test seam)."""
    try:
        with open(os.path.join(proc_root, "self/statm")) as f:
            pages = float(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0.0


class HostMetricsReceiver:
    """Reads /proc and publishes system.* gauges (OTel hostmetrics names)."""

    def __init__(self, registry: MetricRegistry | None = None, proc_root: str = "/proc"):
        self.registry = registry or MetricRegistry()
        self.proc_root = proc_root
        self._prev_cpu: tuple[float, float] | None = None  # (busy, total)

    def scrape(self) -> None:
        self._scrape_cpu()
        self._scrape_memory()
        self._scrape_load()
        self._scrape_network()
        self._scrape_process()

    # -- scrapers (each tolerant of a missing/foreign /proc) ----------

    def _read(self, name: str) -> str | None:
        try:
            with open(os.path.join(self.proc_root, name)) as f:
                return f.read()
        except OSError:
            return None

    def _scrape_cpu(self) -> None:
        text = self._read("stat")
        if not text or not text.startswith("cpu "):
            return
        fields = [float(x) for x in text.splitlines()[0].split()[1:]]
        idle = fields[3] + (fields[4] if len(fields) > 4 else 0.0)  # idle+iowait
        total = sum(fields)
        busy = total - idle
        if self._prev_cpu is not None:
            db = busy - self._prev_cpu[0]
            dt = total - self._prev_cpu[1]
            if dt > 0:
                self.registry.gauge_set(
                    "system_cpu_utilization", db / dt, state="busy"
                )
        self._prev_cpu = (busy, total)

    def _scrape_memory(self) -> None:
        text = self._read("meminfo")
        if not text:
            return
        kv = {}
        for line in text.splitlines():
            parts = line.split()
            if len(parts) >= 2 and parts[0].endswith(":"):
                kv[parts[0][:-1]] = float(parts[1]) * 1024.0  # kB → bytes
        if "MemTotal" in kv and "MemAvailable" in kv:
            used = kv["MemTotal"] - kv["MemAvailable"]
            self.registry.gauge_set("system_memory_usage_bytes", used, state="used")
            self.registry.gauge_set(
                "system_memory_usage_bytes", kv["MemAvailable"], state="free"
            )
            self.registry.gauge_set(
                "system_memory_utilization", used / max(kv["MemTotal"], 1.0)
            )

    def _scrape_load(self) -> None:
        text = self._read("loadavg")
        if not text:
            return
        parts = text.split()
        if len(parts) >= 3:
            self.registry.gauge_set("system_cpu_load_average_1m", float(parts[0]))
            self.registry.gauge_set("system_cpu_load_average_5m", float(parts[1]))
            self.registry.gauge_set("system_cpu_load_average_15m", float(parts[2]))

    def _scrape_network(self) -> None:
        text = self._read("net/dev")
        if not text:
            return
        rx = tx = 0.0
        for line in text.splitlines()[2:]:
            if ":" not in line:
                continue
            iface, rest = line.split(":", 1)
            if iface.strip() == "lo":
                continue
            fields = rest.split()
            if len(fields) >= 9:
                rx += float(fields[0])
                tx += float(fields[8])
        self.registry.gauge_set("system_network_io_bytes", rx, direction="receive")
        self.registry.gauge_set("system_network_io_bytes", tx, direction="transmit")

    def _scrape_process(self) -> None:
        rss = self_rss_bytes(self.proc_root)
        if rss:
            self.registry.gauge_set("process_memory_usage_bytes", rss)
