"""The system under test: the detector daemon's ingest and detection path.

:class:`System` assembles what ``runtime/daemon.py`` wires between its
receivers and the card, minus the sockets: an ``IngestPool`` feeding
``DetectorPipeline.submit_columns`` (bounded admission, the device-put
spine, the adaptive width, synchronous harvest), the self-tracer, the
provenance engine, the keyspace watchdog and the phase histograms. Every
knob takes the daemon's default from the port's knob registries
(``utils/config.py``), except those a configuration file lists under
``overrides``; the detector's geometry and thresholds come from the
file's ``detector`` block. The pump is the daemon's: one ``pump`` every
``ANOMALY_PUMP_INTERVAL_S`` on its own thread (:class:`Pump`).

Each harvested report goes through the daemon's ``_on_report``
(:meth:`System.on_report`): the remediation controller's ``observe``,
``telemetry.metrics.export_report`` over every service, the lag gauge
and the span counter. The controller is built from the remediation
knobs with no actuators: at the default ``ANOMALY_REMEDIATION_ENABLE=0``
the daemon's never act either. Two hooks serve the judge and differ from
the daemon: ``history_capture`` (off in the daemon) copies the five
columns of each dispatched batch, and the report's z-scores, CUSUM and
flags are copied after the export.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

# Knob families the served path reads, by the port's registry names.
REGISTRIES = ("DAEMON_KNOBS", "OVERLOAD_KNOBS", "INGEST_KNOBS", "SPINE_KNOBS",
              "SELFTRACE_KNOBS", "PROVENANCE_KNOBS", "KEYSPACE_KNOBS", "QUERY_KNOBS",
              "REMEDIATION_KNOBS")


def knobs(overrides: dict) -> dict:
    """Every knob of :data:`REGISTRIES` at its registered default, then
    the configuration's overrides (an unknown name raises)."""
    from opentelemetry_demo_tpu_torch.utils import config as knob_config

    out = {}
    for reg in REGISTRIES:
        for name, (_kind, default, _help) in getattr(knob_config, reg).items():
            out[name] = default
    for name, value in overrides.items():
        if name not in out:
            raise KeyError(f"{name} is no knob of the served path")
        out[name] = value
    return out


@dataclass
class PhaseLog:
    """Every ``phase_observe(phase, seconds)`` call, with the clock at its
    end, and the daemon's histograms fed the same values."""

    registry: object
    events: list = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)

    def __call__(self, phase: str, seconds: float) -> None:
        t = time.perf_counter()
        with self.lock:
            self.events.append((phase, t, seconds))
        from opentelemetry_demo_tpu_torch.runtime import selftrace
        from opentelemetry_demo_tpu_torch.telemetry import metrics

        if phase == selftrace.PHASE_HARVEST_LAG:
            self.registry.histogram_observe(metrics.ANOMALY_HARVEST_LAG, seconds, selftrace.PHASE_BUCKETS)
        elif phase == selftrace.PHASE_PUT_WAIT:
            self.registry.histogram_observe(metrics.ANOMALY_SPINE_PUT_WAIT, seconds, selftrace.PHASE_BUCKETS)
        else:
            self.registry.histogram_observe(metrics.ANOMALY_PHASE_SECONDS, seconds,
                                            selftrace.PHASE_BUCKETS, phase=phase)


class System:
    """The pool, the pipeline and the threads beside them."""

    def __init__(self, cfg: dict, device, record, capture):
        from opentelemetry_demo_tpu_torch.models.detector import AnomalyDetector, DetectorConfig
        from opentelemetry_demo_tpu_torch.runtime.ingest_pool import IngestPool
        from opentelemetry_demo_tpu_torch.runtime.keyspace import KeyspaceManager
        from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
        from opentelemetry_demo_tpu_torch.runtime.provenance import ProvenanceEngine
        from opentelemetry_demo_tpu_torch.runtime.remediation import RemediationController
        from opentelemetry_demo_tpu_torch.runtime.selftrace import SelfTracer
        from opentelemetry_demo_tpu_torch.telemetry.metrics import MetricRegistry

        k = self.knobs = knobs(cfg.get("overrides", {}))
        g = cfg["detector"]
        self.config = DetectorConfig(
            num_services=int(g["num_services"]), hll_p=int(g["hll_p"]),
            cms_depth=int(g["cms_depth"]), cms_width=int(g["cms_width"]),
            windows_s=tuple(float(x) for x in g["windows_s"]),
            taus_s=tuple(float(x) for x in g["taus_s"]),
            z_threshold=float(g["z_threshold"]), card_alpha=float(g["card_alpha"]),
            warmup_batches=float(g["warmup_batches"]), z_warmup_batches=float(g["z_warmup_batches"]),
            warmup_windows=float(g["warmup_windows"]), eps=float(g["eps"]),
            cusum_k=float(g["cusum_k"]), cusum_h=float(g["cusum_h"]),
            cusum_cap=float(g["cusum_cap"]), err_slack=float(g["err_slack"]),
            cusum_h_rate=float(g["cusum_h_rate"]),
        )
        for knob, fld in (("ANOMALY_NUM_SERVICES", "num_services"), ("ANOMALY_HLL_P", "hll_p"),
                          ("ANOMALY_CMS_WIDTH", "cms_width"), ("ANOMALY_WARMUP_BATCHES", "warmup_batches"),
                          ("ANOMALY_Z_WARMUP_BATCHES", "z_warmup_batches")):
            if float(k[knob]) != -1 and float(k[knob]) != float(getattr(self.config, fld)):
                raise ValueError(f"{knob}={k[knob]} disagrees with the detector block's {fld}")
        self.detector = AnomalyDetector(self.config, device=device)
        self.registry = MetricRegistry()
        self.phases = PhaseLog(self.registry)
        self.remediation = RemediationController(
            [], enabled=bool(int(k["ANOMALY_REMEDIATION_ENABLE"])),
            act_batches=int(k["ANOMALY_REMEDIATION_ACT_BATCHES"]),
            clear_batches=int(k["ANOMALY_REMEDIATION_CLEAR_BATCHES"]),
            budget=int(k["ANOMALY_REMEDIATION_BUDGET"]),
            budget_refill_s=float(k["ANOMALY_REMEDIATION_BUDGET_REFILL_S"]),
            deadline_s=float(k["ANOMALY_REMEDIATION_DEADLINE_S"]),
            rollback=bool(int(k["ANOMALY_REMEDIATION_ROLLBACK"])),
        )
        self._record = record
        self._spans_seen = 0
        self.tracer = (SelfTracer(submit=None, sample=float(k["ANOMALY_SELFTRACE_SAMPLE"]))
                       if int(k["ANOMALY_SELFTRACE_ENABLE"]) else None)
        self.provenance = (ProvenanceEngine(self.config, topk=int(k["ANOMALY_PROVENANCE_TOPK"]),
                                            trajectory_windows=int(k["ANOMALY_PROVENANCE_TRAJECTORY_WINDOWS"]))
                           if int(k["ANOMALY_PROVENANCE_ENABLE"]) else None)
        self.pipe = DetectorPipeline(
            self.detector,
            on_report=self.on_report,
            batch_size=int(k["ANOMALY_BATCH"]),
            harvest_interval_s=float(k["ANOMALY_HARVEST_INTERVAL"]),
            harvest_async=bool(int(k["ANOMALY_HARVEST_ASYNC"])),
            adaptive_batching=bool(int(k["ANOMALY_ADAPTIVE_BATCH"])),
            queue_max_rows=int(k["ANOMALY_QUEUE_MAX_ROWS"]),
            high_watermark=float(k["ANOMALY_QUEUE_HIGH_WATERMARK"]),
            low_watermark=float(k["ANOMALY_QUEUE_LOW_WATERMARK"]),
            brownout_hold_s=float(k["ANOMALY_BROWNOUT_HOLD_S"]),
            brownout_max_level=int(k["ANOMALY_BROWNOUT_MAX_LEVEL"]),
            retry_after_s=float(k["ANOMALY_RETRY_AFTER_S"]),
            exemplar_ring=int(k["ANOMALY_QUERY_EXEMPLARS"]),
            hh_candidates=int(k["ANOMALY_QUERY_CANDIDATES"]),
            spine_ring=int(k["ANOMALY_SPINE_RING"]),
            spine_overlap=bool(int(k["ANOMALY_SPINE_OVERLAP"])),
            spine_chunk_rows=int(k["ANOMALY_SPINE_CHUNK_ROWS"]),
            phase_observe=self.phases,
            selftrace=self.tracer,
            history_capture=capture,
            provenance=self.provenance,
            explain_ring=int(k["ANOMALY_PROVENANCE_RING"]),
            keyspace_enable=bool(int(k["ANOMALY_KEYSPACE_ENABLE"])),
            keyspace_high_watermark=float(k["ANOMALY_KEYSPACE_HIGH_WATERMARK"]),
            keyspace_low_watermark=float(k["ANOMALY_KEYSPACE_LOW_WATERMARK"]),
            keyspace_hold_s=float(k["ANOMALY_KEYSPACE_HOLD_S"]),
            keyspace_newkey_rate=float(k["ANOMALY_KEYSPACE_NEWKEY_RATE"]),
            keyspace_retry_after_s=float(k["ANOMALY_KEYSPACE_RETRY_AFTER_S"]),
        )
        self.keyspace = None
        if int(k["ANOMALY_KEYSPACE_ENABLE"]):
            self.keyspace = KeyspaceManager(
                self.pipe, idle_s=float(k["ANOMALY_KEYSPACE_IDLE_S"]),
                evict_batch=int(k["ANOMALY_KEYSPACE_EVICT_BATCH"]),
                rss_budget_mb=float(k["ANOMALY_KEYSPACE_RSS_MB"]),
            )
        self.pool = IngestPool(
            self.pipe.submit_columns, self.pipe.tensorizer,
            workers=int(k["ANOMALY_INGEST_WORKERS"]),
            coalesce_max=int(k["ANOMALY_INGEST_COALESCE"]),
            max_pending=int(k["ANOMALY_INGEST_MAX_PENDING"]),
            phase_observe=self.phases, selftrace=self.tracer,
            native_threads=int(k["ANOMALY_INGEST_NATIVE_THREADS"]),
            shard_min_bytes=int(k["ANOMALY_INGEST_SHARD_MIN_BYTES"]),
        )
        self.pump = Pump(self.pipe, float(k["ANOMALY_PUMP_INTERVAL_S"]))

    def on_report(self, t_batch, report, flagged) -> None:
        """The daemon's ``_on_report``, then the judge's copy."""
        from opentelemetry_demo_tpu_torch.telemetry import metrics

        names = self.pipe.tensorizer.service_names
        self.remediation.observe(t_batch, flagged, services=names)
        metrics.export_report(self.registry, names, report, flagged)
        stats = self.pipe.stats
        self.registry.gauge_set(metrics.ANOMALY_LAG_P99, stats.lag_p99_ms())
        self.registry.counter_add(metrics.ANOMALY_SPANS_TOTAL, float(stats.spans - self._spans_seen))
        self._spans_seen = stats.spans
        self._record(t_batch, report)

    def start(self) -> None:
        if self.keyspace is not None:
            self.keyspace.start()
        self.pump.start()

    def idle(self) -> bool:
        """Nothing queued, staged or in flight."""
        pipe = self.pipe
        spine = pipe._spine
        with pipe._inflight_lock:
            inflight = len(pipe._inflight)
        return (self.pool.depth() == 0 and pipe.pending_rows() == 0
                and (spine is None or spine.pending() == 0) and inflight == 0)

    def close(self) -> None:
        self.pump.stop()
        if self.keyspace is not None:
            self.keyspace.close()
        self.pool.close()
        self.pipe.close()


class Pump:
    """The daemon's pump loop: ``pipe.pump(time.monotonic())`` every
    interval, on its own thread. ``spans`` records (start, end) of each
    pump call on ``time.perf_counter``."""

    def __init__(self, pipe, interval_s: float):
        self.pipe = pipe
        self.interval_s = interval_s
        self.spans: list[tuple[float, float]] = []
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="bench-pump", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        spans = self.spans
        try:
            while not self._stop.wait(self.interval_s):
                t0 = time.perf_counter()
                self.pipe.pump(time.monotonic())
                spans.append((t0, time.perf_counter()))
        except BaseException as e:  # noqa: BLE001 — re-raised by cell.run
            self.error = e

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            if self._thread.is_alive():
                raise RuntimeError("the pump thread did not stop")
