"""The anomaly-detector sidecar daemon: the deployable service.

This is what runs inside the ``anomaly-detector`` container that
deploy/torch/docker-compose.anomaly.yml adds to the shop (wired like the
reference's fraud-detection consumer,
the upstream demo's docker-compose.yml:226-256): an OTLP/HTTP receiver for
the collector's ``otlphttp/anomaly`` exporter, an optional Kafka
``orders`` consumer, the device pipeline, a Prometheus ``/metrics``
surface, flagd gating, and offset-keyed checkpoints.

Configuration is environment-driven with hard failure on malformed
values — the reference's ``mustMapEnv`` discipline
(the upstream demo's src/checkout/main.go:230-236): a service that boots
with half a config is worse than one that refuses to boot.

Env contract (all optional, sensible defaults). Daemon-core knobs are
ONE registry — ``utils.config.DAEMON_KNOBS`` — consumed here, by the
compose overlay, the k8s generator and the checkers, so the set can
never drift between surfaces (scripts/staticcheck knob-discipline
pass):

- ``ANOMALY_OTLP_PORT``      OTLP/HTTP listen port (default 4318)
- ``ANOMALY_NUM_SERVICES`` / ``ANOMALY_CMS_WIDTH`` / ``ANOMALY_HLL_P`` /
  ``ANOMALY_WARMUP_BATCHES`` / ``ANOMALY_Z_WARMUP_BATCHES``
                             detector geometry/warmup overrides (defaults
                             from models.DetectorConfig; geometry shrinks
                             the state on small deployments)
- ``ANOMALY_OTLP_GRPC_PORT`` OTLP/gRPC listen port (default 4317, the
                             collector's primary ingress; -1 disables)
- ``ANOMALY_METRICS_PORT``   Prometheus listen port (default 9464)
- ``ANOMALY_BATCH``          device batch size (default 2048)
- ``ANOMALY_HARVEST_INTERVAL``  report readback cadence seconds (default 0
  = every batch); ``ANOMALY_HARVEST_ASYNC=1`` fetches on a side thread
- ``ANOMALY_ADAPTIVE_BATCH``  adaptive dispatch-width controller
  (default 1 = on): widens batches in pow2 steps when report readback
  can't keep pace, bounding the skip rate under load spikes, and sizes a
  take that finds more than a batch pending to the ladder width that
  holds the backlog; set 0 for a fixed width. Every ladder width runs
  once in the background at boot
- ``ANOMALY_PUMP_INTERVAL_S``  batch cadence (default 0.05 — the <100ms
                               detection-lag budget spends half on batching)
- ``FLAGD_FILE``             flagd-schema JSON path (hot-reloaded)
- ``OFREP_URL``              OFREP endpoint (used when FLAGD_FILE unset)
- ``KAFKA_ADDR``             bootstrap servers for the orders topic
                             (requires a Kafka client in the image)
- ``ANOMALY_CHECKPOINT``       snapshot path prefix (enables resume)
- ``ANOMALY_CHECKPOINT_INTERVAL_S``  snapshot cadence (default 30)
- ``ANOMALY_OTLP_MAX_BODY``    ingest body-size cap in bytes (default
                               16 MiB; oversized exports answer
                               413/RESOURCE_EXHAUSTED)
- Overload knobs (one registry: ``utils.config.OVERLOAD_KNOBS``):
  ``ANOMALY_QUEUE_MAX_ROWS`` (pending-queue row budget, default 65536,
  0 = unbounded), ``ANOMALY_QUEUE_HIGH_WATERMARK`` /
  ``ANOMALY_QUEUE_LOW_WATERMARK`` (saturation hysteresis, defaults
  0.85/0.5), ``ANOMALY_BROWNOUT_HOLD_S`` / ``ANOMALY_BROWNOUT_MAX_LEVEL``
  (head-sampling ladder, defaults 2.0 s / 4), ``ANOMALY_RETRY_AFTER_S``
  (the cap of the 429/RESOURCE_EXHAUSTED retry hint, default 1.0; a
  saturated queue hints the time its pump needs to drain to the low
  watermark, which HTTP and the native door round up to whole seconds)
- Ingest-pool knobs (one registry: ``utils.config.INGEST_KNOBS``;
  engine: ``runtime.ingest_pool``): ``ANOMALY_INGEST_WORKERS`` (decode
  workers, default 2; 0 disables the pool — serial in-thread decode),
  ``ANOMALY_INGEST_COALESCE`` (max requests per batched decode+flush,
  default 64), ``ANOMALY_INGEST_MAX_PENDING`` (bounded request queue
  ahead of the pool, default 512; full = retryable 429),
  ``ANOMALY_INGEST_NATIVE_THREADS`` / ``ANOMALY_INGEST_SHARD_MIN_BYTES``
  (two-pass scanner pass-2 sharding: extraction threads per batched
  decode call and the payload-byte floor that arms them)
- Device-put spine knobs (one registry: ``utils.config.SPINE_KNOBS``;
  engine: ``runtime.spine`` — the staging ring between batch assembly
  and the device step): ``ANOMALY_SPINE_RING`` (pre-allocated
  host staging buffers, default 2 = double buffering; 0 = spine off,
  pack+put inline on the pump thread), ``ANOMALY_SPINE_OVERLAP``
  (0: the pump waits on the host for each put's copy;
  anomaly_spine_put_overlap_ratio reports the share of copies issued
  while the last step still ran, which falls toward 0 under light
  traffic, where a caught-up pump finds the card idle),
  ``ANOMALY_SPINE_CHUNK_ROWS`` (pack copy block rows, 0 = whole batch)
- Hot-standby replication knobs (one registry:
  ``utils.config.REPLICATION_KNOBS``; engine: ``runtime.replication``):
  ``ANOMALY_ROLE`` (``primary`` serves + ships state deltas,
  ``standby`` applies them and promotes itself on primary silence),
  ``ANOMALY_REPLICATION_PORT`` (primary-side listener, -1 off),
  ``ANOMALY_REPLICATION_TARGET`` (standby-side primary host:port),
  ``ANOMALY_REPLICATION_INTERVAL_S`` (delta cadence, default 1.0),
  ``ANOMALY_FAILOVER_TIMEOUT_S`` (standby watchdog before promotion,
  default 5.0), ``ANOMALY_PRIMARY_HEALTH_ADDR`` (optional grpc-health
  double-check before promoting), ``ANOMALY_OFFSET_DEFER_MAX`` (cap on
  the deferred-confirmation offset list, default 64)
- Live-query-plane knobs (one registry: ``utils.config.QUERY_KNOBS``;
  engine: ``runtime.query`` — the HTTP/gRPC read API over live sketch
  state + the Grafana simple-JSON datasource):
  ``ANOMALY_QUERY_PORT`` (HTTP/JSON + Grafana surface, 0 = ephemeral,
  -1 disables), ``ANOMALY_QUERY_GRPC_PORT`` (same documents over
  gRPC, default -1), ``ANOMALY_QUERY_TOPK`` (default k for top-k
  answers), ``ANOMALY_QUERY_EXEMPLARS`` (per-service exemplar-ring
  size — trace ids captured at flag time), ``ANOMALY_QUERY_TIMELINE``
  (snapshot-timeline ring depth), ``ANOMALY_QUERY_READ_REPLICA``
  (1 = a standby serves queries from its replicated mirror while
  remaining promotable), ``ANOMALY_QUERY_MAX_STALENESS_S`` (snapshot
  cache budget; every answer reports its staleness)
- Self-telemetry knobs (one registry: ``utils.config.SELFTRACE_KNOBS``;
  engines: ``runtime.selftrace`` + ``runtime.flightrec``):
  ``ANOMALY_SELFTRACE_ENABLE`` (batch-lifecycle tracer, default 1),
  ``ANOMALY_SELFTRACE_SAMPLE`` (deterministic splitmix64 head-sampling
  rate, default 0.01), ``ANOMALY_SELFTRACE_ENDPOINT`` (OTLP endpoint
  for the detector's own traces; empty = encode-only),
  ``ANOMALY_SELFTRACE_FLIGHT_RING`` (flight-recorder ring size,
  default 512), ``ANOMALY_SELFTRACE_FLIGHT_DIR`` (evidence-dump
  directory written on DEGRADED/SATURATED/FENCED/PROMOTING
  transitions; empty = ring-only)
- Verified-frame knobs (one registry: ``utils.config.FRAME_KNOBS``;
  engine: ``runtime.frame`` — the ONE checksummed columnar format that
  ingest scratch→pipeline, replication payloads and checkpoint files
  all move): ``ANOMALY_FRAME_VERIFY`` (checksum verification at every
  hop, default 1), ``ANOMALY_FRAME_WRITE_VERSION`` (format version
  written, default 2; readers accept 1..2 — pin to 1 mid-rolling-
  upgrade), ``ANOMALY_FRAME_QUARANTINE_DIR`` (where corrupt frames are
  written aside for forensics; empty = count + drop)
- Time-travel history knobs (one registry:
  ``utils.config.HISTORY_KNOBS``; engine: ``runtime.history`` — the
  compaction thread folding expiring window banks into an on-disk
  retention ladder of verified frames, plus the range-query backend
  and the replay corpus): ``ANOMALY_HISTORY_DIR`` (segment-log
  directory; empty = tier off), ``ANOMALY_HISTORY_RUNGS`` (ladder
  spans seconds, default ``1,60,3600``),
  ``ANOMALY_HISTORY_RETENTION_S`` (per-rung caps),
  ``ANOMALY_HISTORY_COMPACT_INTERVAL_S`` (compaction tick),
  ``ANOMALY_HISTORY_SEGMENT_MB`` (segment roll size),
  ``ANOMALY_HISTORY_SPANS`` ('1' = capture dispatched span batches
  for replaybench; or a per-service sample-rate map
  ``svc:rate[,*:rate]`` — record a mitigation drill's flagged service
  at 100% without the quiet firehose), ``ANOMALY_HISTORY_REPLAY_RATE``
  (replaybench's wall-clock speedup target)
- Closed-loop auto-mitigation knobs (one registry:
  ``utils.config.REMEDIATION_KNOBS``; engine: ``runtime.remediation``
  — the supervised controller that subscribes to the pipeline's
  per-service verdicts and, ONLY when opted in, flips flagd
  mitigation flags + promotes the sampling policy, then verifies its
  own action recovered the system): ``ANOMALY_REMEDIATION_ENABLE``
  (default 0 — observe-only), ``ANOMALY_REMEDIATION_ACT_BATCHES`` /
  ``ANOMALY_REMEDIATION_CLEAR_BATCHES`` (two-edge hysteresis),
  ``ANOMALY_REMEDIATION_BUDGET`` /
  ``ANOMALY_REMEDIATION_BUDGET_REFILL_S`` (token-bucket actuation
  budget — a flapping detector freezes the flags instead of
  oscillating them), ``ANOMALY_REMEDIATION_DEADLINE_S`` /
  ``ANOMALY_REMEDIATION_ROLLBACK`` (verified recovery; a missed
  deadline rolls the actuation back and parks MITIGATION_FAILED),
  ``ANOMALY_REMEDIATION_FLAG_URL`` (remote flag-editor write surface;
  empty = the daemon's own flag store),
  ``ANOMALY_REMEDIATION_TIMEOUT_S`` (bounded per-write transport),
  ``ANOMALY_REMEDIATION_SAMPLING`` (exemplar-seeded keep-100%
  promotion of flagged services)

Replication / failover (runtime.replication; tests/test_replication.py):
the daemon runs a role state machine — PRIMARY / STANDBY / PROMOTING
(plus FENCED, the visible end state of a stale resurrected primary).
A primary ships epoch-stamped state deltas to attached standbys;
offsets ship only after flush confirmation (the deferred-
confirmation rule), so a promoted standby resumes the ``orders`` pump
at-least-once from its replicated offset map. A standby that stops
hearing frames for ``ANOMALY_FAILOVER_TIMEOUT_S`` (optionally
double-checking the primary's gRPC health first) promotes: epoch bump,
Kafka seek to the replicated offsets, OTLP receivers up, immediate
epoch-stamped checkpoint, and its own replication listener for the
next standby. A stale primary's writes are fenced on all three paths
(checkpoint save, epoch-tagged Kafka offset commit, replication
frames); it parks in role=fenced instead of split-braining.

Overload protection (tests/test_overload.py): above the high watermark
the pending queue sheds oldest OK-lane rows (never error-lane), trace
exports answer retryable 429 + ``Retry-After`` (HTTP) /
``RESOURCE_EXHAUSTED`` + retry hint (gRPC), the Kafka pump pauses
fetching (offsets hold, the broker buffers), and sustained pressure
engages a deterministic brownout head-sampling ladder. ``/healthz`` on
the metrics port reports ``saturated`` distinct from ``degraded``.

Fault tolerance (runtime.supervision; proven by tests/test_chaos.py):
every ingest leg is supervised — a crashed receiver restarts with
bounded backoff+jitter, poison ``orders`` records are quarantined (not
fatal), a truncated OTLP body answers 4xx, and a corrupt checkpoint at
boot degrades to a cold start. Component state is visible as
``anomaly_component_up{component=...}`` /
``anomaly_component_restarts_total`` / ``anomaly_degraded`` on
``/metrics`` and per-component on the gRPC health service
(``runtime.health_probe --component <name>``).

On the card (this package): ``DetectorDaemon(config, device=None)``
runs the detector, the metrics head and the shadow verifier on the
card unless ``device`` names another, and raises with no card;
``python -m opentelemetry_demo_tpu_torch --device cpu`` asks for the
plain path (a flag, not a knob: the registries equal the reference's).
The step updates the card's state in place on one stream, so:

- every read of the live state goes through
  ``DetectorPipeline.state_snapshot`` (its copy enqueued on the steps'
  stream under the dispatch lock);
- promotion and adoption WRITE the card's state in place, on the steps'
  stream, under the dispatch lock (:meth:`DetectorDaemon._write_state`);
  adoption reads, merges and writes in one hold of the lock, so a step
  dispatched meanwhile lands after the merge, never under it;
- a failed width-ladder warm-up is logged and kept on ``warmup_error``
  rather than swallowed, and ``ANOMALY_FRONTDOOR_ENABLE=1`` without the
  native front door raises at boot with the build error;
- ``anomaly_build_info`` is labelled ``torch=`` and ``cuda=`` where the
  reference's carries ``jax=``.
"""

from __future__ import annotations

import argparse
import collections
import logging
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..models.detector import AnomalyDetector, DetectorConfig, DetectorState
from ..telemetry import metrics as tele_metrics
from ..utils.config import (
    ConfigError,
    autoscale_config,
    daemon_config,
    fleet_config,
    fleet_tenant_map,
    frame_config,
    frontdoor_config,
    history_config,
    history_spans_policy,
    ingest_config,
    keyspace_config,
    overload_config,
    provenance_config,
    query_config,
    remediation_config,
    replication_config,
    selftrace_config,
    shadow_config,
    spine_config,
)
from ..utils.flags import FlagEvaluator, FlagFileStore, OfrepClient
from . import autoscale, checkpoint, fleet, history, provenance, remediation, replication, selftrace, shadow
from . import frame as frame_fmt
from .flightrec import FlightRecorder
from .hostcopy import HostCopy
from .metrics_feed import MetricsFeed
from .otlp import OtlpHttpReceiver
from .pipeline import DetectorPipeline
from .tensorize import EVICTED_SLOT
from .replication import (
    ROLE_FENCED,
    ROLE_PRIMARY,
    ROLE_PROMOTING,
    ROLE_STANDBY,
    EpochFence,
)
from .supervision import Supervisor


def _package_version() -> str:
    """Package version for the build_info gauge ("unknown" rather than
    a crash if the package is run from a mangled checkout)."""
    try:
        from .. import __version__

        return str(__version__)
    except Exception:  # noqa: BLE001 — a label must never fail boot
        return "unknown"


def _torch_versions() -> tuple[str, str]:
    """(torch, CUDA) versions for the build_info gauge; CUDA is "none"
    for a CPU-only build."""
    return str(torch.__version__), str(torch.version.cuda or "none")


class DetectorDaemon:
    """Wires receiver → pipeline → detector → metrics; owns the loop."""

    def __init__(
        self,
        config: DetectorConfig | None = None,
        device: "torch.device | str | None" = None,
    ):
        # The card unless the caller names another; no card raises
        # before anything binds.
        self.device = resolve_device(device)
        # A failed width-ladder warm-up (see _warm_widths_quietly).
        self.warmup_error: BaseException | None = None
        self._warm_thread: threading.Thread | None = None
        # Dispatch-lock hold per replication ship, seconds (newest last).
        self.ship_lock_holds: collections.deque = collections.deque(
            maxlen=4096
        )
        # Daemon-core knobs (ONE registry: utils.config.DAEMON_KNOBS —
        # the same literal dict the compose overlay, the k8s generator
        # and the checkers consume; the env reads this replaces were
        # the stray-knob violations the staticcheck knob-discipline
        # pass exists to catch).
        try:
            dk = daemon_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        self.otlp_port = int(dk["ANOMALY_OTLP_PORT"])
        self.metrics_port = int(dk["ANOMALY_METRICS_PORT"])
        self.batch_size = int(dk["ANOMALY_BATCH"])
        self.pump_interval_s = float(dk["ANOMALY_PUMP_INTERVAL_S"])
        self.ckpt_path = str(dk["ANOMALY_CHECKPOINT"]) or None
        self.ckpt_interval_s = float(dk["ANOMALY_CHECKPOINT_INTERVAL_S"])

        # Verified-frame policy FIRST (knob registry:
        # utils.config.FRAME_KNOBS; engine: runtime.frame): the
        # checkpoint load below and every hop after it read/write the
        # one columnar format, so the write-version/verify/quarantine
        # knobs must be installed before any byte moves.
        try:
            fk = frame_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        frame_fmt.configure(
            write_version=int(fk["ANOMALY_FRAME_WRITE_VERSION"]),
            verify=bool(int(fk["ANOMALY_FRAME_VERIFY"])),
            quarantine_dir=str(fk["ANOMALY_FRAME_QUARANTINE_DIR"]),
        )

        # Replication role state machine (knob registry:
        # utils.config.REPLICATION_KNOBS; engine: runtime.replication).
        try:
            rp = replication_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        self.role = (
            ROLE_STANDBY if rp["ANOMALY_ROLE"] == "standby" else ROLE_PRIMARY
        )
        self._repl_port = int(rp["ANOMALY_REPLICATION_PORT"])
        self._repl_target = str(rp["ANOMALY_REPLICATION_TARGET"])
        self._repl_interval_s = float(rp["ANOMALY_REPLICATION_INTERVAL_S"])
        self._failover_timeout_s = float(rp["ANOMALY_FAILOVER_TIMEOUT_S"])
        self._primary_health_addr = str(rp["ANOMALY_PRIMARY_HEALTH_ADDR"])
        self._offset_defer_max = int(rp["ANOMALY_OFFSET_DEFER_MAX"])
        if self.role == ROLE_STANDBY and not self._repl_target:
            raise SystemExit(
                "ANOMALY_ROLE=standby requires ANOMALY_REPLICATION_TARGET "
                "(the primary's replication listener host:port)"
            )
        self.repl_primary: replication.ReplicationPrimary | None = None
        self.repl_standby: replication.ReplicationStandby | None = None

        # Live query plane (knob registry: utils.config.QUERY_KNOBS;
        # engine: runtime.query). Parsed before the pipeline below —
        # the exemplar-ring size is a pipeline constructor knob.
        try:
            qk = query_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        self._query_port_req = int(qk["ANOMALY_QUERY_PORT"])
        self._query_grpc_port_req = int(qk["ANOMALY_QUERY_GRPC_PORT"])
        self._query_topk = int(qk["ANOMALY_QUERY_TOPK"])
        self._query_exemplars = int(qk["ANOMALY_QUERY_EXEMPLARS"])
        self._query_candidates = int(qk["ANOMALY_QUERY_CANDIDATES"])
        self._query_timeline = int(qk["ANOMALY_QUERY_TIMELINE"])
        self._query_read_replica = bool(
            int(qk["ANOMALY_QUERY_READ_REPLICA"])
        )
        self._query_max_staleness_s = float(
            qk["ANOMALY_QUERY_MAX_STALENESS_S"]
        )
        self._query_evicted_lookback_s = float(
            qk["ANOMALY_QUERY_EVICTED_LOOKBACK_S"]
        )

        # Detector self-telemetry (knob registry:
        # utils.config.SELFTRACE_KNOBS; engines: runtime.selftrace +
        # runtime.flightrec). Parsed before the pipeline below — the
        # tracer and the phase-observe hook are pipeline/pool
        # constructor arguments, and the flight recorder must exist
        # before any boot-time transition (a boot-fenced primary is
        # the first event worth recording).
        try:
            st = selftrace_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        self.flight = FlightRecorder(
            size=int(st["ANOMALY_SELFTRACE_FLIGHT_RING"]),
            dump_dir=str(st["ANOMALY_SELFTRACE_FLIGHT_DIR"]),
        )
        self.selftrace = None
        self._selftrace_poster = None
        if int(st["ANOMALY_SELFTRACE_ENABLE"]):
            endpoint = str(st["ANOMALY_SELFTRACE_ENDPOINT"])
            submit = None
            if endpoint:
                # The ONE network leg of self-tracing: the shared
                # background poster (encode on the harvester, POST on
                # the sender thread — never the pump).
                self._selftrace_poster = selftrace.make_exporter(endpoint)
                submit = self._selftrace_poster.submit
            self.selftrace = selftrace.SelfTracer(
                submit=submit,
                sample=float(st["ANOMALY_SELFTRACE_SAMPLE"]),
            )
        # Provenance log-record export reuses the selftrace collector
        # endpoint: evidence bundles ride the same OTLP pipeline as
        # every other self-observation signal (no second endpoint knob).
        self._otlp_export_endpoint = str(st["ANOMALY_SELFTRACE_ENDPOINT"])
        self.flight.record(
            "boot", role=self.role,
            selftrace=bool(int(st["ANOMALY_SELFTRACE_ENABLE"])),
            sample=float(st["ANOMALY_SELFTRACE_SAMPLE"]),
        )
        # Transition-edge state for the flight recorder's health wiring.
        self._flight_last_state: str | None = None
        self._flight_last_brownout = 0
        self._flight_fence_seen = 0
        self._spine_overlap_seen = (0, 0)  # (hits, taken) window base

        # Time-travel history tier knobs (registry:
        # utils.config.HISTORY_KNOBS; engine: runtime.history). Parsed
        # here; the store/writer themselves are constructed after the
        # pipeline below (the writer snapshots through the same
        # dispatch-lock helper replication uses, and its span capture
        # is a pipeline hook) and BEFORE the boot fencing check (the
        # log's on-disk epochs are fencing evidence like the
        # checkpoint volume's).
        try:
            hk = history_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        from ..utils.config import history_ladder

        self._history_dir = str(hk["ANOMALY_HISTORY_DIR"]) or None
        # The SAME parse history_config() just validated with — not a
        # re-implementation that could drift from it.
        self._history_rungs, self._history_retention = history_ladder(
            hk["ANOMALY_HISTORY_RUNGS"],
            hk["ANOMALY_HISTORY_RETENTION_S"],
        )
        self._history_interval_s = float(
            hk["ANOMALY_HISTORY_COMPACT_INTERVAL_S"]
        )
        self._history_segment_bytes = (
            int(hk["ANOMALY_HISTORY_SEGMENT_MB"]) << 20
        )
        # Span-capture policy: '0'/'1' or the per-service sample-rate
        # map — the SAME parse history_config() just validated with.
        self._history_spans, self._history_span_rates = (
            history_spans_policy(hk["ANOMALY_HISTORY_SPANS"])
        )
        # Replay-rate target: consumed by replaybench against a
        # recorded log; surfaced in the flight record below so a
        # postmortem knows what the deployment promised.
        self._history_replay_rate = float(
            hk["ANOMALY_HISTORY_REPLAY_RATE"]
        )
        self.history_store: history.HistoryStore | None = None
        self.history_writer: history.HistoryWriter | None = None
        self.history_reader: history.HistoryReader | None = None
        self._history_seen = {"compactions": 0, "frames_corrupt": 0}

        flagd_file = str(dk["FLAGD_FILE"]) or None
        ofrep = str(dk["OFREP_URL"]) or None
        if flagd_file:
            flags = FlagFileStore(flagd_file)
        elif ofrep:
            flags = OfrepClient(ofrep)  # type: ignore[assignment]
        else:
            flags = FlagEvaluator()

        if config is None:
            # Geometry knobs use -1 as "keep the model's default" (the
            # registry must stay literal/torch-free, so it cannot name
            # DetectorConfig's values).
            base = DetectorConfig()

            def _geom(knob: str, current, cast):
                value = dk[knob]
                return current if float(value) < 0 else cast(value)

            config = base._replace(
                num_services=_geom(
                    "ANOMALY_NUM_SERVICES", base.num_services, int
                ),
                cms_width=_geom("ANOMALY_CMS_WIDTH", base.cms_width, int),
                hll_p=_geom("ANOMALY_HLL_P", base.hll_p, int),
                warmup_batches=_geom(
                    "ANOMALY_WARMUP_BATCHES", base.warmup_batches, float
                ),
                z_warmup_batches=_geom(
                    "ANOMALY_Z_WARMUP_BATCHES", base.z_warmup_batches,
                    float,
                ),
            )
        restored_offsets: dict = {}
        meta: dict | None = None
        ckpt_corrupt = False
        if self.ckpt_path:
            # Resilient boot: a truncated/bit-rotted snapshot means
            # cold start + a counter, never a boot crash — the snapshot
            # is an optimization, not a dependency (checkpoint module
            # docstring). Config mismatch still refuses to boot.
            self.detector, meta, ckpt_corrupt = checkpoint.load_resilient(
                self.ckpt_path, config, self.device
            )
        if meta is not None:
            restored_names = meta.get("service_names", [])
            # JSON round-trips partition keys as strings; offsets are
            # keyed by int partition everywhere else.
            restored_offsets = {
                int(p): int(o) for p, o in meta.get("offsets", {}).items()
            }
        else:
            self.detector = AnomalyDetector(config, device=self.device)
            restored_names = []
        # The fencing epoch resumes from the snapshot (a promoted
        # standby's checkpoint carries its bumped epoch, so ITS restart
        # keeps outranking the old primary); further fencing evidence
        # arrives from the broker's commit tags below and from
        # replication frames at runtime.
        self._fence = EpochFence(
            int(meta.get("epoch", 0)) if meta is not None else 0
        )

        self.registry = tele_metrics.MetricRegistry()
        # Build identity: version labels are static for the process
        # lifetime, so the gauge is set exactly once here; the matching
        # start_ts rides /healthz (restart forensics pair with bundle
        # timestamps through these two surfaces).
        self._start_ts = time.time()
        torch_version, cuda_version = _torch_versions()
        self.registry.gauge_set(
            tele_metrics.ANOMALY_BUILD_INFO, 1.0,
            version=_package_version(),
            frame_version=str(frame_fmt.FRAME_VERSION),
            torch=torch_version,
            cuda=cuda_version,
        )
        self.registry.describe(
            tele_metrics.ANOMALY_BUILD_INFO,
            "Constant 1 labelled with package/frame/torch/cuda versions",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_FLAG_TOTAL,
            "Anomaly flags raised, by service",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_Z_SCORE,
            "Current |z| per service and signal",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_COMPONENT_RESTARTS,
            "Supervised component restarts, by component",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_COMPONENT_UP,
            "1 while the supervised component is up, 0 in backoff/degraded",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_DEGRADED,
            "1 while any supervised component is crash-looping",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_QUARANTINE_TOTAL,
            "Poison records quarantined instead of crashing the consumer",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_INGEST_REJECTED,
            "Malformed/truncated/oversized ingest bodies answered 4xx",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_CHECKPOINT_CORRUPT,
            "Corrupt snapshots found at boot (each = one cold start)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_SHED_ROWS,
            "Pending-queue rows dropped under overload, by lane and cause",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_QUEUE_ROWS,
            "Pending-queue depth in rows (bounded by the row budget)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_QUEUE_WATERMARK,
            "Configured saturation watermarks in rows, by mark",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_BROWNOUT_LEVEL,
            "Brownout head-sampling level (keep 1/2^level of OK-lane spans)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_SATURATED,
            "1 while admission is saturated (429/RESOURCE_EXHAUSTED to producers)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_KAFKA_PAUSED,
            "1 while the orders pump holds fetching under saturation",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_INGEST_POOL_DEPTH,
            "Requests queued ahead of the decode pool (bounded)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_INGEST_POOL_FLUSHES,
            "Coalesced decode+tensorize flushes merged into the pipeline",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_INGEST_POOL_SPANS,
            "Spans decoded through the parallel ingest pool",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_INGEST_POOL_REQUESTS,
            "Export requests folded into pool flushes (requests/flush = "
            "the live coalescing factor)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_INGEST_POOL_UTILIZATION,
            "Decode-worker busy fraction over the last scrape window "
            "(1.0 = the pool itself is the bottleneck: add workers)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_SPINE_PUT_OVERLAP,
            "Fraction of dispatched batches whose host->device put "
            "completed entirely behind the in-flight step (1.0 = "
            "transfer fully hidden by compute)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_SPINE_RING_DEPTH,
            "Configured device-put staging ring depth (0 = spine off)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_ROLE,
            "1 on the series matching this process's replication role",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_EPOCH,
            "Current fencing epoch (bumped by every promotion)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_REPLICATION_DELTAS,
            "Replication deltas, by direction (shipped on the primary, "
            "applied on the standby)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_REPLICATION_SNAPSHOTS,
            "Full-state replication snapshots, by direction",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_REPLICATION_LAG,
            "Primary: seconds since the last acked delta; standby: "
            "seconds since the last frame (the watchdog's clock)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_REPLICATION_FENCED,
            "Stale-epoch writes rejected, by path "
            "(checkpoint/offsets/frame)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_FAILOVERS,
            "Standby promotions performed by this process",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_OFFSET_DEFER_DROPPED,
            "Deferred-confirmation offset entries shed at the cap "
            "(each = a bounded replay on restart, never silent loss)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_RESTORE_PARTIAL,
            "Boots whose snapshot had a metrics leg that could not be "
            "hydrated (geometry change): span leg restored, metrics "
            "head cold-started",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_FRAME_CORRUPT,
            "Frames that failed checksum verification, by hop — each "
            "one is corruption caught at a boundary and quarantined, "
            "never merged into sketch state",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_FRAME_VERSION,
            "Columnar frame format version this process writes "
            "(mixed values across a fleet = rolling upgrade in flight)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_QUERY_REQUESTS,
            "Query-plane requests, by endpoint and HTTP status code",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_QUERY_LATENCY,
            "Query-plane request latency (host-side numpy over the "
            "cached state snapshot)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_QUERY_STALENESS,
            "Bound on how old query answers are: snapshot age plus "
            "replication lag on a read replica",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_EXEMPLARS_CAPTURED,
            "Exemplar trace ids captured at anomaly-flag time (each "
            "links a flag to a concrete Jaeger trace)",
        )
        self.registry.counter_add(
            tele_metrics.ANOMALY_EXEMPLARS_CAPTURED, 0.0
        )
        self.registry.describe(
            tele_metrics.ANOMALY_PHASE_SECONDS,
            "Batch-lifecycle phase latency (decode/verify/tensorize/"
            "stage/dispatch/harvest/flag) — the promoted per-phase "
            "timers, one observation per flush/batch",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_SPINE_PUT_WAIT,
            "Seconds the pump waited on a staged batch's device put "
            "(0 = the transfer hid entirely behind the in-flight step)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_HARVEST_LAG,
            "Submit-to-harvest detection lag per fetched report (the "
            "p99 the lag SLO gates, now Prometheus-owned)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_SPINE_OVERLAP_WINDOW,
            "Windowed put-overlap ratio (one observation per scrape "
            "window) — the histogram companion to the lifetime gauge",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_QUERY_STALENESS_HIST,
            "Per-answer query staleness bound (histogram companion to "
            "the anomaly_query_staleness_seconds gauge)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_HISTORY_SEGMENTS,
            "Segment files in the on-disk history log (sealed + active)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_HISTORY_BYTES,
            "Total bytes across history segments (bounded by the "
            "per-rung retention caps)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_HISTORY_COMPACTIONS,
            "Retention-ladder folds performed (N fine-rung records "
            "monoid-merged into one coarse record)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_HISTORY_OLDEST,
            "Age of the oldest history record — how far back time "
            "travel reaches",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_HISTORY_READ_LATENCY,
            "History range-read latency (seek + memcpy + verified "
            "decode + monoid merge per query)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_SELFTRACE_TRACES,
            "Sampled batch-lifecycle traces exported by the self-tracer",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_SELFTRACE_SPANS,
            "Spans exported inside self-trace batch traces",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_FLIGHT_EVENTS,
            "Flight-recorder events recorded, by kind (role moves, "
            "shed/brownout steps, fence hits, quarantines, snapshots)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_FLIGHT_DUMPS,
            "Flight-recorder evidence dumps written, by transition "
            "reason (each one is a postmortem file on disk)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_MITIGATION_ACTIONS,
            "Mitigations actuated by the remediation controller, by "
            "actuator (flagd flag flips / sampling-policy promotions)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_MITIGATION_ROLLBACKS,
            "Actuations automatically rolled back after the verified-"
            "recovery deadline expired",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_MITIGATION_VERIFIED,
            "Mitigations whose recovery the controller VERIFIED with "
            "its own detection heads (clean-streak within deadline)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_MITIGATION_FAILED,
            "Mitigations that did not recover the system within the "
            "deadline (service parked in MITIGATION_FAILED)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_MITIGATION_ACTIVE,
            "Services currently under an active or failed mitigation",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_TIME_TO_MITIGATE,
            "Fault-flagged to verified-recovery interval per mitigated "
            "incident — time-to-mitigate beside time-to-detect",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_PREFLIGHT_VERDICTS,
            "Counterfactual pre-flight verdicts by direction "
            "(released = the shadow replay proved the mitigation "
            "clears the heads; refused = it would not have helped)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_PREFLIGHT_REFUSED,
            "Pre-flight refusals by reason (still_flagged / deadline "
            "/ insufficient_records / error) — every one is a "
            "mitigation that did NOT fire, with flight evidence",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_PREFLIGHT_SECONDS,
            "Act-decision to shadow-verdict wall interval — what the "
            "counterfactual gate adds in front of every actuation",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_COLLECTOR_KEEP_RATIO,
            "Storage fraction the pushed collector tail-sampling "
            "policy implies (promoted services keep 1.0, quiet ones "
            "the base head-sampling rate)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_FLEET_SHARDS_LIVE,
            "Shards this member currently believes alive (itself "
            "included) — N means full fleet, less means a keyspace "
            "slice is browned out or resharded",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_FLEET_RING_VERSION,
            "Stable digest of the current ring member set (all live "
            "members agree on this value; disagreement = a ring split)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_FLEET_FROZEN,
            "1 while the reshard budget is exhausted: the ring holds "
            "its last state and membership changes are refused",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_RESHARDS,
            "Ring membership changes APPLIED (leave + join), each one "
            "a keyspace reassignment",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_RESHARDS_REFUSED,
            "Membership changes REFUSED by the exhausted reshard "
            "budget — the flapping-shard audit trail",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_FLEET_SHARD_SPANS,
            "Spans ingested by this shard, labeled with its shard id "
            "(the per-shard ingest-rate panel)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_PROCESS_RSS,
            "Resident set size of this process (VmRSS) — the keyspace "
            "budget watchdog's denominator",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_KEYSPACE_ROWS,
            "Live interned service keys (detector state rows in use)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_KEYSPACE_CAPACITY,
            "Intern-table key budget (num_services minus the overflow "
            "slot)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_KEYSPACE_FILL,
            "Intern-table fill fraction (rows/capacity) — the "
            "keyspace ladder's pressure signal",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_KEYSPACE_LEVEL,
            "Keyspace degradation-ladder level: 0 normal, 1 evict "
            "idle, 2 throttle new keys, 3 collapse new keys to "
            "overflow, 4 shed ingest (429)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_KEYSPACE_GENERATION,
            "Keyspace generation epoch — bumped by every eviction "
            "sweep; frames refuse to merge across a bump",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_KEYSPACE_EVICTED,
            "Idle keys evicted into history (their ids recycled)",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_KEYSPACE_FREE_IDS,
            "Retired intern ids awaiting reuse",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_KEYSPACE_THROTTLED,
            "New keys refused by the per-tenant admission throttle "
            "(ladder level 2+), by tenant",
        )
        self.registry.describe(
            tele_metrics.ANOMALY_KEYSPACE_OVERFLOW,
            "New keys collapsed into the overflow bucket under "
            "keyspace pressure (ladder level 3+), by tenant",
        )
        self._exemplars_seen = 0
        # Mint the per-hop corrupt series at zero (like the shed-lane
        # counters): "this number never moved" must be a visible 0.
        for hop in ("ingest", "replication", "checkpoint", "history"):
            self.registry.counter_add(
                tele_metrics.ANOMALY_FRAME_CORRUPT, 0.0, hop=hop
            )
        self.registry.gauge_set(
            tele_metrics.ANOMALY_FRAME_VERSION,
            float(frame_fmt.write_version()),
        )
        if ckpt_corrupt:
            self.registry.counter_add(
                tele_metrics.ANOMALY_CHECKPOINT_CORRUPT, 1.0
            )
            self.registry.counter_add(
                tele_metrics.ANOMALY_FRAME_CORRUPT, 1.0, hop="checkpoint"
            )
            self.flight.record("quarantine", hop="checkpoint", frames=1)
        # The supervision tree: restart hooks + probes are registered
        # for each ingest leg; passive (run_step-guarded) components
        # register here, thread/server-backed ones in start().
        self._supervisor = Supervisor(registry=self.registry)
        self._supervisor.register(
            "pump", base_backoff_s=0.1, max_backoff_s=5.0,
            restart_budget=10, budget_window_s=60.0,
        )
        try:
            ov = overload_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        # Device-put spine (knob registry: utils.config.SPINE_KNOBS;
        # engine: runtime.spine): a staging ring the pump thread packs
        # and copies through on a side stream, so the host→device put of
        # batch k+1 overlaps batch k's in-flight step. Ring 0 restores
        # the inline pack+put path.
        try:
            sp = spine_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        # Sharded-fleet knobs (registry: utils.config.FLEET_KNOBS;
        # engines: runtime.fleet membership/ring + runtime.aggregator
        # scatter-gather). Parsed before the pipeline below — the
        # per-tenant quota and tenant map are pipeline constructor
        # knobs; the membership leg itself is built after the health
        # surface exists (its heartbeats poll peer /healthz).
        try:
            fl = fleet_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        self._fleet_shards = int(fl["ANOMALY_FLEET_SHARDS"])
        self._fleet_index = int(fl["ANOMALY_FLEET_SHARD_INDEX"])
        self._fleet_peers_raw = str(fl["ANOMALY_FLEET_PEERS"])
        self._fleet_query_peers_raw = str(fl["ANOMALY_FLEET_QUERY_PEERS"])
        self._fleet_repl_peers_raw = str(fl["ANOMALY_FLEET_REPL_PEERS"])
        self._fleet_vnodes = int(fl["ANOMALY_FLEET_VNODES"])
        self._fleet_services = [
            s.strip()
            for s in str(fl["ANOMALY_FLEET_SERVICES"]).split(",")
            if s.strip()
        ]
        self._fleet_heartbeat_s = float(fl["ANOMALY_FLEET_HEARTBEAT_S"])
        self._fleet_dead_after_s = float(fl["ANOMALY_FLEET_DEAD_AFTER_S"])
        self._fleet_rejoin_after_s = float(
            fl["ANOMALY_FLEET_REJOIN_AFTER_S"]
        )
        self._fleet_reshard_budget = int(
            fl["ANOMALY_FLEET_RESHARD_BUDGET"]
        )
        self._fleet_reshard_refill_s = float(
            fl["ANOMALY_FLEET_RESHARD_REFILL_S"]
        )
        self._tenant_map = fleet_tenant_map(fl["ANOMALY_FLEET_TENANTS"])
        self._tenant_quota_rows_s = float(
            fl["ANOMALY_FLEET_TENANT_QUOTA_ROWS_S"]
        )
        self._aggregator_port_req = int(fl["ANOMALY_AGGREGATOR_PORT"])
        self._aggregator_timeout_s = float(
            fl["ANOMALY_AGGREGATOR_TIMEOUT_S"]
        )
        self.fleet = None
        self.aggregator_service = None
        # Adoption surface (filled in by the fleet block below when
        # ANOMALY_FLEET_REPL_PEERS wires the successor mirrors).
        self._fleet_repl_addrs: dict[str, str] = {}
        self._adoption_mirror = None
        self._adoption_target: str | None = None
        self._adoption_fence = None
        self._adoptions_total = 0
        self._adoptions_refused: dict[str, int] = {}
        self._adoption_seen = {"total": 0}
        self._last_adoption_tta: float | None = None

        # Verdict provenance plane (knob registry:
        # utils.config.PROVENANCE_KNOBS; engine: runtime.provenance).
        # The engine rings head trajectories off the already-harvested
        # reports and assembles one bounded evidence bundle per flagged
        # service at capture time — the pipeline owns the flag-time
        # hook, so the engine must exist before the pipeline does.
        try:
            pv = provenance_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        self.provenance = None
        self._explain_poster = None
        self._provenance_ring = int(pv["ANOMALY_PROVENANCE_RING"])
        self._explanations_seen = 0
        if int(pv["ANOMALY_PROVENANCE_ENABLE"]):
            self.provenance = provenance.ProvenanceEngine(
                self.detector.config,
                topk=int(pv["ANOMALY_PROVENANCE_TOPK"]),
                trajectory_windows=int(
                    pv["ANOMALY_PROVENANCE_TRAJECTORY_WINDOWS"]
                ),
                epoch_fn=lambda: self._fence.epoch,
            )
            if self._otlp_export_endpoint:
                # Bundles double as OTLP log records on the same
                # collector pipeline the selftrace spans ride.
                from .otlp_export import OtlpHttpLogsExporter

                self._explain_poster = OtlpHttpLogsExporter(
                    self._otlp_export_endpoint
                )
            self.flight.record(
                "provenance", op="enabled",
                ring=self._provenance_ring,
                topk=int(pv["ANOMALY_PROVENANCE_TOPK"]),
                export=bool(self._explain_poster is not None),
            )
        # Key lifecycle plane (knob registry: utils.config.
        # KEYSPACE_KNOBS; engine: runtime.keyspace): the pipeline owns
        # the ladder + per-tenant new-key admission; the manager below
        # owns the watchdog thread and the idle-key evictor.
        try:
            ks = keyspace_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        self._keyspace_cfg = ks
        self.pipeline = DetectorPipeline(
            self.detector,
            flags=flags,
            on_report=self._on_report,
            batch_size=self.batch_size,
            # Remote/tunneled devices: readback RTT dominates — set an
            # interval (and/or async) so dispatch never waits on fetch.
            harvest_interval_s=float(dk["ANOMALY_HARVEST_INTERVAL"]),
            harvest_async=bool(int(dk["ANOMALY_HARVEST_ASYNC"])),
            # Adaptive width (on by default): bounds the report skip
            # rate when readback RTT outpaces the batch interval — the
            # 10× stress regime. Every ladder width runs once in the
            # background below so an escalation meets warm caches
            # mid-incident.
            adaptive_batching=bool(int(dk["ANOMALY_ADAPTIVE_BATCH"])),
            # Bounded admission + brownout (the overload half of the
            # fault matrix; knob registry: utils.config.OVERLOAD_KNOBS).
            queue_max_rows=ov["ANOMALY_QUEUE_MAX_ROWS"],
            high_watermark=ov["ANOMALY_QUEUE_HIGH_WATERMARK"],
            low_watermark=ov["ANOMALY_QUEUE_LOW_WATERMARK"],
            brownout_hold_s=ov["ANOMALY_BROWNOUT_HOLD_S"],
            brownout_max_level=ov["ANOMALY_BROWNOUT_MAX_LEVEL"],
            retry_after_s=ov["ANOMALY_RETRY_AFTER_S"],
            # Query plane: exemplar trace ids captured at flag time —
            # every anomaly answer links to a concrete Jaeger trace —
            # and the recently-seen candidate keys top-k scores.
            exemplar_ring=self._query_exemplars,
            hh_candidates=self._query_candidates,
            # Device-put spine (SPINE_KNOBS; runtime.spine).
            spine_ring=sp["ANOMALY_SPINE_RING"],
            spine_overlap=bool(int(sp["ANOMALY_SPINE_OVERLAP"])),
            spine_chunk_rows=sp["ANOMALY_SPINE_CHUNK_ROWS"],
            # Self-telemetry (SELFTRACE_KNOBS; runtime.selftrace): the
            # promoted phase histograms + sampled batch-lifecycle traces.
            phase_observe=self._observe_phase,
            selftrace=self.selftrace,
            # Per-tenant namespaces (FLEET_KNOBS; runtime.fleet): one
            # noisy tenant sheds alone, ahead of the shared ladder.
            tenant_of=(
                (lambda name: fleet.tenant_of(name, self._tenant_map))
                if self._tenant_quota_rows_s > 0 else None
            ),
            tenant_quota_rows_s=self._tenant_quota_rows_s,
            # Verdict provenance (PROVENANCE_KNOBS; runtime.provenance):
            # evidence bundles assembled at flag time on the harvester.
            provenance=self.provenance,
            explain_ring=self._provenance_ring,
            # Key lifecycle ladder (KEYSPACE_KNOBS; runtime.keyspace):
            # evict idle → throttle new keys per tenant → collapse new
            # keys to overflow → 429 through every ingest door.
            keyspace_enable=bool(int(ks["ANOMALY_KEYSPACE_ENABLE"])),
            keyspace_high_watermark=ks["ANOMALY_KEYSPACE_HIGH_WATERMARK"],
            keyspace_low_watermark=ks["ANOMALY_KEYSPACE_LOW_WATERMARK"],
            keyspace_hold_s=ks["ANOMALY_KEYSPACE_HOLD_S"],
            keyspace_newkey_rate=ks["ANOMALY_KEYSPACE_NEWKEY_RATE"],
            keyspace_retry_after_s=ks["ANOMALY_KEYSPACE_RETRY_AFTER_S"],
        )
        # Watermark gauges are static config — export once so every
        # scrape can judge anomaly_queue_rows against them; and mint the
        # per-lane shed series at zero so the error-lane invariant
        # ("this number never moves") is a visible 0, not a missing row.
        if self.pipeline.queue_max_rows:
            self.registry.gauge_set(
                tele_metrics.ANOMALY_QUEUE_WATERMARK,
                float(self.pipeline._high_rows), mark="high",
            )
            self.registry.gauge_set(
                tele_metrics.ANOMALY_QUEUE_WATERMARK,
                float(self.pipeline._low_rows), mark="low",
            )
        for lane in ("ok", "error"):
            for cause in ("overflow", "brownout"):
                self.registry.counter_add(
                    tele_metrics.ANOMALY_SHED_ROWS, 0.0,
                    lane=lane, cause=cause,
                )
        self._shed_seen = {"ok": 0, "error": 0}
        self._brownout_seen = 0
        self._kafka_paused = False
        # SATURATED surfaces beside (and ordered below) DEGRADED: the
        # supervisor reports it on overall_state()/anomaly_saturated,
        # /healthz (below) serves it to probes.
        self._supervisor.set_saturation_probe(lambda: self.pipeline.saturated)
        # Role/epoch surface beside saturation: anomaly_role/anomaly_epoch
        # from the supervisor's tick, role+epoch on /healthz below —
        # how a probe tells a healthy standby from a degraded primary.
        self._supervisor.set_role_probe(
            lambda: (self.role, self._fence.epoch)
        )
        if self.pipeline.adaptive_batching:
            self._warm_thread = threading.Thread(
                target=self._warm_widths_quietly,
                name="width-ladder-warmup", daemon=True,
            )
            self._warm_thread.start()
        # Positional re-adoption, NOT name-by-name re-interning: a
        # checkpoint written after an eviction sweep carries
        # EVICTED_SLOT tombstones, and interning each live name in
        # sequence would compact past them — shifting every later id
        # off the sketch rows the restored state holds for it. The
        # keyspace generation rides along so a restored primary keeps
        # refusing frames from before its last eviction sweep.
        self.pipeline.tensorizer.adopt_names(restored_names)
        if meta is not None:
            self.pipeline.tensorizer.generation = int(
                meta.get("generation") or 0
            )
        for name in self._fleet_services:
            # Fleet mode pre-interns ONE shared service table in knob
            # order on every shard: CMS cells fold the service id into
            # the key hash, so cross-shard frame adoption (reshard) is
            # bit-exact only when the tables agree —
            # fleet.merge_shard_arrays refuses drifted tables. A
            # checkpoint restored above already carries the same order
            # (interning an existing name is a no-op).
            self.pipeline.tensorizer.service_id(name)

        # Parallel host-ingest engine (runtime.ingest_pool): N decode
        # workers between the receivers and the pipeline — batched
        # native decode, pooled buffers, one tensorize+merge per flush.
        # Workers=0 keeps the serial in-thread decode (the receivers'
        # on_columnar path). Knob registry: utils.config.INGEST_KNOBS.
        try:
            ing = ingest_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        self.ingest_pool = None
        if ing["ANOMALY_INGEST_WORKERS"] > 0:
            from .ingest_pool import IngestPool

            self.ingest_pool = IngestPool(
                submit_columns=self.pipeline.submit_columns,
                tensorizer=self.pipeline.tensorizer,
                workers=ing["ANOMALY_INGEST_WORKERS"],
                coalesce_max=ing["ANOMALY_INGEST_COALESCE"],
                max_pending=ing["ANOMALY_INGEST_MAX_PENDING"],
                phase_observe=self._observe_phase,
                selftrace=self.selftrace,
                native_threads=ing["ANOMALY_INGEST_NATIVE_THREADS"],
                shard_min_bytes=ing["ANOMALY_INGEST_SHARD_MIN_BYTES"],
            )
            self._supervisor.register(
                "ingest-pool", base_backoff_s=0.1, max_backoff_s=5.0,
                restart=self.ingest_pool.restart_workers,
                probe=lambda: (
                    self.ingest_pool is None or self.ingest_pool.alive()
                ),
            )
        self._pool_seen = {
            "flushes": 0, "flushed_spans": 0, "coalesced_requests": 0,
            "frames_corrupt": 0, "busy_s": 0.0, "wall_t": time.monotonic(),
        }
        # Native front door (runtime/frontdoor.py): opt-in second
        # producer into the SAME bounded decode queue — socket→scratch
        # →scan with zero Python per payload. Resolved (and validated)
        # at boot even when disabled, so a typo'd knob fails fast;
        # started only from run()/promotion on a serving primary.
        # Knob registry: utils.config.FRONTDOOR_KNOBS.
        try:
            self._frontdoor_cfg = frontdoor_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        self.frontdoor = None
        if (
            int(self._frontdoor_cfg["ANOMALY_FRONTDOOR_ENABLE"]) == 1
            and self.ingest_pool is not None
        ):
            # No fallback to the Python receiver alone: a front door
            # that was asked for and did not build refuses the boot
            # with the compiler's error.
            from . import native as _native

            if not _native.frontdoor_available():
                raise RuntimeError(
                    "ANOMALY_FRONTDOOR_ENABLE=1 but the native front "
                    f"door did not build: {_native.frontdoor_load_error()}"
                )
        # Orders flushes whose pool ticket hadn't resolved within the
        # pump's wait: offsets are withheld until the flush confirms,
        # so a checkpoint can never persist offsets for records that
        # never reached the pipeline (at-least-once: a crash before
        # confirmation replays them from the broker on resume). BOUNDED
        # (ANOMALY_OFFSET_DEFER_MAX): a permanently-failing flush path
        # sheds the oldest entry (counted; its records replay on
        # restart) and forces a checkpoint barrier.
        from .kafka_orders import DeferredOffsets

        self._deferred_offsets = DeferredOffsets(cap=self._offset_defer_max)
        self._defer_dropped_seen = 0

        # The OTLP metrics leg: /v1/metrics → feed → metrics head. The
        # feed keeps its OWN service table: results join on service NAME
        # at the export surface, and sharing the span tensorizer's table
        # would let metric-only scrape jobs (kafka, node exporters, …)
        # exhaust the span detector's service slots.
        from ..models.metrics_head import MetricsHeadConfig

        self.metrics_feed = MetricsFeed(
            MetricsHeadConfig(num_services=config.num_services),
            on_report=self._on_metrics_report,
            device=self.device,
        )
        if meta is not None:
            restored_feed = checkpoint.restore_metrics_feed(
                meta, self.metrics_feed
            )
            if not restored_feed and (
                meta.get("_metrics_arrays")
                or meta.get("metrics_config") is not None
            ):
                # The snapshot HAD a metrics leg we could not hydrate
                # (geometry change — restore_metrics_feed logged the
                # mismatching key): a partial restore an operator must
                # be able to see, not infer from a cold metrics head.
                self.registry.counter_add(
                    tele_metrics.ANOMALY_RESTORE_PARTIAL, 1.0
                )
        self._metric_series_seen: set[tuple[str, str]] = set()
        # Logs leg (the collector's third signal,
        # otelcol-config.yml:128-131): /v1/logs → bounded store (the
        # OpenSearch-analogue index, queryable for debugging) + a
        # severity-rate lane into the metrics head so an error-log burst
        # is detectable even when the producing service emits no spans.
        from ..telemetry.logstore import LogStore

        self.log_store = LogStore()
        self.max_body_bytes = int(dk["ANOMALY_OTLP_MAX_BODY"])
        self._grpc_port_req = int(dk["ANOMALY_OTLP_GRPC_PORT"])
        # A standby answers no ingest until promotion, and a
        # boot-fenced stale primary answers none EVER (a fenced process
        # that kept serving would hold the orchestrator's readiness and
        # the collector's traffic on a replica whose writes are all
        # rejected): receivers are constructed below only once the
        # fence evidence is in, and at promote time for standbys.
        self.receiver = None
        self.grpc_receiver = None
        self.exporter = tele_metrics.PrometheusExporter(
            self.registry, port=self.metrics_port, health=self._healthz
        )
        self._orders = None
        self._quarantine_seen = 0
        kafka_addr = str(dk["KAFKA_ADDR"]) or None
        if kafka_addr:
            from .kafka_orders import OrdersSource  # gated import

            self._orders = OrdersSource(kafka_addr)
            # Fencing: commits are epoch-tagged + fence-guarded, and a
            # resurrected primary reads the tag its successor left on
            # the group's committed offsets BEFORE its first write —
            # the broker doubles as a fencing witness.
            self._orders.fence = self._fence
            self._fence.observe(self._orders.last_committed_epoch())
            if restored_offsets:
                # The snapshot's offsets win over broker-committed ones:
                # sketch state corresponds to THEM (checkpoint.py module
                # docstring — replay past the snapshot double-counts).
                self._orders.seek(restored_offsets)
            self._supervisor.register(
                "kafka-orders", base_backoff_s=0.5, max_backoff_s=15.0,
            )
        # Time-travel tier (runtime.history): the store opens for every
        # role that has the directory (range reads are disk-only); the
        # COMPACTION WRITER is built here but started only by a serving
        # role (start() on a primary, promote() on a standby). Opening
        # the store OBSERVES the largest epoch already on disk — the
        # fourth fencing path: a resurrected stale primary sharing the
        # history volume learns it was superseded before the boot-fence
        # check below, exactly like the checkpoint volume.
        if self._history_dir:
            self.history_store = history.HistoryStore(
                self._history_dir,
                segment_bytes=self._history_segment_bytes,
                fence=self._fence,
                retention_s=self._history_retention,
            )
            self.history_reader = history.HistoryReader(
                self.history_store, rungs=self._history_rungs
            )
            self.history_writer = history.HistoryWriter(
                self.history_store,
                snapshot_fn=self._replication_snapshot,
                rungs=self._history_rungs,
                interval_s=self._history_interval_s,
                capture_spans=self._history_spans,
                # Per-service capture rates (the map form of the spans
                # knob); the remediation sampling actuator re-publishes
                # over this live (flagged service → keep-100%).
                span_sample=self._history_span_rates or None,
                service_names_fn=(
                    lambda: self.pipeline.tensorizer.service_names
                ),
            )
            if self._history_spans:
                self.pipeline.history_capture = self.history_writer.capture
            self.flight.record(
                "history", dir=self._history_dir,
                rungs=list(self._history_rungs),
                retention_s=list(self._history_retention),
                spans=self._history_spans,
                replay_rate=self._history_replay_rate,
            )
        # Key lifecycle watchdog + evictor (runtime.keyspace): built
        # after the history tier so eviction fold records have a
        # writer to land in; started only by a SERVING role (start()
        # below / promote()) — a standby mirrors the primary's state
        # verbatim and must not run local eviction sweeps that would
        # diverge its generation.
        self.keyspace = None
        self._keyspace_level_seen = 0
        self._keyspace_evicted_seen = 0
        self._keyspace_tenant_seen: dict[str, dict[str, float]] = {
            "throttled": {}, "overflow": {},
        }
        if int(ks["ANOMALY_KEYSPACE_ENABLE"]):
            from .keyspace import KeyspaceManager

            self.keyspace = KeyspaceManager(
                self.pipeline,
                idle_s=ks["ANOMALY_KEYSPACE_IDLE_S"],
                evict_batch=ks["ANOMALY_KEYSPACE_EVICT_BATCH"],
                rss_budget_mb=ks["ANOMALY_KEYSPACE_RSS_MB"],
                protected=self._fleet_services,
                history_writer=self.history_writer,
                flight=self.flight,
            )
            self.flight.record(
                "keyspace", op="enabled",
                capacity=self.pipeline.tensorizer.capacity,
                idle_s=float(ks["ANOMALY_KEYSPACE_IDLE_S"]),
                evict_batch=int(ks["ANOMALY_KEYSPACE_EVICT_BATCH"]),
                rss_budget_mb=float(ks["ANOMALY_KEYSPACE_RSS_MB"]),
            )
        # Closed-loop auto-mitigation (knob registry:
        # utils.config.REMEDIATION_KNOBS; engine: runtime.remediation).
        # Constructed for EVERY role — a standby observes episodes so a
        # promotion inherits warm streaks — but only an enabled PRIMARY
        # ever actuates, and every actuator write is fence-guarded
        # (path="remediation", the fifth fenced write path).
        try:
            rk = remediation_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        rem_actuators: list = []
        rem_url = str(rk["ANOMALY_REMEDIATION_FLAG_URL"])
        rem_timeout_s = float(rk["ANOMALY_REMEDIATION_TIMEOUT_S"])
        if rem_url or not isinstance(flags, OfrepClient):
            # OFREP is evaluate-only: without a writable store a flagd
            # actuator needs the remote flag-editor URL; with neither,
            # only the sampling actuator runs.
            rem_actuators.append(remediation.FlagdActuator(
                store=None if rem_url else flags,
                url=rem_url,
                timeout_s=rem_timeout_s,
            ))
        if int(rk["ANOMALY_REMEDIATION_SAMPLING"]):
            rem_actuators.append(remediation.SamplingActuator(
                publish=self._publish_sampling_policy,
                base_policy=dict(self._history_span_rates),
                exemplar_fn=self._exemplars_for,
            ))
        # Collector-steering leg (ROADMAP item 4): when a policy file
        # path or endpoint is configured, the flagged service's traces
        # tail-sample at 100% (exemplar-seeded) while quiet services
        # head-sample at the base keep — the storage-reduction ratio
        # rides the scrape as anomaly_collector_keep_ratio.
        self._collector_actuator = None
        col_path = str(rk["ANOMALY_REMEDIATION_COLLECTOR_PATH"])
        col_url = str(rk["ANOMALY_REMEDIATION_COLLECTOR_URL"])
        if col_path or col_url:
            self._collector_actuator = remediation.CollectorActuator(
                policy_path=col_path,
                url=col_url,
                base_keep=float(
                    rk["ANOMALY_REMEDIATION_COLLECTOR_BASE_KEEP"]
                ),
                exemplar_fn=self._exemplars_for,
                # Tombstoned (evicted) slots are not services — a
                # sampling rule for one would be noise in the policy.
                services_fn=(
                    lambda: [
                        n
                        for n in self.pipeline.tensorizer.service_names
                        if n != EVICTED_SLOT
                    ]
                ),
                timeout_s=rem_timeout_s,
            )
            rem_actuators.append(self._collector_actuator)
        # Counterfactual pre-flight gate (knob registry:
        # utils.config.SHADOW_KNOBS; engine: runtime.shadow): opt-in,
        # and a gate that cannot replay is a misconfiguration that
        # refuses to boot — never a silent rubber stamp.
        try:
            sk = shadow_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        self.shadow_verifier: shadow.ShadowVerifier | None = None
        if int(sk["ANOMALY_SHADOW_ENABLE"]):
            if self.history_reader is None or not self._history_spans:
                raise SystemExit(
                    "ANOMALY_SHADOW_ENABLE=1 needs the recorded replay "
                    "corpus: set ANOMALY_HISTORY_DIR and turn on "
                    "ANOMALY_HISTORY_SPANS span capture"
                )
            self.shadow_verifier = shadow.ShadowVerifier(
                self.history_reader,
                self.detector.config,
                batch_size=self.batch_size,
                window_s=float(sk["ANOMALY_SHADOW_WINDOW_S"]),
                deadline_s=float(sk["ANOMALY_SHADOW_DEADLINE_S"]),
                rate_target=float(sk["ANOMALY_SHADOW_RATE"]),
                min_records=int(sk["ANOMALY_SHADOW_MIN_RECORDS"]),
                flight=self.flight,
                bundle_fn=self._bundle_for,
                device=self.device,
            )
            self.flight.record(
                "preflight", op="enabled",
                window_s=float(sk["ANOMALY_SHADOW_WINDOW_S"]),
                deadline_s=float(sk["ANOMALY_SHADOW_DEADLINE_S"]),
            )
        self.remediation = remediation.RemediationController(
            rem_actuators,
            enabled=bool(int(rk["ANOMALY_REMEDIATION_ENABLE"])),
            act_batches=int(rk["ANOMALY_REMEDIATION_ACT_BATCHES"]),
            clear_batches=int(rk["ANOMALY_REMEDIATION_CLEAR_BATCHES"]),
            budget=int(rk["ANOMALY_REMEDIATION_BUDGET"]),
            budget_refill_s=float(
                rk["ANOMALY_REMEDIATION_BUDGET_REFILL_S"]
            ),
            deadline_s=float(rk["ANOMALY_REMEDIATION_DEADLINE_S"]),
            rollback=bool(int(rk["ANOMALY_REMEDIATION_ROLLBACK"])),
            role_fn=lambda: self.role,
            fence=self._fence,
            flight=self.flight,
            preflight=(
                self._preflight_mitigation
                if self.shadow_verifier is not None else None
            ),
            bundle_fn=self._bundle_for,
        )
        self._remediation_seen: dict[str, int] = {}
        if self.remediation.enabled:
            self.flight.record(
                "mitigation", op="enabled",
                actuators=[a.name for a in rem_actuators],
            )
        # Saturation-driven autoscaler (knob registry:
        # utils.config.AUTOSCALE_KNOBS; engine: runtime.autoscale):
        # strictly opt-in like remediation — default is observe-only —
        # proposing shard split on sustained brownout and join on
        # sustained idle behind the reused token-bucket + two-edge
        # hysteresis, with every decision fence-checked
        # (path="autoscale", the sixth fenced write path). The daemon
        # cannot spawn a shard itself: a landed proposal is
        # evidence-dumped and exported (anomaly_autoscale_target_shards
        # + /healthz), and the deployment layer makes the resize one
        # FLEET_KNOBS change end-to-end.
        try:
            ak = autoscale_config()
        except ConfigError as e:
            raise SystemExit(str(e)) from e
        self.autoscaler = autoscale.AutoscaleController(
            enabled=bool(int(ak["ANOMALY_AUTOSCALE_ENABLE"])),
            act_batches=int(ak["ANOMALY_AUTOSCALE_ACT_BATCHES"]),
            clear_batches=int(ak["ANOMALY_AUTOSCALE_CLEAR_BATCHES"]),
            budget=int(ak["ANOMALY_AUTOSCALE_BUDGET"]),
            refill_s=float(ak["ANOMALY_AUTOSCALE_REFILL_S"]),
            high_water=float(ak["ANOMALY_AUTOSCALE_HIGH_WATER"]),
            low_water=float(ak["ANOMALY_AUTOSCALE_LOW_WATER"]),
            min_shards=int(ak["ANOMALY_AUTOSCALE_MIN_SHARDS"]),
            max_shards=int(ak["ANOMALY_AUTOSCALE_MAX_SHARDS"]),
            shards_fn=self._fleet_shard_count,
            role_fn=lambda: self.role,
            fence=self._fence,
            flight=self.flight,
        )
        self._autoscale_seen: dict[str, int] = {}
        self._autoscale_shed_seen = 0
        if self.autoscaler.enabled:
            self.flight.record("autoscale", op="enabled")
        # Sharded fleet membership (knob registry:
        # utils.config.FLEET_KNOBS; engine: runtime.fleet): a
        # supervised heartbeat loop over the peer shards' /healthz
        # surfaces feeding the consistent-hash ring, with the
        # double-check + hysteresis + reshard-budget guardrails. Every
        # ROLE runs it (a standby's view of the fleet must be warm at
        # promotion). The optional embedded aggregator serves the
        # fleet-global /query/* scatter-gather tier from this process
        # (ANOMALY_AGGREGATOR_PORT >= 0; the compose/k8s
        # anomaly-aggregator service runs it standalone instead).
        if self._fleet_shards > 1:
            peer_addrs = fleet.parse_peer_list(
                self._fleet_peers_raw, self._fleet_shards,
                self._fleet_index,
            )
            # Adoption mirrors (ANOMALY_FLEET_REPL_PEERS, index-aligned
            # like the heartbeat list): each shard subscribes a standby
            # to its RING-SUCCESSOR's replication stream, so when
            # membership declares that pair dead through the
            # double-check + budget guardrails, this daemon already
            # holds the victim's frame and adopts its keyspace with
            # zero operator action. Empty list = no automatic adoption
            # (the operator merge drill).
            self._fleet_repl_addrs = (
                fleet.parse_peer_list(
                    self._fleet_repl_peers_raw, self._fleet_shards,
                    self_index=-1, prefix="shard-",
                )
                if self._fleet_repl_peers_raw else {}
            )
            self.fleet = fleet.FleetMember(
                f"shard-{self._fleet_index}",
                peer_addrs,
                heartbeat_s=self._fleet_heartbeat_s,
                vnodes=self._fleet_vnodes,
                dead_after_s=self._fleet_dead_after_s,
                rejoin_after_s=self._fleet_rejoin_after_s,
                reshard_budget=self._fleet_reshard_budget,
                reshard_refill_s=self._fleet_reshard_refill_s,
                on_reshard=self._on_reshard,
                adoptive=bool(self._fleet_repl_addrs),
            )
            self._supervisor.register(
                "fleet", base_backoff_s=0.5, max_backoff_s=15.0,
                restart=self._restart_fleet,
                probe=lambda: (
                    self.fleet is None or self.fleet.alive()
                ),
            )
            if self._fleet_repl_addrs:
                # The mirror observes the SUCCESSOR's epoch domain —
                # never this shard's own fence (each shard is its own
                # primary; a peer's higher epoch must not fence us).
                self._adoption_fence = EpochFence()
                self._retarget_adoption_mirror(
                    list(self.fleet.membership.ring.members())
                )
            if self._aggregator_port_req >= 0:
                from .aggregator import (
                    AggregatorService,
                    FleetAggregator,
                )

                query_addrs = fleet.parse_peer_list(
                    self._fleet_query_peers_raw, self._fleet_shards,
                    self_index=-1,
                )
                self.aggregator_service = AggregatorService(
                    FleetAggregator(
                        query_addrs,
                        timeout_s=self._aggregator_timeout_s,
                        ring=self.fleet.membership.ring,
                        tenant_map=self._tenant_map,
                        live_fn=self._fleet_live_shards,
                    ),
                    registry=self.registry,
                    port=self._aggregator_port_req,
                )
        self._fleet_seen = {"reshards": 0, "refused": 0, "spans": 0}
        self._tenant_shed_seen: dict[str, int] = {}
        if self.fleet is not None:
            # Mint the fleet counters at zero (the shed-lane habit):
            # "no reshard ever happened" must be a visible 0.
            self.registry.counter_add(tele_metrics.ANOMALY_RESHARDS, 0.0)
            self.registry.counter_add(
                tele_metrics.ANOMALY_RESHARDS_REFUSED, 0.0
            )
            self.registry.counter_add(
                tele_metrics.ANOMALY_FLEET_SHARD_SPANS, 0.0,
                shard=f"shard-{self._fleet_index}",
            )
        if self.role == ROLE_PRIMARY and self._fence.stale():
            # Booted into a world that promoted past us (newer epoch on
            # the broker's commit tags or our own snapshot volume):
            # park FENCED instead of split-braining. Visible on
            # anomaly_role and /healthz; an operator redeploys us as a
            # standby (or retires us).
            self._become_fenced(at_boot=True)
        if self.role == ROLE_PRIMARY:
            self.receiver = self._make_http_receiver(self.otlp_port)
            # OTLP/gRPC :4317 — the reference collector's primary
            # ingress (otelcol-config.yml:5-8); every SDK defaults to
            # gRPC export.
            if self._grpc_port_req >= 0:
                try:
                    self.grpc_receiver = self._make_grpc_receiver(
                        self._grpc_port_req
                    )
                except ImportError:  # grpcio absent: HTTP leg serves
                    self.grpc_receiver = None
        if self.ckpt_path:
            self._supervisor.register(
                "checkpoint", base_backoff_s=1.0, max_backoff_s=60.0,
            )
        self._offsets: dict = dict(restored_offsets)
        # Guards _offsets against the replication session thread's
        # snapshot read: the pump thread mutates the map per poll,
        # and an unguarded concurrent iteration can raise
        # "dictionary changed size during iteration".
        self._offsets_lock = threading.Lock()
        # Live query plane (runtime.query): the engine consumes ONLY
        # the role-dispatched snapshot helper below — live state under
        # the dispatch lock on a primary, the replication mirror on a
        # standby — so queries fail over with the role and never tear
        # a step. Constructed for every role; a plain
        # standby (read-replica off) starts it only at promotion.
        self.query_engine = None
        self.query_service = None
        self.query_grpc = None
        self._query_started = False
        if self._query_port_req >= 0:
            from .query import QueryEngine, QueryService

            self.query_engine = QueryEngine(
                snapshot_fn=self._query_snapshot,
                role_fn=lambda: self.role,
                epoch_fn=lambda: self._fence.epoch,
                lag_fn=self._query_lag,
                max_staleness_s=self._query_max_staleness_s,
                timeline_depth=self._query_timeline,
                topk_default=self._query_topk,
                # /query/flight serves THIS process's event ring — the
                # on-demand half of the flight-recorder surface.
                flight_fn=self.flight.snapshot,
                # Time-travel range queries (from/to params + Grafana
                # true ranges) answer from the on-disk log; every
                # range read lands one latency observation.
                history=self.history_reader,
                read_observe=self._observe_history_read,
                # Evicted-key continuity: how far back the fallback
                # searches history for a name the live table dropped.
                evicted_lookback_s=self._query_evicted_lookback_s,
            )
            self.query_service = QueryService(
                self.query_engine, registry=self.registry,
                port=self._query_port_req,
            )
            if self._query_grpc_port_req >= 0:
                try:
                    from .query import QueryGrpcService

                    self.query_grpc = QueryGrpcService(
                        self.query_engine, registry=self.registry,
                        port=self._query_grpc_port_req,
                    )
                except ImportError:  # grpcio absent: HTTP leg serves
                    self.query_grpc = None
        self._stop = threading.Event()
        self._last_ckpt = time.monotonic()

    # -- supervised construction ---------------------------------------

    def _on_ingest_reject(self, transport: str):
        def bump(reason: str) -> None:
            self.registry.counter_add(
                tele_metrics.ANOMALY_INGEST_REJECTED, 1.0,
                transport=transport, reason=reason,
            )

        return bump

    def _make_http_receiver(self, port: int) -> OtlpHttpReceiver:
        return OtlpHttpReceiver(
            self.pipeline.submit,
            port=port,
            on_columnar=self.pipeline.submit_columnar,
            # Parallel ingest: raw protobuf trace bodies go to the
            # decode pool (late-bound so a restarted pool is followed).
            on_payload=(
                (lambda body: self.ingest_pool.submit(body))
                if self.ingest_pool is not None else None
            ),
            on_metric_records=self.metrics_feed.submit,
            on_log_records=self._on_logs,
            on_reject=self._on_ingest_reject("http"),
            max_body_bytes=self.max_body_bytes,
            # Backpressure: the pipeline's single admission question —
            # late-bound through self so a restarted receiver follows.
            retry_after=lambda: self.pipeline.admission_retry_after(),
        )

    def _make_grpc_receiver(self, port: int):
        from .otlp_grpc import OtlpGrpcReceiver

        return OtlpGrpcReceiver(
            self.pipeline.submit,
            port=port,
            on_columnar=self.pipeline.submit_columnar,
            on_payload=(
                (lambda body: self.ingest_pool.submit(body))
                if self.ingest_pool is not None else None
            ),
            on_metric_records=self.metrics_feed.submit,
            on_log_records=self._on_logs,
            on_reject=self._on_ingest_reject("grpc"),
            max_body_bytes=self.max_body_bytes,
            component_status=self._supervisor.health_status,
            retry_after=lambda: self.pipeline.admission_retry_after(),
        )

    def _restart_http_receiver(self) -> None:
        if self.role == ROLE_FENCED or self.receiver is None:
            return  # fenced: the stop was deliberate, stay down
        # Rebind on the RESOLVED port: env may have requested :0, and
        # the collector's exporter keeps pointing at the first bind.
        port = self.receiver.port
        try:
            self.receiver.stop()
        except Exception:  # noqa: BLE001 — a dead server may half-stop
            pass
        self.receiver = self._make_http_receiver(port)
        self.receiver.start()

    def _start_frontdoor(self) -> None:
        """Opt-in native OTLP/HTTP front door (FRONTDOOR_KNOBS).

        Started only on a serving primary, only when
        ANOMALY_FRONTDOOR_ENABLE=1, only with a decode pool to ticket
        into (ANOMALY_INGEST_WORKERS>0); without a pool the Python
        receiver stays the sole door and the log says why. A native
        library that did not build raises (checked at boot too).
        """
        fd = self._frontdoor_cfg
        if int(fd["ANOMALY_FRONTDOOR_ENABLE"]) != 1:
            return
        if self.frontdoor is not None:
            return
        log = logging.getLogger(__name__)
        if self.ingest_pool is None:
            log.warning(
                "ANOMALY_FRONTDOOR_ENABLE=1 ignored: the front door "
                "tickets into the decode pool and "
                "ANOMALY_INGEST_WORKERS=0 built none"
            )
            return
        from . import native as _native

        if not _native.frontdoor_available():
            raise RuntimeError(
                "ANOMALY_FRONTDOOR_ENABLE=1 but the native front door "
                f"did not build: {_native.frontdoor_load_error()}"
            )
        from .frontdoor import FrontDoorServer

        self.frontdoor = FrontDoorServer(
            self.ingest_pool,
            port=int(fd["ANOMALY_FRONTDOOR_PORT"]),
            max_body_bytes=self.max_body_bytes,
            pumps=int(fd["ANOMALY_FRONTDOOR_PUMPS"]),
            batch_max=int(fd["ANOMALY_FRONTDOOR_BATCH"]),
            max_conns=int(fd["ANOMALY_FRONTDOOR_MAX_CONNS"]),
            retry_after=lambda: self.pipeline.admission_retry_after(),
            on_reject=self._on_ingest_reject("frontdoor"),
            on_metric_records=self.metrics_feed.submit,
            on_log_records=self._on_logs,
        )
        log.info("native front door serving on :%d", self.frontdoor.port)

    def _restart_grpc_receiver(self) -> None:
        if self.role == ROLE_FENCED or self.grpc_receiver is None:
            return
        port = self.grpc_receiver.port
        try:
            self.grpc_receiver.stop(grace=0.5)
        except Exception:  # noqa: BLE001 — best-effort stop of the old receiver before rebind
            pass
        self.grpc_receiver = self._make_grpc_receiver(port)
        self.grpc_receiver.start()

    def _probe_grpc(self) -> bool:
        if self.role == ROLE_FENCED or self.grpc_receiver is None:
            return True  # deliberately down, nothing to restart
        from .health_probe import probe

        return probe(f"127.0.0.1:{self.grpc_receiver.port}", timeout_s=2.0)

    # -- logs ingress ---------------------------------------------------

    def _on_logs(self, docs) -> None:
        """OTLP logs → store + per-service severity counts.

        The decoders normalize severity at the boundary
        (logstore.normalize_severity), so docs arrive on the canonical
        5-level scale. ERROR/FATAL counts also enter the metrics head
        as a delta-sum lane per service — the "error-log rate" signal
        the spanmetrics leg can't see.
        """
        from .otlp_metrics import TEMPORALITY_DELTA, MetricRecord

        error_counts: dict[str, float] = {}
        n = 0
        for doc in docs:
            self.log_store.add(doc)
            n += 1
            if doc.severity in ("ERROR", "FATAL"):
                error_counts[doc.service] = error_counts.get(doc.service, 0.0) + 1.0
        if error_counts:
            self.metrics_feed.submit([
                MetricRecord(
                    service=svc, name="log_error_records", value=v,
                    kind="sum", monotonic=True, temporality=TEMPORALITY_DELTA,
                )
                for svc, v in error_counts.items()
            ])
        if n:
            self.registry.counter_add(
                tele_metrics.ANOMALY_LOG_RECORDS_TOTAL, float(n)
            )

    # -- health surface -------------------------------------------------

    def _healthz(self):
        """/healthz payload: overall state + the overload/supervision
        numbers an operator triages with. ``saturated`` is distinct
        from ``degraded`` (and loses to it — supervision.SATURATED):
        a shedding daemon is healthy-but-browning-out, a crash-looping
        one is not."""
        from .supervision import UP

        state = self._supervisor.overall_state()
        detail = {
            "components": self._supervisor.states(),
            "queue_rows": self.pipeline.pending_rows(),
            "queue_max_rows": self.pipeline.queue_max_rows,
            "brownout_level": self.pipeline.brownout_level,
            "shed_rows": dict(self.pipeline.stats.shed_rows),
            # Replication surface: how Grafana/k8s tell a healthy
            # standby (role=standby, status ok) from a degraded primary
            # — and what health_probe --role prints.
            "role": self.role,
            "epoch": self._fence.epoch,
            # Process birth time: lets an operator (and the build_info
            # gauge's dashboards) correlate restarts with verdicts.
            "start_ts": self._start_ts,
            # Auto-mitigation surface: what is mitigated right now and
            # whether any mitigation FAILED (the DEGRADED-style state
            # an operator triages before trusting the loop again).
            "mitigation": {
                "enabled": self.remediation.enabled,
                "active": self.remediation.active_count(),
                "failed": self.remediation.failed_services(),
            },
        }
        # Keyspace block (the cardinality-bomb triage surface): how
        # full the intern table is, which ladder rung is engaged, and
        # the generation epoch peers must match to merge frames.
        # Present even with the evictor disabled — fill + RSS are the
        # early-warning numbers.
        if self.keyspace is not None:
            detail["keyspace"] = self.keyspace.stats()
        else:
            tz = self.pipeline.tensorizer
            detail["keyspace"] = {
                "level": self.pipeline.keyspace_level,
                "rows": tz.live_keys,
                "capacity": tz.capacity,
                "fill": round(tz.live_keys / max(tz.capacity, 1), 4),
                "free_ids": tz.free_ids,
                "generation": tz.generation,
                "evicted_total": tz.evicted_total,
            }
        if self.shadow_verifier is not None:
            # Counterfactual gate surface (separate block so the
            # mitigation block's shape stays pinned): verdict counts
            # by direction + refusal reasons.
            st = self.remediation.stats()
            detail["shadow"] = {
                "runs": self.shadow_verifier.runs,
                "verdicts": st["preflight_verdicts"],
                "refused": st["preflight_refused"],
            }
        if self.fleet is not None:
            # Fleet block (health_probe --shard reads this): ring
            # version, member set, peer liveness, reshard counters —
            # how an operator tells "one shard browned out" from "the
            # fleet is splitting". The adoption sub-block rides along:
            # what this heir merged, what it refused, at what TTA.
            detail["fleet"] = self.fleet.snapshot()
            detail["fleet"]["adoptions"] = {
                "total": self._adoptions_total,
                "refused": dict(self._adoptions_refused),
                "last_tta_s": self._last_adoption_tta,
                "mirror_target": self._adoption_target,
            }
        # Autoscale surface: the deployment layer reads the proposed
        # target from here (and the scrape) — a resize is one
        # FLEET_KNOBS change, this block says which one.
        detail["autoscale"] = self.autoscaler.stats()
        return ("ok" if state == UP else state), detail

    # -- self-telemetry -------------------------------------------------

    # Windowed overlap-ratio buckets: the interesting band is the top
    # end (is the put hidden or not), so the ladder is top-heavy.
    _OVERLAP_BUCKETS = (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0)

    def _observe_phase(self, phase: str, seconds: float) -> None:
        """The pipeline/pool phase hook → promoted histograms: each
        lifecycle phase lands in anomaly_phase_seconds{phase=}, except
        the two with their own dedicated series (put-wait, harvest
        lag). Phase labels come from the runtime.selftrace constant
        table — the trace-discipline pass fences the call sites."""
        if phase == selftrace.PHASE_HARVEST_LAG:
            self.registry.histogram_observe(
                tele_metrics.ANOMALY_HARVEST_LAG, seconds,
                selftrace.PHASE_BUCKETS,
            )
        elif phase == selftrace.PHASE_PUT_WAIT:
            self.registry.histogram_observe(
                tele_metrics.ANOMALY_SPINE_PUT_WAIT, seconds,
                selftrace.PHASE_BUCKETS,
            )
        else:
            self.registry.histogram_observe(
                tele_metrics.ANOMALY_PHASE_SECONDS, seconds,
                selftrace.PHASE_BUCKETS, phase=phase,
            )

    def _flight_health_tick(self) -> None:
        """Edge-detect health/brownout/fence movement into the flight
        recorder; DEGRADED/SATURATED transitions dump evidence (role
        transitions dump from their own paths — promote/_become_fenced
        — so a standby that never saturates still leaves a trail)."""
        from .supervision import DEGRADED, SATURATED

        state = self._supervisor.overall_state()
        if state != self._flight_last_state:
            self.flight.record(
                "health", state=state, prev=self._flight_last_state,
                role=self.role, epoch=self._fence.epoch,
            )
            if state in (DEGRADED, SATURATED):
                self.flight.dump(state)
            self._flight_last_state = state
        brownout = self.pipeline.brownout_level
        if brownout != self._flight_last_brownout:
            self.flight.record(
                "brownout", level=brownout,
                prev=self._flight_last_brownout,
            )
            self._flight_last_brownout = brownout
        fence_total = sum(self._fence.fenced_by_path.values())
        if fence_total != self._flight_fence_seen:
            self.flight.record(
                "fence", total=fence_total,
                by_path=dict(self._fence.fenced_by_path),
            )
            self._flight_fence_seen = fence_total

    def _selftrace_delta(self, metric: str, key: str, value: int,
                         **labels) -> None:
        """Delta export with a seen-map the REPLICATION restart path
        never clears: the flight/tracer objects live for the process,
        so sharing _repl_counters (cleared on a supervised replication
        restart) would re-emit their full lifetime totals."""
        if not hasattr(self, "_selftrace_seen"):
            self._selftrace_seen = {}
        delta = value - self._selftrace_seen.get(key, 0)
        if delta > 0:
            self.registry.counter_add(metric, float(delta), **labels)
        self._selftrace_seen[key] = value

    def _export_selftrace_stats(self) -> None:
        """Flight/tracer counters → Prometheus (delta-based, like the
        replication exports), plus the tracer poster's sender-queue
        stats on the shared export family."""
        events, dumps = self.flight.counts()
        for kind, count in events.items():
            self._selftrace_delta(
                tele_metrics.ANOMALY_FLIGHT_EVENTS,
                f"flight_ev_{kind}", count, kind=kind,
            )
        for reason, count in dumps.items():
            self._selftrace_delta(
                tele_metrics.ANOMALY_FLIGHT_DUMPS,
                f"flight_dump_{reason}", count, reason=reason,
            )
        if self.selftrace is not None:
            stats = self.selftrace.stats()
            self._selftrace_delta(
                tele_metrics.ANOMALY_SELFTRACE_TRACES,
                "selftrace_traces", stats["traces_exported"],
            )
            self._selftrace_delta(
                tele_metrics.ANOMALY_SELFTRACE_SPANS,
                "selftrace_spans", stats["spans_exported"],
            )
        if self._selftrace_poster is not None:
            self._selftrace_delta(
                tele_metrics.ANOMALY_EXPORT_DROPPED,
                "selftrace_dropped", self._selftrace_poster.dropped,
                signal="selftrace",
            )
            self.registry.gauge_set(
                tele_metrics.ANOMALY_EXPORT_QUEUE_DEPTH,
                float(self._selftrace_poster.take_high_water()),
                signal="selftrace",
            )

    # -- report → metrics ---------------------------------------------

    def _warm_widths_quietly(self) -> None:
        """Background run of every ladder width; failure does not stop
        boot, but it is not hidden either: on the card a warm-up failure
        is a kernel that did not build or launch, so it is logged with
        its traceback and kept on ``warmup_error``."""
        try:
            self.pipeline.warm_widths()
        except Exception as e:  # noqa: BLE001 — boot goes on; the error stays visible
            self.warmup_error = e
            logging.getLogger(__name__).error(
                "width-ladder warm-up failed", exc_info=True
            )

    def wait_warm(self, timeout: float | None = None) -> bool:
        """Join the width-ladder warm-up thread; True once it is done
        (or there was none)."""
        if self._warm_thread is not None:
            self._warm_thread.join(timeout)
            return not self._warm_thread.is_alive()
        return True

    # -- remediation wiring --------------------------------------------

    def _exemplars_for(self, service: str) -> list[str]:
        """Flag-time exemplar trace ids for one service (the sampling
        actuator's policy seed; remediation worker thread — reads the
        pipeline's query meta under its own query lock, never the
        dispatch lock)."""
        names = self.pipeline.tensorizer.service_names
        if service not in names:
            return []
        idx = names.index(service)
        block = self.pipeline.query_meta()
        events = (block.get("exemplars") or {}).get(str(idx), [])
        return [e.get("trace_id") for e in events if e.get("trace_id")]

    def _bundle_for(self, service: str | int) -> str | None:
        """Newest evidence-bundle id for one service — the remediation
        (by name) and pre-flight (by index) citation hook: every
        episode/refusal names the verdict it answers (worker thread;
        query lock only, same discipline as ``_exemplars_for``)."""
        if self.provenance is None:
            return None
        if isinstance(service, int):
            names = self.pipeline.tensorizer.service_names
            if not 0 <= service < len(names):
                return None
            service = names[service]
        block = self.pipeline.query_meta()
        for b in reversed(block.get("explains") or []):
            if b.get("service") == service:
                return b.get("id")
        return None

    def _publish_sampling_policy(self, policy, seeds) -> None:
        """The sampling actuator's one push target: the history
        writer's span-capture sampler when the time-travel tier is on
        (flagged service records at 100% — the mitigation-drill
        corpus), a flight-recorder note either way."""
        if self.history_writer is not None:
            self.history_writer.set_span_sample(policy)
        self.flight.record(
            "mitigation", op="sampling_policy", policy=dict(policy),
            seeds={svc: len(ex) for svc, ex in (seeds or {}).items()},
        )

    def _preflight_mitigation(self, service: str):
        """The controller's pre-flight hook (worker thread): replay
        the recorded window with the service's fault columns
        suppressed — the counterfactual of the flagd mitigation — and
        return the shadow verdict. An unmappable service fails closed
        (the verifier could prove nothing about it)."""
        names = self.pipeline.tensorizer.service_names
        if service not in names:
            return shadow.refused(shadow.REASON_ERROR)
        idx = names.index(service)
        return self.shadow_verifier.verify(
            idx, shadow.suppress_transform(idx)
        )

    def _export_remediation_stats(self) -> None:
        """anomaly_mitigation_* (delta-based like every family) plus
        the TTM histogram observations drained from the controller."""
        st = self.remediation.stats()
        seen = self._remediation_seen
        for actuator, count in st["actions"].items():
            key = f"act_{actuator}"
            delta = count - seen.get(key, 0)
            if delta > 0:
                self.registry.counter_add(
                    tele_metrics.ANOMALY_MITIGATION_ACTIONS,
                    float(delta), actuator=actuator,
                )
            seen[key] = count
        for key, metric in (
            ("rollbacks", tele_metrics.ANOMALY_MITIGATION_ROLLBACKS),
            ("verified", tele_metrics.ANOMALY_MITIGATION_VERIFIED),
            ("failed", tele_metrics.ANOMALY_MITIGATION_FAILED),
        ):
            delta = st[key] - seen.get(key, 0)
            if delta > 0:
                self.registry.counter_add(metric, float(delta))
            seen[key] = st[key]
        self.registry.gauge_set(
            tele_metrics.ANOMALY_MITIGATION_ACTIVE, float(st["active"])
        )
        for ttm, _act_to_recover in self.remediation.take_ttm_samples():
            self.registry.histogram_observe(
                tele_metrics.ANOMALY_TIME_TO_MITIGATE, ttm,
                remediation.TTM_BUCKETS,
            )
        # Pre-flight family (delta-based like the rest; series appear
        # only once a verdict exists, so a gate-less daemon's scrape
        # is unchanged).
        for verdict, count in st["preflight_verdicts"].items():
            key = f"pf_{verdict}"
            delta = count - seen.get(key, 0)
            if delta > 0:
                self.registry.counter_add(
                    tele_metrics.ANOMALY_PREFLIGHT_VERDICTS,
                    float(delta), verdict=verdict,
                )
            seen[key] = count
        for reason, count in st["preflight_refused"].items():
            key = f"pfr_{reason}"
            delta = count - seen.get(key, 0)
            if delta > 0:
                self.registry.counter_add(
                    tele_metrics.ANOMALY_PREFLIGHT_REFUSED,
                    float(delta), reason=reason,
                )
            seen[key] = count
        for verdict_s in self.remediation.take_preflight_samples():
            self.registry.histogram_observe(
                tele_metrics.ANOMALY_PREFLIGHT_SECONDS, verdict_s,
                shadow.PREFLIGHT_BUCKETS,
            )
        if self._collector_actuator is not None:
            self.registry.gauge_set(
                tele_metrics.ANOMALY_COLLECTOR_KEEP_RATIO,
                float(self._collector_actuator.keep_ratio()),
            )

    # -- report export --------------------------------------------------

    def _on_report(self, t_batch, report, flagged) -> None:
        names = self.pipeline.tensorizer.service_names
        # Close the loop: the controller sees the same per-service
        # verdicts the query plane serves (hot path: streak bookkeeping
        # under the controller's own lock, never I/O — actuator writes
        # happen on its worker thread). getattr: the width-ladder
        # warmup thread can deliver a report during __init__, before
        # the controller block runs.
        rem = getattr(self, "remediation", None)
        if rem is not None:
            try:
                rem.observe(t_batch, flagged, services=names)
            except Exception:  # noqa: BLE001 — the mitigation loop
                # must never take down report export; a controller bug
                # costs mitigations, not detection.
                logging.getLogger(__name__).exception(
                    "remediation observe failed"
                )
        tele_metrics.export_report(self.registry, names, report, flagged)
        self.registry.gauge_set(
            tele_metrics.ANOMALY_LAG_P99, self.pipeline.stats.lag_p99_ms()
        )
        self.registry.counter_add(
            tele_metrics.ANOMALY_SPANS_TOTAL,
            float(self.pipeline.stats.spans - getattr(self, "_spans_seen", 0)),
        )
        self._spans_seen = self.pipeline.stats.spans

    def _on_metrics_report(self, t_batch, report) -> None:
        names = self.metrics_feed.service_names
        flagged = self.metrics_feed.flagged_services(report, names)
        tele_metrics.export_metrics_report(
            self.registry,
            names,
            self.metrics_feed.metric_slot_names(),
            report,
            flagged,
            seen=self._metric_series_seen,
        )
        self.registry.counter_add(
            tele_metrics.ANOMALY_METRIC_POINTS_TOTAL,
            float(self.metrics_feed.points_total - getattr(self, "_points_seen", 0)),
        )
        self._points_seen = self.metrics_feed.points_total

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        # Fleet membership + the optional embedded aggregator come up
        # for EVERY role: heartbeats are reads, the aggregator mutates
        # nothing, and a standby that boots with a cold membership
        # table would misjudge the fleet at promotion time.
        if self.fleet is not None:
            self.fleet.start()
            if self.aggregator_service is not None:
                self.aggregator_service.start()
        if self.role == ROLE_STANDBY:
            # A standby serves only its metrics/health surface and the
            # replication client; ingest legs come up at promotion.
            # In read-replica mode it ALSO serves the query API from
            # the replicated mirror — the standby stops idling and
            # becomes the read path, while remaining promotable.
            self.exporter.start()
            self._start_replication_standby()
            if self._query_read_replica:
                self._start_query_plane()
            return
        if self.role == ROLE_FENCED:
            # Boot-fenced: health/metrics stay observable (that is how
            # the operator finds us), but no ingest, no replication —
            # readiness probes against the (absent) ingest ports fail
            # and the orchestrator keeps traffic on the live primary.
            # The query plane stays up: reads mutate nothing, and every
            # answer is labeled role=fenced for the operator to judge.
            self.exporter.start()
            self._start_query_plane()
            return
        self.receiver.start()
        if self.grpc_receiver is not None:
            self.grpc_receiver.start()
        self._start_frontdoor()
        self.exporter.start()
        self._start_query_plane()
        self._start_history_writer()
        self._start_keyspace()
        self._register_serving_components()
        if self._repl_port >= 0:
            self._start_replication_primary()

    def _register_serving_components(self) -> None:
        # Thread/server-backed components join the supervision tree
        # once they are actually up (registering before start() would
        # probe a receiver that hasn't bound yet).
        self._supervisor.register(
            "otlp-http",
            restart=self._restart_http_receiver,
            # Late-bound: a restart swaps self.receiver for a new
            # object, and the probe must follow it. Fenced = the
            # receiver was stopped ON PURPOSE — not a crash to undo.
            probe=lambda: (
                self.role == ROLE_FENCED
                or (self.receiver is not None and self.receiver.alive())
            ),
        )
        if self.grpc_receiver is not None:
            self._supervisor.register(
                "otlp-grpc",
                restart=self._restart_grpc_receiver,
                # A real health-check RPC on a slow cadence: the grpc
                # core owns its threads, so thread-liveness can't see a
                # wedged server — only the wire can.
                probe=self._probe_grpc,
                probe_interval_s=10.0,
            )
        if self.pipeline.harvest_async:
            self._supervisor.register(
                "harvester",
                restart=self.pipeline.restart_harvester,
                probe=self.pipeline.harvester_alive,
            )

    # -- replication wiring --------------------------------------------

    def _replication_snapshot(self, hold_observe=None) -> tuple[dict, dict]:
        """(arrays, meta) of the CURRENT state for the replication
        layer, through ``DetectorPipeline.state_snapshot``: its copy is
        enqueued on the steps' stream under the dispatch lock (the step
        updates the state in place, so no later step can tear it) and
        waited for after the lock is released. ``hold_observe`` gets the
        seconds the lock was held."""
        arrays, clock_t_prev = self.pipeline.state_snapshot(
            hold_observe=hold_observe
        )
        meta = {
            # Confirmed offsets ONLY (self._offsets merges after flush
            # confirmation — the deferred-confirmation rule): a standby promoted from
            # this map replays any unconfirmed tail, never skips it.
            "offsets": self._offsets_snapshot(),
            "service_names": self.pipeline.tensorizer.service_names,
            # Keyspace generation: bumped by every eviction sweep.
            # Standbys refuse DELTAS from a different generation (the
            # arrays' slot→service mapping changed under them) and
            # adopt the new one wholesale from the next snapshot.
            "generation": self.pipeline.tensorizer.generation,
            "clock_t_prev": clock_t_prev,
            "config": list(
                self.detector.config._replace(sketch_impl=None)
            ),
            # Query-plane block (exemplar rings, anomaly events, top-k
            # candidates — all JSON-able): riding the replication meta
            # is what lets a read replica answer exemplar/anomaly/top-k
            # queries bit-identically to the primary.
            "query": self.pipeline.query_meta(),
        }
        return arrays, meta

    # -- query plane ---------------------------------------------------

    def _query_snapshot(self) -> tuple[dict, dict]:
        """THE query plane's single state access, role-dispatched:
        a standby answers from its replicated mirror (so queries work
        before promotion and fail over WITH the role), everything else
        from the replication snapshot helper — which copies live state
        on the steps' stream under the pipeline's dispatch lock, the
        same discipline that keeps replication from tearing a step.
        runtime/query.py itself never touches detector state."""
        if (
            self.role in (ROLE_STANDBY, ROLE_PROMOTING)
            and self.repl_standby is not None
        ):
            return self.repl_standby.snapshot()
        return self._replication_snapshot()

    def _query_lag(self) -> float:
        """The replica half of reported staleness: seconds since the
        last replication frame on a standby, 0 on a serving role (its
        snapshot IS the live state at refresh time)."""
        if (
            self.role in (ROLE_STANDBY, ROLE_PROMOTING)
            and self.repl_standby is not None
        ):
            return max(self.repl_standby.seconds_since_frame(), 0.0)
        return 0.0

    def _start_query_plane(self) -> None:
        """Start + supervise the query listeners (idempotent): called
        at boot for serving roles and read-replica standbys, and at
        promotion for a standby that booted with read-replica off."""
        if self.query_service is None or self._query_started:
            return
        self.query_service.start()
        if self.query_grpc is not None:
            # The gRPC twin is optional: losing it must not take the
            # HTTP leg (already bound) down with it, and leaving
            # _query_started unset here would double-start HTTP on
            # the next call.
            try:
                self.query_grpc.start()
            except Exception:  # noqa: BLE001 — optional twin; HTTP alone still serves every query
                logging.getLogger(__name__).exception(
                    "query gRPC twin failed to start; HTTP-only"
                )
                self.query_grpc = None
        self._query_started = True
        if not self._supervisor.registered("query"):
            self._supervisor.register(
                "query", base_backoff_s=0.5, max_backoff_s=15.0,
                probe=lambda: (
                    self.query_service is None
                    or self.query_service.alive()
                ),
                restart=self._restart_query_service,
            )

    def _start_history_writer(self) -> None:
        """Start + supervise the compaction thread (idempotent):
        serving roles only — a standby's state is the primary's
        mirror, and recording it too would double the log."""
        if self.history_writer is None:
            return
        self.history_writer.start()
        if not self._supervisor.registered("history"):
            self._supervisor.register(
                "history", base_backoff_s=1.0, max_backoff_s=30.0,
                # A FENCED writer stopped on purpose; don't restart it.
                probe=lambda: (
                    self.role == ROLE_FENCED
                    or self.history_writer is None
                    or self.history_writer.alive()
                ),
                restart=self._restart_history_writer,
            )

    def _restart_history_writer(self) -> None:
        if self.history_writer is None or self.role == ROLE_FENCED:
            return
        self.history_writer.start()  # idempotent while alive

    def _start_keyspace(self) -> None:
        """Start + supervise the keyspace watchdog (idempotent):
        serving roles only — an eviction sweep WRITES detector state
        and bumps the generation, so a standby running its own sweeps
        would drift from the primary instead of mirroring it."""
        if self.keyspace is None:
            return
        self.keyspace.start()
        if not self._supervisor.registered("keyspace"):
            self._supervisor.register(
                "keyspace", base_backoff_s=0.5, max_backoff_s=15.0,
                probe=lambda: (
                    self.role == ROLE_FENCED
                    or self.keyspace is None
                    or self.keyspace.alive()
                ),
                restart=self._restart_keyspace,
            )

    def _restart_keyspace(self) -> None:
        if self.keyspace is None or self.role == ROLE_FENCED:
            return
        self.keyspace.start()  # idempotent while alive

    def _observe_history_read(self, seconds: float) -> None:
        from .query import LATENCY_BUCKETS

        self.registry.histogram_observe(
            tele_metrics.ANOMALY_HISTORY_READ_LATENCY, seconds,
            LATENCY_BUCKETS,
        )

    def _export_history_stats(self) -> None:
        """anomaly_history_* gauges/counters (delta-based like every
        other family), plus corrupt records on the shared
        anomaly_frame_corrupt_total{hop=history} series."""
        store = self.history_store
        if store is None:
            return
        st = store.stats()
        self.registry.gauge_set(
            tele_metrics.ANOMALY_HISTORY_SEGMENTS, float(st["segments"])
        )
        self.registry.gauge_set(
            tele_metrics.ANOMALY_HISTORY_BYTES, float(st["bytes"])
        )
        oldest = st["oldest_t"]
        self.registry.gauge_set(
            tele_metrics.ANOMALY_HISTORY_OLDEST,
            max(time.time() - oldest, 0.0) if oldest else 0.0,
        )
        seen = self._history_seen
        if self.history_writer is not None:
            comp = self.history_writer.compactions
            if comp > seen["compactions"]:
                self.registry.counter_add(
                    tele_metrics.ANOMALY_HISTORY_COMPACTIONS,
                    float(comp - seen["compactions"]),
                )
                seen["compactions"] = comp
        corrupt = st["frames_corrupt"]
        if corrupt > seen["frames_corrupt"]:
            self.registry.counter_add(
                tele_metrics.ANOMALY_FRAME_CORRUPT,
                float(corrupt - seen["frames_corrupt"]), hop="history",
            )
            self.flight.record(
                "quarantine", hop="history",
                frames=int(corrupt - seen["frames_corrupt"]),
            )
            seen["frames_corrupt"] = corrupt

    def _restart_query_service(self) -> None:
        if self.query_service is None:
            return
        from .query import QueryService

        port = self.query_service.port
        try:
            self.query_service.stop()
        except Exception:  # noqa: BLE001 — a dead server may half-stop
            pass
        self.query_service = QueryService(
            self.query_engine, registry=self.registry, port=port
        )
        self.query_service.start()

    def _export_query_stats(self) -> None:
        """Per-step query-plane housekeeping: keep the snapshot cache
        within its staleness budget even with no queries arriving (the
        timeline ring accretes from these refreshes), export the
        staleness gauge and the exemplar-capture counter delta."""
        self.query_engine.maybe_refresh()
        staleness = self.query_engine.staleness_s()
        if staleness != float("inf"):
            self.registry.gauge_set(
                tele_metrics.ANOMALY_QUERY_STALENESS, staleness
            )
        captured = self.pipeline.exemplars_captured
        delta = captured - self._exemplars_seen
        if delta > 0:
            self.registry.counter_add(
                tele_metrics.ANOMALY_EXEMPLARS_CAPTURED, float(delta)
            )
            self._exemplars_seen = captured

    def _export_provenance_stats(self) -> None:
        """Provenance housekeeping each step: the built-counter delta
        (same seen-baseline discipline as exemplars — a restore must
        not replay old increments), build-latency observations, and
        the export drain — each drained bundle lands in the history
        tier (ranged /query/explain after restart) and, when the
        collector endpoint is configured, ships as one OTLP log
        record on the shared background poster."""
        if self.provenance is None:
            return
        from .query import LATENCY_BUCKETS

        built = self.pipeline.explanations_built
        delta = built - self._explanations_seen
        if delta > 0:
            self.registry.counter_add(
                tele_metrics.ANOMALY_EXPLANATIONS_BUILT, float(delta)
            )
            self._explanations_seen = built
        for seconds in self.provenance.take_build_samples():
            self.registry.histogram_observe(
                tele_metrics.ANOMALY_EXPLAIN_LATENCY, seconds,
                LATENCY_BUCKETS,
            )
        bundles = self.pipeline.take_explain_exports()
        if bundles:
            if self.history_writer is not None:
                for b in bundles:
                    self.history_writer.capture_explain(b)
            if self._explain_poster is not None:
                docs = [provenance.log_doc(b) for b in bundles]
                self._explain_poster(time.time(), docs)
            if (self.history_writer is not None
                    or self._explain_poster is not None):
                self.registry.counter_add(
                    tele_metrics.ANOMALY_EXPLANATIONS_EXPORTED,
                    float(len(bundles)),
                )
        if self._explain_poster is not None:
            self._explain_poster.publish_stats(
                self.registry, signal="explain"
            )

    def _register_replication_component(self) -> None:
        """One supervised 'replication' component for either role: the
        standby watchdog thread and the primary listener both restart
        under the same backoff/budget discipline as every ingest leg.
        Registered once — a supervised restart must not reset its own
        crash-budget accounting."""
        if "replication" in self._supervisor._components:
            return
        self._supervisor.register(
            "replication", base_backoff_s=0.5, max_backoff_s=15.0,
            probe=self._replication_alive,
            restart=self._restart_replication,
        )

    def _replication_alive(self) -> bool:
        if self.role == ROLE_STANDBY and self.repl_standby is not None:
            return self.repl_standby.alive()
        if self.role == ROLE_PRIMARY and self.repl_primary is not None:
            return self.repl_primary.alive()
        return True  # promoting/fenced: nothing to probe

    def _restart_replication(self) -> None:
        # The replacement object counts from zero: reset the delta
        # baselines so its first exports aren't swallowed by the old
        # object's high-water marks (see _export_counter_delta).
        self._repl_counters().clear()
        if self.role == ROLE_STANDBY and self.repl_standby is not None:
            try:
                self.repl_standby.stop()
            except Exception:  # noqa: BLE001 — may be half-dead already
                pass
            self._start_replication_standby()
        elif self.role == ROLE_PRIMARY and self.repl_primary is not None:
            port = self.repl_primary.port
            try:
                self.repl_primary.stop()
            except Exception:  # noqa: BLE001 — best-effort stop before relisten
                pass
            self._start_replication_primary(port=port)

    def _offsets_snapshot(self) -> dict[int, int]:
        with self._offsets_lock:
            return {int(p): int(o) for p, o in self._offsets.items()}

    def _ship_snapshot(self) -> tuple[dict, dict]:
        """The primary's snapshot_fn: each ship's lock hold lands in
        ``ship_lock_holds``."""
        return self._replication_snapshot(
            hold_observe=self.ship_lock_holds.append
        )

    def _start_replication_primary(self, port: int | None = None) -> None:
        self.repl_primary = replication.ReplicationPrimary(
            snapshot_fn=self._ship_snapshot,
            fence=self._fence,
            port=self._repl_port if port is None else port,
            interval_s=self._repl_interval_s,
        )
        self.repl_primary.start()
        self._register_replication_component()

    def _start_replication_standby(self) -> None:
        self.repl_standby = replication.ReplicationStandby(
            target=self._repl_target,
            fence=self._fence,
            config_fingerprint=list(
                self.detector.config._replace(sketch_impl=None)
            ),
            # Abandon a half-open session well before the promotion
            # watchdog would fire on the same silence.
            silence_reconnect_s=max(3 * self._repl_interval_s, 2.0),
        )
        self.repl_standby.start()
        self._register_replication_component()

    def step(self, t_now: float | None = None) -> None:
        """One pump + housekeeping tick (public for tests/sims)."""
        # Fleet gauges for EVERY role (a standby's membership view
        # must be scrapeable too — it inherits the ring at promotion).
        self._export_fleet_stats()
        if self.role in (ROLE_STANDBY, ROLE_PROMOTING):
            self._standby_step()
            return
        if self.role == ROLE_PRIMARY and self._fence.stale():
            # Someone promoted past us (learned via a replication
            # frame, the broker's commit tags, or the checkpoint
            # volume): stop writing IMMEDIATELY and visibly.
            self._become_fenced()
        if self.role == ROLE_FENCED:
            # A fenced ex-primary keeps draining what it already
            # admitted (and keeps its health/metrics surface honest)
            # but performs no durable writes: no orders pump, no offset
            # commits, no checkpoints.
            self.pipeline.pump(
                time.monotonic() if t_now is None else t_now
            )
            self.metrics_feed.pump(
                time.monotonic() if t_now is None else t_now
            )
            self._export_fence_stats()
            self._flight_health_tick()
            self._export_selftrace_stats()
            # Deadlines/budget still advance (rollbacks of pre-fence
            # actuations must fire), but every actuator WRITE is
            # refused by fence.check(path="remediation") — the fenced
            # daemon observes its loop, it never drives it.
            self.remediation.tick(
                time.monotonic() if t_now is None else t_now
            )
            self._export_remediation_stats()
            # Autoscale housekeeping too: the budget refills, and every
            # would-be proposal is refused by fence.check — the fenced
            # counter IS the sixth path's audit trail.
            self.autoscaler.tick(
                time.monotonic() if t_now is None else t_now
            )
            self._export_autoscale_stats()
            if self.query_engine is not None and self._query_started:
                self._export_query_stats()
            self._export_provenance_stats()
            self._supervisor.tick()
            return
        # Self-telemetry on a 1 s cadence (the collector's own otelcol_*
        # habit): ingest/batch/backlog visibility even before the first
        # detector report, and the first handle on a wedged pipeline.
        now_mono = time.monotonic()
        if now_mono - getattr(self, "_last_self_report", 0.0) >= 1.0:
            self._last_self_report = now_mono
            # docker_stats analogue: this container's resource stats on
            # the same exposition the shop's processes use.
            if not hasattr(self, "_proc_stats"):
                from ..telemetry.receivers import ProcessStatsReceiver

                self._proc_stats = ProcessStatsReceiver(
                    "anomaly-detector", registry=self.registry
                )
            self._proc_stats.scrape()
            self.registry.gauge_set(
                tele_metrics.ANOMALY_PENDING_ROWS,
                float(self.pipeline._pending_rows),
            )
            self.registry.gauge_set(
                tele_metrics.ANOMALY_BATCHES_DISPATCHED,
                float(self.pipeline.stats.batches),
            )
            self.registry.gauge_set(
                tele_metrics.ANOMALY_SPANS_INGESTED,
                float(self.pipeline.stats.spans),
            )
            self.registry.gauge_set(
                tele_metrics.ANOMALY_LOG_DOCS_STORED,
                float(self.log_store.count()),
            )
            # History-tier gauges on the same 1 s cadence (they walk
            # the segment dir listing — not per-step work).
            self._export_history_stats()
            # Keyspace/RSS gauges on the 1 s cadence too (the RSS
            # sample is a /proc open+scan; the ladder moves on hold_s
            # timescales, never sub-second).
            self._export_keyspace_stats()
            # Trend context for any later transition dump: a compact
            # 1 Hz snapshot of where batch time goes right now.
            spine_st = self.pipeline.spine_stats()
            self.flight.record(
                "phase_snapshot",
                pool_phase_s=(
                    dict(self.ingest_pool.stats()["phase_s"])
                    if self.ingest_pool is not None else None
                ),
                spine_overlap=(
                    spine_st["overlap_ratio"] if spine_st else None
                ),
                pending_rows=self.pipeline.pending_rows(),
                lag_p99_ms=self.pipeline.stats.lag_p99_ms(),
            )
            # One autoscale observation window per self-report (the
            # same 1 s cadence ACT_BATCHES counts in).
            self._autoscale_observe(now_mono)
        # Overload gauges/counters every step (not the 1 s cadence):
        # saturation flips sub-second and the chaos tests scrape between
        # steps — a few dict writes, nothing device-side.
        self.registry.gauge_set(
            tele_metrics.ANOMALY_QUEUE_ROWS,
            float(self.pipeline.pending_rows()),
        )
        self.registry.gauge_set(
            tele_metrics.ANOMALY_BROWNOUT_LEVEL,
            float(self.pipeline.brownout_level),
        )
        shed = self.pipeline.stats.shed_rows
        for lane in ("ok", "error"):
            delta = shed[lane] - self._shed_seen[lane]
            if delta:
                self.registry.counter_add(
                    tele_metrics.ANOMALY_SHED_ROWS, float(delta),
                    lane=lane, cause="overflow",
                )
                self._shed_seen[lane] = shed[lane]
                self.flight.record("shed", lane=lane, rows=int(delta))
        brownout = self.pipeline.stats.brownout_rows
        if brownout != self._brownout_seen:
            self.registry.counter_add(
                tele_metrics.ANOMALY_SHED_ROWS,
                float(brownout - self._brownout_seen),
                lane="ok", cause="brownout",
            )
            self._brownout_seen = brownout
        # Per-tenant quota shed (the fleet's noisy-tenant isolation):
        # anomaly_shed_rows_total{tenant=} — one series per tenant
        # that ever shed, so "this tenant's loss" is a number an
        # operator can alert on in isolation.
        for tenant, total in list(
            self.pipeline.stats.shed_rows_tenant.items()
        ):
            delta = total - self._tenant_shed_seen.get(tenant, 0)
            if delta:
                self.registry.counter_add(
                    tele_metrics.ANOMALY_SHED_ROWS, float(delta),
                    lane="ok", cause="tenant-quota", tenant=tenant,
                )
                self._tenant_shed_seen[tenant] = total
                self.flight.record(
                    "shed", lane="ok", tenant=tenant, rows=int(delta),
                )
        if self.ingest_pool is not None:
            self._export_pool_stats()
        self._export_spine_stats()
        self._export_fence_stats()
        self._flight_health_tick()
        self._export_selftrace_stats()
        # Remediation housekeeping on the pump cadence: the recovery
        # deadline and the token-bucket refill must advance even when
        # no report arrives (a wedged harvest must still roll back a
        # mitigation whose deadline passed).
        self.remediation.tick(time.monotonic() if t_now is None else t_now)
        self._export_remediation_stats()
        self.autoscaler.tick(time.monotonic() if t_now is None else t_now)
        self._export_autoscale_stats()
        if self.query_engine is not None and self._query_started:
            self._export_query_stats()
        self._export_provenance_stats()
        if self.repl_primary is not None:
            self._export_replication_stats()
        if self._orders is not None:
            # Guarded: an exception escaping the poll/submit loop (a
            # transport state no one anticipated) backs the pump off
            # and retries instead of killing the daemon loop.
            self._supervisor.run_step("kafka-orders", self._pump_orders)
        # The daemon is a WALL-CLOCK caller: pump(None) would reuse the
        # pipeline's last timebase (the virtual-time contract for
        # harness callers), freezing dt and window rotation for the
        # whole serve-loop lifetime — tumbling windows would never
        # expire, starving the cardinality head AND the history
        # ladder. Resolve the clock here, like the metrics feed always
        # has.
        self.pipeline.pump(time.monotonic() if t_now is None else t_now)
        self.metrics_feed.pump(time.monotonic() if t_now is None else t_now)
        self._supervisor.tick()
        if (
            self.ckpt_path
            and time.monotonic() - self._last_ckpt >= self.ckpt_interval_s
        ):
            # Guarded: a full disk is a degraded snapshot cadence, not
            # a dead detector.
            self._supervisor.run_step("checkpoint", self._checkpoint)

    def _export_keyspace_stats(self) -> None:
        """anomaly_process_rss_bytes (first-class — the soak bench's
        VmRSS read promoted to a scrape) + the anomaly_keyspace_*
        family, delta-based per-tenant counters like the shed exports,
        and one flight-recorder event per ladder EDGE — the evidence
        an operator replays after surviving a cardinality bomb."""
        tz = self.pipeline.tensorizer
        if self.keyspace is not None and self.keyspace.last_rss:
            rss = self.keyspace.last_rss
        else:
            from .keyspace import process_rss_bytes

            rss = process_rss_bytes()
        self.registry.gauge_set(
            tele_metrics.ANOMALY_PROCESS_RSS, float(rss)
        )
        self.registry.gauge_set(
            tele_metrics.ANOMALY_KEYSPACE_ROWS, float(tz.live_keys)
        )
        self.registry.gauge_set(
            tele_metrics.ANOMALY_KEYSPACE_CAPACITY, float(tz.capacity)
        )
        fill = tz.live_keys / max(tz.capacity, 1)
        self.registry.gauge_set(
            tele_metrics.ANOMALY_KEYSPACE_FILL, float(fill)
        )
        self.registry.gauge_set(
            tele_metrics.ANOMALY_KEYSPACE_FREE_IDS, float(tz.free_ids)
        )
        self.registry.gauge_set(
            tele_metrics.ANOMALY_KEYSPACE_GENERATION,
            float(tz.generation),
        )
        level = self.pipeline.keyspace_level
        self.registry.gauge_set(
            tele_metrics.ANOMALY_KEYSPACE_LEVEL, float(level)
        )
        delta = tz.evicted_total - self._keyspace_evicted_seen
        if delta:
            self.registry.counter_add(
                tele_metrics.ANOMALY_KEYSPACE_EVICTED, float(delta)
            )
            self._keyspace_evicted_seen = tz.evicted_total
        if level != self._keyspace_level_seen:
            # Every ladder edge (both directions) leaves evidence: the
            # eviction sweeps themselves record their own events.
            self.flight.record(
                "keyspace", op="level",
                prev=self._keyspace_level_seen, level=level,
                fill=round(float(fill), 4),
                rss_mb=round(rss / (1024 * 1024), 1),
                rows=tz.live_keys, free_ids=tz.free_ids,
                generation=tz.generation,
            )
            self._keyspace_level_seen = level
        for kind, metric, totals in (
            (
                "throttled", tele_metrics.ANOMALY_KEYSPACE_THROTTLED,
                self.pipeline.stats.newkey_throttled_tenant,
            ),
            (
                "overflow", tele_metrics.ANOMALY_KEYSPACE_OVERFLOW,
                self.pipeline.stats.overflow_keys_tenant,
            ),
        ):
            seen = self._keyspace_tenant_seen[kind]
            for tenant, total in list(totals.items()):
                d = total - seen.get(tenant, 0)
                if d:
                    self.registry.counter_add(
                        metric, float(d), tenant=tenant
                    )
                    seen[tenant] = total
                    self.flight.record(
                        "keyspace", op=kind, tenant=tenant, keys=int(d),
                    )

    def _export_pool_stats(self) -> None:
        """anomaly_ingest_pool_* gauges/counters from the pool's
        counters (delta-based, like the shed/quarantine exports)."""
        st = self.ingest_pool.stats()
        seen = self._pool_seen
        self.registry.gauge_set(
            tele_metrics.ANOMALY_INGEST_POOL_DEPTH, float(st["depth"])
        )
        for key, metric in (
            ("flushes", tele_metrics.ANOMALY_INGEST_POOL_FLUSHES),
            ("flushed_spans", tele_metrics.ANOMALY_INGEST_POOL_SPANS),
            ("coalesced_requests", tele_metrics.ANOMALY_INGEST_POOL_REQUESTS),
        ):
            delta = st[key] - seen[key]
            if delta:
                self.registry.counter_add(metric, float(delta))
                seen[key] = st[key]
        delta = st["frames_corrupt"] - seen["frames_corrupt"]
        if delta:
            self.registry.counter_add(
                tele_metrics.ANOMALY_FRAME_CORRUPT, float(delta),
                hop="ingest",
            )
            seen["frames_corrupt"] = st["frames_corrupt"]
            self.flight.record(
                "quarantine", hop="ingest", frames=int(delta)
            )
        # Windowed utilization: busy-seconds delta over wall delta,
        # normalized by worker count — the "is the pool the
        # bottleneck" gauge.
        now = time.monotonic()
        wall = max(now - seen["wall_t"], 1e-9)
        busy = st["busy_s"] - seen["busy_s"]
        self.registry.gauge_set(
            tele_metrics.ANOMALY_INGEST_POOL_UTILIZATION,
            min(busy / (wall * st["workers"]), 1.0),
        )
        seen["busy_s"] = st["busy_s"]
        seen["wall_t"] = now

    def _export_spine_stats(self) -> None:
        """anomaly_spine_* gauges: is the host→device transfer actually
        hidden behind compute (overlap ratio), at what ring depth."""
        st = self.pipeline.spine_stats()
        if st is None:
            self.registry.gauge_set(
                tele_metrics.ANOMALY_SPINE_RING_DEPTH, 0.0
            )
            return
        self.registry.gauge_set(
            tele_metrics.ANOMALY_SPINE_RING_DEPTH, float(st["ring_depth"])
        )
        self.registry.gauge_set(
            tele_metrics.ANOMALY_SPINE_PUT_OVERLAP,
            float(st["overlap_ratio"]),
        )
        # Histogram companion on a per-window basis: the lifetime
        # gauge flattens transients; one observation per scrape window
        # lets Prometheus answer "what fraction of windows had the put
        # hidden" as a quantile.
        hits = int(st["overlap_hits"])
        taken = hits + int(st["overlap_misses"])
        seen_hits, seen_taken = self._spine_overlap_seen
        if taken > seen_taken:
            self.registry.histogram_observe(
                tele_metrics.ANOMALY_SPINE_OVERLAP_WINDOW,
                (hits - seen_hits) / (taken - seen_taken),
                self._OVERLAP_BUCKETS,
            )
            self._spine_overlap_seen = (hits, taken)

    # -- sharded fleet ---------------------------------------------------

    def _on_reshard(self, event: dict) -> None:
        """Membership applied a ring change (leave/join): evidence in
        the flight recorder — the postmortem question after any
        reshard is 'who moved, when, at what ring version' — and, in
        adoptive mode, the automatic-adoption trigger: when the leave
        named THIS shard the heir, the victim's keyspace merges from
        the successor mirror with zero operator action. Runs on the
        fleet heartbeat thread, AFTER the membership lock released
        (the two-phase tick contract), so the merge can take the
        dispatch lock without ordering against membership state."""
        self.flight.record(
            "reshard", op=event.get("op"), shard=event.get("shard"),
            ring_version=event.get("ring_version"),
            members=event.get("members"),
            heir=event.get("heir"),
        )
        if (
            event.get("op") == "leave"
            and event.get("heir") == f"shard-{self._fleet_index}"
        ):
            self._adopt_shard(event)
        # Membership moved, so this shard's ring-successor may have
        # too: re-point the mirror (a retargeted standby drops the old
        # peer's arrays and bootstraps from the new primary's
        # SNAPSHOT). After the adoption above — the merge needs the
        # mirror's pre-retarget state.
        self._retarget_adoption_mirror(event.get("members") or [])

    def _refuse_adoption(self, reason: str, victim: str) -> None:
        self._adoptions_refused[reason] = (
            self._adoptions_refused.get(reason, 0) + 1
        )
        self.flight.record(
            "adoption-refused", reason=reason, victim=victim,
        )
        self.flight.dump(
            "adoption-refused", refusal=reason, victim=victim,
        )

    def _adopt_shard(self, event: dict) -> None:
        """Automatic in-daemon frame adoption: merge the dead
        ring-successor's mirrored frame into live state under the
        dispatch lock (the operator merge drill, with the operator
        replaced by the heir computation). Refusals are counted by
        reason and evidence-dumped — an adoption that CANNOT be done
        safely (drifted intern tables, no mirrored state) leaves the
        keyspace orphaned-but-audited, exactly like the manual path."""
        victim = str(event.get("shard"))
        mirror = self._adoption_mirror
        if mirror is None:
            self._refuse_adoption("no_mirror", victim)
            return
        if self.role != ROLE_PRIMARY or self._fence.stale():
            # A fenced/standby heir must not write state it does not
            # own; the keyspace stays with whoever outranked us.
            self._refuse_adoption("role", victim)
            return
        src_arrays, src_meta = mirror.snapshot()
        if not src_arrays:
            self._refuse_adoption("no_state", victim)
            return
        # The victim's keyspace slice under the PRE-leave ring: the
        # post-event members + adopted map minus this very adoption
        # reconstruct it exactly (every member computes the same ring
        # from the same inputs — the zero-coordination property).
        members = [str(m) for m in (event.get("members") or [])]
        pre_adopted = {
            v: h
            for v, h in self.fleet.membership.ring.adopted().items()
            if v != victim
        }
        pre_ring = fleet.HashRing(
            members + [victim], vnodes=self._fleet_vnodes,
            adopted=pre_adopted,
        )
        src_names = [str(s) for s in src_meta.get("service_names") or []]
        owned = {
            svc for svc in src_names
            if pre_ring.owner_of(
                svc, fleet.tenant_of(svc, self._tenant_map)
            ) == victim
        }
        try:
            # One critical section: read, merge and write back under
            # one hold of the dispatch lock, so a step dispatched
            # meanwhile lands after the merge instead of being lost
            # under it. The read waits for its copy inside the lock
            # (adoption is rare; the reference stalls here too).
            state = self.detector.state  # staticcheck: ok[donation-race] steps write the state tensors in place and only AnomalyDetector.__init__ binds them, so this handle is the live state; it is read and written back under the one lock hold below, on the steps' stream
            copy = HostCopy(state)
            with self.pipeline._dispatch_lock:
                copy.start(state, stream=self.pipeline.step_stream)
                dst = dict(zip(DetectorState._fields, copy.numpy()))
                head = dst.get("lat_mean")
                num_rows = int(head.shape[0]) if head is not None else 0
                mask = fleet.service_row_mask(
                    src_names,
                    self.pipeline.tensorizer.service_names,
                    num_rows,
                    owned=owned,
                )
                merged = fleet.merge_shard_arrays(
                    dst, src_arrays, mask,
                    # Keyspace generation drift refuses the merge: a
                    # victim that ran an eviction sweep we never saw
                    # has recycled ids our positional mask would
                    # cross-attribute.
                    dst_generation=self.pipeline.tensorizer.generation,
                    src_generation=int(
                        src_meta.get("generation") or 0
                    ),
                )
                self._write_state(merged)
        except fleet.ShardMergeError as e:
            self._refuse_adoption("merge", victim)
            logging.getLogger(__name__).error(
                "adoption of %s refused: %s", victim, e
            )
            return
        except Exception:  # noqa: BLE001 — a failed adoption is an
            # audited orphan (like a refused manual merge), never a
            # dead heartbeat thread.
            self._refuse_adoption("error", victim)
            logging.getLogger(__name__).exception(
                "adoption of %s failed", victim
            )
            return
        # The victim's names are already interned (the pre-intern
        # contract the drift check just verified) — but late services
        # the victim interned past our table still need ids for the
        # query plane to answer by name.
        for name in src_names:
            self.pipeline.tensorizer.service_id(name)
        tta = max(time.monotonic() - float(event.get("t") or 0.0), 0.0)
        self._adoptions_total += 1
        self._last_adoption_tta = tta
        self.flight.record(
            "adoption", victim=victim, tta_s=round(tta, 4),
            services=sorted(owned),
            ring_version=event.get("ring_version"),
        )
        self.flight.dump(
            "adoption", victim=victim, tta_s=round(tta, 4),
            services=sorted(owned),
        )

    def _write_state(self, arrays: dict) -> None:
        """Write host arrays (by ``DetectorState`` field) into the live
        state tensors in place, on the steps' stream. The caller holds
        the dispatch lock. Fields, shapes and dtypes must equal the live
        state's (a copy would broadcast or cast quietly); the check runs
        before any tensor is written. Returns once the copies are done,
        so the host arrays may be dropped."""
        state = self.detector.state  # staticcheck: ok[donation-race] the caller holds the dispatch lock (see the docstring), and steps write these tensors in place: the handle is the live state
        if set(arrays) != set(DetectorState._fields):
            raise ValueError(
                f"state fields {sorted(arrays)} != "
                f"{sorted(DetectorState._fields)}"
            )
        hosts = {}
        for name, live in zip(DetectorState._fields, state):
            host = torch.from_numpy(np.array(arrays[name], order="C"))
            if host.dtype != live.dtype or host.shape != live.shape:
                raise ValueError(
                    f"state field {name}: {host.dtype}{tuple(host.shape)} "
                    f"!= live {live.dtype}{tuple(live.shape)}"
                )
            hosts[name] = host
        stream = self.pipeline.step_stream
        if stream is None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
        if stream is None:
            for name, live in zip(DetectorState._fields, state):
                live.copy_(hosts[name])
            return
        with torch.cuda.stream(stream):
            for name, live in zip(DetectorState._fields, state):
                live.copy_(hosts[name], non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()

    def _retarget_adoption_mirror(self, members: list) -> None:
        """Keep the standby mirror pointed at this shard's CURRENT
        ring-successor (pure function of the member list — every
        member re-derives the same pairing with no coordination)."""
        if not self._fleet_repl_addrs:
            return
        self_id = f"shard-{self._fleet_index}"
        succ = fleet.ring_successor(
            [str(m) for m in members], self_id
        )
        addr = self._fleet_repl_addrs.get(succ) if succ else None
        if addr == self._adoption_target:
            return
        self._adoption_target = addr
        if addr is None:
            # Alone on the ring (or the successor has no stream):
            # nothing to mirror — stop, keep the object for rejoin.
            if self._adoption_mirror is not None:
                try:
                    self._adoption_mirror.stop()
                except Exception:  # noqa: BLE001 — a half-dead client
                    pass
            return
        if self._adoption_mirror is None:
            self._adoption_mirror = replication.ReplicationStandby(
                addr,
                fence=self._adoption_fence or EpochFence(),
                standby_id=f"{self_id}-adopt",
                silence_reconnect_s=max(
                    self._fleet_heartbeat_s * 2.0, 2.0
                ),
            )
            self._adoption_mirror.start()
        else:
            self._adoption_mirror.retarget(addr)
        self.flight.record(
            "adoption-mirror", successor=succ, target=addr,
        )

    def _fleet_shard_count(self) -> int:
        """The autoscaler's proposal base: live members on the ring
        (single-shard daemons scale from 1)."""
        if self.fleet is None:
            return 1
        return self.fleet.membership.live_count()

    def _restart_fleet(self) -> None:
        if self.fleet is None:
            return
        try:
            self.fleet.stop()
        except Exception:  # noqa: BLE001 — a wedged loop may half-stop
            pass
        self.fleet.start()

    def _fleet_live_shards(self) -> list[str]:
        """The embedded aggregator's membership filter: fan out only
        to shards the heartbeat table believes alive (plus self)."""
        if self.fleet is None:
            return []
        snap = self.fleet.snapshot()
        live = [
            peer for peer, st in snap["peers"].items() if st["alive"]
        ]
        live.append(snap["shard"])
        return live

    def _export_fleet_stats(self) -> None:
        """anomaly_fleet_* gauges/counters from the membership table
        (delta-based counters, the shed/quarantine discipline)."""
        if self.fleet is None:
            return
        snap = self.fleet.snapshot()
        self.registry.gauge_set(
            tele_metrics.ANOMALY_FLEET_SHARDS_LIVE,
            float(snap["shards_live"]),
        )
        # Prometheus gauges are floats: fold the 64-bit digest into 31
        # bits so the exposition round-trips exactly (the comparison
        # across shards only needs equality, not the full digest).
        self.registry.gauge_set(
            tele_metrics.ANOMALY_FLEET_RING_VERSION,
            float(snap["ring_version"] % (1 << 31)),
        )
        self.registry.gauge_set(
            tele_metrics.ANOMALY_FLEET_FROZEN,
            1.0 if snap["frozen"] else 0.0,
        )
        seen = self._fleet_seen
        for key, metric in (
            ("reshards", tele_metrics.ANOMALY_RESHARDS),
            ("refused", tele_metrics.ANOMALY_RESHARDS_REFUSED),
        ):
            value = snap[
                "reshards_total" if key == "reshards"
                else "reshards_refused"
            ]
            delta = value - seen[key]
            if delta > 0:
                self.registry.counter_add(metric, float(delta))
                seen[key] = value
        spans = int(self.pipeline.stats.spans)
        delta = spans - seen["spans"]
        if delta > 0:
            self.registry.counter_add(
                tele_metrics.ANOMALY_FLEET_SHARD_SPANS, float(delta),
                shard=f"shard-{self._fleet_index}",
            )
            seen["spans"] = spans
        # Adoption trail (delta-based like every fleet counter; the
        # refused map is tiny — a handful of reason keys).
        delta = self._adoptions_total - self._adoption_seen["total"]
        if delta > 0:
            self.registry.counter_add(
                tele_metrics.ANOMALY_FLEET_ADOPTIONS, float(delta)
            )
            self._adoption_seen["total"] = self._adoptions_total
        for reason, count in list(self._adoptions_refused.items()):
            key = f"refused_{reason}"
            d = count - self._adoption_seen.get(key, 0)
            if d > 0:
                self.registry.counter_add(
                    tele_metrics.ANOMALY_FLEET_ADOPTIONS_REFUSED,
                    float(d), reason=reason,
                )
                self._adoption_seen[key] = count
        if self._last_adoption_tta is not None:
            self.registry.gauge_set(
                tele_metrics.ANOMALY_FLEET_ADOPTION_TTA,
                float(self._last_adoption_tta),
            )

    def _export_autoscale_stats(self) -> None:
        """anomaly_autoscale_* from the controller's counters (delta-
        based) + the live score/target gauges."""
        st = self.autoscaler.stats()
        seen = self._autoscale_seen
        for action in ("split", "join"):
            key = f"proposals_{action}"
            delta = st[key] - seen.get(key, 0)
            if delta > 0:
                self.registry.counter_add(
                    tele_metrics.ANOMALY_AUTOSCALE_PROPOSALS,
                    float(delta), action=action,
                )
                seen[key] = st[key]
        for reason in (
            "disabled", "role", "fenced", "bounds", "budget", "apply",
        ):
            key = f"refused_{reason}"
            delta = st[key] - seen.get(key, 0)
            if delta > 0:
                self.registry.counter_add(
                    tele_metrics.ANOMALY_AUTOSCALE_REFUSED,
                    float(delta), reason=reason,
                )
                seen[key] = st[key]
        self.registry.gauge_set(
            tele_metrics.ANOMALY_AUTOSCALE_SCORE, float(st["score"])
        )
        if st["target_shards"] is not None:
            self.registry.gauge_set(
                tele_metrics.ANOMALY_AUTOSCALE_TARGET,
                float(st["target_shards"]),
            )

    def _autoscale_observe(self, t_now: float) -> None:
        """One saturation window for the autoscaler (1 s cadence, on
        the primary step): watermark / shed / brownout / saturation
        signals, each normalized to [0, 1]."""
        pending = float(self.pipeline.pending_rows())
        high = float(getattr(self.pipeline, "_high_rows", 0) or 0)
        shed = self.pipeline.stats.shed_rows
        shed_total = (
            int(shed.get("ok", 0)) + int(shed.get("error", 0))
            + int(self.pipeline.stats.brownout_rows)
        )
        shed_active = shed_total > self._autoscale_shed_seen
        self._autoscale_shed_seen = shed_total
        max_level = max(
            float(getattr(self.pipeline, "brownout_max_level", 0) or 0),
            1.0,
        )
        signals = {
            "watermark": min(pending / high, 1.0) if high > 0 else 0.0,
            "shed": 1.0 if shed_active else 0.0,
            "brownout": min(
                float(self.pipeline.brownout_level) / max_level, 1.0
            ),
            "saturated": 1.0 if self.pipeline.saturated else 0.0,
        }
        self.autoscaler.observe(t_now, signals)

    # -- replication: standby step / promotion / fencing ----------------

    def _repl_counters(self) -> dict:
        if not hasattr(self, "_repl_seen"):
            self._repl_seen = {}
        return self._repl_seen

    def _export_counter_delta(self, metric: str, key: str, value: int, **labels):
        seen = self._repl_counters()
        delta = value - seen.get(key, 0)
        # delta > 0 only: a supervised replication restart swaps in a
        # fresh stats object (counts restart at 0), and a negative add
        # would make the Prometheus counter decrease — rate() would
        # read it as a bogus reset spike. _restart_replication also
        # clears the seen map so post-restart counts aren't swallowed.
        if delta > 0:
            self.registry.counter_add(metric, float(delta), **labels)
        seen[key] = value

    def _export_fence_stats(self) -> None:
        """Fence-rejected writes by path — the split-brain audit trail
        (anomaly_replication_fenced_total{path=checkpoint|offsets|…});
        frame-path rejections are exported from the replication stats,
        these are the checkpoint/commit halves."""
        for path, count in list(self._fence.fenced_by_path.items()):
            label = "offsets" if "offset" in path else path
            self._export_counter_delta(
                tele_metrics.ANOMALY_REPLICATION_FENCED,
                f"fence_{path}", count, path=label,
            )

    def _export_replication_stats(self) -> None:
        p = self.repl_primary
        self.registry.gauge_set(
            tele_metrics.ANOMALY_REPLICATION_LAG, p.lag_seconds()
        )
        self._export_counter_delta(
            tele_metrics.ANOMALY_REPLICATION_DELTAS, "shipped",
            p.deltas_shipped, direction="shipped",
        )
        self._export_counter_delta(
            tele_metrics.ANOMALY_REPLICATION_SNAPSHOTS, "snap_shipped",
            p.snapshots_shipped, direction="shipped",
        )
        self._export_counter_delta(
            tele_metrics.ANOMALY_REPLICATION_FENCED, "frame_fenced",
            p.fenced_events, path="frame",
        )
        self._export_counter_delta(
            tele_metrics.ANOMALY_FRAME_CORRUPT, "frames_corrupt_primary",
            p.frames_corrupt, hop="replication",
        )

    def _standby_step(self) -> None:
        """One standby housekeeping tick: watchdog + metrics (and, in
        read-replica mode, the query snapshot cache). No ingest, no
        Kafka, no checkpoints — beyond serving reads, the standby's
        job is staying current and noticing the primary die."""
        self._export_fence_stats()
        self._export_remediation_stats()
        if self.query_engine is not None and self._query_started:
            self._export_query_stats()
        st = self.repl_standby
        if st is not None:
            quiet_s = st.seconds_since_frame()
            self.registry.gauge_set(
                tele_metrics.ANOMALY_REPLICATION_LAG, quiet_s
            )
            self._export_counter_delta(
                tele_metrics.ANOMALY_REPLICATION_DELTAS, "applied",
                st.deltas_applied, direction="applied",
            )
            self._export_counter_delta(
                tele_metrics.ANOMALY_REPLICATION_SNAPSHOTS, "snap_applied",
                st.snapshots_applied, direction="applied",
            )
            self._export_counter_delta(
                tele_metrics.ANOMALY_REPLICATION_FENCED, "fenced_sent",
                st.fenced_sent, path="frame",
            )
            corrupt_prev = self._repl_counters().get("frames_corrupt", 0)
            self._export_counter_delta(
                tele_metrics.ANOMALY_FRAME_CORRUPT, "frames_corrupt",
                st.frames_corrupt, hop="replication",
            )
            if st.frames_corrupt > corrupt_prev:
                self.flight.record(
                    "quarantine", hop="replication",
                    frames=int(st.frames_corrupt - corrupt_prev),
                )
            if (
                self.role == ROLE_STANDBY
                and quiet_s > self._failover_timeout_s
                and st.applied_seq >= 0  # never promote off nothing
            ):
                if self._primary_confirmed_alive():
                    # Link fault, not primary death: promoting now would
                    # split-brain against a serving primary. Reset the
                    # watchdog and keep reconnecting.
                    st.last_frame_t = time.monotonic()
                else:
                    self.promote()
        self._supervisor.tick()

    def _primary_confirmed_alive(self) -> bool:
        """grpc.health double-check before promotion (only when
        ANOMALY_PRIMARY_HEALTH_ADDR is configured): True means the
        primary still answers SERVING and the silence is the LINK's
        fault."""
        if not self._primary_health_addr:
            return False
        try:
            from .health_probe import probe

            return probe(self._primary_health_addr, timeout_s=2.0)
        except Exception:  # noqa: BLE001 — no grpcio / unreachable:
            return False  # treat as dead, promotion proceeds

    def promote(self) -> None:
        """STANDBY → PROMOTING → PRIMARY: the failover path.

        Order matters: the epoch bump comes FIRST (every later write is
        stamped with it), then state hydration from the replicated
        mirror, then the Kafka seek to the replicated offset map
        (at-least-once: offsets only ever replicated after flush
        confirmation), then ingest comes up, then an immediate
        epoch-stamped checkpoint makes the promotion durable — a
        promoted standby that crashes and restarts keeps outranking
        the old primary."""
        self.role = ROLE_PROMOTING
        epoch = self._fence.bump()
        # Promotion steps land in the flight recorder AND dump an
        # evidence file: a failover is exactly the moment an operator
        # later asks "what did the daemon see".
        self.flight.record("role", state=ROLE_PROMOTING, epoch=epoch)
        self.flight.dump("promoting")
        try:
            # Everything fallible happens BEFORE the standby client is
            # stopped: if any step raises (wrong-shaped replicated
            # arrays, a broker fault in seek, a receiver bind failure),
            # we return to STANDBY with the mirror intact and the
            # watchdog re-fires after another failover timeout — a
            # failed promotion must be a retry, never a process parked
            # in PROMOTING with no ingest and no way forward.
            arrays, meta = {}, {}
            if self.repl_standby is not None:
                arrays, meta = self.repl_standby.snapshot()
            if arrays:
                # Hydration writes the mirror into the live state on
                # the card, in place, on the steps' stream and under the
                # dispatch lock (the width-ladder warm-up clones the
                # state under it): the standby's detector has lived on
                # the card since boot, so promotion allocates nothing.
                with self.pipeline._dispatch_lock:
                    self._write_state(arrays)
                    self.detector.clock._t_prev = meta.get("clock_t_prev")
                # Positional adoption (the checkpoint-restore rule):
                # the mirrored table may carry EVICTED_SLOT tombstones
                # from the old primary's sweeps, and name-by-name
                # interning would compact past them, shifting ids off
                # the rows we just hydrated. The generation rides
                # along so this promoted primary refuses pre-sweep
                # frames exactly like the one it replaced.
                self.pipeline.tensorizer.adopt_names(
                    list(meta.get("service_names", []))
                )
                self.pipeline.tensorizer.generation = int(
                    meta.get("generation") or 0
                )
                self._offsets = {
                    int(p): int(o)
                    for p, o in (meta.get("offsets") or {}).items()
                }
                # Query-plane continuity: once role==PRIMARY the
                # engine reads the LIVE pipeline, whose exemplar/
                # anomaly/candidate rings are empty on a fresh
                # standby — refill them from the mirror or the
                # replicated history vanishes as soon as the snapshot
                # cache expires.
                self.pipeline.restore_query_meta(
                    meta.get("query") or {}
                )
            if self._orders is not None and self._offsets:
                # Replicated offsets win over broker-committed ones for
                # the same reason checkpoint offsets do: the sketch
                # state we just hydrated corresponds to THEM.
                self._orders.seek(self._offsets)
            # Ingest up: construct + start the receivers the standby
            # never built, join them to the supervision tree.
            if self.receiver is None:
                self.receiver = self._make_http_receiver(self.otlp_port)
                self.receiver.start()
            if self.grpc_receiver is None and self._grpc_port_req >= 0:
                try:
                    self.grpc_receiver = self._make_grpc_receiver(
                        self._grpc_port_req
                    )
                    self.grpc_receiver.start()
                except ImportError:
                    self.grpc_receiver = None
            self._start_frontdoor()
            self._register_serving_components()
        except Exception:  # noqa: BLE001 — promotion retries, never parks
            logging.getLogger(__name__).exception(
                "promotion failed; returning to standby for retry"
            )
            self.role = ROLE_STANDBY
            return
        if self.repl_standby is not None:
            try:
                self.repl_standby.stop()
            except Exception:  # noqa: BLE001 — a half-dead client must
                pass  # not block the failover
        self.role = ROLE_PRIMARY
        self.registry.counter_add(tele_metrics.ANOMALY_FAILOVERS, 1.0)
        self.flight.record(
            "role", state=ROLE_PRIMARY, epoch=epoch,
            offsets={str(k): v for k, v in self._offsets.items()},
        )
        # Queries fail over WITH the role: the engine's role-dispatched
        # snapshot now reads live state (an already-serving read
        # replica needs no rewiring); a standby that booted with
        # read-replica off starts its listeners here. A bind failure
        # (port clash on a shared host) must not kill a daemon that
        # just took over ingest — promote without the read path.
        try:
            self._start_query_plane()
        except Exception:  # noqa: BLE001 — read path is optional after promotion; ingest must live
            logging.getLogger(__name__).exception(
                "promoted, but the query listener failed to start — "
                "serving ingest without the read path"
            )
        # The promoted daemon owns the compaction duty now (its
        # appends stamp the bumped epoch — the old primary's are
        # refused). Optional like the read path: ingest must live.
        try:
            self._start_history_writer()
        except Exception:  # noqa: BLE001 — history is an optional tier; ingest must live
            logging.getLogger(__name__).exception(
                "promoted, but the history writer failed to start"
            )
        try:
            # The promoted daemon owns eviction duty now, same as
            # compaction: a standby never ran local sweeps.
            self._start_keyspace()
        except Exception:  # noqa: BLE001 — the keyspace plane is optional; ingest must live
            logging.getLogger(__name__).exception(
                "promoted, but the keyspace watchdog failed to start"
            )
        if self.ckpt_path:
            # Durable promotion (and the first fencing artifact the old
            # primary can trip over on a shared volume).
            self._supervisor.run_step("checkpoint", self._checkpoint)
        if self._repl_port >= 0:
            # Serve the NEXT standby (failure here is the supervised
            # replication component's to retry, not the promotion's).
            try:
                self._start_replication_primary()
            except Exception:  # noqa: BLE001 — the supervised replication component retries the listener
                logging.getLogger(__name__).exception(
                    "promoted, but the replication listener failed to "
                    "start — running unreplicated until it recovers"
                )
        logging.getLogger(__name__).warning(
            "promoted to primary at epoch %d (offsets %s)",
            epoch, dict(self._offsets),
        )

    def _become_fenced(self, at_boot: bool = False) -> None:
        self.role = ROLE_FENCED
        self.registry.counter_add(
            tele_metrics.ANOMALY_REPLICATION_FENCED, 1.0, path="role",
        )
        self.flight.record(
            "role", state=ROLE_FENCED, at_boot=at_boot,
            epoch=self._fence.epoch, observed=self._fence.observed,
        )
        self.flight.dump("fenced")
        if self.repl_primary is not None:
            try:
                self.repl_primary.stop()
            except Exception:  # noqa: BLE001 — fenced teardown is best-effort; the daemon is exiting serving anyway
                pass
        if self.history_writer is not None:
            # Deliberate stop (the supervised probe is role-gated):
            # every further append would be fence-refused anyway, and
            # sealing now keeps the log's tail durable for whoever owns
            # the volume next.
            try:
                self.history_writer.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        if self.keyspace is not None:
            # A fenced process must not keep mutating its state tree
            # (evictions bump the generation — noise for forensics).
            try:
                self.keyspace.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        # Stop SERVING too: a fenced replica that kept answering OTLP
        # would hold the orchestrator's readiness probes (the k8s
        # bundle probes grpc.health on :4317) and the collector's
        # traffic on a process whose durable writes are all rejected —
        # the failover would never actually move ingest. The supervised
        # receiver components are role-gated (below), so this is a
        # deliberate stop, not a crash they would undo.
        for recv in (self.receiver, self.grpc_receiver):
            if recv is None:
                continue
            try:
                recv.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self.receiver = None
        self.grpc_receiver = None
        logging.getLogger(__name__).error(
            "fenced%s: epoch %d superseded by %d — durable writes "
            "stopped (checkpoint/offset-commit/replication); redeploy "
            "this process as a standby or retire it",
            " at boot" if at_boot else "",
            self._fence.epoch, self._fence.observed,
        )

    def _pump_orders(self) -> None:
        # Saturation pause: Kafka is the one ingest leg with a durable
        # upstream buffer, so backpressure here is simply NOT polling —
        # offsets hold, the broker keeps the log, nothing is shed, and
        # the consumer resumes exactly where it paused once the queue
        # drains below the low watermark (at-least-once preserved).
        paused = self.pipeline.saturated
        if paused != self._kafka_paused:
            self._kafka_paused = paused
            self.registry.gauge_set(
                tele_metrics.ANOMALY_KAFKA_PAUSED, 1.0 if paused else 0.0
            )
        if paused:
            return
        # Deferred flush confirmations first: merge the offsets of any
        # earlier pool flush that has since resolved CLEANLY (a failed
        # flush keeps its offsets out of the checkpoint, so a restart
        # replays those records — at-least-once, never silent loss).
        # The list is BOUNDED: sheds are counted and force a checkpoint
        # barrier (persist what IS confirmed, bound the replay window).
        if len(self._deferred_offsets):
            with self._offsets_lock:
                self._offsets.update(self._deferred_offsets.resolve())
        dropped = self._deferred_offsets.dropped_total
        if dropped != self._defer_dropped_seen:
            self.registry.counter_add(
                tele_metrics.ANOMALY_OFFSET_DEFER_DROPPED,
                float(dropped - self._defer_dropped_seen),
            )
            self._defer_dropped_seen = dropped
        if self._deferred_offsets.take_barrier() and self.ckpt_path:
            self._supervisor.run_step("checkpoint", self._checkpoint)
        # One poll = one batch: records coalesce into a single
        # tensorize pass (through the ingest pool when enabled, so the
        # Kafka leg shares the pool's flush amortization) instead of a
        # per-record submit that took the pipeline lock per message.
        # Offsets merge into the checkpointable map only AFTER the
        # records reach the pipeline — "checkpoint offsets correspond
        # to submitted sketch rows" is the resume invariant.
        offsets, batch = self._orders.poll_batch(0.0)
        if not batch:
            # Tombstones / quarantined poison pills: their offsets
            # still advance, or a pill at the partition tail replays
            # (and re-logs) on every restart.
            with self._offsets_lock:
                    self._offsets.update(offsets)
            return
        if self.ingest_pool is not None:
            from .ingest_pool import IngestPoolSaturated

            try:
                ticket = self.ingest_pool.submit_records(batch)
                # Wait for the flush (one coalesced flush, not a round
                # trip per record); on timeout the confirmation — and
                # the offset merge — is deferred to a later pump.
                ticket.result(timeout=10.0)
                with self._offsets_lock:
                    self._offsets.update(offsets)
            except IngestPoolSaturated:
                # The pool queue is full: fall back to the direct path
                # rather than dropping.
                self.pipeline.submit(batch)
                with self._offsets_lock:
                    self._offsets.update(offsets)
            except TimeoutError:
                # Flush still pending (wedged worker — the
                # supervisor's probe/restart handles it); records sit
                # in the pool queue, offsets withheld until confirmed.
                self._deferred_offsets.add(ticket, offsets)
            # An IngestWorkerError resolution means the flush died
            # server-side: offsets are NOT merged (the records never
            # reached the pipeline), so a restart replays them.
        else:
            self.pipeline.submit(batch)
            with self._offsets_lock:
                    self._offsets.update(offsets)
        quarantined = self._orders.decode_failures
        if quarantined != self._quarantine_seen:
            self.registry.counter_add(
                tele_metrics.ANOMALY_QUARANTINE_TOTAL,
                float(quarantined - self._quarantine_seen),
                source="orders",
            )
            self.registry.gauge_set(
                tele_metrics.ANOMALY_QUARANTINE_LAST_ERROR_TS,
                self._orders.last_error_ts,
                source="orders",
            )
            self._quarantine_seen = quarantined

    def _checkpoint(self) -> None:
        # Fence first (a process that has OBSERVED a newer epoch must
        # not write even to an empty path), then the epoch-stamped save
        # (which additionally refuses to replace a newer-epoch snapshot
        # on a shared volume — checkpoint.StaleEpochError either way).
        self._fence.check(path="checkpoint")
        checkpoint.save(
            self.ckpt_path,
            self.detector,
            offsets=dict(self._offsets),
            service_names=self.pipeline.tensorizer.service_names,
            metrics_feed=self.metrics_feed,
            epoch=self._fence.epoch,
            # The keyspace generation restores WITH the name table:
            # a restored primary keeps refusing pre-sweep frames.
            generation=self.pipeline.tensorizer.generation,
            # The copy-out is enqueued under the pipeline's dispatch
            # lock, on the stream the steps run on: it holds every step
            # dispatched before it and no later one.
            dispatch_lock=self.pipeline._dispatch_lock,
            stream=self.pipeline.step_stream,
        )
        self._last_ckpt = time.monotonic()
        if self._orders is not None and self._offsets:
            # Epoch-tagged broker commit beside the snapshot: the
            # broker becomes a fencing witness any resurrected writer
            # consults at boot. Broker-down is NOT a checkpoint failure
            # (the snapshot, the real durability, already landed) — but
            # a StaleEpochError propagates: it means fence state
            # changed mid-step and the caller must see it.
            try:
                self._orders.commit(self._offsets, epoch=self._fence.epoch)
            except checkpoint.StaleEpochError:
                raise
            except Exception:  # noqa: BLE001 — transport-only failure
                pass

    def run(self, on_ready=None) -> None:
        """Blocking serve loop; returns after :meth:`stop`.

        ``on_ready(daemon)`` fires once after the listeners start —
        the hook for announcing resolved ports."""
        self.start()
        if on_ready is not None:
            on_ready(self)
        try:
            while not self._stop.wait(self.pump_interval_s):
                # Guarded: one bad step (a transient device/transport/
                # filesystem fault) backs off and retries — the serve
                # loop of an always-on sidecar must not be one
                # exception away from exit. A genuine crash loop
                # surfaces as anomaly_degraded + component "pump".
                self._supervisor.run_step("pump", self.step)
                # Tick again OUTSIDE the guarded step: step() ticks on
                # the happy path, but a persistently-failing pump must
                # not also starve every other component of its probes
                # and restarts — multi-fault incidents are exactly when
                # the supervision tree earns its keep.
                self._supervisor.tick()
        finally:
            self.shutdown()

    def stop(self) -> None:
        self._stop.set()

    def shutdown(self) -> None:
        if self.fleet is not None:
            self.fleet.stop()
        if self._adoption_mirror is not None:
            self._adoption_mirror.stop()
        if self.aggregator_service is not None:
            self.aggregator_service.stop()
        if self.repl_standby is not None:
            self.repl_standby.stop()
        if self.repl_primary is not None:
            self.repl_primary.stop()
        if self.query_service is not None:
            self.query_service.stop()
        if self.query_grpc is not None:
            self.query_grpc.stop()
        if self.receiver is not None:
            self.receiver.stop()
        if self.grpc_receiver is not None:
            self.grpc_receiver.stop()
        if self.frontdoor is not None:
            # Quiesce + drain in-flight verdicts BEFORE the decode
            # pool closes: a ticket the pool will never resolve must
            # get its 503, not a hung socket.
            self.frontdoor.stop()
        if self._orders is not None:
            self._orders.close()
        if self.keyspace is not None:
            # Before the pipeline drains: a sweep mid-drain would race
            # the final flushes for the dispatch lock for no benefit.
            self.keyspace.close()
        # Stop the remediation worker before the pipeline drains: no
        # new reports can arrive, and a queued actuation against a dead
        # flagd must not pin shutdown past its bounded retries.
        self.remediation.close()
        self.autoscaler.close()
        if self.ingest_pool is not None:
            # Receivers are stopped, so no new jobs: flush the decode
            # queue into the pipeline, then stop the workers — BEFORE
            # the pipeline drains, so nothing in flight is lost.
            self.ingest_pool.close()
        self.pipeline.close()  # drain + stop the harvester thread if any
        # Final provenance drain AFTER the pipeline drain (bundles the
        # last batches flagged) and BEFORE the writer closes, so they
        # make the sealed log.
        try:
            self._export_provenance_stats()
        except Exception:  # noqa: BLE001 — shutdown must not hang on it
            pass
        if self.history_writer is not None:
            # After the pipeline drain (the last captured batches are
            # in the queue) and before the final checkpoint: one last
            # tick + seal so the log ends durable.
            self.history_writer.close()
        if self.ckpt_path and self.role == ROLE_PRIMARY:
            # A standby's state is the primary's to persist; a fenced
            # ex-primary's save would (correctly) raise — neither
            # writes a shutdown snapshot.
            self._checkpoint()
        if self._selftrace_poster is not None:
            # Ship whatever traces the drain produced, then stop the
            # sender — bounded: shutdown never hangs on a dead sink.
            self._selftrace_poster.flush(timeout_s=1.0)
            self._selftrace_poster.close()
        if self._explain_poster is not None:
            self._explain_poster.flush(timeout_s=1.0)
            self._explain_poster.close()
        self.exporter.stop()


def main(argv: list[str] | None = None) -> None:
    import faulthandler
    import signal

    parser = argparse.ArgumentParser(
        prog="python -m opentelemetry_demo_tpu_torch",
        description="The anomaly-detector daemon; configured by the "
        "ANOMALY_* environment (utils.config).",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the CUDA card; 'cpu' for "
        "the plain PyTorch path)",
    )
    args = parser.parse_args(argv)
    # SIGUSR1 dumps all stacks — the debugging handle for a wedged
    # daemon (kill -USR1 <pid>), matching Go services' SIGQUIT habit.
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    daemon = DetectorDaemon(device=args.device)
    signal.signal(signal.SIGTERM, lambda *_: daemon.stop())
    signal.signal(signal.SIGINT, lambda *_: daemon.stop())

    def announce(d: DetectorDaemon) -> None:
        # Announce resolved ports (env may request ephemeral :0) so
        # operators and cross-process harnesses can discover them.
        grpc_port = d.grpc_receiver.port if d.grpc_receiver else -1
        http_port = d.receiver.port if d.receiver else -1
        repl_port = d.repl_primary.port if d.repl_primary else -1
        # A constructed-but-unstarted QueryService (standby with
        # read-replica off) would report its *requested* port; gate on
        # _query_started so -1 means "nothing listening", like repl.
        query_port = (
            d.query_service.port
            if d.query_service is not None and d._query_started
            else -1
        )
        print(
            f"anomaly-detector: otlp-http :{http_port} "
            f"otlp-grpc :{grpc_port} metrics :{d.exporter.port} "
            f"repl :{repl_port} query :{query_port} role {d.role}",
            flush=True,
        )

    daemon.run(on_ready=announce)


if __name__ == "__main__":
    main()
