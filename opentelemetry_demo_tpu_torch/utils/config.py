"""Environment config contract: hard-fail on missing keys.

Mirrors the reference's two-tier config system (SURVEY.md §5 "Config /
flag system"): static configuration arrives exclusively through
environment variables and a service must refuse to boot when a required
key is absent — the behaviour every reference service implements
(Go ``mustMapEnv`` in the upstream demo's src/checkout/main.go:230-236,
Python ``must_map_env`` in src/recommendation/recommendation_server.py:116-120,
Kotlin in src/fraud-detection/src/main/kotlin/frauddetection/main.kt:42-46).
Failing fast at boot beats a half-configured service discovered at 3am.
"""

from __future__ import annotations

import os


class ConfigError(RuntimeError):
    """A required environment key is missing or malformed."""


def must_map_env(target: dict, key: str, env_name: str) -> None:
    """Fetch ``env_name`` into ``target[key]`` or refuse to boot."""
    value = os.environ.get(env_name, "")
    if not value:
        raise ConfigError(f"environment variable {env_name} not set")
    target[key] = value


def env_str(env_name: str, default: str | None = None) -> str:
    value = os.environ.get(env_name, "")
    if value:
        return value
    if default is None:
        raise ConfigError(f"environment variable {env_name} not set")
    return default


def env_int(env_name: str, default: int | None = None) -> int:
    raw = os.environ.get(env_name, "")
    if not raw:
        if default is None:
            raise ConfigError(f"environment variable {env_name} not set")
        return default
    try:
        return int(raw)
    except ValueError as e:
        raise ConfigError(f"{env_name}={raw!r} is not an integer") from e


def env_float(env_name: str, default: float | None = None) -> float:
    raw = os.environ.get(env_name, "")
    if not raw:
        if default is None:
            raise ConfigError(f"environment variable {env_name} not set")
        return default
    try:
        return float(raw)
    except ValueError as e:
        raise ConfigError(f"{env_name}={raw!r} is not a number") from e


# Overload-protection knobs (runtime.pipeline bounded admission /
# brownout; runtime/daemon.py threads them into the pipeline). ONE
# declarative registry — env name → (type, default, meaning) — so the
# daemon, the compose overlay, the k8s generator and sanitycheck.py can
# never disagree about the knob set: scripts/sanitycheck.py asserts
# every key here appears in deploy/docker-compose.anomaly.yml,
# utils/k8s.py and runtime/daemon.py. Values must stay literals
# (sanitycheck reads this dict via ast.literal_eval, without importing
# torch).
OVERLOAD_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_QUEUE_MAX_ROWS": (
        "int", 65536,
        "pending-queue row budget (0 = unbounded; the memory_limiter "
        "analogue for the span pipeline)",
    ),
    "ANOMALY_QUEUE_HIGH_WATERMARK": (
        "float", 0.85,
        "fraction of the row budget at which admission saturates "
        "(OTLP answers 429/RESOURCE_EXHAUSTED)",
    ),
    "ANOMALY_QUEUE_LOW_WATERMARK": (
        "float", 0.5,
        "fraction of the row budget at which admission resumes "
        "(hysteresis: must be below the high watermark)",
    ),
    "ANOMALY_BROWNOUT_HOLD_S": (
        "float", 2.0,
        "sustained-saturation seconds before the brownout ladder moves "
        "one level (and sustained-clear seconds before it relaxes one)",
    ),
    "ANOMALY_BROWNOUT_MAX_LEVEL": (
        "int", 4,
        "deepest head-sampling level: level L keeps 1/2^L of OK-lane "
        "spans (error-lane spans always pass)",
    ),
    "ANOMALY_RETRY_AFTER_S": (
        "float", 1.0,
        "the longest Retry-After hint (seconds) handed to throttled OTLP "
        "producers; a saturated queue answers the time its pump needs to "
        "drain to the low watermark, at most this",
    ),
}


# Parallel host-ingest knobs (runtime.ingest_pool: the sharded decode
# pool between the OTLP/Kafka receivers and the pipeline). Same ONE-
# registry discipline as OVERLOAD_KNOBS — the daemon, the compose
# overlay, the k8s generator and sanitycheck.py all consume this dict,
# so the knob set can never drift between them. Values must stay
# literals (sanitycheck reads via ast.literal_eval, without importing
# torch).
INGEST_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_INGEST_WORKERS": (
        "int", 2,
        "decode-pool worker threads (0 = no pool: serial in-thread "
        "decode on the receiver threads, the pre-pool path)",
    ),
    "ANOMALY_INGEST_COALESCE": (
        "int", 64,
        "max export requests folded into ONE native batch decode + "
        "tensorize + pipeline merge (a worker drains up to this many "
        "queued requests per flush; coalescing is opportunistic, so an "
        "idle stream still sees single-request latency)",
    ),
    "ANOMALY_INGEST_MAX_PENDING": (
        "int", 512,
        "bounded request queue ahead of the decode pool; a full queue "
        "answers retryable 429/RESOURCE_EXHAUSTED (no unbounded buffer "
        "ever forms before the pipeline's row-budgeted admission)",
    ),
    "ANOMALY_INGEST_NATIVE_THREADS": (
        "int", 2,
        "native extraction threads PER batched decode call (the "
        "two-pass scanner's pass-2 sharding: one oversized flush "
        "splits across cores at span-record boundaries); <=1 keeps "
        "extraction serial per call",
    ),
    "ANOMALY_INGEST_SHARD_MIN_BYTES": (
        "int", 262144,
        "payload-byte floor below which a batched decode never shards "
        "across native threads (thread spawn/join would cost more "
        "than the extraction it hides)",
    ),
}


# Hot-standby replication knobs (runtime.replication: epoch-fenced
# primary→standby state streaming; runtime/daemon.py role state
# machine). Same ONE-registry discipline as OVERLOAD_KNOBS/INGEST_KNOBS
# — daemon, compose overlay, k8s generator and sanitycheck.py all
# consume this dict. Values must stay literals (sanitycheck reads via
# ast.literal_eval, without importing torch).
REPLICATION_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_ROLE": (
        "str", "primary",
        "boot role: 'primary' serves + ships deltas, 'standby' applies "
        "them and promotes itself when the primary goes quiet",
    ),
    "ANOMALY_REPLICATION_PORT": (
        "int", -1,
        "primary-side replication listener port (-1 disables "
        "replication; a promoted standby opens the same listener so "
        "the NEXT standby can attach)",
    ),
    "ANOMALY_REPLICATION_TARGET": (
        "str", "",
        "standby-side primary address host:port (the primary's "
        "ANOMALY_REPLICATION_PORT listener); empty = no replication",
    ),
    "ANOMALY_REPLICATION_INTERVAL_S": (
        "float", 1.0,
        "delta ship cadence seconds — replicated state lags the "
        "primary by at most this much (the failover data-loss bound "
        "for the replace-latest EWMA block; HLL/CMS converge exactly "
        "by merge regardless)",
    ),
    "ANOMALY_FAILOVER_TIMEOUT_S": (
        "float", 5.0,
        "standby watchdog: seconds without a replication frame before "
        "the standby promotes itself (epoch bump + Kafka resume from "
        "the replicated offset map + OTLP ingest up)",
    ),
    "ANOMALY_PRIMARY_HEALTH_ADDR": (
        "str", "",
        "optional grpc.health.v1 address of the primary; when set, the "
        "standby double-checks it before promoting (a SERVING primary "
        "behind a broken replication link must not cause split-brain)",
    ),
    "ANOMALY_OFFSET_DEFER_MAX": (
        "int", 64,
        "cap on the deferred-confirmation offset list (orders flushes "
        "whose pool ticket hasn't resolved); over it the oldest entry "
        "is shed (anomaly_offset_defer_dropped_total — its records "
        "replay on restart, at-least-once preserved) and a checkpoint "
        "barrier is forced",
    ),
}


# Verified-frame knobs (runtime.frame: the ONE columnar wire format —
# checksummed, versioned — that ingest scratch→pipeline, replication
# payloads and checkpoint files all move; runtime/daemon.py threads
# these into frame.configure() at boot). Same ONE-registry discipline
# as the other knob families — daemon, compose overlay, k8s generator
# and sanitycheck.py all consume this dict. Values must stay literals
# (sanitycheck reads via ast.literal_eval, without importing torch).
FRAME_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_FRAME_VERIFY": (
        "int", 1,
        "verify frame checksums (per-column CRC32C + trailer) at every "
        "hop before state merges (0 = trust the bytes — benchmarking "
        "only; corruption then merges undetected, the pre-frame "
        "behavior)",
    ),
    "ANOMALY_FRAME_WRITE_VERSION": (
        "int", 2,
        "frame format version this process WRITES (readers always "
        "accept the full window, currently 1..2): pin to the old "
        "version while a rolling primary/standby upgrade is in flight "
        "so the not-yet-upgraded side keeps reading every payload",
    ),
    "ANOMALY_FRAME_QUARANTINE_DIR": (
        "str", "",
        "directory where frames that fail verification are written "
        "aside for forensics (empty = count + drop for in-memory hops; "
        "corrupt checkpoint FILES always move aside to <file>.corrupt "
        "regardless)",
    ),
}


# Live-query-plane knobs (runtime.query: the HTTP/gRPC read API over
# live sketch state, the Grafana JSON datasource, and read-replica
# serving on a standby; runtime/daemon.py wires them). Same ONE-
# registry discipline as the other knob families — daemon, compose
# overlay, k8s generator and sanitycheck.py all consume this dict.
# Values must stay literals (sanitycheck reads via ast.literal_eval,
# without importing torch).
QUERY_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_QUERY_PORT": (
        "int", 0,
        "HTTP/JSON query port (also the Grafana simple-JSON datasource "
        "surface); 0 binds an ephemeral port (announced at boot), -1 "
        "disables the query plane entirely",
    ),
    "ANOMALY_QUERY_GRPC_PORT": (
        "int", -1,
        "gRPC query port (same documents over "
        "/otdtpu.query.v1.QueryService/Query); -1 disables, 0 binds an "
        "ephemeral port; silently skipped when grpcio is absent",
    ),
    "ANOMALY_QUERY_TOPK": (
        "int", 10,
        "default k for /query/topk heavy-hitter answers (per-request "
        "?k= overrides)",
    ),
    "ANOMALY_QUERY_EXEMPLARS": (
        "int", 8,
        "per-service exemplar-ring size: trace ids captured at flag "
        "time from the flagged batch, linking every anomaly to a "
        "concrete Jaeger trace (0 disables capture)",
    ),
    "ANOMALY_QUERY_CANDIDATES": (
        "int", 64,
        "per-service ring of recently-seen attribute keys — the "
        "candidate set /query/topk scores against the live CMS (a CMS "
        "cannot enumerate its keys); bounds how many distinct keys a "
        "top-k answer can rank, so keep it >= the largest k queried",
    ),
    "ANOMALY_QUERY_TIMELINE": (
        "int", 120,
        "snapshot-timeline ring depth: per-interval cardinality/CUSUM "
        "samples backing Grafana timeseries targets and "
        "/query/cardinality timelines",
    ),
    "ANOMALY_QUERY_READ_REPLICA": (
        "int", 1,
        "1 = a STANDBY serves the query API from its replicated mirror "
        "(staleness-bounded by replication lag, reported per response) "
        "while remaining promotable; 0 = standby serves no queries "
        "until promotion",
    ),
    "ANOMALY_QUERY_MAX_STALENESS_S": (
        "float", 2.0,
        "snapshot cache budget: a query re-snapshots state when the "
        "cached copy is older than this, so every answer is at most "
        "this stale (plus replication lag on a read replica)",
    ),
    "ANOMALY_QUERY_EVICTED_LOOKBACK_S": (
        "float", 3600.0,
        "how far back /query/* searches history for a service the "
        "keyspace evictor retired from the live table; answers found "
        "there are labeled source:\"evicted\" (0 disables the "
        "evicted-key fallback)",
    ),
}


# Daemon-core knobs (runtime/daemon.py boot contract): ports, batch
# geometry, harvest/adaptive cadence, checkpoint path/cadence, body
# cap, and the flag/Kafka wiring env. Historically these were ad-hoc
# ``os.environ`` reads scattered through daemon.__init__ — outside any
# registry, invisible to the deploy surfaces and the checkers. Same
# ONE-registry discipline as every other family; scripts/staticcheck's
# knob-discipline pass (and sanitycheck's literal pins) enforce the
# correspondence. Values must stay literals (read via ast.literal_eval,
# without importing torch). The -1 geometry defaults mean "use the
# model's DetectorConfig default" (this module must stay torch-free, so
# it cannot name those defaults directly).
DAEMON_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_OTLP_PORT": (
        "int", 4318,
        "OTLP/HTTP listen port (the collector's otlphttp exporter "
        "target); 0 binds an ephemeral port",
    ),
    "ANOMALY_OTLP_GRPC_PORT": (
        "int", 4317,
        "OTLP/gRPC listen port (the collector's primary ingress); "
        "-1 disables the gRPC leg",
    ),
    "ANOMALY_METRICS_PORT": (
        "int", 9464,
        "Prometheus /metrics + /healthz listen port",
    ),
    "ANOMALY_BATCH": (
        "int", 2048,
        "device batch size (rows per dispatched step)",
    ),
    "ANOMALY_PUMP_INTERVAL_S": (
        "float", 0.05,
        "batch cadence seconds (the <100ms detection-lag budget "
        "spends half on batching)",
    ),
    "ANOMALY_HARVEST_INTERVAL": (
        "float", 0.0,
        "report readback cadence seconds (0 = harvest every batch; "
        "set on tunneled/remote devices where readback RTT dominates)",
    ),
    "ANOMALY_HARVEST_ASYNC": (
        "int", 0,
        "1 = fetch reports on a background harvester thread so "
        "dispatch never waits on a device->host round trip",
    ),
    "ANOMALY_ADAPTIVE_BATCH": (
        "int", 1,
        "adaptive dispatch-width controller (1 = on): widens batches "
        "in pow2 steps when readback can't keep pace, and widens a "
        "take to the ladder width that holds the pending backlog; "
        "the width ladder precompiles in the background at boot",
    ),
    "ANOMALY_NUM_SERVICES": (
        "int", -1,
        "detector service-axis size (-1 = DetectorConfig default); "
        "smaller geometry shrinks compile time on small deployments",
    ),
    "ANOMALY_CMS_WIDTH": (
        "int", -1,
        "CMS sketch width (-1 = DetectorConfig default)",
    ),
    "ANOMALY_HLL_P": (
        "int", -1,
        "HLL precision p (-1 = DetectorConfig default)",
    ),
    "ANOMALY_WARMUP_BATCHES": (
        "float", -1.0,
        "EWMA warmup batches before z-scores count (-1 = "
        "DetectorConfig default)",
    ),
    "ANOMALY_Z_WARMUP_BATCHES": (
        "float", -1.0,
        "z-score suppression window in batches (-1 = DetectorConfig "
        "default)",
    ),
    "ANOMALY_CHECKPOINT": (
        "str", "",
        "snapshot path prefix (enables offset-keyed checkpoint/resume; "
        "empty = stateless)",
    ),
    "ANOMALY_CHECKPOINT_INTERVAL_S": (
        "float", 30.0,
        "snapshot cadence seconds",
    ),
    "ANOMALY_OTLP_MAX_BODY": (
        "int", 16777216,
        "ingest body-size cap in bytes (oversized exports answer "
        "413/RESOURCE_EXHAUSTED)",
    ),
    "FLAGD_FILE": (
        "str", "",
        "flagd-schema JSON path (hot-reloaded flag store; wins over "
        "OFREP_URL)",
    ),
    "OFREP_URL": (
        "str", "",
        "OFREP flag endpoint (used when FLAGD_FILE is unset)",
    ),
    "KAFKA_ADDR": (
        "str", "",
        "Kafka bootstrap for the orders topic (empty = no Kafka leg)",
    ),
}


# Device-put spine knobs (runtime.spine: the staging ring between the
# pipeline's batch assembly and the donated device step — pack + async
# device puts on the pump thread through a side stream, overlapping
# batch k+1's host→device transfer with batch k's in-flight compute;
# runtime/daemon.py threads these into the pipeline). Same ONE-registry discipline as every
# other family — daemon, compose overlay, k8s generator and
# sanitycheck.py all consume this dict. Values must stay literals
# (sanitycheck reads via ast.literal_eval, without importing torch).
SPINE_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_SPINE_RING": (
        "int", 2,
        "device-put staging ring depth: pre-allocated host batch "
        "buffers the pump thread packs + asynchronously puts through, "
        "so batch k+1's transfer rides behind batch k's in-flight "
        "donated step (2 = classic double buffering; 0 = spine off — "
        "pack+put inline on the pump thread, the pre-spine path)",
    ),
    "ANOMALY_SPINE_OVERLAP": (
        "int", 1,
        "1 = dispatch without waiting on the host for the put: the "
        "step waits for it on the card (transfer hidden behind compute; "
        "anomaly_spine_put_overlap_ratio tracks the hit rate); 0 = "
        "always wait for the put synchronously (A/B debugging)",
    ),
    "ANOMALY_SPINE_CHUNK_ROWS": (
        "int", 0,
        "rows per copy block when packing into a staging slot (cache "
        "blocking for the host pack loop); 0 = whole batch in one pass",
    ),
}


# Detector self-telemetry knobs (runtime.selftrace: the batch-lifecycle
# tracer exporting the daemon's OWN traces into the telemetry stack it
# monitors; runtime.flightrec: the flight-recorder event ring dumped as
# evidence on health/role transitions). Same ONE-registry discipline as
# every other family — daemon, compose overlay, k8s generator and
# sanitycheck.py all consume this dict. Values must stay literals
# (sanitycheck reads via ast.literal_eval, without importing torch).
SELFTRACE_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_SELFTRACE_ENABLE": (
        "int", 1,
        "1 = trace sampled batch lifecycles (decode→…→flag) and export "
        "them through the background OTLP poster; 0 = tracer off "
        "(phase histograms and the flight recorder stay on — they are "
        "metrics/forensics, not traces)",
    ),
    "ANOMALY_SELFTRACE_SAMPLE": (
        "float", 0.01,
        "head-sampling rate in [0,1]: batch seq is hashed with "
        "splitmix64 and sampled below rate*2^64 — deterministic, so "
        "every replica and restart agrees which batches carry traces",
    ),
    "ANOMALY_SELFTRACE_ENDPOINT": (
        "str", "",
        "OTLP endpoint the detector's own traces export to "
        "(http(s)://host:4318 or grpc://host:4317 — the collector the "
        "shop already feeds, so detector batch traces land in the same "
        "Jaeger); empty = encode-only (tests/bench read the bytes)",
    ),
    "ANOMALY_SELFTRACE_FLIGHT_RING": (
        "int", 512,
        "flight-recorder ring size (structured runtime events: role/"
        "epoch moves, shed/brownout steps, fence hits, quarantines, "
        "phase snapshots); the ring is the /query/flight body and the "
        "dump payload",
    ),
    "ANOMALY_SELFTRACE_FLIGHT_DIR": (
        "str", "",
        "directory for flight-recorder evidence dumps written on every "
        "DEGRADED/SATURATED/FENCED/PROMOTING transition "
        "(flight-<reason>-<ms>.json, per-reason cooldown); empty = "
        "ring-only, nothing written",
    ),
}


# Time-travel history tier knobs (runtime.history: the compaction
# thread folding expiring window banks into an on-disk retention
# ladder of verified frames, the range-query read path, and the span
# capture leg runtime.replaybench replays; runtime/daemon.py threads
# them). Same ONE-registry discipline as every other family — daemon,
# compose overlay, k8s generator and sanitycheck.py all consume this
# dict. Values must stay literals (sanitycheck reads via
# ast.literal_eval, without importing torch).
HISTORY_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_HISTORY_DIR": (
        "str", "",
        "segment-log directory for the frame-native history store "
        "(empty = time-travel tier off: no compaction thread, range "
        "queries answer 404)",
    ),
    "ANOMALY_HISTORY_RUNGS": (
        "str", "1,60,3600",
        "retention-ladder rung spans in seconds, finest first; each "
        "rung folds the previous one's records by the sketch monoids "
        "(HLL max-merge, CMS add-merge; EWMA/CUSUM heads keep "
        "last-value-per-rung), so every rung must divide the next",
    ),
    "ANOMALY_HISTORY_RETENTION_S": (
        "str", "3600,86400,604800",
        "per-rung retention caps in seconds (one entry per rung): "
        "sealed segments whose newest record ages past the cap are "
        "deleted oldest-first; span-capture records share rung 0's cap",
    ),
    "ANOMALY_HISTORY_COMPACT_INTERVAL_S": (
        "float", 0.5,
        "compaction-thread tick seconds: how often the writer "
        "snapshots state (under the dispatch lock, same discipline as "
        "replication) looking for a completed shortest-window bank to "
        "fold into the ladder; keep below the shortest rung span or "
        "completed windows are missed (counted, never mis-merged)",
    ),
    "ANOMALY_HISTORY_SEGMENT_MB": (
        "int", 8,
        "segment roll size in MiB: the active segment seals "
        "(flush+fsync+rename, the checkpoint crash-safety discipline) "
        "and a new one opens once it grows past this",
    ),
    "ANOMALY_HISTORY_SPANS": (
        "str", "0",
        "span-batch capture policy for the replay corpus "
        "runtime.replaybench re-feeds through the real pipeline: "
        "'0' = off, '1' = capture every dispatched batch (one "
        "host-side column copy per batch plus rung-0-retention disk), "
        "or a per-service sample-rate map 'svc:rate,svc2:rate[,*:rate]' "
        "(rates in [0,1]; '*' is the default for unlisted services, 0 "
        "when absent) — record a mitigation drill's flagged service at "
        "100% without capturing the full firehose; rows sample "
        "deterministically by trace key, so reruns keep the same spans",
    ),
    "ANOMALY_HISTORY_REPLAY_RATE": (
        "float", 10.0,
        "target wall-clock speedup for replaybench (virtual-time "
        "clock injection re-feeds recorded frames at N x real time); "
        "bench.py gates replay_speedup against this",
    ),
}


# Closed-loop auto-mitigation knobs (runtime.remediation: the
# supervised controller that subscribes to the pipeline's per-service
# anomaly verdicts and — ONLY when opted in — drives the flagd
# mitigation flags and the sampling policy, then verifies its own
# action recovered the system). Same ONE-registry discipline as every
# other family — daemon, compose overlay, k8s generator and
# sanitycheck.py all consume this dict. Values must stay literals
# (sanitycheck reads via ast.literal_eval, without importing torch).
REMEDIATION_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_REMEDIATION_ENABLE": (
        "int", 0,
        "1 = the controller ACTS (flips mitigation flags / promotes "
        "sampling) on a PRIMARY; 0 (the default — auto-mitigation is "
        "strictly opt-in) = observe-only: the controller tracks "
        "episodes and exports metrics but never writes an actuator",
    ),
    "ANOMALY_REMEDIATION_ACT_BATCHES": (
        "int", 3,
        "hysteresis, acting half: consecutive flagged batches a "
        "service must accrue before the controller actuates (one "
        "noisy batch must never flip a production flag)",
    ),
    "ANOMALY_REMEDIATION_CLEAR_BATCHES": (
        "int", 8,
        "hysteresis, clearing half: consecutive clean batches after "
        "an actuation before recovery is VERIFIED and the actuation "
        "reverts (also how long a MITIGATION_FAILED service stays "
        "sticky before the episode resets)",
    ),
    "ANOMALY_REMEDIATION_BUDGET": (
        "int", 4,
        "token-bucket capacity: maximum actuations in flight-window "
        "burst; a flapping detector exhausts the bucket and the flags "
        "STAY in their last state instead of oscillating",
    ),
    "ANOMALY_REMEDIATION_BUDGET_REFILL_S": (
        "float", 60.0,
        "seconds per token refill (observed-timebase): the sustained "
        "actuation rate ceiling, 1 action per this many seconds",
    ),
    "ANOMALY_REMEDIATION_DEADLINE_S": (
        "float", 30.0,
        "verified-recovery deadline (observed-timebase seconds after "
        "acting): no clean-streak verification within it rolls the "
        "actuation back and parks the service in MITIGATION_FAILED",
    ),
    "ANOMALY_REMEDIATION_ROLLBACK": (
        "int", 1,
        "1 = automatically roll the actuation back when the recovery "
        "deadline expires (restore the flag's prior state); 0 = leave "
        "the mitigation in place and only mark MITIGATION_FAILED "
        "(for mitigations an operator prefers sticky, e.g. load shed)",
    ),
    "ANOMALY_REMEDIATION_FLAG_URL": (
        "str", "",
        "remote flag-write base URL (the flag editor mounted on the "
        "shop gateway, e.g. http://gateway:8080/feature — the "
        "actuator calls its GET /api/read-file + POST "
        "/api/write-to-file routes); when set it wins over the local "
        "FLAGD_FILE store — every write is bounded-timeout with "
        "capped jittered retry, and a dead/slow endpoint queues or "
        "fails the ACTION, never the ingest path",
    ),
    "ANOMALY_REMEDIATION_TIMEOUT_S": (
        "float", 1.0,
        "per-actuator-write transport bound (connect/read); with the "
        "bounded retry count this caps what one sick flagd write can "
        "cost the worker thread",
    ),
    "ANOMALY_REMEDIATION_SAMPLING": (
        "int", 1,
        "1 = the sampling-policy actuator runs beside the flagd one: "
        "a flagged service is promoted to keep-100% span capture "
        "(seeded with its flag-time exemplar trace ids) while quiet "
        "services keep the configured ANOMALY_HISTORY_SPANS policy; "
        "0 = flagd actuator only",
    ),
    "ANOMALY_REMEDIATION_COLLECTOR_PATH": (
        "str", "",
        "collector-steering leg, file transport: path the "
        "CollectorActuator atomically writes its rendered "
        "tail-sampling policy document to (an otelcol config "
        "reloader/sidecar watches it — see "
        "deploy/otelcol-config-anomaly.yml); empty AND no URL = the "
        "collector actuator is off (the default)",
    ),
    "ANOMALY_REMEDIATION_COLLECTOR_URL": (
        "str", "",
        "collector-steering leg, HTTP transport: base URL whose POST "
        "/api/sampling-policy receives the rendered tail-sampling "
        "policy (bounded timeout + the worker's capped jittered "
        "retry); wins over the file path when both are set",
    ),
    "ANOMALY_REMEDIATION_COLLECTOR_BASE_KEEP": (
        "float", 0.1,
        "head-sampling keep fraction [0,1] for QUIET services in the "
        "pushed collector policy (flagged services always keep 1.0); "
        "the policy-implied storage fraction is exported as "
        "anomaly_collector_keep_ratio",
    ),
}


# Sharded-fleet knobs (runtime.fleet: consistent-hash keyspace
# partitioning over (service × tenant) keys, heartbeat membership with
# guardrailed reshard; runtime.aggregator: the scatter-gather read tier
# behind the existing /query/* API). Same ONE-registry discipline as
# every other family — daemon, compose overlay, k8s generator and
# sanitycheck.py all consume this dict. Values must stay literals
# (sanitycheck reads via ast.literal_eval, without importing torch).
FLEET_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_FLEET_SHARDS": (
        "int", 0,
        "detector shard count N (0/1 = fleet off: the classic single "
        "primary + hot standby deployment); each shard is a FULL "
        "daemon — its own epoch fence, standby, history, remediation "
        "gating — consuming only its assigned Kafka partitions / "
        "OTLP-routed slice of the keyspace",
    ),
    "ANOMALY_FLEET_SHARD_INDEX": (
        "int", 0,
        "this shard's index in 0..N-1 (its ring member id is "
        "shard-<index>); Kafka partition assignment and the "
        "collector's OTLP routing key off the same index",
    ),
    "ANOMALY_FLEET_PEERS": (
        "str", "",
        "comma list of PEER health addresses host:metrics_port, "
        "index-aligned with the shard indices (this shard's own entry "
        "may be present and is skipped): the membership heartbeat "
        "polls each peer's /healthz on this address",
    ),
    "ANOMALY_FLEET_QUERY_PEERS": (
        "str", "",
        "comma list of shard QUERY-plane addresses host:query_port, "
        "index-aligned like ANOMALY_FLEET_PEERS: the aggregator tier "
        "fans /query/* out to these and merges the shard frames",
    ),
    "ANOMALY_FLEET_VNODES": (
        "int", 128,
        "virtual nodes per shard on the consistent-hash ring: more "
        "vnodes = tighter balance (the fleet suite pins the balance "
        "bound at this default) at O(N*vnodes) ring-build cost",
    ),
    "ANOMALY_FLEET_SERVICES": (
        "str", "",
        "comma list of service names PRE-INTERNED in this exact order "
        "on every shard at boot — the shared service-id table that "
        "makes cross-shard monoid merges (reshard frame adoption) "
        "bit-exact: CMS cells fold the service id into the key hash, "
        "so shards whose intern tables drift cannot exchange frames; "
        "empty = dynamic interning (single-shard behavior)",
    ),
    "ANOMALY_FLEET_HEARTBEAT_S": (
        "float", 1.0,
        "membership heartbeat cadence seconds (one /healthz poll per "
        "peer per tick)",
    ),
    "ANOMALY_FLEET_DEAD_AFTER_S": (
        "float", 3.0,
        "hysteresis, down edge: heartbeat silence seconds before a "
        "peer is DECLARED dead and its key range reassigned — but "
        "only after the health double-check below also fails (a "
        "compile-stalled-but-serving shard is not dead)",
    ),
    "ANOMALY_FLEET_REJOIN_AFTER_S": (
        "float", 5.0,
        "hysteresis, up edge: a dead peer must answer heartbeats "
        "continuously for this long before it REJOINS the ring (a "
        "flapping shard cannot thrash the keyspace on every blip)",
    ),
    "ANOMALY_FLEET_RESHARD_BUDGET": (
        "int", 4,
        "token-bucket capacity on ring membership changes: a flapping "
        "shard exhausts the bucket and the ring FREEZES in its last "
        "state (reshards refused + counted) instead of thrashing — "
        "the brownout-ladder / actuation-budget guardrail "
        "construction",
    ),
    "ANOMALY_FLEET_RESHARD_REFILL_S": (
        "float", 60.0,
        "seconds per reshard-budget token refill: the sustained "
        "membership-change rate ceiling, 1 reshard per this many "
        "seconds",
    ),
    "ANOMALY_FLEET_TENANTS": (
        "str", "",
        "per-tenant sketch namespaces: a comma map "
        "'service:tenant[,*:tenant]' assigning every service to a "
        "tenant ('*' is the default for unlisted services; absent = "
        "tenant 'default') — ring keys are tenant/service, and the "
        "per-tenant quota below sheds one noisy tenant's rows alone "
        "(anomaly_shed_rows_total{tenant=})",
    ),
    "ANOMALY_FLEET_TENANT_QUOTA_ROWS_S": (
        "float", 0.0,
        "per-tenant admission quota in rows/second (token bucket, 1 s "
        "burst), folded into the backpressure ladder AHEAD of the "
        "global row budget: a tenant over quota has its OK-lane rows "
        "shed (error lane always passes) while other tenants' "
        "admission and TTD are untouched; 0 = no per-tenant quota",
    ),
    "ANOMALY_AGGREGATOR_PORT": (
        "int", -1,
        "scatter-gather aggregator HTTP port (the fleet-global "
        "/query/* surface; runtime.aggregator main): -1 = this "
        "process serves no aggregator, 0 = ephemeral",
    ),
    "ANOMALY_AGGREGATOR_TIMEOUT_S": (
        "float", 1.0,
        "per-shard fan-out timeout seconds: a shard that cannot "
        "answer within this is annotated missing and the merged "
        "answer degrades to a labeled PARTIAL result "
        "(shards_answered/shards_total) — never a crashed query",
    ),
    "ANOMALY_FLEET_REPL_PEERS": (
        "str", "",
        "comma list of per-shard REPLICATION-stream addresses "
        "host:repl_port, index-aligned like ANOMALY_FLEET_PEERS: each "
        "shard subscribes a standby mirror to its ring-successor's "
        "stream so a declared-dead pair's keyspace is ADOPTED by the "
        "survivor automatically (merge under the dispatch lock, new "
        "ring version, flight-recorded) with zero operator action; "
        "empty = no adoption mirrors (the operator-merge "
        "behavior)",
    ),
}


# Fleet autoscaler knobs (runtime.autoscale: the supervised,
# STRICTLY OPT-IN controller that proposes shard split on sustained
# brownout and join on sustained idle, behind the same token-bucket +
# two-edge-hysteresis guardrails as remediation and reshard — a
# flapping load shape exhausts the budget and FREEZES the ring instead
# of oscillating it; every decision is epoch-fenced, the sixth fenced
# path, and evidence-dumped). Same ONE-registry discipline as every
# other family — daemon, compose overlay, k8s generator and
# sanitycheck.py all consume this dict. Values must stay literals
# (sanitycheck reads via ast.literal_eval, without importing torch).
AUTOSCALE_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_AUTOSCALE_ENABLE": (
        "int", 0,
        "1 = the autoscaler PROPOSES ring resizes (split/join) on a "
        "PRIMARY; 0 (the default — elastic scaling is strictly "
        "opt-in) = observe-only: the controller tracks saturation "
        "streaks and exports metrics but never proposes",
    ),
    "ANOMALY_AUTOSCALE_ACT_BATCHES": (
        "int", 5,
        "hysteresis, acting half: consecutive observation windows at "
        "or above the high watermark before a SPLIT is proposed (one "
        "noisy window must never resize a production ring)",
    ),
    "ANOMALY_AUTOSCALE_CLEAR_BATCHES": (
        "int", 30,
        "hysteresis, clearing half: consecutive windows at or below "
        "the low watermark before a JOIN is proposed — deliberately "
        "much longer than the acting half (scaling in is cheap to "
        "defer, expensive to regret)",
    ),
    "ANOMALY_AUTOSCALE_BUDGET": (
        "int", 2,
        "token-bucket capacity on resize proposals: a flapping load "
        "shape exhausts the bucket and the ring FREEZES in its last "
        "shape (proposals refused + counted) instead of oscillating",
    ),
    "ANOMALY_AUTOSCALE_REFILL_S": (
        "float", 300.0,
        "seconds per proposal-budget token refill (observed "
        "timebase): the sustained resize rate ceiling, 1 proposal "
        "per this many seconds",
    ),
    "ANOMALY_AUTOSCALE_HIGH_WATER": (
        "float", 0.75,
        "two-edge hysteresis, upper edge: saturation score (max of "
        "admission watermark fraction, shed activity, brownout "
        "level) at or above which a window counts toward the split "
        "streak",
    ),
    "ANOMALY_AUTOSCALE_LOW_WATER": (
        "float", 0.15,
        "two-edge hysteresis, lower edge: saturation score at or "
        "below which a window counts toward the join streak; scores "
        "between the edges reset BOTH streaks (the dead band that "
        "makes a flapping shape freeze instead of oscillate)",
    ),
    "ANOMALY_AUTOSCALE_MIN_SHARDS": (
        "int", 2,
        "floor on the proposed fleet size: join proposals below it "
        "are refused (counted) — the fleet never scales itself back "
        "to a single point of failure",
    ),
    "ANOMALY_AUTOSCALE_MAX_SHARDS": (
        "int", 8,
        "ceiling on the proposed fleet size: split proposals above "
        "it are refused (counted) — a runaway load shape cannot "
        "demand unbounded hardware",
    ),
}


# Counterfactual pre-flight knobs (runtime.shadow: before the
# remediation controller releases an actuator write, replay the last
# WINDOW_S of recorded span frames through a fresh shadow pipeline
# with the proposed mitigation applied, and refuse acts whose shadow
# heads do not clear). Same ONE-registry discipline as every other
# family — daemon, compose overlay, k8s generator and sanitycheck.py
# all consume this dict. Values must stay literals (sanitycheck reads
# via ast.literal_eval, without importing torch).
SHADOW_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_SHADOW_ENABLE": (
        "int", 0,
        "1 = every remediation act is pre-flighted on a shadow replay "
        "of recorded history before any actuator write (requires "
        "ANOMALY_HISTORY_DIR + ANOMALY_HISTORY_SPANS span capture); "
        "0 (the default — the gate is strictly opt-in like every "
        "controller tier) = act on hysteresis alone",
    ),
    "ANOMALY_SHADOW_WINDOW_S": (
        "float", 120.0,
        "how far back the counterfactual replay reaches: the recorded "
        "span window (seconds, recorded timebase) re-fed through the "
        "shadow pipeline with the mitigation transform applied",
    ),
    "ANOMALY_SHADOW_RATE": (
        "float", 10.0,
        "minimum recorded-seconds-per-wall-second the shadow replay "
        "must sustain (the replaybench >=10x discipline) — gated by "
        "the mitigbench shadow leg, measured on every verdict",
    ),
    "ANOMALY_SHADOW_DEADLINE_S": (
        "float", 5.0,
        "verification deadline (wall seconds): a shadow replay still "
        "running past it REFUSES the act (fail closed, "
        "reason=deadline) — a slow verifier must delay mitigation, "
        "never release an unproven one",
    ),
    "ANOMALY_SHADOW_MIN_RECORDS": (
        "int", 20,
        "minimum recorded span batches inside the window for a "
        "verdict; fewer = the counterfactual is unprovable and the "
        "act is refused (fail closed, reason=insufficient_records)",
    ),
}


# Verdict provenance knobs (runtime.provenance: the per-verdict
# evidence engine — at flag time a bounded JSON-able bundle is built
# per flagged service: firing head, head trajectories over the last K
# windows, CMS top-k contributors, HLL cardinality delta, exemplar +
# selftrace ids — served live by /query/explain, replicated in the
# query_meta block, persisted through the history retention ladder and
# exported as OTLP log records). Same ONE-registry discipline as every
# other family — daemon, compose overlay, k8s generator and
# sanitycheck.py all consume this dict. Values must stay literals
# (sanitycheck reads via ast.literal_eval, without importing torch).
PROVENANCE_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_PROVENANCE_ENABLE": (
        "int", 1,
        "1 = build an evidence bundle per flagged service at flag "
        "time (harvester thread, beside exemplar capture) and serve "
        "it on /query/explain; 0 = provenance off (flags and "
        "exemplars still capture — bundles are explanation, not "
        "detection)",
    ),
    "ANOMALY_PROVENANCE_RING": (
        "int", 64,
        "bounded bundle ring size (newest wins): the live "
        "/query/explain depth, and — because the ring rides the "
        "replicated query_meta block — the replica's too",
    ),
    "ANOMALY_PROVENANCE_TOPK": (
        "int", 5,
        "heavy-hitter contributors per bundle: the top-k candidate "
        "attribute CRCs folded through the CMS under the dispatch "
        "lock at flag time (the /query/topk fold, snapshotted into "
        "evidence)",
    ),
    "ANOMALY_PROVENANCE_TRAJECTORY_WINDOWS": (
        "int", 16,
        "per-service head-trajectory depth (reports): how many "
        "recent harvested windows of z/CUSUM/cardinality each "
        "bundle replays — ring-buffered host-side from stats "
        "already fetched, never an extra device round trip",
    ),
}


# Native front-door knobs (runtime/frontdoor.py + native/frontdoor.cc:
# the zero-Python OTLP/HTTP acceptor that recv's request bodies into
# native buffers and tickets them straight to the decode pool).
# Strictly OPT-IN: enable defaults to 0 and the Python receiver stays
# the default path — the front door is a second, faster door into the
# SAME bounded admission queue, never a replacement contract. Values
# must stay literals (sanitycheck reads via ast.literal_eval).
FRONTDOOR_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_FRONTDOOR_ENABLE": (
        "int", 0,
        "1 = start the native OTLP/HTTP front door (socket→scratch→"
        "scan, zero Python per payload); 0 (default) = Python "
        "receiver only — opt-in, never implicit",
    ),
    "ANOMALY_FRONTDOOR_PORT": (
        "int", 4316,
        "front-door listen port (distinct from the Python receiver's "
        "4318 — both can serve at once during migration; 0 = ephemeral "
        "for tests)",
    ),
    "ANOMALY_FRONTDOOR_PUMPS": (
        "int", 1,
        "verdict-pump threads draining native tickets into the decode "
        "pool (each drains whole batches per GIL-released call; 1 is "
        "enough below ~10 Gb/s of OTLP)",
    ),
    "ANOMALY_FRONTDOOR_BATCH": (
        "int", 64,
        "max tickets one pump drain hands the decode pool before "
        "resolving verdicts (mirrors ANOMALY_INGEST_COALESCE: an idle "
        "stream still sees single-request latency)",
    ),
    "ANOMALY_FRONTDOOR_MAX_CONNS": (
        "int", 64,
        "concurrent front-door connections; the acceptor answers 503 "
        "past the cap instead of queueing unbounded sockets",
    ),
}


# Key lifecycle knobs (runtime/keyspace.py: the memory-budgeted
# keyspace plane — idle-key eviction folding sketch rows into history
# under the dispatch lock, intern-id recycling behind a generation
# epoch, and the keyspace degradation ladder: evict → per-tenant
# new-key throttle → overflow-collapse → 429). The watchdog gauges
# (anomaly_process_rss_bytes + row/interner fill) export regardless of
# the enable bit, so a cardinality bomb is visible even with the
# ladder off. Values must stay literals (sanitycheck reads via
# ast.literal_eval).
KEYSPACE_KNOBS: dict[str, tuple[str, object, str]] = {
    "ANOMALY_KEYSPACE_ENABLE": (
        "int", 1,
        "1 = keyspace lifecycle plane on (idle eviction + degradation "
        "ladder under pressure); 0 = watchdog gauges only — the table "
        "reverts to append-only-then-overflow",
    ),
    "ANOMALY_KEYSPACE_HIGH_WATERMARK": (
        "float", 0.85,
        "live-row fill fraction (interned keys / table capacity) above "
        "which the keyspace ladder counts pressure; two-edge "
        "hysteresis against the low watermark",
    ),
    "ANOMALY_KEYSPACE_LOW_WATERMARK": (
        "float", 0.70,
        "fill fraction the ladder must fall below before de-escalating "
        "(the hysteresis lower edge; must be < high watermark)",
    ),
    "ANOMALY_KEYSPACE_IDLE_S": (
        "float", 300.0,
        "a key with no rows admitted for this long is eviction-"
        "eligible under pressure; its sketch/head rows fold into a "
        "history record before the id recycles",
    ),
    "ANOMALY_KEYSPACE_HOLD_S": (
        "float", 5.0,
        "seconds of SUSTAINED pressure (or relief) per ladder edge — "
        "the same two-edge hysteresis hold the brownout ladder uses, "
        "so one fill spike never staircases straight to 429",
    ),
    "ANOMALY_KEYSPACE_EVICT_BATCH": (
        "int", 64,
        "max idle keys folded out per evictor sweep; bounds how long "
        "one sweep holds the dispatch lock",
    ),
    "ANOMALY_KEYSPACE_RSS_MB": (
        "float", 0.0,
        "process RSS budget in MB; above it the watchdog counts "
        "pressure even when the intern table has room (0 = no RSS "
        "budget — fill-fraction pressure only)",
    ),
    "ANOMALY_KEYSPACE_NEWKEY_RATE": (
        "float", 64.0,
        "per-tenant NEW-key admissions per second once the ladder "
        "reaches the throttle rung; keys past the budget collapse to "
        "the overflow bucket (counted per tenant)",
    ),
    "ANOMALY_KEYSPACE_RETRY_AFTER_S": (
        "float", 2.0,
        "Retry-After hint (seconds) the ingest doors return with 429 "
        "once the keyspace ladder reaches its shed rung",
    ),
}


# Registries whose knobs ride the DEPLOY surfaces: every knob in these
# must be threaded through runtime/daemon.py, the compose overlay and
# the k8s generator (scripts/staticcheck knob-discipline pass +
# scripts/sanitycheck.py both assert the correspondence). The harness
# registries below this tuple only legitimize env reads — a chaos
# proxy or a bench harness has no business in the fleet compose file.
DEPLOYED_KNOB_REGISTRIES: tuple[str, ...] = (
    "DAEMON_KNOBS", "OVERLOAD_KNOBS", "INGEST_KNOBS",
    "REPLICATION_KNOBS", "FRAME_KNOBS", "QUERY_KNOBS", "SPINE_KNOBS",
    "SELFTRACE_KNOBS", "HISTORY_KNOBS", "REMEDIATION_KNOBS",
    "FLEET_KNOBS", "AUTOSCALE_KNOBS", "SHADOW_KNOBS",
    "PROVENANCE_KNOBS", "FRONTDOOR_KNOBS", "KEYSPACE_KNOBS",
)


# Chaos-harness knobs (runtime/faultwire.py: the fault-injection TCP
# proxy tests/test_chaos.py and test_frame.py drive). Registered so
# the knob-discipline pass can resolve the proxy's env reads; NOT a
# deployed registry — faults are injected by test harnesses, not by
# the fleet config.
FAULTWIRE_KNOBS: dict[str, tuple[str, object, str]] = {
    "FAULTWIRE_DELAY_MS": ("float", 0.0, "per-direction added latency"),
    "FAULTWIRE_TRUNCATE_AFTER": (
        "str", "", "close each connection after N relayed bytes",
    ),
    "FAULTWIRE_RST": ("int", 0, "1 = RST every connect immediately"),
    "FAULTWIRE_BLACKHOLE": (
        "int", 0, "1 = accept then drop all bytes (half-open link)",
    ),
    "FAULTWIRE_CORRUPT_RATE": (
        "float", 0.0, "per-byte bit-flip probability (seeded)",
    ),
    "FAULTWIRE_CORRUPT_SEED": ("int", 0, "bit-flip plan seed"),
    "FAULTWIRE_CORRUPT_OFFSET": (
        "int", 0, "absolute stream offset where corruption starts",
    ),
}


# Dev-harness knobs (scripts/serve_shop.py, scripts/serve_kafka.py and
# the in-proc load generator): CLI-default conveniences for the local
# shop stack. Registered, not deployed.
SHOP_KNOBS: dict[str, tuple[str, object, str]] = {
    "SHOP_PORT": ("int", 8080, "gateway listen port"),
    "SHOP_USERS": ("int", 0, "simulated browsing users"),
    "SHOP_MINIMAL": ("str", "", "non-empty = reduced profile"),
    "SHOP_GRPC_PORT": ("int", -1, "gRPC edge port (-1 off)"),
    "KAFKA_PORT": ("int", 9092, "in-repo broker listen port"),
    "OTEL_EXPORTER_OTLP_ENDPOINT": (
        "str", "", "where the shop exports OTLP (reference env name)",
    ),
    "LOCUST_BROWSER_TRAFFIC_ENABLED": (
        "str", "",
        "truthy = the load generator adds browser-shaped traffic "
        "(reference locustfile env name)",
    ),
}


# Benchmark scaffolding knobs (bench.py): section toggles and load
# shapes for the flagship benchmark line. Registered, not deployed.
BENCH_KNOBS: dict[str, tuple[str, object, str]] = {
    "BENCH_BATCH": ("int", 2097152, "device sketch benchmark batch"),
    "BENCH_MATRIX": ("int", 1, "0 skips the sketch impl matrix"),
    "BENCH_INGEST": ("int", 1, "0 skips host-ingest benches"),
    "BENCH_REPL": ("int", 1, "0 skips the replication/failover drill"),
    "BENCH_QUERY": ("int", 1, "0 skips the query-plane bench"),
    "BENCH_QUALITY": ("int", 1, "0 skips detection-quality scenarios"),
    "BENCH_LAG_STRESS": ("int", 1, "0 skips the lag stress leg"),
    "BENCH_LAG_RATE": ("float", 2000.0, "lag bench offered spans/s"),
    "BENCH_LAG_SECONDS": ("float", 12.0, "lag bench duration"),
    "BENCH_SPINE": ("int", 1, "0 skips the e2e ingest-spine bench"),
    "BENCH_SELFTRACE": (
        "int", 1,
        "0 skips the self-telemetry overhead A/B (tracer-on vs "
        "tracer-off spinebench, gated <= 1.03)",
    ),
    "BENCH_EXPLAIN": (
        "int", 1,
        "0 skips the provenance overhead A/B (evidence-engine-on vs "
        "off spinebench, gated <= 1.03) and the /query/explain "
        "latency leg",
    ),
    "BENCH_SPINE_SECONDS": (
        "float", 6.0, "e2e spine bench duration per configuration",
    ),
    "BENCH_REPLAY": (
        "int", 1,
        "0 skips the history replay bench (record a synthetic "
        "incident, replay the recorded frames through the real "
        "pipeline at N x wall clock, pin bit-identical verdicts)",
    ),
    "BENCH_MITIG": (
        "int", 1,
        "0 skips the closed-loop mitigation bench (runtime.mitigbench:"
        " time-to-mitigate beside time-to-detect per flagd scenario, "
        "rollback drill, no-oscillation gate over a long clean run)",
    ),
    "BENCH_FLEET": (
        "int", 1,
        "0 skips the sharded-fleet reshard drill (runtime.replbench "
        "measure_reshard: kill a shard beside an unkilled witness "
        "fleet, reshard TTD, witness-pinned bit-exact answers, "
        "blackholed-shard partial answers, noisy-tenant isolation)",
    ),
    "BENCH_AUTOSCALE": (
        "int", 1,
        "0 skips the elastic-fleet drill (runtime.replbench "
        "measure_adoption: ramp load to brownout, watch the "
        "autoscaler propose scale-out, SIGKILL a shard mid-resize, "
        "pin the automatic adoption bit-exact against an unkilled "
        "witness; lifts autoscale_tta_s and autoscale_ok)",
    ),
    "BENCH_SHADOW": (
        "int", 1,
        "0 skips the counterfactual pre-flight leg of the mitigation "
        "bench (runtime.mitigbench --shadow: released + refused "
        "verdict drills through a preflighted controller, "
        "shadow-vs-replaybench bit-identity at >= ANOMALY_SHADOW_RATE "
        "x wall, collector keep-ratio measurement; lifts "
        "preflight_refusal_ok and preflight_verdict_s)",
    ),
    "BENCH_FRONTDOOR": (
        "int", 1,
        "0 skips the native front-door leg (runtime.frontdoorbench: "
        "front-door spans/s vs the in-process pool at matched "
        "workers + the >=1M-distinct-key cardinality soak; lifts "
        "frontdoor_ok and frontdoor_soak_ok)",
    ),
    "BENCH_FRONTDOOR_WORKERS": (
        "int", 2, "front-door bench decode workers per side",
    ),
    "BENCH_FRONTDOOR_SECONDS": (
        "float", 4.0, "front-door vs pool timed-run duration",
    ),
    "BENCH_FRONTDOOR_KEYS": (
        "int", 1048576,
        "distinct (tenant x service) keys the cardinality soak must "
        "push through ingest->sketch->query",
    ),
    "BENCH_CHURN_WAVES": (
        "int", 8,
        "churn-soak waves (each wave: a fresh churn cohort past the "
        "key budget, an eviction sweep, a live-cohort liveness + "
        "evicted-query + generation-refusal probe; lifts churn_ok)",
    ),
}


# Native-build knobs (runtime/native.py's on-demand kernel compile)
# and check-pipeline plumbing (scripts/sanitycheck.py).
BUILD_KNOBS: dict[str, tuple[str, object, str]] = {
    "CXX": ("str", "g++", "C++ compiler for the native kernels"),
    "SANITYCHECK_SKIP_STATICCHECK": (
        "int", 0,
        "1 = the caller (make check) already ran the full staticcheck; "
        "sanitycheck skips its delegated frame-monopoly re-run instead "
        "of parsing the tree twice",
    ),
}


def _resolve(registry: dict) -> dict[str, int | float | str]:
    out: dict[str, int | float | str] = {}
    for env_name, (kind, default, _help) in registry.items():
        out[env_name] = (
            env_int(env_name, default) if kind == "int"
            else env_float(env_name, default) if kind == "float"
            else env_str(env_name, default)
        )
    return out


def overload_config() -> dict[str, int | float]:
    """Resolve every OVERLOAD_KNOBS entry from the environment (typed,
    defaulted, hard-fail on malformed values — mustMapEnv discipline)."""
    return _resolve(OVERLOAD_KNOBS)


def ingest_config() -> dict[str, int | float]:
    """Resolve every INGEST_KNOBS entry from the environment (same
    contract as :func:`overload_config`)."""
    return _resolve(INGEST_KNOBS)


def frame_config() -> dict[str, int | float | str]:
    """Resolve every FRAME_KNOBS entry from the environment (same
    contract as :func:`overload_config`); validates the write version
    against the reader window — a version nobody could read back must
    refuse to boot, not corrupt-by-construction."""
    out = _resolve(FRAME_KNOBS)
    # Literal window bounds (not an import of runtime.frame: this
    # module stays torch/numpy-free for sanitycheck's AST read); the
    # correspondence with frame.MIN_READ_VERSION..FRAME_VERSION is
    # asserted by tests/test_frame.py.
    if not 1 <= int(out["ANOMALY_FRAME_WRITE_VERSION"]) <= 2:
        raise ConfigError(
            f"ANOMALY_FRAME_WRITE_VERSION="
            f"{out['ANOMALY_FRAME_WRITE_VERSION']} outside the readable "
            "window 1..2"
        )
    return out


def query_config() -> dict[str, int | float]:
    """Resolve every QUERY_KNOBS entry from the environment (same
    contract as :func:`overload_config`); validates the shape knobs —
    a query plane with a zero-deep timeline or a negative staleness
    budget must refuse to boot, not serve nonsense."""
    out = _resolve(QUERY_KNOBS)
    if int(out["ANOMALY_QUERY_TOPK"]) < 1:
        raise ConfigError(
            f"ANOMALY_QUERY_TOPK={out['ANOMALY_QUERY_TOPK']} must be >= 1"
        )
    if int(out["ANOMALY_QUERY_TIMELINE"]) < 1:
        raise ConfigError(
            f"ANOMALY_QUERY_TIMELINE={out['ANOMALY_QUERY_TIMELINE']} "
            "must be >= 1"
        )
    if int(out["ANOMALY_QUERY_CANDIDATES"]) < int(out["ANOMALY_QUERY_TOPK"]):
        raise ConfigError(
            f"ANOMALY_QUERY_CANDIDATES={out['ANOMALY_QUERY_CANDIDATES']} "
            f"below ANOMALY_QUERY_TOPK={out['ANOMALY_QUERY_TOPK']}: "
            "top-k could never rank k candidates"
        )
    if float(out["ANOMALY_QUERY_MAX_STALENESS_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_QUERY_MAX_STALENESS_S="
            f"{out['ANOMALY_QUERY_MAX_STALENESS_S']} must be > 0"
        )
    return out


def spine_config() -> dict[str, int | float]:
    """Resolve every SPINE_KNOBS entry from the environment (same
    contract as :func:`overload_config`); validates the shapes — a
    negative ring depth or copy block must refuse to boot."""
    out = _resolve(SPINE_KNOBS)
    if int(out["ANOMALY_SPINE_RING"]) < 0:
        raise ConfigError(
            f"ANOMALY_SPINE_RING={out['ANOMALY_SPINE_RING']} must be "
            ">= 0 (0 disables the spine)"
        )
    if int(out["ANOMALY_SPINE_CHUNK_ROWS"]) < 0:
        raise ConfigError(
            "ANOMALY_SPINE_CHUNK_ROWS="
            f"{out['ANOMALY_SPINE_CHUNK_ROWS']} must be >= 0"
        )
    return out


def daemon_config() -> dict[str, int | float | str]:
    """Resolve every DAEMON_KNOBS entry from the environment (same
    contract as :func:`overload_config`); validates the shape knobs —
    a daemon with a zero batch or a non-positive pump cadence must
    refuse to boot, not spin."""
    out = _resolve(DAEMON_KNOBS)
    if int(out["ANOMALY_BATCH"]) < 1:
        raise ConfigError(
            f"ANOMALY_BATCH={out['ANOMALY_BATCH']} must be >= 1"
        )
    if float(out["ANOMALY_PUMP_INTERVAL_S"]) <= 0:
        raise ConfigError(
            f"ANOMALY_PUMP_INTERVAL_S={out['ANOMALY_PUMP_INTERVAL_S']} "
            "must be > 0"
        )
    if int(out["ANOMALY_OTLP_MAX_BODY"]) < 1:
        raise ConfigError(
            f"ANOMALY_OTLP_MAX_BODY={out['ANOMALY_OTLP_MAX_BODY']} "
            "must be >= 1"
        )
    if float(out["ANOMALY_CHECKPOINT_INTERVAL_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_CHECKPOINT_INTERVAL_S="
            f"{out['ANOMALY_CHECKPOINT_INTERVAL_S']} must be > 0"
        )
    return out


def selftrace_config() -> dict[str, int | float | str]:
    """Resolve every SELFTRACE_KNOBS entry from the environment (same
    contract as :func:`overload_config`); validates the shapes — a
    sampling rate outside [0,1] or a zero flight ring must refuse to
    boot, not mis-sample silently."""
    out = _resolve(SELFTRACE_KNOBS)
    sample = float(out["ANOMALY_SELFTRACE_SAMPLE"])
    if not 0.0 <= sample <= 1.0:
        raise ConfigError(
            f"ANOMALY_SELFTRACE_SAMPLE={sample} outside [0, 1]"
        )
    if int(out["ANOMALY_SELFTRACE_FLIGHT_RING"]) < 1:
        raise ConfigError(
            "ANOMALY_SELFTRACE_FLIGHT_RING="
            f"{out['ANOMALY_SELFTRACE_FLIGHT_RING']} must be >= 1"
        )
    return out


def history_ladder(
    rungs_raw, retention_raw
) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """Parsed ``(rung_spans_s, retention_s)`` from the two raw
    comma-separated ladder knob values — the ONE parse, shared by the
    validator below and the daemon (two copies of the split/float
    could drift, and then the values validated would not be the
    values used). Callers pass the knob values themselves so the
    consuming subscripts stay visible to the knob-discipline pass."""
    rungs = tuple(
        float(r) for r in str(rungs_raw).split(",") if r.strip()
    )
    retention = tuple(
        float(r) for r in str(retention_raw).split(",") if r.strip()
    )
    return rungs, retention


def history_spans_policy(raw) -> tuple[bool, dict[str, float]]:
    """Parsed ``(capture_on, {service: rate})`` from the raw
    ``ANOMALY_HISTORY_SPANS`` knob value — the ONE parse, shared by
    :func:`history_config`'s validator and the daemon (the same
    no-drift rule as :func:`history_ladder`).

    ``'0'``/``''`` → off; ``'1'`` → capture everything
    (``{'*': 1.0}``); otherwise a comma map ``svc:rate[,*:rate]`` with
    rates in [0, 1] (``'*'`` is the default rate for unlisted
    services; absent = 0, so a map names exactly what it records).
    Raises ``ConfigError`` on malformed entries or out-of-range rates.
    """
    text = str(raw).strip()
    if text in ("", "0"):
        return False, {}
    if text == "1":
        return True, {"*": 1.0}
    rates: dict[str, float] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ConfigError(
                f"ANOMALY_HISTORY_SPANS entry {part!r} is not "
                "'service:rate' (or the literal '0'/'1')"
            )
        name, rate_raw = part.rsplit(":", 1)
        name = name.strip()
        try:
            rate = float(rate_raw)
        except ValueError as e:
            raise ConfigError(
                f"ANOMALY_HISTORY_SPANS rate {rate_raw!r} for "
                f"{name!r} is not a number"
            ) from e
        if not 0.0 <= rate <= 1.0:
            raise ConfigError(
                f"ANOMALY_HISTORY_SPANS rate {rate} for {name!r} "
                "outside [0, 1]"
            )
        if not name:
            raise ConfigError(
                "ANOMALY_HISTORY_SPANS has an empty service name"
            )
        rates[name] = rate
    if not rates:
        raise ConfigError(
            f"ANOMALY_HISTORY_SPANS={text!r} parsed to an empty map"
        )
    return True, rates


def history_config() -> dict[str, int | float | str]:
    """Resolve every HISTORY_KNOBS entry from the environment (same
    contract as :func:`overload_config`); validates the ladder shape —
    rungs must be positive, ascending, and each must divide the next
    (a rung that doesn't divide its parent can never fold exactly N
    child records into one parent record), with one retention cap per
    rung. A ladder nobody can fold must refuse to boot."""
    out = _resolve(HISTORY_KNOBS)
    try:
        rungs, retention = history_ladder(
            out["ANOMALY_HISTORY_RUNGS"],
            out["ANOMALY_HISTORY_RETENTION_S"],
        )
    except ValueError as e:
        raise ConfigError(
            "ANOMALY_HISTORY_RUNGS/RETENTION_S must be comma-separated "
            f"numbers: {e}"
        ) from e
    if not rungs or any(r <= 0 for r in rungs):
        raise ConfigError(
            f"ANOMALY_HISTORY_RUNGS={out['ANOMALY_HISTORY_RUNGS']!r} "
            "needs at least one positive rung span"
        )
    for fine, coarse in zip(rungs, rungs[1:]):
        if coarse <= fine or (coarse / fine) != int(coarse / fine):
            raise ConfigError(
                f"ANOMALY_HISTORY_RUNGS={out['ANOMALY_HISTORY_RUNGS']!r}"
                ": rungs must ascend and each must divide the next "
                f"({fine} -> {coarse})"
            )
    if len(retention) != len(rungs):
        raise ConfigError(
            "ANOMALY_HISTORY_RETENTION_S needs one cap per rung "
            f"({len(retention)} caps for {len(rungs)} rungs)"
        )
    if float(out["ANOMALY_HISTORY_COMPACT_INTERVAL_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_HISTORY_COMPACT_INTERVAL_S="
            f"{out['ANOMALY_HISTORY_COMPACT_INTERVAL_S']} must be > 0"
        )
    if int(out["ANOMALY_HISTORY_SEGMENT_MB"]) < 1:
        raise ConfigError(
            f"ANOMALY_HISTORY_SEGMENT_MB={out['ANOMALY_HISTORY_SEGMENT_MB']}"
            " must be >= 1"
        )
    if float(out["ANOMALY_HISTORY_REPLAY_RATE"]) <= 0:
        raise ConfigError(
            "ANOMALY_HISTORY_REPLAY_RATE="
            f"{out['ANOMALY_HISTORY_REPLAY_RATE']} must be > 0"
        )
    # Span-capture policy: validate the map shape here (the parse the
    # daemon reuses) — a policy nobody can apply must refuse to boot.
    history_spans_policy(out["ANOMALY_HISTORY_SPANS"])
    return out


def remediation_config() -> dict[str, int | float | str]:
    """Resolve every REMEDIATION_KNOBS entry from the environment
    (same contract as :func:`overload_config`); validates the
    guardrail shapes — a controller with zero hysteresis, a zero
    budget or a non-positive deadline could flip production flags on
    one noisy batch, and must refuse to boot instead."""
    out = _resolve(REMEDIATION_KNOBS)
    if int(out["ANOMALY_REMEDIATION_ACT_BATCHES"]) < 1:
        raise ConfigError(
            "ANOMALY_REMEDIATION_ACT_BATCHES="
            f"{out['ANOMALY_REMEDIATION_ACT_BATCHES']} must be >= 1"
        )
    if int(out["ANOMALY_REMEDIATION_CLEAR_BATCHES"]) < 1:
        raise ConfigError(
            "ANOMALY_REMEDIATION_CLEAR_BATCHES="
            f"{out['ANOMALY_REMEDIATION_CLEAR_BATCHES']} must be >= 1"
        )
    if int(out["ANOMALY_REMEDIATION_BUDGET"]) < 1:
        raise ConfigError(
            f"ANOMALY_REMEDIATION_BUDGET="
            f"{out['ANOMALY_REMEDIATION_BUDGET']} must be >= 1"
        )
    if float(out["ANOMALY_REMEDIATION_BUDGET_REFILL_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_REMEDIATION_BUDGET_REFILL_S="
            f"{out['ANOMALY_REMEDIATION_BUDGET_REFILL_S']} must be > 0"
        )
    if float(out["ANOMALY_REMEDIATION_DEADLINE_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_REMEDIATION_DEADLINE_S="
            f"{out['ANOMALY_REMEDIATION_DEADLINE_S']} must be > 0"
        )
    if float(out["ANOMALY_REMEDIATION_TIMEOUT_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_REMEDIATION_TIMEOUT_S="
            f"{out['ANOMALY_REMEDIATION_TIMEOUT_S']} must be > 0"
        )
    keep = float(out["ANOMALY_REMEDIATION_COLLECTOR_BASE_KEEP"])
    if not 0.0 <= keep <= 1.0:
        raise ConfigError(
            f"ANOMALY_REMEDIATION_COLLECTOR_BASE_KEEP={keep} must be "
            "a keep fraction in [0, 1]"
        )
    return out


def fleet_tenant_map(raw) -> dict[str, str]:
    """Parsed ``{service: tenant}`` from the raw
    ``ANOMALY_FLEET_TENANTS`` knob value — the ONE parse, shared by
    :func:`fleet_config`'s validator, the daemon and the fleet/
    aggregator tiers (the same no-drift rule as
    :func:`history_ladder`). ``'*'`` names the default tenant for
    unlisted services; an empty knob means every service is tenant
    ``'default'``. Raises ``ConfigError`` on malformed entries."""
    text = str(raw).strip()
    out: dict[str, str] = {}
    if not text:
        return out
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ConfigError(
                f"ANOMALY_FLEET_TENANTS entry {part!r} is not "
                "'service:tenant'"
            )
        name, tenant = part.rsplit(":", 1)
        name, tenant = name.strip(), tenant.strip()
        if not name or not tenant:
            raise ConfigError(
                f"ANOMALY_FLEET_TENANTS entry {part!r} has an empty "
                "service or tenant name"
            )
        if "/" in tenant or "/" in name:
            # '/' is the ring-key separator (tenant/service): letting
            # it into either side would let two different (tenant,
            # service) pairs collide on one ring key.
            raise ConfigError(
                f"ANOMALY_FLEET_TENANTS entry {part!r} contains '/' "
                "(reserved as the ring-key separator)"
            )
        out[name] = tenant
    if not out:
        raise ConfigError(
            f"ANOMALY_FLEET_TENANTS={text!r} parsed to an empty map"
        )
    return out


def fleet_config() -> dict[str, int | float | str]:
    """Resolve every FLEET_KNOBS entry from the environment (same
    contract as :func:`overload_config`); validates the fleet shape —
    an index outside 0..N-1, a zero heartbeat, inverted hysteresis
    edges or an empty reshard budget could thrash or split the ring
    and must refuse to boot instead."""
    out = _resolve(FLEET_KNOBS)
    shards = int(out["ANOMALY_FLEET_SHARDS"])
    if shards < 0:
        raise ConfigError(
            f"ANOMALY_FLEET_SHARDS={shards} must be >= 0"
        )
    if shards > 1:
        index = int(out["ANOMALY_FLEET_SHARD_INDEX"])
        if not 0 <= index < shards:
            raise ConfigError(
                f"ANOMALY_FLEET_SHARD_INDEX={index} outside "
                f"0..{shards - 1}"
            )
        # The peer lists are index-aligned: fewer entries than shards
        # means some member can never be heartbeated (or queried) —
        # every shard would build a partial ring and believe it owns
        # keyspace it doesn't: a SILENT permanent ring split, the one
        # failure mode this validator exists to refuse.
        peers = [
            a for a in str(out["ANOMALY_FLEET_PEERS"]).split(",")
            if a.strip()
        ]
        if len(peers) < shards:
            raise ConfigError(
                f"ANOMALY_FLEET_PEERS lists {len(peers)} address(es) "
                f"for ANOMALY_FLEET_SHARDS={shards}: every shard "
                "index needs its health address (index-aligned)"
            )
        if int(out["ANOMALY_AGGREGATOR_PORT"]) >= 0:
            qpeers = [
                a
                for a in str(out["ANOMALY_FLEET_QUERY_PEERS"]).split(",")
                if a.strip()
            ]
            if len(qpeers) < shards:
                raise ConfigError(
                    "ANOMALY_FLEET_QUERY_PEERS lists "
                    f"{len(qpeers)} address(es) for "
                    f"ANOMALY_FLEET_SHARDS={shards}: the aggregator "
                    "needs every shard's query address (index-aligned)"
                )
    if int(out["ANOMALY_FLEET_VNODES"]) < 1:
        raise ConfigError(
            f"ANOMALY_FLEET_VNODES={out['ANOMALY_FLEET_VNODES']} "
            "must be >= 1"
        )
    if float(out["ANOMALY_FLEET_HEARTBEAT_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_FLEET_HEARTBEAT_S="
            f"{out['ANOMALY_FLEET_HEARTBEAT_S']} must be > 0"
        )
    if float(out["ANOMALY_FLEET_DEAD_AFTER_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_FLEET_DEAD_AFTER_S="
            f"{out['ANOMALY_FLEET_DEAD_AFTER_S']} must be > 0"
        )
    if float(out["ANOMALY_FLEET_REJOIN_AFTER_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_FLEET_REJOIN_AFTER_S="
            f"{out['ANOMALY_FLEET_REJOIN_AFTER_S']} must be > 0"
        )
    if int(out["ANOMALY_FLEET_RESHARD_BUDGET"]) < 1:
        raise ConfigError(
            "ANOMALY_FLEET_RESHARD_BUDGET="
            f"{out['ANOMALY_FLEET_RESHARD_BUDGET']} must be >= 1"
        )
    if float(out["ANOMALY_FLEET_RESHARD_REFILL_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_FLEET_RESHARD_REFILL_S="
            f"{out['ANOMALY_FLEET_RESHARD_REFILL_S']} must be > 0"
        )
    if float(out["ANOMALY_FLEET_TENANT_QUOTA_ROWS_S"]) < 0:
        raise ConfigError(
            "ANOMALY_FLEET_TENANT_QUOTA_ROWS_S="
            f"{out['ANOMALY_FLEET_TENANT_QUOTA_ROWS_S']} must be >= 0"
        )
    if float(out["ANOMALY_AGGREGATOR_TIMEOUT_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_AGGREGATOR_TIMEOUT_S="
            f"{out['ANOMALY_AGGREGATOR_TIMEOUT_S']} must be > 0"
        )
    # Tenant map: validate the shape here (the parse the daemon and
    # the fleet tier reuse) — a map nobody can apply must refuse to
    # boot.
    fleet_tenant_map(out["ANOMALY_FLEET_TENANTS"])
    return out


def autoscale_config() -> dict[str, int | float | str]:
    """Resolve every AUTOSCALE_KNOBS entry from the environment (same
    contract as :func:`overload_config`); validates the guardrail
    shapes — a controller with zero hysteresis, a zero budget,
    inverted watermark edges or an inverted shard range could resize
    a production ring on one noisy window, and must refuse to boot
    instead."""
    out = _resolve(AUTOSCALE_KNOBS)
    if int(out["ANOMALY_AUTOSCALE_ACT_BATCHES"]) < 1:
        raise ConfigError(
            "ANOMALY_AUTOSCALE_ACT_BATCHES="
            f"{out['ANOMALY_AUTOSCALE_ACT_BATCHES']} must be >= 1"
        )
    if int(out["ANOMALY_AUTOSCALE_CLEAR_BATCHES"]) < 1:
        raise ConfigError(
            "ANOMALY_AUTOSCALE_CLEAR_BATCHES="
            f"{out['ANOMALY_AUTOSCALE_CLEAR_BATCHES']} must be >= 1"
        )
    if int(out["ANOMALY_AUTOSCALE_BUDGET"]) < 1:
        raise ConfigError(
            f"ANOMALY_AUTOSCALE_BUDGET="
            f"{out['ANOMALY_AUTOSCALE_BUDGET']} must be >= 1"
        )
    if float(out["ANOMALY_AUTOSCALE_REFILL_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_AUTOSCALE_REFILL_S="
            f"{out['ANOMALY_AUTOSCALE_REFILL_S']} must be > 0"
        )
    high = float(out["ANOMALY_AUTOSCALE_HIGH_WATER"])
    low = float(out["ANOMALY_AUTOSCALE_LOW_WATER"])
    if not 0.0 <= low < high <= 1.0:
        raise ConfigError(
            f"ANOMALY_AUTOSCALE_LOW_WATER={low} / HIGH_WATER={high}: "
            "the two-edge hysteresis needs 0 <= low < high <= 1 (the "
            "dead band between the edges is what prevents oscillation)"
        )
    lo_n = int(out["ANOMALY_AUTOSCALE_MIN_SHARDS"])
    hi_n = int(out["ANOMALY_AUTOSCALE_MAX_SHARDS"])
    if not 1 <= lo_n <= hi_n:
        raise ConfigError(
            f"ANOMALY_AUTOSCALE_MIN_SHARDS={lo_n} / MAX_SHARDS={hi_n}: "
            "need 1 <= min <= max"
        )
    return out


def shadow_config() -> dict[str, int | float | str]:
    """Resolve every SHADOW_KNOBS entry from the environment (same
    contract as :func:`overload_config`); validates the fail-closed
    shapes — a zero window, rate, deadline or record floor would turn
    the counterfactual gate into a rubber stamp (or a wedge), and must
    refuse to boot instead."""
    out = _resolve(SHADOW_KNOBS)
    if float(out["ANOMALY_SHADOW_WINDOW_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_SHADOW_WINDOW_S="
            f"{out['ANOMALY_SHADOW_WINDOW_S']} must be > 0"
        )
    if float(out["ANOMALY_SHADOW_RATE"]) <= 0:
        raise ConfigError(
            f"ANOMALY_SHADOW_RATE={out['ANOMALY_SHADOW_RATE']} "
            "must be > 0"
        )
    if float(out["ANOMALY_SHADOW_DEADLINE_S"]) <= 0:
        raise ConfigError(
            "ANOMALY_SHADOW_DEADLINE_S="
            f"{out['ANOMALY_SHADOW_DEADLINE_S']} must be > 0"
        )
    if int(out["ANOMALY_SHADOW_MIN_RECORDS"]) < 1:
        raise ConfigError(
            "ANOMALY_SHADOW_MIN_RECORDS="
            f"{out['ANOMALY_SHADOW_MIN_RECORDS']} must be >= 1"
        )
    return out


def provenance_config() -> dict[str, int | float | str]:
    """Resolve every PROVENANCE_KNOBS entry from the environment (same
    contract as :func:`overload_config`); validates the bundle shapes —
    a zero ring or trajectory depth would silently build empty
    evidence, and must refuse to boot instead."""
    out = _resolve(PROVENANCE_KNOBS)
    if int(out["ANOMALY_PROVENANCE_RING"]) < 1:
        raise ConfigError(
            "ANOMALY_PROVENANCE_RING="
            f"{out['ANOMALY_PROVENANCE_RING']} must be >= 1"
        )
    if int(out["ANOMALY_PROVENANCE_TOPK"]) < 1:
        raise ConfigError(
            "ANOMALY_PROVENANCE_TOPK="
            f"{out['ANOMALY_PROVENANCE_TOPK']} must be >= 1"
        )
    if int(out["ANOMALY_PROVENANCE_TRAJECTORY_WINDOWS"]) < 1:
        raise ConfigError(
            "ANOMALY_PROVENANCE_TRAJECTORY_WINDOWS="
            f"{out['ANOMALY_PROVENANCE_TRAJECTORY_WINDOWS']} "
            "must be >= 1"
        )
    return out


def frontdoor_config() -> dict[str, int | float | str]:
    """Resolve every FRONTDOOR_KNOBS entry from the environment (same
    contract as :func:`overload_config`); validates the pump/batch
    shapes — a zero pump count would accept connections whose tickets
    nobody ever drains, and must refuse to boot instead."""
    out = _resolve(FRONTDOOR_KNOBS)
    if int(out["ANOMALY_FRONTDOOR_PUMPS"]) < 1:
        raise ConfigError(
            "ANOMALY_FRONTDOOR_PUMPS="
            f"{out['ANOMALY_FRONTDOOR_PUMPS']} must be >= 1"
        )
    if int(out["ANOMALY_FRONTDOOR_BATCH"]) < 1:
        raise ConfigError(
            "ANOMALY_FRONTDOOR_BATCH="
            f"{out['ANOMALY_FRONTDOOR_BATCH']} must be >= 1"
        )
    if int(out["ANOMALY_FRONTDOOR_MAX_CONNS"]) < 1:
        raise ConfigError(
            "ANOMALY_FRONTDOOR_MAX_CONNS="
            f"{out['ANOMALY_FRONTDOOR_MAX_CONNS']} must be >= 1"
        )
    return out


def keyspace_config() -> dict[str, int | float | str]:
    """Resolve every KEYSPACE_KNOBS entry from the environment (same
    contract as :func:`overload_config`); validates the watermark
    ordering and the per-edge shapes — an inverted hysteresis band
    would flap the ladder on every sweep, and must refuse to boot
    instead."""
    out = _resolve(KEYSPACE_KNOBS)
    hi = float(out["ANOMALY_KEYSPACE_HIGH_WATERMARK"])
    lo = float(out["ANOMALY_KEYSPACE_LOW_WATERMARK"])
    if not (0.0 < lo < hi <= 1.0):
        raise ConfigError(
            "keyspace watermarks must satisfy 0 < "
            f"ANOMALY_KEYSPACE_LOW_WATERMARK ({lo}) < "
            f"ANOMALY_KEYSPACE_HIGH_WATERMARK ({hi}) <= 1"
        )
    if int(out["ANOMALY_KEYSPACE_EVICT_BATCH"]) < 1:
        raise ConfigError(
            "ANOMALY_KEYSPACE_EVICT_BATCH="
            f"{out['ANOMALY_KEYSPACE_EVICT_BATCH']} must be >= 1"
        )
    if float(out["ANOMALY_KEYSPACE_HOLD_S"]) < 0:
        raise ConfigError(
            "ANOMALY_KEYSPACE_HOLD_S="
            f"{out['ANOMALY_KEYSPACE_HOLD_S']} must be >= 0"
        )
    if float(out["ANOMALY_KEYSPACE_IDLE_S"]) < 0:
        raise ConfigError(
            "ANOMALY_KEYSPACE_IDLE_S="
            f"{out['ANOMALY_KEYSPACE_IDLE_S']} must be >= 0"
        )
    return out


def replication_config() -> dict[str, int | float | str]:
    """Resolve every REPLICATION_KNOBS entry from the environment (same
    contract as :func:`overload_config`); validates the role name —
    a typo'd role must refuse to boot, not silently run as primary."""
    out = _resolve(REPLICATION_KNOBS)
    if out["ANOMALY_ROLE"] not in ("primary", "standby"):
        raise ConfigError(
            f"ANOMALY_ROLE={out['ANOMALY_ROLE']!r} is not a role "
            "(expected 'primary' or 'standby')"
        )
    return out
