"""Failover + fleet-reshard drill driver: one methodology, bench + tests.

The overloadbench/lagbench sibling for the replication fault class:
run a real detector as primary with a live replication link, a standby
applying deltas, then kill the primary abruptly (RST, the SIGKILL
shape from the standby's point of view) and measure the hot-standby
contract end to end:

- ``replication_lag_p99_ms`` — p99 of ship→ack round trips while the
  link is healthy (how stale the standby's mirror can be);
- ``failover_ttd_s`` — wall time from primary death to the standby
  promoted (watchdog fire + epoch bump), the blind window a host loss
  actually costs;
- convergence — the promoted mirror's HLL/CMS equal the primary's last
  acked state exactly (merge semantics, not replay).

The primary's detector runs on the card unless the caller passes
``device="cpu"``; its ``snapshot_fn`` is
``DetectorPipeline.state_snapshot`` (the copy enqueued on the steps'
stream under the dispatch lock), called once per ship and once per
HELLO. ``lock_holds`` collects each such call's dispatch-lock hold.

The fleet drill (:func:`measure_reshard`; ``runtime.fleet`` +
``runtime.aggregator``) scales the same methodology to the N-way
sharded tier: an in-process 3-shard fleet under deterministic
virtual-time load beside an unkilled witness fleet fed identically;
kill one shard (RST), let membership declare it dead (health
double-check + hysteresis), reshard its keyspace by monoid-merging its
last replicated frame into the survivors, and pin every post-reshard
``/query/*`` answer for the victim's keys bit-exact against the
witness. Also drives the aggregator's partial-answer contract (one
shard blackholed via ``runtime.faultwire`` → labeled partial 200, never
5xx) and the noisy-tenant quota isolation.

The live-fire legs boot daemon subprocesses of this package
(``python -m opentelemetry_demo_tpu_torch.runtime.daemon``, with
``--device`` passed through): :func:`measure_reshard_live` SIGKILLs a
real victim shard mid-load and adopts its mirrored frame in process;
:func:`measure_adoption` runs an adoptive pair with the autoscaler on
the heir, ramps it into saturation, SIGKILLs the victim mid-resize and
pins the heir's own ``/query/*`` answers against an unkilled witness.

    python -m opentelemetry_demo_tpu_torch.runtime.replbench [--fleet [--no-live]] [--autoscale]

prints one JSON line (on the card).
"""

from __future__ import annotations

import time

import numpy as np

from ..models import AnomalyDetector, DetectorConfig
from .lagbench import make_columns
from .pipeline import DetectorPipeline
from .replication import EpochFence, ReplicationPrimary, ReplicationStandby


def pipeline_snapshot_fn(pipe: DetectorPipeline, offsets: dict | None = None,
                         lock_holds: list | None = None, query: bool = False):
    """A replication primary's ``snapshot_fn`` over a live pipeline: the
    whole state by ``DetectorPipeline.state_snapshot`` and the meta block
    in the checkpoint's shape (``offsets`` read at call time). Each
    call's dispatch-lock hold (seconds) is appended to ``lock_holds``."""
    detector = pipe.detector
    observe = lock_holds.append if lock_holds is not None else None

    def snapshot():
        arrays, clock_t_prev = pipe.state_snapshot(hold_observe=observe)
        meta = {
            "offsets": dict(offsets or {}),
            "service_names": pipe.tensorizer.service_names,
            "clock_t_prev": clock_t_prev,
            "config": list(detector.config._replace(sketch_impl=None)),
        }
        if query:
            meta["query"] = pipe.query_meta()
        return arrays, meta

    return snapshot


def measure_failover(
    seconds: float = 2.0,
    batch: int = 256,
    interval_s: float = 0.05,
    failover_timeout_s: float = 0.5,
    pump_interval_s: float = 0.01,
    seed: int = 0,
    config: DetectorConfig | None = None,
    device: "str | None" = None,
    lock_holds: list | None = None,
    mirror: dict | None = None,
) -> dict:
    """Drive a primary pipeline under load with a live standby, kill
    the primary, and time the standby's promotion decision.

    The watchdog here is the rule the daemon's standby step runs
    (silence > ``failover_timeout_s`` after a completed bootstrap), so
    the number is the deployment's TTD floor. When the caller passes a
    ``mirror`` dict, the promoted mirror (``arrays``, ``meta``), the
    primary's final state (``final``) and its detector (``detector``,
    the uninterrupted twin of a promotion) go into it."""
    config = config or DetectorConfig(
        num_services=8, hll_p=8, cms_width=512
    )
    detector = AnomalyDetector(config, device=device)
    pipe = DetectorPipeline(detector, batch_size=batch)
    offsets = {0: 0}
    snapshot = pipeline_snapshot_fn(pipe, offsets, lock_holds)

    fence_p = EpochFence(0)
    primary = ReplicationPrimary(
        snapshot, fence_p, interval_s=interval_s
    )
    primary.start()
    fence_s = EpochFence(0)
    standby = ReplicationStandby(
        f"127.0.0.1:{primary.port}", fence_s,
        config_fingerprint=list(config._replace(sketch_impl=None)),
    )
    standby.start()
    try:
        if not standby.wait_for_state(10.0):
            raise RuntimeError("standby never bootstrapped")

        # Load: realistic columns at a steady cadence, offsets advancing
        # the way confirmed Kafka offsets would. One warmup dispatch
        # first so first-use costs don't eat the timed load window.
        rng = np.random.default_rng(seed)
        pipe.submit_columns(make_columns(rng, batch))
        pipe.pump(0.0)
        pipe.drain()
        offsets[0] += batch
        t_end = time.monotonic() + seconds
        t = pump_interval_s  # virtual clock continues past the warmup pump
        while time.monotonic() < t_end:
            pipe.submit_columns(make_columns(rng, batch))
            pipe.pump(t)
            offsets[0] += batch
            t += pump_interval_s
            time.sleep(pump_interval_s)
        pipe.drain()

        # Let the link quiesce so the standby's mirror reaches the final
        # state and the final offsets (a ship between a step and its
        # offset advance carries the state a batch ahead of the offsets;
        # the next one carries both), then record the healthy-link lag.
        deadline = time.monotonic() + max(10 * interval_s, 2.0)
        final = snapshot()[0]
        fed = {str(k): v for k, v in offsets.items()}
        while time.monotonic() < deadline:
            arrs, meta = standby.snapshot()
            if (
                arrs and (arrs["cms_bank"] == final["cms_bank"]).all()
                and meta.get("offsets") == fed
            ):
                break
            time.sleep(interval_s / 2)
        stats = primary.stats()
        lag_p99_ms = stats["ack_lag_p99_ms"]

        # Death: RST every session — what a SIGKILLed host looks like.
        t_kill = time.monotonic()
        primary.kill()
        # The standby-side watchdog loop (the daemon's standby rule).
        promoted_at = None
        give_up = t_kill + failover_timeout_s * 20 + 10.0
        while time.monotonic() < give_up:
            if (
                standby.seconds_since_frame() > failover_timeout_s
                and standby.applied_seq >= 0
            ):
                fence_s.bump()  # the promotion's first act
                promoted_at = time.monotonic()
                break
            time.sleep(0.005)
        if promoted_at is None:
            raise RuntimeError("standby never promoted")
        arrays, meta = standby.snapshot()
    finally:
        standby.stop()
        primary.stop()
        pipe.close()
    converged = bool(
        arrays
        and (arrays["cms_bank"] == final["cms_bank"]).all()
        and (arrays["hll_bank"] == final["hll_bank"]).all()
    )
    if mirror is not None:
        mirror.update(arrays=arrays, meta=meta, final=final, detector=detector)
    return {
        "failover_ttd_s": round(promoted_at - t_kill, 4),
        "replication_lag_p99_ms": (
            round(lag_p99_ms, 3) if lag_p99_ms is not None else None
        ),
        "failover_timeout_s": failover_timeout_s,
        "replication_interval_s": interval_s,
        "deltas_shipped": stats["deltas_shipped"],
        "snapshots_shipped": stats["snapshots_shipped"],
        "converged_exact": converged,
        "promoted_epoch": fence_s.epoch,
        "replicated_offsets": meta.get("offsets"),
        "spans_fed": int(pipe.stats.spans),
    }


# -- the N-way fleet reshard drill (runtime.fleet) ----------------------

FLEET_SERVICES = (
    "frontend", "cart", "checkout", "currency", "payment", "email",
)
FLEET_TENANTS = {
    "frontend": "web", "cart": "web", "checkout": "web",
    "currency": "platform", "payment": "platform", "email": "platform",
}


def _fleet_records(rng: np.random.Generator, service: str, n: int) -> list:
    """Deterministic per-service span records: the fleet shard and its
    witness twin are fed byte-identical streams."""
    from .tensorize import SpanRecord

    return [
        SpanRecord(
            service=service,
            duration_us=float(200.0 + 50.0 * rng.random()),
            trace_id=rng.bytes(8),
            is_error=bool(rng.random() < 0.02),
            attr=f"a{int(rng.integers(0, 8))}",
        )
        for _ in range(n)
    ]


class _Shard:
    """One in-process fleet member: detector + pipeline with the shared
    pre-interned service table, plus a live replication primary so a
    mirror of its state exists to adopt after its death."""

    def __init__(self, name: str, config: DetectorConfig, batch: int,
                 interval_s: float, device: "str | None" = None):
        self.name = name
        self.detector = AnomalyDetector(config, device=device)
        self.pipe = DetectorPipeline(self.detector, batch_size=batch)
        for svc in FLEET_SERVICES:  # the shared-table contract
            self.pipe.tensorizer.service_id(svc)
        self.fence = EpochFence(0)
        self._snapshot = pipeline_snapshot_fn(self.pipe)
        self.primary = ReplicationPrimary(
            self._snapshot, self.fence, interval_s=interval_s
        )
        self.primary.start()

    def arrays(self) -> dict:
        return self._snapshot()[0]

    def stop(self) -> None:
        self.primary.stop()
        self.pipe.close()


def _query_docs(arrays: dict, meta: dict, services) -> dict:
    """The /query/* answer set for a service list over one state —
    the bit-comparable unit the witness pin asserts on (the same pure
    numpy read functions the shard plane and a read replica run)."""
    from . import query as q

    return {
        svc: {
            "cardinality": q.cardinality(arrays, meta, svc),
            "topk": q.topk_heavy_hitters(arrays, meta, svc, k=5),
            "zscore": q.zscore_state(arrays, meta, svc),
        }
        for svc in services
    }


def measure_reshard(
    seconds: float = 1.5,
    batch: int = 256,
    interval_s: float = 0.05,
    dead_after_s: float = 0.35,
    pump_interval_s: float = 0.05,
    rows_per_service: int = 24,
    seed: int = 7,
    config: DetectorConfig | None = None,
    device: "str | None" = None,
) -> dict:
    """The in-process shard-kill → reshard drill (module docstring).

    3 shards + a 3-shard witness fleet fed byte-identical virtual-time
    streams; kill shard-1's replication abruptly, detect death through
    the membership guardrails, monoid-merge its mirror frame into the
    survivors, and pin the post-reshard answers for the victim's keys
    bit-exact against the witness fleet merged the same way. Every
    shard's detector runs on ``device`` (the card unless ``"cpu"``).
    ``victim_docs`` holds the post-reshard answers for the victim's keys.
    """
    from .fleet import (
        FleetMembership,
        HashRing,
        merge_shard_arrays,
        service_row_mask,
        shard_key,
        tenant_of,
    )

    config = config or DetectorConfig(
        num_services=8, hll_p=8, cms_width=512
    )
    shard_ids = ["shard-0", "shard-1", "shard-2"]
    victim_id = "shard-1"
    ring = HashRing(shard_ids, vnodes=128)
    owner_of = {
        svc: ring.owner(shard_key(svc, tenant_of(svc, FLEET_TENANTS)))
        for svc in FLEET_SERVICES
    }
    # The ring must give the victim a slice for the drill to mean
    # anything; with 6 keys × 128 vnodes it does, but assert it.
    victim_services = [s for s, o in owner_of.items() if o == victim_id]
    if not victim_services:
        raise RuntimeError("ring assigned the victim no keyspace")

    fleet = {s: _Shard(s, config, batch, interval_s, device) for s in shard_ids}
    witness = {s: _Shard(s, config, batch, interval_s, device) for s in shard_ids}
    # The victim's hot mirror: the frame the survivors adopt. (In the
    # deployed fleet every shard has one — its standby; the drill
    # mirrors only the shard it will kill.)
    mirror_fence = EpochFence(0)
    mirror = ReplicationStandby(
        f"127.0.0.1:{fleet[victim_id].primary.port}", mirror_fence,
        config_fingerprint=list(config._replace(sketch_impl=None)),
    )
    mirror.start()
    try:
        if not mirror.wait_for_state(10.0):
            raise RuntimeError("victim mirror never bootstrapped")

        # Virtual-time load, routed by ring ownership, fed identically
        # to fleet and witness (one rng stream per (service, step)).
        steps = max(int(seconds / pump_interval_s), 8)
        t = 0.0
        for i in range(steps):
            for svc in FLEET_SERVICES:
                rng = np.random.default_rng(
                    seed * 100003 + i * 131 + hash_stable(svc)
                )
                records = _fleet_records(rng, svc, rows_per_service)
                fleet[owner_of[svc]].pipe.submit(records)
                witness[owner_of[svc]].pipe.submit(records)
            for shard in (*fleet.values(), *witness.values()):
                shard.pipe.pump(t)
            t += pump_interval_s
        for shard in (*fleet.values(), *witness.values()):
            shard.pipe.drain()

        # Quiesce: the mirror must carry the victim's final state (the
        # bit-exact pin needs the acked frame to be the final state, as
        # in measure_failover).
        final_victim = fleet[victim_id].arrays()
        deadline = time.monotonic() + max(10 * interval_s, 2.0)
        while time.monotonic() < deadline:
            arrs, _m = mirror.snapshot()
            if arrs and (
                arrs["cms_bank"] == final_victim["cms_bank"]
            ).all() and (
                arrs["hll_bank"] == final_victim["hll_bank"]
            ).all():
                break
            time.sleep(interval_s / 2)

        # Membership over the fleet, with the health double-check (a
        # serving shard is never declared dead).
        alive = {s: True for s in shard_ids}
        membership = FleetMembership(
            "shard-0", [s for s in shard_ids if s != "shard-0"],
            vnodes=128, dead_after_s=dead_after_s,
            rejoin_after_s=1.0, reshard_budget=4,
            reshard_refill_s=60.0,
            health_check=lambda s: alive[s],
        )
        for s in shard_ids[1:]:
            membership.observe(s)

        # Kill: RST every replication session + health goes dark.
        t_kill = time.monotonic()
        fleet[victim_id].primary.kill()
        alive[victim_id] = False
        events: list = []
        give_up = t_kill + dead_after_s * 20 + 5.0
        while time.monotonic() < give_up and not events:
            events = membership.tick()
            if not events:
                membership.observe("shard-2")  # survivor stays fresh
                time.sleep(0.02)
        if not any(
            e["op"] == "leave" and e["shard"] == victim_id
            for e in events
        ):
            raise RuntimeError("membership never declared the victim dead")

        # Reshard: adopt the victim's last replicated frame into every
        # survivor (reads route by ownership, so the add-merge can
        # never double-count an answer), then answer for its keys.
        mirror_arrays, mirror_meta = mirror.snapshot()
        survivors = [s for s in shard_ids if s != victim_id]
        merged: dict[str, dict] = {}
        for s in survivors:
            dst = fleet[s].arrays()
            mask = service_row_mask(
                list(mirror_meta.get("service_names") or []),
                fleet[s].pipe.tensorizer.service_names,
                int(dst["lat_mean"].shape[0]),
                owned=victim_services,
            )
            merged[s] = merge_shard_arrays(dst, mirror_arrays, mask)
        # TTD: kill → a survivor answering the victim's keys.
        meta = {
            "service_names": list(FLEET_SERVICES),
            "config": list(config._replace(sketch_impl=None)),
        }
        post_owner = {
            svc: membership.ring.owner(
                shard_key(svc, tenant_of(svc, FLEET_TENANTS))
            )
            for svc in victim_services
        }
        answers = {
            svc: _query_docs(merged[post_owner[svc]], meta, [svc])[svc]
            for svc in victim_services
        }
        ttd_s = time.monotonic() - t_kill
        answered = all(
            max(a["cardinality"]["estimate"]) > 0.0
            for a in answers.values()
        )

        # Witness pin: the unkilled witness fleet, merged identically,
        # must answer bit-exactly for every service on every survivor.
        witness_merged: dict[str, dict] = {}
        for s in survivors:
            dst = witness[s].arrays()
            mask = service_row_mask(
                witness[victim_id].pipe.tensorizer.service_names,
                witness[s].pipe.tensorizer.service_names,
                int(dst["lat_mean"].shape[0]),
                owned=victim_services,
            )
            witness_merged[s] = merge_shard_arrays(
                dst, witness[victim_id].arrays(), mask
            )
        bitexact = True
        for s in survivors:
            got = _query_docs(merged[s], meta, FLEET_SERVICES)
            want = _query_docs(witness_merged[s], meta, FLEET_SERVICES)
            if got != want:
                bitexact = False
            for name in ("hll_bank", "cms_bank"):
                if not (merged[s][name] == witness_merged[s][name]).all():
                    bitexact = False
    finally:
        mirror.stop()
        for shard in (*fleet.values(), *witness.values()):
            shard.stop()

    partial = _measure_partial_answer(config, batch, device)
    tenant = _measure_tenant_isolation(config, batch, device)
    fleet_ok = bool(
        answered and bitexact
        and partial["partial_answer_ok"]
        and tenant["noisy_tenant_isolated"]
    )
    return {
        "shard_reshard_ttd_s": round(ttd_s, 4),
        "fleet_shards": len(shard_ids),
        "victim": victim_id,
        "victim_services": victim_services,
        "reshards_applied": membership.reshards_total,
        "reshard_bitexact": bitexact,
        "survivor_answers_victim_keys": answered,
        "dead_after_s": dead_after_s,
        **partial,
        **tenant,
        "fleet_ok": fleet_ok,
        "victim_docs": answers,
    }


def hash_stable(s: str) -> int:
    """Deterministic small int from a string (not hash(): the drill's
    rng seeds must not change across processes)."""
    from .fleet import key_hash64

    return key_hash64(s) % 65521


def _measure_partial_answer(config: DetectorConfig, batch: int,
                            device: "str | None" = None) -> dict:
    """Aggregator degradation leg: two real shard query planes, one
    blackholed via runtime.faultwire — the merged answer must come back
    200, labeled partial, never 5xx."""
    from .aggregator import FleetAggregator
    from .faultwire import FaultWire
    from .query import QueryEngine, QueryService

    services = []
    pipes = []
    shards = {}
    wire = None
    aggregator = None
    try:
        for name in ("shard-0", "shard-1"):
            det = AnomalyDetector(config, device=device)
            pipe = DetectorPipeline(det, batch_size=batch)
            pipes.append(pipe)
            for svc in FLEET_SERVICES:
                pipe.tensorizer.service_id(svc)
            rng = np.random.default_rng(11)
            pipe.submit_columns(make_columns(rng, batch))
            pipe.pump(0.0)
            pipe.drain()
            engine = QueryEngine(snapshot_fn=pipeline_snapshot_fn(pipe, query=True))
            service = QueryService(engine, host="127.0.0.1", port=0)
            service.start()
            services.append(service)
            shards[name] = f"127.0.0.1:{service.port}"
        # Blackhole shard-1 behind a faultwire proxy: accepted
        # connections, every byte dropped — the half-open worst case.
        wire = FaultWire("127.0.0.1", services[1].port)
        wire.blackhole = True
        wire.start()
        shards["shard-1"] = f"127.0.0.1:{wire.port}"
        aggregator = FleetAggregator(shards, timeout_s=0.5)
        status, doc = aggregator.dispatch("/query/services", {})
        meta = doc.get("meta") or {}
        ok = (
            status == 200
            and meta.get("partial") is True
            and meta.get("shards_answered") == 1
            and meta.get("shards_total") == 2
            and not meta.get("shards", {}).get("shard-1", {}).get("ok")
            and (doc.get("data") or {}).get("services")
        )
        return {
            "partial_answer_ok": bool(ok),
            "partial_shards_answered": meta.get("shards_answered"),
        }
    finally:
        if aggregator is not None:
            aggregator.close()
        if wire is not None:
            wire.stop()
        for service in services:
            service.stop()
        for pipe in pipes:
            pipe.close()


def _measure_tenant_isolation(config: DetectorConfig, batch: int,
                              device: "str | None" = None) -> dict:
    """Noisy-tenant leg: one tenant floods far past its quota — only
    its rows shed (``shed_rows_tenant`` isolated), the quiet tenant's
    rows all admitted."""
    from .fleet import tenant_of

    det = AnomalyDetector(config, device=device)
    pipe = DetectorPipeline(
        det, batch_size=batch,
        tenant_of=lambda name: tenant_of(name, FLEET_TENANTS),
        tenant_quota_rows_s=500.0,
    )
    try:
        for svc in FLEET_SERVICES:
            pipe.tensorizer.service_id(svc)
        rng = np.random.default_rng(3)
        # The web tenant floods (frontend), platform stays modest (payment).
        for _ in range(6):
            pipe.submit(_fleet_records(rng, "frontend", 400))
            pipe.submit(_fleet_records(rng, "payment", 40))
        shed = dict(pipe.stats.shed_rows_tenant)
        pipe.pump(0.0)
        pipe.drain()
    finally:
        pipe.close()
    isolated = bool(
        shed.get("web", 0) > 0 and shed.get("platform", 0) == 0
    )
    return {
        "noisy_tenant_isolated": isolated,
        "tenant_shed_rows": shed,
    }


def _daemon_command(device: "str | None") -> list[str]:
    """A daemon subprocess of this package; ``--device`` only when the
    caller named one (the daemon's own default is the card)."""
    import sys

    cmd = [sys.executable, "-m", "opentelemetry_demo_tpu_torch.runtime.daemon"]
    return cmd if device is None else cmd + ["--device", str(device)]


def measure_reshard_live(
    dead_after_s: float = 2.0,
    batch: int = 128,
    device: "str | None" = None,
) -> dict:
    """Live-fire reshard: the victim shard is a REAL daemon subprocess
    under live Kafka + OTLP load, SIGKILLed mid-stream; an in-proc
    survivor adopts its replicated frame once membership (heartbeating
    the victim's real /healthz, with the double-check) declares it
    dead. ``shard_reshard_ttd_s`` here is the deployment-shaped
    number: real process death, real health silence, real frame
    adoption. The victim daemon and the in-proc survivor run on the
    card unless ``device`` names another."""
    import http.client
    import os
    import re
    import signal
    import subprocess

    from .fleet import (
        FleetMembership,
        http_health_alive,
        merge_shard_arrays,
        service_row_mask,
    )
    from .kafka_broker import KafkaBroker
    from .kafka_orders import Order, encode_order
    from .otlp_export import encode_export_request

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))
    config = DetectorConfig(num_services=8, hll_p=8, cms_width=512)
    broker = KafkaBroker()
    broker.start()
    broker.ensure_topic("orders")
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONUNBUFFERED"] = "1"
    env.update({
        "ANOMALY_OTLP_PORT": "0",
        "ANOMALY_OTLP_GRPC_PORT": "-1",
        "ANOMALY_METRICS_PORT": "0",
        "ANOMALY_BATCH": str(batch),
        "ANOMALY_PUMP_INTERVAL_S": "0.05",
        "ANOMALY_NUM_SERVICES": "8",
        "ANOMALY_CMS_WIDTH": "512",
        "ANOMALY_HLL_P": "8",
        "ANOMALY_INGEST_WORKERS": "0",
        "ANOMALY_ROLE": "primary",
        "ANOMALY_REPLICATION_PORT": "0",
        "ANOMALY_REPLICATION_INTERVAL_S": "0.1",
        "ANOMALY_FLEET_SERVICES": ",".join(FLEET_SERVICES),
        "KAFKA_ADDR": f"127.0.0.1:{broker.port}",
    })
    env.pop("ANOMALY_CHECKPOINT", None)
    proc = subprocess.Popen(
        _daemon_command(device),
        cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    mirror = None
    try:
        line = None
        deadline = time.monotonic() + 180.0
        while time.monotonic() < deadline:
            out = proc.stdout.readline()
            if not out:
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"victim shard exited rc={proc.returncode}"
                    )
                time.sleep(0.05)
                continue
            if "anomaly-detector:" in out:
                line = out
                break
        if not line:
            raise RuntimeError("victim shard never announced")
        otlp_port = int(re.search(r"otlp-http :(\d+)", line).group(1))
        repl_port = int(re.search(r"repl :(\d+)", line).group(1))
        metrics_port = int(
            re.search(r"metrics :(\d+)", line).group(1)
        )

        # Live load on both legs: orders into the broker + spans over
        # OTLP at the victim.
        for i in range(8):
            broker.append("orders", encode_order(Order(
                order_id=f"ord-{i}", tracking_id=f"trk-{i}",
                shipping_cost_units=5.0, item_count=1,
                product_ids=("EYE-PLO-25",), total_quantity=1,
            )))
        rng = np.random.default_rng(5)
        body = encode_export_request(
            _fleet_records(rng, "payment", 64)
            + _fleet_records(rng, "frontend", 64)
        )
        conn = http.client.HTTPConnection(
            "127.0.0.1", otlp_port, timeout=10.0
        )
        conn.request(
            "POST", "/v1/traces", body=body,
            headers={"Content-Type": "application/x-protobuf"},
        )
        if conn.getresponse().status != 200:
            raise RuntimeError("victim refused OTLP load")

        # The survivor's mirror of the victim (its standby, in-proc).
        mirror_fence = EpochFence(0)
        mirror = ReplicationStandby(
            f"127.0.0.1:{repl_port}", mirror_fence,
            config_fingerprint=list(
                config._replace(sketch_impl=None)
            ),
        )
        mirror.start()
        if not mirror.wait_for_state(60.0):
            raise RuntimeError("mirror never bootstrapped")
        # Wait until the mirror has actually absorbed the span load.
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            arrs, _m = mirror.snapshot()
            if arrs and float(np.asarray(arrs["span_total"]).sum()) > 0:
                break
            time.sleep(0.1)

        # The survivor shard, in-proc, with the SHARED service table.
        survivor = _Shard(
            "shard-0", config, batch, interval_s=0.1, device=device
        )
        membership = FleetMembership(
            "shard-0", ["shard-1"],
            dead_after_s=dead_after_s, rejoin_after_s=2.0,
            reshard_budget=4, reshard_refill_s=60.0,
            # The REAL double-check: the victim's live /healthz.
            health_check=lambda s: http_health_alive(
                f"127.0.0.1:{metrics_port}", timeout_s=2.0
            ),
        )
        membership.observe("shard-1")

        # SIGKILL, the real thing, mid-load.
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        t_kill = time.monotonic()
        events: list = []
        give_up = t_kill + dead_after_s * 20 + 30.0
        while time.monotonic() < give_up and not events:
            events = membership.tick()
            if not events:
                time.sleep(0.05)
        if not events:
            raise RuntimeError("membership never declared the victim dead")
        mirror_arrays, mirror_meta = mirror.snapshot()
        dst = survivor.arrays()
        mask = service_row_mask(
            list(mirror_meta.get("service_names") or []),
            survivor.pipe.tensorizer.service_names,
            int(dst["lat_mean"].shape[0]),
        )
        merged = merge_shard_arrays(dst, mirror_arrays, mask)
        meta = {
            "service_names": list(FLEET_SERVICES),
            "config": list(config._replace(sketch_impl=None)),
        }
        docs = _query_docs(merged, meta, ["payment", "frontend"])
        ttd_s = time.monotonic() - t_kill
        answered = all(
            max(d["cardinality"]["estimate"]) > 0.0
            for d in docs.values()
        )
        # Adoption exactness, pinned INDEPENDENTLY of the merge
        # implementation: the survivor ingested nothing in this leg,
        # so the post-merge answers for the victim's services must
        # equal the answers computed from the mirror frame ALONE —
        # the unkilled witness for the live leg. (Recomputing the
        # max/add here would just re-run merge_shard_arrays' own
        # arithmetic and could never fail.)
        witness_docs = _query_docs(
            mirror_arrays, meta, ["payment", "frontend"]
        )
        exact = docs == witness_docs
        survivor.stop()
        return {
            "live_sigkill_ttd_s": round(ttd_s, 4),
            "live_survivor_answers": answered,
            "live_adoption_exact": exact,
            "live_reshards_applied": membership.reshards_total,
        }
    finally:
        if mirror is not None:
            mirror.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)
        broker.stop()


def _free_port() -> int:
    """Reserve an ephemeral port number (bind/close: the usual bench
    race window, acceptable on a loopback-only drill)."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http_json(port: int, path: str, timeout_s: float = 2.0):
    """GET 127.0.0.1:port/path as parsed JSON; None on any failure."""
    import http.client
    import json as _json

    try:
        conn = http.client.HTTPConnection(
            "127.0.0.1", port, timeout=timeout_s
        )
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        if resp.status != 200:
            return None
        return _json.loads(body)
    except Exception:  # noqa: BLE001 — a dead/booting shard is "no"
        return None


def _read_announce(proc, deadline_s: float = 180.0) -> dict:
    """Block until a daemon subprocess prints its announce line; then
    keep DRAINING its stdout on a thread (an unread pipe would block
    the daemon's own prints mid-drill)."""
    import re
    import threading

    line = None
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        out = proc.stdout.readline()
        if not out:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"shard exited rc={proc.returncode} before announce"
                )
            time.sleep(0.05)
            continue
        if "anomaly-detector:" in out:
            line = out
            break
    if not line:
        raise RuntimeError("shard never announced")

    def _drain() -> None:
        for _ in proc.stdout:
            pass

    threading.Thread(target=_drain, daemon=True).start()
    return {
        "otlp": int(re.search(r"otlp-http :(\d+)", line).group(1)),
        "query": int(re.search(r"query :(\d+)", line).group(1)),
    }


def measure_adoption(
    dead_after_s: float = 2.0,
    batch: int = 256,
    quiet_s: float = 5.0,
    device: "str | None" = None,
) -> dict:
    """The ELASTIC-fleet live drill (`make autoscalebench`): two REAL
    daemon shards wired as an adoptive pair (each mirrors its
    ring-successor's replication stream) with the autoscaler enabled
    on the heir. Ramp OTLP load until the heir's admission saturates
    and the autoscaler proposes scale-out, then SIGKILL the victim
    shard mid-resize and watch the heir adopt its keyspace with ZERO
    operator action — membership double-check, in-daemon monoid merge
    under the dispatch lock, new ring version.

    - ``autoscale_tta_s`` — SIGKILL → the heir's /healthz reporting
      the adoption applied (the zero-operator time-to-adopt);
    - ``autoscale_ok`` — the whole contract: a split was proposed
      under real saturation, adoption happened automatically, the
      heir's post-settle /query/* answers for the victim's keys are
      BIT-EXACT against an unkilled witness (both shards' pre-kill
      mirror frames merged in-proc by the same monoid ops), and the
      controller stays quiet (no further proposals) for ``quiet_s``
      after the resize — no oscillation.

    Both daemons run on the card unless ``device`` names another.
    """
    import http.client
    import json as _json
    import os
    import signal
    import subprocess

    from .fleet import (
        HashRing,
        merge_shard_arrays,
        service_row_mask,
        shard_key,
        tenant_of,
    )
    from .otlp_export import encode_export_request

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))
    config = DetectorConfig(num_services=8, hll_p=8, cms_width=512)
    heartbeat_s = 0.25
    metrics_ports = [_free_port(), _free_port()]
    repl_ports = [_free_port(), _free_port()]
    peers = ",".join(f"127.0.0.1:{p}" for p in metrics_ports)
    repl_peers = ",".join(f"127.0.0.1:{p}" for p in repl_ports)

    base_env = dict(os.environ)
    base_env.pop("ANOMALY_CHECKPOINT", None)
    base_env["PYTHONPATH"] = repo + os.pathsep + base_env.get(
        "PYTHONPATH", ""
    )
    base_env["PYTHONUNBUFFERED"] = "1"
    base_env.update({
        "ANOMALY_OTLP_PORT": "0",
        "ANOMALY_OTLP_GRPC_PORT": "-1",
        "ANOMALY_QUERY_PORT": "0",
        "ANOMALY_BATCH": str(batch),
        "ANOMALY_PUMP_INTERVAL_S": "0.2",
        "ANOMALY_NUM_SERVICES": "8",
        "ANOMALY_CMS_WIDTH": "512",
        "ANOMALY_HLL_P": "8",
        "ANOMALY_INGEST_WORKERS": "0",
        "ANOMALY_ROLE": "primary",
        "ANOMALY_REPLICATION_INTERVAL_S": "0.1",
        # Selftrace spans would keep mutating the heir's sketches
        # after the witness snapshot — off for the bit-exact pin.
        "ANOMALY_SELFTRACE_ENABLE": "0",
        # Tight snapshot cache: the post-adoption /query/* pin must
        # not be answered from a pre-merge cached snapshot.
        "ANOMALY_QUERY_MAX_STALENESS_S": "0.25",
        "ANOMALY_FLEET_SHARDS": "2",
        "ANOMALY_FLEET_PEERS": peers,
        "ANOMALY_FLEET_REPL_PEERS": repl_peers,
        "ANOMALY_FLEET_SERVICES": ",".join(FLEET_SERVICES),
        "ANOMALY_FLEET_HEARTBEAT_S": str(heartbeat_s),
        "ANOMALY_FLEET_DEAD_AFTER_S": str(dead_after_s),
        "ANOMALY_FLEET_REJOIN_AFTER_S": "2.0",
        "KAFKA_ADDR": "",
    })
    heir_env = dict(base_env)
    heir_env.update({
        "ANOMALY_FLEET_SHARD_INDEX": "0",
        "ANOMALY_METRICS_PORT": str(metrics_ports[0]),
        "ANOMALY_REPLICATION_PORT": str(repl_ports[0]),
        # The elastic half under test: opt-in autoscaler on the heir,
        # with a small row budget so the ramp actually saturates.
        "ANOMALY_AUTOSCALE_ENABLE": "1",
        "ANOMALY_AUTOSCALE_ACT_BATCHES": "3",
        "ANOMALY_AUTOSCALE_CLEAR_BATCHES": "120",
        "ANOMALY_AUTOSCALE_BUDGET": "2",
        "ANOMALY_AUTOSCALE_REFILL_S": "300.0",
        "ANOMALY_QUEUE_MAX_ROWS": "1024",
    })
    victim_env = dict(base_env)
    victim_env.update({
        "ANOMALY_FLEET_SHARD_INDEX": "1",
        "ANOMALY_METRICS_PORT": str(metrics_ports[1]),
        "ANOMALY_REPLICATION_PORT": str(repl_ports[1]),
    })

    # Route load by the SAME ring the daemons build (member ids,
    # default vnodes, default tenant map).
    ring = HashRing(["shard-0", "shard-1"], vnodes=128)
    owner_of = {
        svc: ring.owner(shard_key(svc, tenant_of(svc, {})))
        for svc in FLEET_SERVICES
    }
    heir_services = [s for s, o in owner_of.items() if o == "shard-0"]
    victim_services = [s for s, o in owner_of.items() if o == "shard-1"]
    if not heir_services or not victim_services:
        raise RuntimeError("ring left one shard without keyspace")

    def spawn(env):
        return subprocess.Popen(
            _daemon_command(device),
            cwd=repo, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

    def post_spans(otlp_port: int, services, rows: int, rng) -> None:
        body = encode_export_request([
            rec
            for svc in services
            for rec in _fleet_records(rng, svc, rows)
        ])
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", otlp_port, timeout=5.0
            )
            conn.request(
                "POST", "/v1/traces", body=body,
                headers={"Content-Type": "application/x-protobuf"},
            )
            conn.getresponse().read()
            conn.close()
        except Exception:  # noqa: BLE001 — 429/refused mid-saturation
            pass            # IS the drill working

    heir = spawn(heir_env)
    victim = spawn(victim_env)
    witness_victim = witness_heir = None
    try:
        heir_ports = _read_announce(heir)
        victim_ports = _read_announce(victim)

        # Membership must see the pair before anything can be adopted.
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            doc = _http_json(metrics_ports[0], "/healthz")
            fleet_doc = (doc or {}).get("fleet") or {}
            if fleet_doc.get("shards_live") == 2:
                break
            time.sleep(0.1)
        else:
            raise RuntimeError("heir never saw the victim alive")

        # The unkilled WITNESS: both shards' replication streams
        # mirrored in-proc — their pre-kill frames merged by the same
        # monoid ops are what the heir must serve after adopting.
        fingerprint = list(config._replace(sketch_impl=None))
        witness_victim = ReplicationStandby(
            f"127.0.0.1:{repl_ports[1]}", EpochFence(0),
            config_fingerprint=fingerprint, standby_id="witness-victim",
        )
        witness_heir = ReplicationStandby(
            f"127.0.0.1:{repl_ports[0]}", EpochFence(0),
            config_fingerprint=fingerprint, standby_id="witness-heir",
        )
        witness_victim.start()
        witness_heir.start()
        if not witness_victim.wait_for_state(60.0):
            raise RuntimeError("victim witness never bootstrapped")
        if not witness_heir.wait_for_state(60.0):
            raise RuntimeError("heir witness never bootstrapped")

        # RAMP until brownout: blast the heir's keyspace far past its
        # row budget until the saturation streak crosses the acting
        # edge and the autoscaler proposes scale-out. (The victim gets
        # a modest stream so its frame is worth adopting.)
        rng = np.random.default_rng(17)
        split_seen = False
        iters = 0
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            post_spans(heir_ports["otlp"], heir_services, 192, rng)
            if iters < 20:
                post_spans(victim_ports["otlp"], victim_services, 48, rng)
            iters += 1
            doc = _http_json(metrics_ports[0], "/healthz")
            auto = (doc or {}).get("autoscale") or {}
            if int(auto.get("proposals_split") or 0) >= 1:
                split_seen = True
                break
            time.sleep(0.05)
        if not split_seen:
            raise RuntimeError(
                "autoscaler never proposed scale-out under saturation"
            )

        # Quiesce: load OFF, wait for both witness mirrors to go
        # static (the daemons' own adoption mirrors ride the same
        # streams, so static witnesses mean static frames everywhere).
        def mirror_sum(standby) -> float | None:
            arrs, _m = standby.snapshot()
            if not arrs:
                return None
            return float(np.asarray(arrs["span_total"]).sum())

        stable_since = None
        last = None
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            now = (mirror_sum(witness_victim), mirror_sum(witness_heir))
            if None not in now and now == last:
                if stable_since is None:
                    stable_since = time.monotonic()
                elif time.monotonic() - stable_since >= 1.5:
                    break
            else:
                stable_since = None
            last = now
            time.sleep(0.25)
        else:
            raise RuntimeError("mirrors never quiesced after the ramp")

        v_arrays, v_meta = witness_victim.snapshot()
        h_arrays, h_meta = witness_heir.snapshot()
        mask = service_row_mask(
            list(v_meta.get("service_names") or []),
            list(h_meta.get("service_names") or []),
            int(h_arrays["lat_mean"].shape[0]),
            owned=victim_services,
        )
        witness_merged = merge_shard_arrays(h_arrays, v_arrays, mask)
        wmeta = {
            "service_names": list(h_meta.get("service_names") or []),
            "config": fingerprint,
        }
        # Pin the PURE state reads (cardinality + zscore): the top-k
        # candidate ring is host-side ingest bookkeeping, not sketch
        # state, so a witness merge cannot reproduce it over HTTP.
        from . import query as q

        witness_docs = _json.loads(_json.dumps({
            svc: {
                "cardinality": q.cardinality(
                    witness_merged, wmeta, svc
                ),
                "zscore": q.zscore_state(witness_merged, wmeta, svc),
            }
            for svc in victim_services
        }))

        # SIGKILL mid-resize: the proposal just landed, the victim
        # dies. Nobody calls a merge — the heir must do it alone.
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait(timeout=30)
        t_kill = time.monotonic()
        adoptions: dict = {}
        give_up = t_kill + dead_after_s * 20 + 30.0
        while time.monotonic() < give_up:
            doc = _http_json(metrics_ports[0], "/healthz", timeout_s=1.0)
            adoptions = (
                (doc or {}).get("fleet") or {}
            ).get("adoptions") or {}
            if int(adoptions.get("total") or 0) >= 1:
                break
            time.sleep(0.02)
        tta_s = time.monotonic() - t_kill
        adopted = int(adoptions.get("total") or 0) >= 1
        if not adopted:
            raise RuntimeError("heir never adopted the victim's keyspace")

        # Post-settle /query/* pin: the heir's own query plane must
        # answer the victim's keys bit-exactly as the witness merge.
        # Retried briefly: the engine's snapshot cache may still hold
        # the last pre-merge state for one staleness window.
        def fetch_docs() -> dict:
            out: dict = {}
            for svc in victim_services:
                docs = {}
                for kind, path in (
                    ("cardinality", f"/query/cardinality?service={svc}"),
                    ("zscore", f"/query/zscore?service={svc}"),
                ):
                    answer = _http_json(heir_ports["query"], path)
                    data = (answer or {}).get("data") or {}
                    data.pop("timeline", None)  # engine-local, not state
                    docs[kind] = data
                out[svc] = docs
            return out

        got: dict = {}
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            got = fetch_docs()
            if got == witness_docs:
                break
            time.sleep(0.25)
        bitexact = got == witness_docs
        answered = all(
            max(d["cardinality"].get("estimate") or [0.0]) > 0.0
            for d in got.values()
        )

        # NO OSCILLATION: the controller must sit quiet after the
        # resize — no further proposals, no further ring changes.
        doc = _http_json(metrics_ports[0], "/healthz")
        auto0 = (doc or {}).get("autoscale") or {}
        time.sleep(quiet_s)
        doc = _http_json(metrics_ports[0], "/healthz")
        auto1 = (doc or {}).get("autoscale") or {}
        fleet1 = (doc or {}).get("fleet") or {}
        quiet = (
            auto1.get("proposals_split") == auto0.get("proposals_split")
            and auto1.get("proposals_join") == auto0.get("proposals_join")
            and int(
                (fleet1.get("adoptions") or {}).get("total") or 0
            ) == 1
        )
        mismatch = None
        if not bitexact:
            # Small enough to ride the json line; a failed pin without
            # the two answer sets is undebuggable after the fact.
            mismatch = {"got": got, "witness": witness_docs}
        return {
            "autoscale_tta_s": round(tta_s, 4),
            "autoscale_ok": bool(
                split_seen and adopted and bitexact and answered and quiet
            ),
            "adoption_mismatch": mismatch,
            "autoscale_proposals_split": auto1.get("proposals_split"),
            "autoscale_frozen": auto1.get("frozen"),
            "adoption_bitexact": bitexact,
            "adoption_answers_victim_keys": answered,
            "adoption_no_oscillation": quiet,
            "adoption_tta_internal_s": adoptions.get("last_tta_s"),
            "adoption_victim_services": victim_services,
            "adoption_dead_after_s": dead_after_s,
            "adoption_heartbeat_s": heartbeat_s,
        }
    finally:
        for standby in (witness_victim, witness_heir):
            if standby is not None:
                standby.stop()
        for proc in (heir, victim):
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=15)


def main() -> None:
    import json
    import sys

    if "--autoscale" in sys.argv[1:]:
        # The elastic-fleet live leg alone.
        print(json.dumps(measure_adoption()))
        return
    if "--fleet" in sys.argv[1:]:
        out = measure_reshard()
        # The live-fire SIGKILL legs (slow: real daemon subprocesses
        # boot); skip with --no-live for quick iterations.
        if "--no-live" not in sys.argv[1:]:
            out.update(measure_reshard_live())
            out["fleet_ok"] = bool(
                out["fleet_ok"]
                and out["live_survivor_answers"]
                and out["live_adoption_exact"]
            )
            # The autoscale leg, folded in: saturation-driven
            # scale-out + SIGKILL mid-resize + automatic adoption.
            out.update(measure_adoption())
            out["fleet_ok"] = bool(
                out["fleet_ok"] and out["autoscale_ok"]
            )
        print(json.dumps(out))
        return
    print(json.dumps(measure_failover()))


if __name__ == "__main__":
    main()
