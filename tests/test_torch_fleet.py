"""The port's fleet tier against the reference.

Each case of the reference's fleet suite that runs without a daemon is
written once and driven through both packages: the consistent-hash ring
(placement, balance, movement, versions, adoption arcs), the membership
guardrails (flapping, the health double-check, rejoin hysteresis,
adoptive leaves), the reshard merge (``merge_shard_arrays``,
``service_row_mask`` and their refusals), the per-tenant quota, the
scatter-gather aggregator over real query planes (partial answers
through ``FaultWire``, routing, the Grafana surface, the mid-resize ring
repair), heartbeats through ``FaultWire`` chaos, and the autoscaler.
The reference's assertions hold for each package, and the two packages'
records (placements, events, snapshots, merged arrays, answer
documents, controller stats) must be equal. The in-process reshard
drill runs on the CPU in both packages: ``fleet_ok``, and the victim's
post-reshard documents equal the reference's (integer fields exact,
float fields within rtol 1e-4 / atol 1e-5, the detector's tolerance).

Tolerance: everything else compares exactly. Wall-clock fields (a
shard's ``staleness_s`` and ``seq`` in an aggregator envelope, a query
engine's ``timeline`` of read times, a peer's ``silence_s``) are left
out; the tenant quota's token bucket reads a virtual clock.
"""

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu import models as jmodels
from opentelemetry_demo_tpu.runtime import aggregator as jaggregator
from opentelemetry_demo_tpu.runtime import autoscale as jautoscale
from opentelemetry_demo_tpu.runtime import faultwire as jfaultwire
from opentelemetry_demo_tpu.runtime import fleet as jfleet
from opentelemetry_demo_tpu.runtime import pipeline as jpipeline
from opentelemetry_demo_tpu.runtime import query as jquery
from opentelemetry_demo_tpu.runtime import replbench as jreplbench
from opentelemetry_demo_tpu.runtime import replication as jreplication
from opentelemetry_demo_tpu.runtime import tensorize as jtensorize
from opentelemetry_demo_tpu_torch import models
from opentelemetry_demo_tpu_torch.runtime import (
    aggregator,
    autoscale,
    faultwire,
    fleet,
    pipeline,
    query,
    replbench,
    replication,
    tensorize,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The geometries here are small: torch's intra-op pool gains
    nothing and spins against XLA's pool and the other test processes'
    threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _detector(m, config):
    return (m.models.AnomalyDetector(config, device="cpu") if m.name == "port"
            else m.models.AnomalyDetector(config))


PKGS = {
    "port": types.SimpleNamespace(
        name="port", fleet=fleet, aggregator=aggregator, autoscale=autoscale, faultwire=faultwire,
        query=query, repl=replication, pipeline=pipeline, models=models, tensorize=tensorize),
    "reference": types.SimpleNamespace(
        name="reference", fleet=jfleet, aggregator=jaggregator, autoscale=jautoscale,
        faultwire=jfaultwire, query=jquery, repl=jreplication, pipeline=jpipeline, models=jmodels,
        tensorize=jtensorize),
}


def same(case, *args):
    """Run ``case`` through both packages; their records must be equal."""
    records = {name: case(ns, *args) for name, ns in PKGS.items()}
    assert records["port"] == records["reference"]
    return records["port"]


def _keys(m, n: int = 4000) -> list[str]:
    return [m.fleet.shard_key(f"svc-{i}", f"tenant-{i % 7}") for i in range(n)]


# -- the consistent-hash ring -------------------------------------------------


def ring_balance_within_bound(m):
    keys = _keys(m)
    out = {}
    for n in (2, 4, 8):
        ring = m.fleet.HashRing([f"shard-{i}" for i in range(n)], vnodes=128)
        spread = ring.spread(keys)
        ideal = len(keys) / n
        assert len(spread) == n
        assert max(spread.values()) <= 1.45 * ideal, (n, spread)
        assert min(spread.values()) >= 0.55 * ideal, (n, spread)
        out[n] = (spread, ring.assignments(keys), ring.version())
    return out


def minimal_key_movement_on_leave_and_join(m):
    keys = _keys(m)
    out = {}
    for n in (2, 4, 8):
        members = [f"shard-{i}" for i in range(n)]
        ring = m.fleet.HashRing(members, vnodes=128)
        before = ring.assignments(keys)
        victim = members[n // 2]
        ring.remove(victim)
        after = ring.assignments(keys)
        moved = [k for k in keys if before[k] != after[k]]
        assert all(before[k] == victim for k in moved)
        assert len(moved) == sum(1 for k in keys if before[k] == victim)
        ring.add(victim)
        assert ring.assignments(keys) == before
        ring.add("shard-new")
        grown = ring.assignments(keys)
        moved_in = [k for k in keys if before[k] != grown[k]]
        assert all(grown[k] == "shard-new" for k in moved_in)
        frac = len(moved_in) / len(keys)
        assert 0.4 / (n + 1) <= frac <= 1.8 / (n + 1), (n, frac)
        out[n] = (after, grown)
    return out


def ring_version_tracks_membership(m):
    ring = m.fleet.HashRing(["a", "b"], vnodes=16)
    v0 = ring.version()
    assert v0 == m.fleet.HashRing(["b", "a"], vnodes=16).version()
    ring.remove("b")
    v1 = ring.version()
    assert v1 != v0
    ring.add("b")
    assert ring.version() == v0
    v32 = m.fleet.HashRing(["a", "b"], vnodes=32).version()
    assert v32 != v0
    return [v0, v1, v32]


def key_hash_is_stable_literal(m):
    import hashlib

    assert m.fleet.key_hash64("tenant/service") == int.from_bytes(
        hashlib.blake2b(b"tenant/service", digest_size=8).digest(), "big")
    return [m.fleet.key_hash64(k) for k in _keys(m, 500)] + [
        m.fleet.tenant_of("cart", {"cart": "web"}), m.fleet.tenant_of("nope", {"cart": "web"}),
        m.fleet.shard_key("svc", "t")]


RING_CASES = [ring_balance_within_bound, minimal_key_movement_on_leave_and_join,
              ring_version_tracks_membership, key_hash_is_stable_literal]


@pytest.mark.parametrize("case", RING_CASES, ids=lambda c: c.__name__)
def test_ring_case_places_as_the_reference(case):
    same(case)


def test_placement_deterministic_across_processes():
    """The port's ring places identically in a fresh interpreter with a
    different hash seed (blake2b, not ``hash()``), and as the reference's."""
    keys = _keys(PKGS["port"], 256)
    local = json.dumps(jfleet.HashRing(["a", "b", "c"], vnodes=64).assignments(keys), sort_keys=True)
    code = (
        "import json\n"
        "from opentelemetry_demo_tpu_torch.runtime.fleet import HashRing, shard_key\n"
        "keys = [shard_key(f'svc-{i}', f'tenant-{i % 7}') for i in range(256)]\n"
        "print(json.dumps(HashRing(['a', 'b', 'c'], vnodes=64).assignments(keys), sort_keys=True))\n"
    )
    env = dict(os.environ, PYTHONHASHSEED="12345", PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == local


# -- membership guardrails ----------------------------------------------------


def flapping_shard_freezes_ring_within_budget(m):
    budget = 3
    mem = m.fleet.FleetMembership(
        "self", ["flappy"], dead_after_s=0.02, rejoin_after_s=0.02,
        reshard_budget=budget, reshard_refill_s=3600.0, health_check=lambda s: False,
    )
    t = 100.0
    applied = []
    for _ in range(40):
        t += 0.05
        applied += mem.tick(t)
        for _ in range(4):
            t += 0.01
            mem.observe("flappy", t)
            applied += mem.tick(t)
    assert len(applied) <= budget
    assert mem.reshards_total <= budget
    assert mem.reshards_refused >= 1
    assert mem.frozen
    frozen_version = mem.ring.version()
    t += 0.05
    mem.tick(t)
    assert mem.ring.version() == frozen_version
    return applied, mem.snapshot()


def stalled_but_serving_shard_not_declared_dead(m):
    serving = {"peer": True}
    mem = m.fleet.FleetMembership(
        "self", ["peer"], dead_after_s=0.02, rejoin_after_s=0.1,
        reshard_budget=4, reshard_refill_s=3600.0, health_check=lambda s: serving[s],
    )
    t = 10.0
    mem.observe("peer", t)
    for _ in range(10):
        t += 0.05
        assert mem.tick(t) == []
    assert mem.reshards_total == 0 and "peer" in mem.ring.members()
    serving["peer"] = False
    t += 0.05
    events = mem.tick(t)
    assert [e["op"] for e in events] == ["leave"]
    assert "peer" not in mem.ring.members()
    return events, mem.snapshot()


def rejoin_requires_sustained_heartbeats(m):
    mem = m.fleet.FleetMembership(
        "self", ["peer"], dead_after_s=0.02, rejoin_after_s=0.5,
        reshard_budget=8, reshard_refill_s=3600.0, health_check=lambda s: False,
    )
    t = 5.0
    mem.observe("peer", t)
    t += 0.1
    leave = mem.tick(t)
    assert [e["op"] for e in leave] == ["leave"]
    mem.observe("peer", t)
    t += 0.01
    assert mem.tick(t) == []
    events = []
    for _ in range(60):
        t += 0.01
        mem.observe("peer", t)
        events = mem.tick(t)
        if events:
            break
    assert [e["op"] for e in events] == ["join"]
    assert "peer" in mem.ring.members()
    return leave, events, mem.snapshot()


def snapshot_shape(m):
    mem = m.fleet.FleetMembership("shard-0", ["shard-1", "shard-2"])
    snap = mem.snapshot()
    assert snap["shard"] == "shard-0" and snap["shards_total"] == 3 and snap["shards_live"] == 3
    assert set(snap["peers"]) == {"shard-1", "shard-2"}
    assert snap["reshards_total"] == 0 and snap["frozen"] is False
    assert snap["ring_version"] == mem.ring.version()
    # Heartbeat ages are wall-clock: keep only the peers' names.
    return {k: (sorted(v) if k == "peers" else v) for k, v in snap.items()}


def parse_peer_list_skips_self(m):
    out = m.fleet.parse_peer_list("a:1, b:2 ,c:3", shards=3, self_index=1)
    assert out == {"shard-0": "a:1", "shard-2": "c:3"}
    every = m.fleet.parse_peer_list("a:1,b:2", shards=2, self_index=-1)
    assert every == {"shard-0": "a:1", "shard-1": "b:2"}
    return out, every


MEMBERSHIP_CASES = [flapping_shard_freezes_ring_within_budget, stalled_but_serving_shard_not_declared_dead,
                    rejoin_requires_sustained_heartbeats, snapshot_shape, parse_peer_list_skips_self]


def _strip_ages(x):
    """Membership snapshots carry wall-clock heartbeat ages: leave them out."""
    if isinstance(x, dict):
        return {k: _strip_ages(v) for k, v in x.items() if k != "silence_s"}
    if isinstance(x, (list, tuple)):
        return [_strip_ages(v) for v in x]
    return x


@pytest.mark.parametrize("case", MEMBERSHIP_CASES, ids=lambda c: c.__name__)
def test_membership_case_runs_as_the_reference_runs_it(case):
    same(lambda m: _strip_ages(case(m)))


# -- the reshard merge ------------------------------------------------------


def _bank_arrays(seed: int, s: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "hll_bank": rng.integers(0, 20, (3, 2, s, 16), dtype=np.int32),
        "cms_bank": rng.integers(0, 50, (3, 2, 2, 32), dtype=np.int32),
        "span_total": rng.random((3, 2)).astype(np.float32),
        "lat_mean": rng.random((s, 3)).astype(np.float32),
        "cusum": rng.random((s, 3)).astype(np.float32),
        "obs_batches": rng.random(s).astype(np.float32),
        "step_idx": np.int32(seed),
    }


def _as_bytes(arrays: dict) -> dict:
    return {k: (np.asarray(v).dtype.str, np.asarray(v).shape, np.asarray(v).tobytes()) for k, v in arrays.items()}


def merge_monoids_bit_exact(m):
    dst, src = _bank_arrays(1), _bank_arrays(2)
    mask = np.array([False, True, False, True])
    out = m.fleet.merge_shard_arrays(dst, src, mask)
    assert (out["hll_bank"] == np.maximum(dst["hll_bank"], src["hll_bank"])).all()
    assert (out["cms_bank"] == dst["cms_bank"] + src["cms_bank"]).all()
    assert np.allclose(out["span_total"], dst["span_total"] + src["span_total"])
    for name in ("lat_mean", "cusum", "obs_batches"):
        assert (out[name][mask] == src[name][mask]).all()
        assert (out[name][~mask] == dst[name][~mask]).all()
    assert int(out["step_idx"]) == 2 and int(dst["step_idx"]) == 1
    return _as_bytes(out)


def merge_refusals(m):
    """Geometry drift, drifted service tables and a keyspace-generation
    bump are refused; an owned subset maps to its rows."""
    refused = []
    with pytest.raises(m.fleet.ShardMergeError) as e:
        m.fleet.merge_shard_arrays(_bank_arrays(1), _bank_arrays(2, s=6), np.ones(4, bool))
    refused.append(str(e.value))
    with pytest.raises(m.fleet.ShardMergeError) as e:
        m.fleet.service_row_mask(["a", "b"], ["a", "x"], 4)
    refused.append(str(e.value))
    with pytest.raises(m.fleet.ShardMergeError) as e:
        m.fleet.merge_shard_arrays({"cms_bank": np.ones((64, 16), np.int32)},
                                   {"cms_bank": np.ones((64, 16), np.int32)},
                                   dst_generation=3, src_generation=0)
    refused.append(str(e.value))
    mask = m.fleet.service_row_mask(["a", "b", "c"], ["a", "b"], 4, owned=["a", "c"])
    assert mask.tolist() == [True, False, True, False]
    return refused, mask.tolist()


def merge_with_every_service_owned(m):
    rng = np.random.default_rng(9)
    names = [f"svc-{i}" for i in range(6)]
    mask = m.fleet.service_row_mask(names, names[:3], 8)
    dst, src = _bank_arrays(3, s=8), _bank_arrays(4, s=8)
    src["cms_bank"] = rng.integers(-3, 3, src["cms_bank"].shape, dtype=np.int32)
    return mask.tolist(), _as_bytes(m.fleet.merge_shard_arrays(dst, src, mask))


MERGE_CASES = [merge_monoids_bit_exact, merge_refusals, merge_with_every_service_owned]


@pytest.mark.parametrize("case", MERGE_CASES, ids=lambda c: c.__name__)
def test_merge_case_equals_the_references(case):
    same(case)


# -- the per-tenant quota -------------------------------------------------------


TENANTS = {"frontend": "web", "cart": "web", "payment": "platform"}


@pytest.fixture
def virtual_clock(monkeypatch):
    clock = {"t": 1000.0}
    virtual = types.SimpleNamespace(monotonic=lambda: clock["t"], perf_counter=time.perf_counter,
                                    time=time.time, sleep=time.sleep)
    for mod in (jpipeline, pipeline):
        monkeypatch.setattr(mod, "time", virtual)
    return clock


def _quota_pipe(m):
    det = _detector(m, m.models.DetectorConfig(num_services=8, hll_p=8, cms_width=512))
    pipe = m.pipeline.DetectorPipeline(
        det, batch_size=256, tenant_of=lambda name: m.fleet.tenant_of(name, TENANTS),
        tenant_quota_rows_s=200.0,
    )
    for svc in TENANTS:
        pipe.tensorizer.service_id(svc)
    return pipe


def _records(m, service: str, n: int, error: bool = False):
    rng = np.random.default_rng(n)
    return [m.tensorize.SpanRecord(service=service, duration_us=300.0, trace_id=rng.bytes(8),
                                   is_error=error, attr="k") for _ in range(n)]


def noisy_tenant_sheds_alone(m, clock):
    pipe = _quota_pipe(m)
    pending0 = pipe.pending_rows()
    for _ in range(5):
        pipe.submit(_records(m, "frontend", 800))
        pipe.submit(_records(m, "payment", 30))
        clock["t"] += 0.1
    shed = dict(pipe.stats.shed_rows_tenant)
    assert shed.get("web", 0) > 0 and shed.get("platform", 0) == 0
    admitted = pipe.pending_rows() - pending0
    assert admitted == 5 * 800 - shed["web"] + 5 * 30
    pipe.close()
    return shed, admitted


def error_lane_never_shed_by_quota(m, clock):
    pipe = _quota_pipe(m)
    pipe.submit(_records(m, "frontend", 800))
    shed0 = dict(pipe.stats.shed_rows_tenant)
    pending0 = pipe.pending_rows()
    pipe.submit(_records(m, "cart", 900, error=True))
    assert pipe.pending_rows() - pending0 == 900
    assert dict(pipe.stats.shed_rows_tenant).get("web", 0) == shed0.get("web", 0)
    assert pipe.stats.shed_rows["error"] == 0
    out = shed0, dict(pipe.stats.shed_rows)
    pipe.close()
    return out


@pytest.mark.parametrize("case", [noisy_tenant_sheds_alone, error_lane_never_shed_by_quota],
                         ids=lambda c: c.__name__)
def test_tenant_quota_case_sheds_as_the_reference(case, virtual_clock):
    same(case, virtual_clock)


# -- the scatter-gather aggregator --------------------------------------------


def _shard_arrays(seed: int, s: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "hll_bank": rng.integers(0, 9, (3, 2, s, 16), np.int32),
        "cms_bank": rng.integers(0, 30, (3, 2, 2, 64), np.int32),
        "span_total": (rng.random((3, 2)) * 100).astype(np.float32),
        **{k: rng.random((s, 3)).astype(np.float32)
           for k in ("lat_mean", "lat_var", "err_mean", "rate_mean", "rate_var", "card_mean", "card_var")},
        "obs_batches": rng.random(s).astype(np.float32),
        "obs_windows": rng.random((s, 3)).astype(np.float32),
        "cusum": rng.random((s, 3)).astype(np.float32),
        "step_idx": np.int32(seed),
    }


class _ShardPlane:
    """One real QueryService of a package over a fabricated snapshot."""

    def __init__(self, m, seed: int, services: list[str]):
        arrays = _shard_arrays(seed, s=len(services))
        meta = {
            "service_names": services,
            "query": {
                "anomalies": [
                    {"t": 100.0 + seed, "service": i, "signals": ["z"], "exemplars": [f"tid-{seed}-{i}"]}
                    for i in range(len(services))
                ],
                "exemplars": {str(i): [f"tid-{seed}-{i}"] for i in range(len(services))},
                "hh_candidates": {str(i): [7, 9] for i in range(len(services))},
            },
        }
        self.engine = m.query.QueryEngine(snapshot_fn=lambda: (arrays, meta))
        self.service = m.query.QueryService(self.engine, host="127.0.0.1", port=0)
        self.service.start()

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.service.port}"

    def stop(self):
        self.service.stop()


def _clean(doc):
    """An answer document without its wall-clock fields (the engine's own
    ``timeline`` of read times included)."""
    if isinstance(doc, dict):
        return {k: _clean(v) for k, v in doc.items() if k not in ("staleness_s", "seq", "age_s", "timeline")}
    if isinstance(doc, (list, tuple)):
        return [_clean(v) for v in doc]
    return doc


def _with_planes(m, body):
    a = _ShardPlane(m, 1, ["frontend", "cart"])
    b = _ShardPlane(m, 2, ["payment", "email"])
    try:
        return _clean(body(m, a, b))
    finally:
        a.stop()
        b.stop()


def services_union(m, a, b):
    agg = m.aggregator.FleetAggregator({"shard-0": a.addr, "shard-1": b.addr}, timeout_s=2.0)
    try:
        status, doc = agg.dispatch("/query/services", {})
        assert status == 200
        assert doc["data"]["services"] == ["cart", "email", "frontend", "payment"]
        assert doc["meta"]["shards_answered"] == 2 and doc["meta"]["partial"] is False
        return status, doc
    finally:
        agg.close()


def blackholed_shard_degrades_to_labeled_partial(m, a, b):
    wire = m.faultwire.FaultWire("127.0.0.1", b.service.port)
    wire.blackhole = True
    wire.start()
    agg = m.aggregator.FleetAggregator(
        {"shard-0": a.addr, "shard-1": f"127.0.0.1:{wire.port}"}, timeout_s=0.4)
    out = []
    try:
        for path in ("/query/services", "/query/anomalies"):
            t0 = time.monotonic()
            status, doc = agg.dispatch(path, {})
            assert time.monotonic() - t0 < 3.0
            meta = doc["meta"]
            assert status == 200 and meta["partial"] is True
            assert meta["shards_answered"] == 1 and meta["shards_total"] == 2
            assert meta["shards"]["shard-1"]["ok"] is False and "error" in meta["shards"]["shard-1"]
            out.append((status, doc))
        status, doc = agg.dispatch("/query/services", {})
        assert doc["data"]["services"] == ["cart", "frontend"]
        return out
    finally:
        agg.close()
        wire.stop()


def rst_shard_annotated_never_5xx(m, a, b):
    wire = m.faultwire.FaultWire("127.0.0.1", b.service.port)
    wire.rst_connects = True
    wire.start()
    agg = m.aggregator.FleetAggregator(
        {"shard-0": a.addr, "shard-1": f"127.0.0.1:{wire.port}"}, timeout_s=0.5)
    try:
        status, doc = agg.dispatch("/query/cardinality", {"service": "frontend"})
        assert status == 200 and doc["data"]["service"] == "frontend"
        assert doc["meta"]["shards"]["shard-1"]["ok"] is False
        # The refused connect's text names the platform's errno: keep
        # only that there was one.
        doc["meta"]["shards"]["shard-1"]["error"] = bool(doc["meta"]["shards"]["shard-1"].get("error"))
        return status, doc
    finally:
        agg.close()
        wire.stop()


def service_keyed_routes_to_owner(m, a, b):
    ring = m.fleet.HashRing(["shard-0", "shard-1"], vnodes=64)
    agg = m.aggregator.FleetAggregator({"shard-0": a.addr, "shard-1": b.addr}, timeout_s=2.0, ring=ring)
    out = []
    try:
        for svc, holder in (("frontend", "shard-0"), ("payment", "shard-1")):
            status, doc = agg.dispatch("/query/zscore", {"service": svc})
            assert status == 200 and doc["data"]["service"] == svc
            assert doc["meta"]["shards"][holder]["ok"] is True
            out.append((status, doc))
        return out
    finally:
        agg.close()


def unknown_service_404_and_param_400(m, a, b):
    agg = m.aggregator.FleetAggregator({"shard-0": a.addr, "shard-1": b.addr}, timeout_s=2.0)
    try:
        out = [agg.dispatch("/query/topk", {"service": "nope"}), agg.dispatch("/query/topk", {}),
               agg.dispatch("/query/flight", {})]
        assert [s for s, _ in out] == [404, 400, 404]
        return out
    finally:
        agg.close()


def total_loss_is_labeled_503(m, a, b):
    agg = m.aggregator.FleetAggregator({"shard-0": "127.0.0.1:1", "shard-1": "127.0.0.1:1"}, timeout_s=0.3)
    try:
        status, doc = agg.dispatch("/query/services", {})
        assert status == 503 and doc["meta"]["shards_answered"] == 0
        return status, doc["meta"]["shards_answered"], doc["meta"]["shards_total"]
    finally:
        agg.close()


def http_surface_serves_merged_answers(m, a, b):
    agg = m.aggregator.FleetAggregator({"shard-0": a.addr, "shard-1": b.addr}, timeout_s=2.0)
    service = m.aggregator.AggregatorService(agg, host="127.0.0.1", port=0)
    service.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", service.port, timeout=5.0)
        conn.request("GET", "/query/anomalies?limit=3")
        resp = conn.getresponse()
        doc = json.loads(resp.read().decode())
        assert resp.status == 200 and len(doc["data"]["events"]) == 3
        assert doc["meta"]["shards_answered"] == 2
        conn.request("GET", "/")
        probe = json.loads(conn.getresponse().read().decode())
        assert probe["tier"] == "aggregator"
        conn.close()
        return resp.status, doc, probe
    finally:
        service.stop()


AGGREGATOR_CASES = [services_union, blackholed_shard_degrades_to_labeled_partial, rst_shard_annotated_never_5xx,
                    service_keyed_routes_to_owner, unknown_service_404_and_param_400, total_loss_is_labeled_503,
                    http_surface_serves_merged_answers]


@pytest.mark.parametrize("case", AGGREGATOR_CASES, ids=lambda c: c.__name__)
def test_aggregator_case_answers_as_the_reference(case):
    same(_with_planes, case)


# -- heartbeats through faultwire chaos ---------------------------------------


class _HealthzServer:
    """A /healthz endpoint publishing ``doc``, on a real socket."""

    def __init__(self, doc: dict):
        body = json.dumps(doc).encode()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


def _wait(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.05)
    return cond()


def heartbeats_through_faultwire_rst_then_heal(m):
    hz = _HealthzServer({"status": "ok"})
    wire = m.faultwire.FaultWire("127.0.0.1", hz.port)
    wire.start()
    member = m.fleet.FleetMember(
        "shard-0", {"shard-1": f"127.0.0.1:{wire.port}"}, heartbeat_s=0.05, dead_after_s=0.25,
        rejoin_after_s=0.3, reshard_budget=2, reshard_refill_s=3600.0,
    )
    member.start()
    out = []
    try:
        assert _wait(lambda: member.snapshot()["peers"]["shard-1"]["alive"], 5.0)
        wire.rst_connects = True
        assert _wait(lambda: not member.snapshot()["peers"]["shard-1"]["alive"], 10.0)
        snap = member.snapshot()
        assert snap["reshards_total"] == 1 and "shard-1" not in snap["members"]
        out.append((snap["reshards_total"], snap["members"]))
        wire.rst_connects = False
        assert _wait(lambda: "shard-1" in member.snapshot()["members"], 10.0)
        assert member.snapshot()["reshards_total"] == 2
        wire.rst_connects = True
        assert _wait(lambda: member.snapshot()["reshards_refused"] >= 1, 5.0)
        snap = member.snapshot()
        assert snap["frozen"] and snap["reshards_total"] == 2 and "shard-1" in snap["members"]
        out.append((snap["reshards_total"], snap["members"], snap["frozen"]))
        return out
    finally:
        member.stop()
        wire.stop()
        hz.stop()


def test_heartbeats_through_faultwire_rst_then_heal():
    """Flapping-shard chaos on real sockets: RST every heartbeat → the
    peer is declared dead once; heal → it rejoins after the sustained-beat
    window; flap again with the budget spent → the ring freezes. The
    port's transitions are the reference's."""
    same(heartbeats_through_faultwire_rst_then_heal)


# -- adoption ring and adoptive membership ------------------------------------


def adopt_transfers_whole_arc_to_heir(m):
    keys = _keys(m, 3000)
    ring = m.fleet.HashRing([f"shard-{i}" for i in range(4)], vnodes=128)
    before = ring.assignments(keys)
    heir = m.fleet.ring_heir(ring.members(), "shard-1")
    assert ring.adopt("shard-1", heir)
    after = ring.assignments(keys)
    for k in keys:
        assert after[k] == (heir if before[k] == "shard-1" else before[k])
    assert ring.adopted() == {"shard-1": heir} and "shard-1" not in ring.members()
    return heir, after, ring.version()


def version_tracks_arcs_and_rejoin_reclaims(m):
    r1 = m.fleet.HashRing(["a", "b", "c"], vnodes=64)
    v0 = r1.version()
    heir = m.fleet.ring_heir(r1.members(), "b")
    r1.adopt("b", heir)
    v1 = r1.version()
    assert v1 != v0
    rebuilt = m.fleet.HashRing(["a", "c"], vnodes=64, adopted={"b": heir})
    assert rebuilt.version() == v1
    keys = _keys(m, 500)
    assert rebuilt.assignments(keys) == r1.assignments(keys)
    r1.add("b")
    assert r1.version() == v0 and r1.adopted() == {}
    return v0, v1, heir


def adoption_chain_resolves_to_live_heir(m):
    ring = m.fleet.HashRing([f"shard-{i}" for i in range(4)], vnodes=128)
    keys = _keys(m, 2000)
    h1 = m.fleet.ring_heir(ring.members(), "shard-1")
    ring.adopt("shard-1", h1)
    h0 = m.fleet.ring_heir(ring.members(), h1)
    ring.adopt(h1, h0)
    placed = ring.assignments(keys)
    owners = set(placed.values())
    assert owners <= set(ring.members()) and h1 not in owners and "shard-1" not in owners
    return h1, h0, placed


def successor_and_heir_are_inverse(m):
    members = [f"shard-{i}" for i in range(5)]
    pairs = []
    for victim in members:
        heir = m.fleet.ring_heir([x for x in members if x != victim], victim)
        assert m.fleet.ring_successor(members, heir) == victim
        pairs.append((victim, heir))
    assert m.fleet.ring_successor(["only"], "only") is None
    assert m.fleet.ring_heir([], "gone") is None
    return pairs


def _adoptive(m, **kw):
    defaults = dict(dead_after_s=0.02, rejoin_after_s=0.1, reshard_budget=4, reshard_refill_s=3600.0,
                    health_check=lambda s: False, adoptive=True)
    defaults.update(kw)
    return m.fleet.FleetMembership("shard-0", ["shard-1", "shard-2"], **defaults)


def adoptive_leave_names_the_mirroring_heir(m):
    mem = _adoptive(m)
    keys = _keys(m, 2000)
    before = mem.ring.assignments(keys)
    t = 50.0
    mem.observe("shard-1", t)
    mem.observe("shard-2", t)
    t += 0.05
    mem.observe("shard-2", t)
    events = mem.tick(t)
    assert [e["op"] for e in events] == ["leave"]
    heir = m.fleet.ring_heir(["shard-0", "shard-1", "shard-2"], "shard-1")
    assert events[0]["shard"] == "shard-1" and events[0]["heir"] == heir
    assert mem.ring.adopted() == {"shard-1": heir}
    after = mem.ring.assignments(keys)
    for k in keys:
        assert after[k] == (heir if before[k] == "shard-1" else before[k])
    return events, after


def stalled_but_serving_shard_never_auto_adopted(m):
    serving = {"shard-1": True, "shard-2": True}
    mem = _adoptive(m, health_check=lambda s: serving[s])
    t = 20.0
    mem.observe("shard-1", t)
    for _ in range(10):
        t += 0.05
        mem.observe("shard-2", t)
        assert mem.tick(t) == []
    assert mem.ring.adopted() == {} and "shard-1" in mem.ring.members()
    serving["shard-1"] = False
    t += 0.05
    mem.observe("shard-2", t)
    events = mem.tick(t)
    assert [e.get("heir") for e in events] == [m.fleet.ring_heir(["shard-0", "shard-1", "shard-2"], "shard-1")]
    assert "shard-1" in mem.ring.adopted()
    return events


def budget_exhausted_freezes_adoption(m):
    mem = _adoptive(m, reshard_budget=1)
    t = 30.0
    mem.observe("shard-1", t)
    mem.observe("shard-2", t)
    t += 0.05
    mem.observe("shard-2", t)
    first = mem.tick(t)
    assert len(first) == 1 and first[0]["heir"] and mem.frozen
    arcs, version = dict(mem.ring.adopted()), mem.ring.version()
    t += 0.05
    assert mem.tick(t) == []
    assert mem.reshards_refused >= 1
    assert mem.ring.adopted() == arcs and mem.ring.version() == version and "shard-2" in mem.ring.members()
    return first, arcs, mem.reshards_refused


def rejoined_victim_reclaims_its_keyspace(m):
    mem = _adoptive(m)
    keys = _keys(m, 1000)
    t = 40.0
    mem.observe("shard-1", t)
    mem.observe("shard-2", t)
    v0 = mem.ring.version()
    before = mem.ring.assignments(keys)
    t += 0.05
    mem.observe("shard-2", t)
    assert [e["op"] for e in mem.tick(t)] == ["leave"]
    events = []
    for _ in range(60):
        t += 0.01
        mem.observe("shard-1", t)
        mem.observe("shard-2", t)
        events = mem.tick(t)
        if events:
            break
    assert [e["op"] for e in events] == ["join"]
    assert mem.ring.adopted() == {} and mem.ring.version() == v0 and mem.ring.assignments(keys) == before
    return events


ADOPTION_CASES = [adopt_transfers_whole_arc_to_heir, version_tracks_arcs_and_rejoin_reclaims,
                  adoption_chain_resolves_to_live_heir, successor_and_heir_are_inverse,
                  adoptive_leave_names_the_mirroring_heir, stalled_but_serving_shard_never_auto_adopted,
                  budget_exhausted_freezes_adoption, rejoined_victim_reclaims_its_keyspace]


@pytest.mark.parametrize("case", ADOPTION_CASES, ids=lambda c: c.__name__)
def test_adoption_case_runs_as_the_reference_runs_it(case):
    same(case)


# -- the autoscaler -------------------------------------------------------------


class _FlightStub:
    def __init__(self):
        self.records: list[tuple] = []
        self.dumps: list[tuple] = []

    def record(self, kind, **fields):
        self.records.append((kind, fields))

    def dump(self, reason, **context):
        self.dumps.append((reason, context))


class _StaleFence:
    def __init__(self, err):
        self.err = err

    def check(self, path):
        raise self.err("outranked")


def _controller(m, **kw):
    defaults = dict(enabled=True, act_batches=3, clear_batches=4, budget=2, refill_s=3600.0,
                    high_water=0.75, low_water=0.15, min_shards=2, max_shards=8, shards_fn=lambda: 2)
    defaults.update(kw)
    return m.autoscale.AutoscaleController(**defaults)


def _run(ctl, n, signals, start=0):
    return [ctl.observe(float(i), dict(signals)) for i in range(start, start + n)]


def observe_only_default_never_proposes(m):
    calls: list = []
    flight = _FlightStub()
    ctl = _controller(m, enabled=False, propose=calls.append, flight=flight)
    scores = _run(ctl, 9, {"queue": 1.0})
    assert calls == []
    st = ctl.stats()
    assert st["enabled"] is False and st["proposals_split"] == 0 and st["refused_disabled"] >= 1
    noted = [r for r in flight.records if r[0] == "autoscale-refused" and r[1]["reason"] == "observe_only"]
    assert len(noted) == 1
    return scores, st, flight.records, flight.dumps


def split_on_sustained_brownout(m):
    calls: list = []
    ctl = _controller(m, propose=lambda d: calls.append(d) or True)
    _run(ctl, 3, {"queue": 0.9, "brownout": 0.2})
    assert len(calls) == 1
    d = calls[0]
    assert d["action"] == "split" and d["shards"] == 2 and d["target"] == 3 and len(d["evidence"]) == 3
    st = ctl.stats()
    assert st["proposals_split"] == 1 and st["hot_streak"] == 0 and st["target_shards"] == 3
    return calls, st


def join_on_sustained_idle(m):
    calls: list = []
    ctl = _controller(m, shards_fn=lambda: 3, propose=lambda d: calls.append(d) or True)
    _run(ctl, 4, {"queue": 0.05})
    assert [d["action"] for d in calls] == ["join"] and calls[0]["target"] == 2
    assert ctl.stats()["proposals_join"] == 1
    return calls, ctl.stats()


def dead_band_resets_both_streaks(m):
    calls: list = []
    ctl = _controller(m, propose=lambda d: calls.append(d) or True)
    _run(ctl, 2, {"queue": 0.9})
    ctl.observe(2.0, {"queue": 0.5})
    st = ctl.stats()
    assert st["hot_streak"] == 0 and st["idle_streak"] == 0 and calls == []
    return st


def score_is_max_of_signals_clamped(m):
    ctl = _controller(m)
    scores = [ctl.observe(0.0, {"a": 0.2, "b": 0.6}), ctl.observe(1.0, {"a": 3.0}), ctl.observe(2.0, {})]
    assert scores == [0.6, 1.0, 0.0]
    return scores


def bounds_refused_at_fleet_limits(m):
    calls: list = []
    ctl = _controller(m, shards_fn=lambda: 8, propose=lambda d: calls.append(d) or True)
    _run(ctl, 3, {"q": 1.0})
    assert calls == [] and ctl.stats()["refused_bounds"] == 1
    ctl2 = _controller(m, shards_fn=lambda: 2, propose=lambda d: calls.append(d) or True)
    _run(ctl2, 4, {"q": 0.0})
    assert calls == [] and ctl2.stats()["refused_bounds"] == 1
    return ctl.stats(), ctl2.stats()


def budget_exhausted_freezes_then_refuses(m):
    calls: list = []
    ctl = _controller(m, budget=1, propose=lambda d: calls.append(d) or True)
    _run(ctl, 3, {"q": 1.0})
    assert len(calls) == 1 and ctl.frozen
    _run(ctl, 3, {"q": 1.0}, start=3)
    assert len(calls) == 1
    st = ctl.stats()
    assert st["refused_budget"] >= 1 and st["frozen"] is True
    return calls, st


def fenced_decision_refused(m):
    calls: list = []
    ctl = _controller(m, fence=_StaleFence(m.repl.StaleEpochError), propose=lambda d: calls.append(d) or True)
    _run(ctl, 3, {"q": 1.0})
    assert calls == [] and ctl.stats()["refused_fenced"] == 1
    return ctl.stats()


def standby_role_refused(m):
    calls: list = []
    ctl = _controller(m, role_fn=lambda: "standby", propose=lambda d: calls.append(d) or True)
    _run(ctl, 3, {"q": 1.0})
    assert calls == [] and ctl.stats()["refused_role"] == 1
    return ctl.stats()


def failed_apply_refunds_the_token(m):
    ctl = _controller(m, budget=2, propose=lambda d: False)
    _run(ctl, 3, {"q": 1.0})
    st = ctl.stats()
    assert st["refused_apply"] == 1 and st["tokens"] == 2.0 and st["frozen"] is False
    return st


AUTOSCALE_CASES = [observe_only_default_never_proposes, split_on_sustained_brownout, join_on_sustained_idle,
                   dead_band_resets_both_streaks, score_is_max_of_signals_clamped, bounds_refused_at_fleet_limits,
                   budget_exhausted_freezes_then_refuses, fenced_decision_refused, standby_role_refused,
                   failed_apply_refunds_the_token]


@pytest.mark.parametrize("case", AUTOSCALE_CASES, ids=lambda c: c.__name__)
def test_autoscale_case_decides_as_the_reference(case):
    same(case)


# -- the elastic aggregator ---------------------------------------------------


SERVICES = ["frontend", "cart", "payment", "email"]


def stale_boot_ring_self_repairs_mid_resize(m):
    heir = _ShardPlane(m, 1, SERVICES)
    post_ring = m.fleet.HashRing(["shard-0"], vnodes=64, adopted={"shard-1": "shard-0"})
    hz = _HealthzServer({"status": "serving", "fleet": {
        "members": ["shard-0"], "adopted": {"shard-1": "shard-0"}, "ring_version": post_ring.version(),
        "reshards_total": 1, "owned_vnodes": 64}})
    boot_ring = m.fleet.HashRing(["shard-0", "shard-1"], vnodes=64)
    victim_svcs = [s for s in SERVICES if boot_ring.owner(m.fleet.shard_key(s, "default")) == "shard-1"]
    assert victim_svcs
    agg = m.aggregator.FleetAggregator(
        {"shard-0": heir.addr, "shard-1": "127.0.0.1:1"}, timeout_s=0.5, ring=boot_ring,
        health_addrs={"shard-0": f"127.0.0.1:{hz.port}", "shard-1": "127.0.0.1:1"},
    )
    try:
        status, doc = agg.dispatch("/query/zscore", {"service": victim_svcs[0]})
        assert status == 200 and doc["data"]["service"] == victim_svcs[0]
        assert doc["meta"]["ring_refreshed"] is True and doc["meta"]["owner"] == "shard-0"
        assert doc["meta"]["partial"] is False and agg._ring_refreshes == 1
        status2, doc2 = agg.dispatch("/query/cardinality", {"service": victim_svcs[-1]})
        assert status2 == 200 and doc2["meta"]["owner"] == "shard-0"
        assert "ring_refreshed" not in doc2["meta"] and agg._ring_refreshes == 1
        return _clean([victim_svcs, status, doc, status2, doc2])
    finally:
        agg.close()
        hz.stop()
        heir.stop()


def grafana_surface_merges_across_shards(m):
    a = _ShardPlane(m, 1, ["frontend", "cart"])
    b = _ShardPlane(m, 2, ["payment", "email"])
    agg = m.aggregator.FleetAggregator({"shard-0": a.addr, "shard-1": b.addr}, timeout_s=2.0)
    try:
        status, targets = agg.dispatch("/search", {}, body={})
        assert status == 200 and "anomalies" in targets and "flight" not in targets
        assert "cardinality:frontend" in targets and "cardinality:payment" in targets
        status, frames = agg.dispatch("/query", {}, body={
            "targets": [{"target": "topk:frontend"}, {"target": "anomalies"}]})
        assert status == 200 and len(frames) == 2
        topk, table = frames
        assert topk["type"] == "table" and topk["rows"]
        assert table["type"] == "table" and len(table["rows"]) == 4
        times = [r[0] for r in table["rows"]]
        assert times == sorted(times, reverse=True)
        status, anns = agg.dispatch("/annotations", {}, body={"annotation": {"name": "anomaly"}})
        assert status == 200 and len(anns) == 4
        return _clean([targets, frames, anns])
    finally:
        agg.close()
        a.stop()
        b.stop()


@pytest.mark.parametrize("case", [stale_boot_ring_self_repairs_mid_resize, grafana_surface_merges_across_shards],
                         ids=lambda c: c.__name__)
def test_elastic_aggregator_case_answers_as_the_reference(case):
    same(case)


# -- the reshard drill ----------------------------------------------------------


def _assert_docs_close(got, want, path="docs"):
    """Integers (and strings, flags) exact; floats within RTOL/ATOL."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_docs_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_docs_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=path)
    else:
        assert got == want, path


def test_the_reshard_drill_answers_the_victims_keys_as_the_reference(monkeypatch):
    """The in-process shard-kill → reshard drill on the CPU in both
    packages (the reference's own test geometry): ``fleet_ok``, one
    reshard, and the victim's post-reshard documents equal the
    reference's."""
    ref_docs: dict = {}
    real = jreplbench._query_docs

    def recording(arrays, meta, services):
        out = real(arrays, meta, services)
        if len(services) == 1:
            ref_docs.update(out)
        return out

    monkeypatch.setattr(jreplbench, "_query_docs", recording)
    got = replbench.measure_reshard(seconds=0.6, rows_per_service=16, device="cpu")
    want = jreplbench.measure_reshard(seconds=0.6, rows_per_service=16)
    for out in (got, want):
        assert out["fleet_ok"] is True and out["reshard_bitexact"] is True
        assert out["survivor_answers_victim_keys"] is True and out["partial_answer_ok"] is True
        assert out["noisy_tenant_isolated"] is True and out["reshards_applied"] == 1
        assert out["shard_reshard_ttd_s"] < 10.0
    assert got["victim_services"] == want["victim_services"] == sorted(ref_docs, key=got["victim_services"].index)
    _assert_docs_close(json.loads(json.dumps(got["victim_docs"])), json.loads(json.dumps(ref_docs)))
