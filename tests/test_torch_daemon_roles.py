"""The port's daemon in its replication and fleet roles.

- ``TestDaemonRoles``: the first two cases of the reference's
  ``tests/test_replication.py::TestDaemonRoles`` against the port (a
  standby's health surface; a stale primary boots fenced).
- ``TestCrossPackageReplication``: a port primary daemon feeding a
  reference standby daemon, and the reverse; the mirror converges to
  the primary's state bit for bit, and the promoted standby's live state
  is the primary's final state.
- ``TestFleetConfig``, ``TestDaemonFleet`` and ``TestDaemonAdoption``:
  the reference's ``tests/test_fleet.py`` cases against the port.
- ``test_adoption_is_one_critical_section``: a step dispatched from
  another thread while an adoption merges lands after the merge, as the
  reference's sequence (adopt, then step) has it; no row is lost.

torch runs on one thread here (its intra-op pool spins against XLA's).
"""

from __future__ import annotations

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import AnomalyDetector as RefDetector
from opentelemetry_demo_tpu.models import DetectorConfig as RefConfig
from opentelemetry_demo_tpu.runtime.daemon import DetectorDaemon as RefDaemon
from opentelemetry_demo_tpu.runtime.pipeline import DetectorPipeline as RefPipeline
from opentelemetry_demo_tpu.runtime.replication import ROLE_PRIMARY as REF_ROLE_PRIMARY
from opentelemetry_demo_tpu_torch.models.detector import DetectorConfig
from opentelemetry_demo_tpu_torch.runtime import checkpoint, fleet
from opentelemetry_demo_tpu_torch.runtime.daemon import DetectorDaemon
from opentelemetry_demo_tpu_torch.runtime.fleet import HashRing, shard_key, tenant_of
from opentelemetry_demo_tpu_torch.runtime.kafka_broker import KafkaBroker
from opentelemetry_demo_tpu_torch.runtime.kafka_orders import OrdersSource
from opentelemetry_demo_tpu_torch.runtime.replbench import FLEET_SERVICES, _fleet_records, _Shard
from opentelemetry_demo_tpu_torch.runtime.replication import ROLE_FENCED, ROLE_PRIMARY, ROLE_STANDBY
from opentelemetry_demo_tpu_torch.utils.config import ConfigError, fleet_config, fleet_tenant_map
from tests.test_fleet import _bank_arrays, _HealthzServer
from tests.test_torch_daemon import _payload, _post

SMALL = dict(num_services=8, hll_p=8, cms_width=512)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _daemon_env(monkeypatch, tmp_path, name, **extra):
    """tests/test_replication.py's environment, plus the ladder off."""
    monkeypatch.setenv("ANOMALY_OTLP_PORT", "0")
    monkeypatch.setenv("ANOMALY_OTLP_GRPC_PORT", "-1")
    monkeypatch.setenv("ANOMALY_METRICS_PORT", "0")
    monkeypatch.setenv("ANOMALY_BATCH", "256")
    monkeypatch.setenv("ANOMALY_ADAPTIVE_BATCH", "0")
    monkeypatch.setenv("ANOMALY_CHECKPOINT", str(tmp_path / name))
    monkeypatch.delenv("KAFKA_ADDR", raising=False)
    for knob in (
        "ANOMALY_ROLE", "ANOMALY_REPLICATION_PORT",
        "ANOMALY_REPLICATION_TARGET", "ANOMALY_REPLICATION_INTERVAL_S",
        "ANOMALY_FAILOVER_TIMEOUT_S", "ANOMALY_PRIMARY_HEALTH_ADDR",
        "ANOMALY_FLEET_SHARDS", "ANOMALY_FLEET_PEERS", "ANOMALY_FLEET_SERVICES",
        "ANOMALY_FLEET_REPL_PEERS", "ANOMALY_FLEET_TENANTS", "ANOMALY_AUTOSCALE_ENABLE",
    ):
        monkeypatch.delenv(knob, raising=False)
    for k, v in extra.items():
        monkeypatch.setenv(k, v)


def _healthz(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5.0)
    conn.request("GET", "/healthz")
    return json.loads(conn.getresponse().read().decode())


def _port_state(daemon) -> dict:
    return daemon.pipeline.state_snapshot()[0]


def _ref_state(daemon) -> dict:
    return {k: np.asarray(v) for k, v in daemon.detector.state._asdict().items()}


def _state(daemon) -> dict:
    return _port_state(daemon) if isinstance(daemon, DetectorDaemon) else _ref_state(daemon)


class TestDaemonRoles:
    def test_standby_healthz_role_epoch_and_probe(self, monkeypatch, tmp_path):
        from opentelemetry_demo_tpu_torch.runtime.health_probe import probe_role

        _daemon_env(
            monkeypatch, tmp_path, "sb",
            ANOMALY_ROLE="standby",
            ANOMALY_REPLICATION_TARGET="127.0.0.1:1",  # nothing there
            ANOMALY_FAILOVER_TIMEOUT_S="3600",
        )
        daemon = DetectorDaemon(DetectorConfig(**SMALL), device="cpu")
        daemon.start()
        try:
            assert daemon.role == ROLE_STANDBY
            assert daemon.receiver is None  # no ingest before promotion
            doc = _healthz(daemon.exporter.port)
            assert doc["role"] == "standby"
            assert doc["epoch"] == 0
            assert doc["status"] == "ok"
            assert probe_role(f"127.0.0.1:{daemon.exporter.port}") == ("standby", 0)
            daemon.step(0.0)
            daemon._supervisor.tick()
            conn = http.client.HTTPConnection("127.0.0.1", daemon.exporter.port)
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
            assert 'anomaly_role{role="standby"} 1.0' in text
            assert "anomaly_epoch 0.0" in text
        finally:
            daemon.shutdown()

    def test_stale_primary_boots_fenced_from_broker_tag(self, monkeypatch, tmp_path):
        broker = KafkaBroker()
        broker.start()
        try:
            broker.ensure_topic("orders")
            promoted = OrdersSource(f"127.0.0.1:{broker.port}")
            promoted.commit({0: 5}, epoch=2)
            promoted.close()
            _daemon_env(monkeypatch, tmp_path, "stale", KAFKA_ADDR=f"127.0.0.1:{broker.port}")
            daemon = DetectorDaemon(DetectorConfig(**SMALL), device="cpu")
            try:
                assert daemon.role == ROLE_FENCED
                assert daemon._fence.observed == 2
                daemon.step(0.0)  # must not raise, must not commit
                assert daemon._healthz()[1]["role"] == "fenced"
            finally:
                daemon.shutdown()  # must not write a snapshot
            assert not checkpoint.exists(str(tmp_path / "stale"))
        finally:
            broker.stop()


def _boot(kind: str):
    if kind == "port":
        return DetectorDaemon(DetectorConfig(**SMALL), device="cpu")
    return RefDaemon(RefConfig(**SMALL))


def _wait(cond, timeout_s: float = 30.0, what: str = "condition") -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"{what} not reached in {timeout_s} s")


class TestCrossPackageReplication:
    @pytest.mark.parametrize("primary_kind,standby_kind", [("port", "ref"), ("ref", "port")])
    def test_standby_converges_and_promotes_exactly(self, monkeypatch, tmp_path, primary_kind, standby_kind):
        _daemon_env(
            monkeypatch, tmp_path, "primary",
            ANOMALY_REPLICATION_PORT="0", ANOMALY_REPLICATION_INTERVAL_S="0.05",
        )
        primary = _boot(primary_kind)
        primary.start()
        standby = None
        rng = np.random.default_rng(21)
        try:
            _daemon_env(
                monkeypatch, tmp_path, "standby",
                ANOMALY_ROLE="standby",
                ANOMALY_REPLICATION_TARGET=f"127.0.0.1:{primary.repl_primary.port}",
                ANOMALY_REPLICATION_INTERVAL_S="0.05",
                ANOMALY_FAILOVER_TIMEOUT_S="3600",  # promoted by hand below
            )
            standby = _boot(standby_kind)
            standby.start()
            for step in range(16):
                assert _post(primary.receiver.port, _payload("payment", 60, rng)) == 200
                assert _post(primary.receiver.port, _payload("cart", 30, rng)) == 200
                primary.step(step * 0.05)
            primary.pipeline.drain()
            final = _state(primary)
            names = list(primary.pipeline.tensorizer.service_names)

            def converged() -> bool:
                arrays, meta = standby.repl_standby.snapshot()
                return bool(arrays) and all(
                    np.array_equal(np.asarray(arrays[k]), v) for k, v in final.items()
                ) and list(meta.get("service_names") or []) == names

            _wait(converged, what="the standby's mirror equal to the primary")
        finally:
            primary.shutdown()
        try:
            standby.promote()
            assert standby.role in (ROLE_PRIMARY, REF_ROLE_PRIMARY)
            assert standby._fence.epoch == 1
            assert list(standby.pipeline.tensorizer.service_names) == names
            got = _state(standby)
            for k, v in final.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        finally:
            standby.shutdown()

    def test_promotion_writes_the_card_state_in_place(self, monkeypatch, tmp_path):
        """The port's promotion copies the mirror into the live tensors:
        the same storage before and after, the mirror's bits inside."""
        _daemon_env(
            monkeypatch, tmp_path, "primary",
            ANOMALY_REPLICATION_PORT="0", ANOMALY_REPLICATION_INTERVAL_S="0.05",
        )
        primary = _boot("ref")
        primary.start()
        rng = np.random.default_rng(4)
        for step in range(6):
            assert _post(primary.receiver.port, _payload("checkout", 80, rng)) == 200
            primary.step(step * 0.05)
        primary.pipeline.drain()
        final = _ref_state(primary)
        _daemon_env(
            monkeypatch, tmp_path, "standby", ANOMALY_ROLE="standby",
            ANOMALY_REPLICATION_TARGET=f"127.0.0.1:{primary.repl_primary.port}",
            ANOMALY_FAILOVER_TIMEOUT_S="3600",
        )
        standby = _boot("port")
        standby.start()
        try:
            _wait(lambda: bool(standby.repl_standby.snapshot()[0]) and np.array_equal(
                standby.repl_standby.snapshot()[0]["cms_bank"], final["cms_bank"]), what="mirror")
            primary.shutdown()
            ptrs = [t.data_ptr() for t in standby.detector.state]
            standby.promote()
            assert [t.data_ptr() for t in standby.detector.state] == ptrs
            for k, v in final.items():
                np.testing.assert_array_equal(getattr(standby.detector.state, k).numpy(), v, err_msg=k)
        finally:
            standby.shutdown()

    def test_a_mirror_of_another_shape_is_refused_and_the_standby_stays(self, monkeypatch, tmp_path):
        _daemon_env(
            monkeypatch, tmp_path, "standby", ANOMALY_ROLE="standby",
            ANOMALY_REPLICATION_TARGET="127.0.0.1:1", ANOMALY_FAILOVER_TIMEOUT_S="3600",
        )
        standby = _boot("port")
        try:
            before = _port_state(standby)
            wrong = {k: np.zeros((1,) + v.shape[1:], v.dtype) if v.ndim else v for k, v in before.items()}
            standby.repl_standby = type("Mirror", (), {
                "snapshot": lambda self: (wrong, {"service_names": []}),
                "stop": lambda self: None,
                "alive": lambda self: True,
            })()
            standby.promote()
            assert standby.role == ROLE_STANDBY  # a failed promotion retries later
            after = _port_state(standby)
            for k, v in before.items():
                np.testing.assert_array_equal(after[k], v, err_msg=k)
        finally:
            standby.repl_standby = None
            standby.shutdown()


# -- tests/test_fleet.py::TestFleetConfig, against the port ----------------


class TestFleetConfig:
    def test_defaults_resolve(self, monkeypatch):
        for knob in ("ANOMALY_FLEET_SHARDS", "ANOMALY_FLEET_SHARD_INDEX", "ANOMALY_FLEET_TENANTS"):
            monkeypatch.delenv(knob, raising=False)
        out = fleet_config()
        assert out["ANOMALY_FLEET_SHARDS"] == 0
        assert out["ANOMALY_AGGREGATOR_PORT"] == -1

    def test_bad_index_refused(self, monkeypatch):
        monkeypatch.setenv("ANOMALY_FLEET_SHARDS", "3")
        monkeypatch.setenv("ANOMALY_FLEET_SHARD_INDEX", "3")
        with pytest.raises(ConfigError):
            fleet_config()

    def test_missing_peers_refused(self, monkeypatch):
        monkeypatch.setenv("ANOMALY_FLEET_SHARDS", "3")
        monkeypatch.setenv("ANOMALY_FLEET_SHARD_INDEX", "0")
        monkeypatch.delenv("ANOMALY_FLEET_PEERS", raising=False)
        monkeypatch.delenv("ANOMALY_AGGREGATOR_PORT", raising=False)
        monkeypatch.delenv("ANOMALY_FLEET_QUERY_PEERS", raising=False)
        with pytest.raises(ConfigError, match="PEERS"):
            fleet_config()
        monkeypatch.setenv("ANOMALY_FLEET_PEERS", "a:1,b:2")
        with pytest.raises(ConfigError, match="PEERS"):
            fleet_config()
        monkeypatch.setenv("ANOMALY_FLEET_PEERS", "a:1,b:2,c:3")
        assert fleet_config()["ANOMALY_FLEET_SHARDS"] == 3
        monkeypatch.setenv("ANOMALY_AGGREGATOR_PORT", "9470")
        with pytest.raises(ConfigError, match="QUERY_PEERS"):
            fleet_config()
        monkeypatch.setenv("ANOMALY_FLEET_QUERY_PEERS", "a:4,b:5,c:6")
        assert fleet_config()["ANOMALY_AGGREGATOR_PORT"] == 9470

    def test_bad_tenant_map_refused(self, monkeypatch):
        monkeypatch.setenv("ANOMALY_FLEET_TENANTS", "frontend")
        with pytest.raises(ConfigError):
            fleet_config()
        monkeypatch.setenv("ANOMALY_FLEET_TENANTS", "a/b:t")
        with pytest.raises(ConfigError):
            fleet_config()

    def test_tenant_map_parse(self):
        m = fleet_tenant_map("frontend:web, cart:web ,*:bulk")
        assert m == {"frontend": "web", "cart": "web", "*": "bulk"}
        assert tenant_of("frontend", m) == "web"
        assert tenant_of("quote", m) == "bulk"
        assert tenant_of("quote", {}) == "default"

    def test_zero_quota_refuses_negative(self, monkeypatch):
        monkeypatch.setenv("ANOMALY_FLEET_TENANT_QUOTA_ROWS_S", "-1")
        with pytest.raises(ConfigError):
            fleet_config()


# -- tests/test_fleet.py::TestDaemonFleet, against the port ----------------


def _fleet_env(monkeypatch, **extra):
    base = {
        "ANOMALY_OTLP_PORT": "0",
        "ANOMALY_OTLP_GRPC_PORT": "-1",
        "ANOMALY_METRICS_PORT": "0",
        "ANOMALY_BATCH": "128",
        "ANOMALY_ADAPTIVE_BATCH": "0",
        "ANOMALY_QUERY_PORT": "-1",
    }
    base.update(extra)
    for k, v in base.items():
        monkeypatch.setenv(k, v)
    for k in (
        "ANOMALY_CHECKPOINT", "KAFKA_ADDR", "ANOMALY_ROLE",
        "ANOMALY_REPLICATION_PORT", "ANOMALY_REPLICATION_TARGET",
        "ANOMALY_AUTOSCALE_ENABLE", "ANOMALY_FLEET_REPL_PEERS",
    ):
        if k not in extra:
            monkeypatch.delenv(k, raising=False)


class TestDaemonFleet:
    def test_daemon_fleet_block_probe_and_metrics(self, monkeypatch):
        from opentelemetry_demo_tpu_torch.runtime.health_probe import probe_shard

        _fleet_env(
            monkeypatch,
            ANOMALY_FLEET_SHARDS="2",
            ANOMALY_FLEET_SHARD_INDEX="0",
            ANOMALY_FLEET_PEERS="self:0,127.0.0.1:1",  # a peer that never answers
            ANOMALY_FLEET_HEARTBEAT_S="0.05",
            ANOMALY_FLEET_DEAD_AFTER_S="0.3",
            ANOMALY_FLEET_SERVICES="frontend,cart,payment",
            ANOMALY_FLEET_TENANTS="frontend:web,*:bulk",
            ANOMALY_FLEET_TENANT_QUOTA_ROWS_S="10000",
        )
        daemon = DetectorDaemon(DetectorConfig(**SMALL), device="cpu")
        daemon.start()
        try:
            assert daemon.pipeline.tensorizer.service_names[:3] == ["frontend", "cart", "payment"]
            assert daemon.pipeline.tenant_quota_rows_s == 10000.0
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                daemon.step(0.0)
                if daemon.fleet.snapshot()["reshards_total"] >= 1:
                    break
                time.sleep(0.05)
            snap = daemon.fleet.snapshot()
            assert snap["reshards_total"] >= 1
            assert snap["shards_live"] == 1
            fleet_doc = probe_shard(f"127.0.0.1:{daemon.exporter.port}")
            assert fleet_doc is not None
            assert fleet_doc["shard"] == "shard-0"
            assert fleet_doc["shards_total"] == 2
            conn = http.client.HTTPConnection("127.0.0.1", daemon.exporter.port, timeout=5.0)
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
            conn.close()
            assert "anomaly_fleet_shards_live 1.0" in text
            assert "anomaly_reshards_total 1.0" in text
            assert "anomaly_fleet_ring_version" in text
            assert 'anomaly_fleet_shard_ingest_spans_total{shard="shard-0"}' in text
        finally:
            daemon.shutdown()

    def test_single_shard_daemon_has_no_fleet_block(self, monkeypatch):
        for k in ("ANOMALY_FLEET_SHARDS", "ANOMALY_FLEET_PEERS", "ANOMALY_FLEET_SERVICES"):
            monkeypatch.delenv(k, raising=False)
        _fleet_env(monkeypatch)
        daemon = DetectorDaemon(DetectorConfig(**SMALL), device="cpu")
        try:
            assert daemon.fleet is None
            _status, detail = daemon._healthz()
            assert "fleet" not in detail
        finally:
            daemon.shutdown()


# -- tests/test_fleet.py::TestDaemonAdoption, against the port ------------


class TestDaemonAdoption:
    def test_dead_peer_frame_adopted_automatically(self, monkeypatch):
        config = DetectorConfig(**SMALL)
        victim = _Shard("shard-1", config, batch=128, interval_s=0.05, device="cpu")
        hz = _HealthzServer()
        _fleet_env(
            monkeypatch,
            ANOMALY_FLEET_SHARDS="2",
            ANOMALY_FLEET_SHARD_INDEX="0",
            ANOMALY_FLEET_PEERS=f"self:0,127.0.0.1:{hz.port}",
            ANOMALY_FLEET_REPL_PEERS=f"self:0,127.0.0.1:{victim.primary.port}",
            ANOMALY_FLEET_HEARTBEAT_S="0.05",
            ANOMALY_FLEET_DEAD_AFTER_S="0.5",
            ANOMALY_FLEET_REJOIN_AFTER_S="60",
            ANOMALY_FLEET_SERVICES=",".join(FLEET_SERVICES),
        )
        monkeypatch.delenv("ANOMALY_FLEET_TENANTS", raising=False)
        ring = HashRing(["shard-0", "shard-1"], vnodes=128)
        victim_services = [s for s in FLEET_SERVICES if ring.owner(shard_key(s, "default")) == "shard-1"]
        assert victim_services
        rng = np.random.default_rng(11)
        for svc in victim_services:
            victim.pipe.submit(_fleet_records(rng, svc, 256))
        victim.pipe.pump(0.0)
        victim.pipe.drain()
        final = victim.arrays()
        assert float(final["span_total"].sum()) > 0.0

        daemon = DetectorDaemon(config, device="cpu")
        daemon.start()
        try:
            _status, detail = daemon._healthz()
            assert detail["autoscale"]["enabled"] is False
            deadline = time.monotonic() + 20.0
            mirrored = False
            while time.monotonic() < deadline and not mirrored:
                mirror = daemon._adoption_mirror
                if mirror is not None:
                    arrs, _m = mirror.snapshot()
                    mirrored = bool(arrs) and (arrs["cms_bank"] == final["cms_bank"]).all()
                if not mirrored:
                    time.sleep(0.05)
            assert mirrored, "adoption mirror never caught up"
            span0 = float(_port_state(daemon)["span_total"].sum())

            hz.stop()
            victim.stop()
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                daemon.step(0.0)
                if daemon._adoptions_total >= 1:
                    break
                time.sleep(0.05)
            assert daemon._adoptions_total == 1
            assert daemon._last_adoption_tta is not None
            merged = _port_state(daemon)
            span1 = float(merged["span_total"].sum())
            assert span1 > span0
            # This daemon ingested nothing: its state IS the victim's frame.
            for k in ("hll_bank", "cms_bank"):
                np.testing.assert_array_equal(merged[k], final[k], err_msg=k)
            _status, detail = daemon._healthz()
            fb = detail["fleet"]
            assert fb["adopted"] == {"shard-1": "shard-0"}
            assert fb["adoptions"]["total"] == 1
            assert fb["adoptions"]["refused"] == {}
            assert "shard-1" not in fb["members"]

            class _DriftedMirror:
                def snapshot(self):
                    return _bank_arrays(3), {"service_names": ["frontend", "zzz-drift"]}

                def stop(self):
                    pass

            event = {
                "op": "leave", "shard": "shard-1", "heir": "shard-0",
                "t": time.monotonic(), "members": ["shard-0"], "ring_version": 0,
            }
            daemon._adoption_mirror = _DriftedMirror()
            daemon._adopt_shard(event)
            assert daemon._adoptions_refused.get("merge") == 1
            assert daemon._adoptions_total == 1
            assert float(_port_state(daemon)["span_total"].sum()) == span1

            daemon._adoption_mirror = None
            daemon._adopt_shard(event)
            assert daemon._adoptions_refused.get("no_mirror") == 1
        finally:
            daemon.shutdown()
            victim.stop()


# -- the adoption's critical section ----------------------------------------


class _Mirror:
    def __init__(self, arrays, meta):
        self._snap = (arrays, meta)

    def snapshot(self):
        return self._snap

    def stop(self):
        pass


def _victim_frame(config: RefConfig) -> tuple[dict, dict, list[str]]:
    """A victim shard's frame: the reference's pipeline with the shared
    service table, fed its own services' rows."""
    ring = HashRing(["shard-0", "shard-1"], vnodes=128)
    victim_services = [s for s in FLEET_SERVICES if ring.owner(shard_key(s, "default")) == "shard-1"]
    pipe = RefPipeline(RefDetector(config), batch_size=128)
    for svc in FLEET_SERVICES:
        pipe.tensorizer.service_id(svc)
    rng = np.random.default_rng(17)
    for svc in victim_services:
        pipe.submit(_fleet_records(rng, svc, 200))
    pipe.pump(0.0)
    pipe.drain()
    arrays = {k: np.asarray(v) for k, v in pipe.detector.state._asdict().items()}
    meta = {"service_names": list(pipe.tensorizer.service_names), "generation": 0}
    pipe.close()
    return arrays, meta, victim_services


def test_adoption_is_one_critical_section(monkeypatch):
    _fleet_env(
        monkeypatch,
        ANOMALY_BATCH="128",
        ANOMALY_SPINE_RING="0",
        ANOMALY_FLEET_SHARDS="2",
        ANOMALY_FLEET_SHARD_INDEX="0",
        ANOMALY_FLEET_PEERS="self:0,127.0.0.1:1",  # never started: no heartbeats
        ANOMALY_FLEET_SERVICES=",".join(FLEET_SERVICES),
    )
    monkeypatch.delenv("ANOMALY_FLEET_TENANTS", raising=False)
    arrays, meta, victim_services = _victim_frame(RefConfig(**SMALL))
    heir_services = [s for s in FLEET_SERVICES if s not in victim_services]
    rng = np.random.default_rng(23)
    warm = [_fleet_records(rng, svc, 128) for svc in heir_services]
    racing = _fleet_records(rng, heir_services[0], 128)  # exactly one batch
    event = {
        "op": "leave", "shard": "shard-1", "heir": "shard-0",
        "t": time.monotonic(), "members": ["shard-0"], "ring_version": 0,
    }

    ref = RefDaemon(RefConfig(**SMALL))
    port = DetectorDaemon(DetectorConfig(**SMALL), device="cpu")
    try:
        for d in (ref, port):
            for recs in warm:
                d.pipeline.submit(recs)
                d.pipeline.pump(1.0)
            d.pipeline.drain()
            d._adoption_mirror = _Mirror(arrays, meta)
        # The reference's sequence: adopt, then the step.
        ref._adopt_shard(event)
        ref.pipeline.submit(racing)
        ref.pipeline.pump(2.0)
        ref.pipeline.drain()

        # The port: the step is dispatched from another thread while
        # the adoption is inside its merge.
        in_merge, order = threading.Event(), []
        real_merge = fleet.merge_shard_arrays

        def slow_merge(*args, **kwargs):
            in_merge.set()
            time.sleep(0.5)  # the step thread reaches the lock meanwhile
            out = real_merge(*args, **kwargs)
            order.append("merged")
            return out

        monkeypatch.setattr(fleet, "merge_shard_arrays", slow_merge)

        def step():
            in_merge.wait(10.0)
            port.pipeline.submit(racing)
            port.pipeline.pump(2.0)
            order.append("stepped")

        stepper = threading.Thread(target=step)
        stepper.start()
        port._adopt_shard(event)
        stepper.join(20.0)
        port.pipeline.drain()
        assert order == ["merged", "stepped"]
        assert port._adoptions_total == ref._adoptions_total == 1
        got, want = _port_state(port), _ref_state(ref)
        for k, b in want.items():
            if b.dtype.kind in "iu":
                np.testing.assert_array_equal(got[k], b, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], b, rtol=RTOL, atol=ATOL, err_msg=k)
        # Every row was dispatched, and the state equal to the
        # reference's sequence holds them all: a step lost under the
        # merge's write-back would leave its rows out of it.
        assert port.pipeline.stats.spans == ref.pipeline.stats.spans == sum(map(len, warm)) + len(racing)
    finally:
        ref.shutdown()
        port.shutdown()
