"""The port's replication link against the reference.

The port's envelopes, primary and standby speak the reference's
protocol byte for byte, so the two packages interoperate on one link:

- envelopes from ``encode_frame`` are byte-identical across packages for
  the same arrays and meta, and each package decodes the other's;
- a port primary (its ``snapshot_fn`` is ``DetectorPipeline.state_snapshot``)
  feeds a reference standby, and a reference primary feeds a port
  standby, over a real socket: at quiescence the mirror equals the
  source bit for bit, dtypes and shapes included;
- the reference's anti-entropy case through the port's ``FaultWire``:
  after the blackhole heals, the partitioned mirror converges by merge
  (one snapshot, no re-bootstrap) and equals the unpartitioned witness
  bit for bit;
- the fencing case: a stale primary is refused on its replication
  frames, its checkpoint saves and its Kafka offset commits;
- detection across failover: the promoted mirror hydrated into a fresh
  detector (``state_from_numpy``) detects the paymentFailure shape
  within 2 batches of the uninterrupted run, at the same batch as the
  reference's promoted run;
- ``measure_failover(device="cpu")`` converges exactly and answers with
  the reference's keys;
- the evictor's flight hook: a cardinality bomb through both packages,
  each with a ``FlightRecorder``, records equal ``keyspace`` events.

Tolerance: every comparison is exact; wall-clock fields (flight events'
``t``, the drill's timings) are left out.
"""

from __future__ import annotations

import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import AnomalyDetector as JDetector
from opentelemetry_demo_tpu.models import DetectorConfig as JConfig
from opentelemetry_demo_tpu.models.detector import DetectorState as JState
from opentelemetry_demo_tpu.runtime import flightrec as jflightrec
from opentelemetry_demo_tpu.runtime import keyspace as jks
from opentelemetry_demo_tpu.runtime import lagbench as jlagbench
from opentelemetry_demo_tpu.runtime import pipeline as jpipe
from opentelemetry_demo_tpu.runtime import qualbench as jqualbench
from opentelemetry_demo_tpu.runtime import replbench as jreplbench
from opentelemetry_demo_tpu.runtime import replication as jrepl
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
from opentelemetry_demo_tpu_torch.models.detector import DetectorState, state_from_numpy, state_to_numpy
from opentelemetry_demo_tpu_torch.runtime import (
    checkpoint,
    flightrec,
    keyspace,
    lagbench,
    pipeline,
    qualbench,
    replbench,
    replication,
    tensorize,
)
from opentelemetry_demo_tpu_torch.runtime.checkpoint import StaleEpochError
from opentelemetry_demo_tpu_torch.runtime.faultwire import FaultWire
from opentelemetry_demo_tpu_torch.runtime.kafka_broker import KafkaBroker
from opentelemetry_demo_tpu_torch.runtime.kafka_orders import OrdersSource

SMALL = dict(num_services=8, hll_p=8, cms_width=512)
REPL = {"port": replication, "reference": jrepl}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The geometries here are small: torch's intra-op pool gains
    nothing and spins against XLA's pool and the other test processes'
    threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- envelopes -----------------------------------------------------------------


def _arrays(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "hll_bank": rng.integers(0, 30, (3, 2, 8, 256), dtype=np.int32),
        "cms_bank": rng.integers(-5, 99, (3, 2, 4, 512), dtype=np.int32),
        "lat_mean": rng.random((8, 3)).astype(np.float32),
        "step_idx": np.array(seed, np.int32),
    }


FRAMES = [
    ("hello", lambda m: m.encode_frame(m.HELLO, 0, meta={"standby_id": "s-1", "applied_seq": -1,
                                                         "config": list(DetectorConfig(**SMALL))})),
    ("snapshot", lambda m: m.encode_frame(m.SNAPSHOT, 3, seq=1, arrays=_arrays(1),
                                          meta={"offsets": {"0": 12}, "service_names": ["a", "b"]})),
    ("delta", lambda m: m.encode_frame(m.DELTA, 3, seq=9, base_seq=7, arrays=_arrays(2),
                                       meta={"hll_monotone": False, "generation": 2})),
    ("ack", lambda m: m.encode_frame(m.ACK, 3, seq=9)),
    ("fenced", lambda m: m.encode_frame(m.FENCED, 4)),
]


@pytest.mark.parametrize("kind,make", FRAMES, ids=[k for k, _ in FRAMES])
def test_envelopes_are_byte_identical_and_decode_across_packages(kind, make):
    ours, theirs = make(replication), make(jrepl)
    assert ours == theirs
    for decoder in (replication, jrepl):
        got = decoder.decode_frame(ours[4:])
        want = jrepl.decode_frame(theirs[4:])
        assert {k: v for k, v in got.items() if k != "arrays"} == {
            k: v for k, v in want.items() if k != "arrays"}
        if got["arrays"]:
            a, b = replication.decode_arrays(got["arrays"]), jrepl.decode_arrays(want["arrays"])
            assert list(a) == list(b)
            for name in a:
                assert a[name].dtype == b[name].dtype and a[name].tobytes() == b[name].tobytes()


def test_protocol_constants_are_the_references():
    for name in ("ROLE_PRIMARY", "ROLE_STANDBY", "ROLE_PROMOTING", "ROLE_FENCED", "HELLO", "SNAPSHOT",
                 "DELTA", "ACK", "FENCED", "MAX_KEYS", "ADD_KEYS"):
        assert getattr(replication, name) == getattr(jrepl, name), name


def test_a_corrupt_envelope_is_refused_by_both():
    blob = bytearray(replication.encode_frame(replication.ACK, 3, seq=9))
    blob[6] ^= 0x01
    for m in (replication, jrepl):
        with pytest.raises(m.EnvelopeCorrupt):
            m.decode_frame(bytes(blob[4:]))


# -- a primary of one package, a standby of the other ---------------------------


def _port_primary_rig(config, rng):
    pipe = pipeline.DetectorPipeline(AnomalyDetector(DetectorConfig(**config), device="cpu"), batch_size=256)
    offsets = {0: 0}
    snap = replbench.pipeline_snapshot_fn(pipe, offsets)

    def feed(t):
        pipe.submit_columns(lagbench.make_columns(rng, 256))
        pipe.pump(t)
        pipe.drain()
        offsets[0] += 256

    return types.SimpleNamespace(pipe=pipe, snapshot=snap, feed=feed, close=pipe.close)


def _reference_primary_rig(config, rng):
    det = JDetector(JConfig(**config))
    pipe = jpipe.DetectorPipeline(det, batch_size=256)
    offsets = {0: 0}

    def snap():
        with pipe._dispatch_lock:
            arrays = {k: np.asarray(v) for k, v in det.state._asdict().items()}
            clock_t_prev = det.clock._t_prev
        return arrays, {
            "offsets": dict(offsets),
            "service_names": pipe.tensorizer.service_names,
            "clock_t_prev": clock_t_prev,
            "config": list(det.config._replace(sketch_impl=None)),
        }

    def feed(t):
        pipe.submit_columns(jlagbench.make_columns(rng, 256))
        pipe.pump(t)
        pipe.drain()
        offsets[0] += 256

    return types.SimpleNamespace(pipe=pipe, snapshot=snap, feed=feed, close=lambda: None)


RIGS = {"port": _port_primary_rig, "reference": _reference_primary_rig}


def _wait_equal(standby, source_fn, timeout=20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        arrs, _meta = standby.snapshot()
        want = source_fn()
        if arrs and list(arrs) == list(want) and all(
                arrs[k].dtype == want[k].dtype and arrs[k].tobytes() == want[k].tobytes() for k in want):
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("primary_pkg,standby_pkg", [("port", "reference"), ("reference", "port")])
def test_a_mirror_across_packages_equals_its_source(primary_pkg, standby_pkg):
    rng = np.random.default_rng(5)
    rig = RIGS[primary_pkg](SMALL, rng)
    fingerprint_cfg = (DetectorConfig if standby_pkg == "port" else JConfig)(**SMALL)
    prim_m, stby_m = REPL[primary_pkg], REPL[standby_pkg]
    primary = prim_m.ReplicationPrimary(rig.snapshot, prim_m.EpochFence(0), interval_s=0.05)
    primary.start()
    standby = stby_m.ReplicationStandby(
        f"127.0.0.1:{primary.port}", stby_m.EpochFence(0),
        config_fingerprint=list(fingerprint_cfg._replace(sketch_impl=None)),
    )
    try:
        standby.start()
        assert standby.wait_for_state(10.0), "the standby never bootstrapped (config refused?)"
        t = 0.0
        for _ in range(12):
            rig.feed(t)
            t += 0.25
            time.sleep(0.01)
        assert _wait_equal(standby, lambda: rig.snapshot()[0])
        # The rig bumps its offsets after the step, so a frame can carry
        # the final state with the previous offsets: wait for the next.
        deadline = time.monotonic() + 20.0
        while standby.snapshot()[1].get("offsets") != rig.snapshot()[1]["offsets"] and time.monotonic() < deadline:
            time.sleep(0.05)
        arrays, meta = standby.snapshot()
        src_arrays, src_meta = rig.snapshot()
        assert meta["offsets"] == {"0": 12 * 256} and meta["clock_t_prev"] == src_meta["clock_t_prev"]
        assert meta["service_names"] == src_meta["service_names"]
        assert standby.deltas_applied > 0 and standby.snapshots_applied >= 1
        # (A delta shipped before the previous ack landed is refused for
        # its base and reshipped: ``frames_rejected`` may count a few.)
        assert standby.frames_corrupt == standby.frames_version_skew == 0
    finally:
        standby.stop()
        primary.stop()
        rig.close()


def test_the_ports_snapshot_has_the_references_dtypes_and_shapes():
    """The arrays on the link: int32 banks, float32 heads, a 0-d int32
    ``step_idx``, as the reference's."""
    rng = np.random.default_rng(0)
    got = _port_primary_rig(SMALL, rng)
    want = _reference_primary_rig(SMALL, rng)
    try:
        got.feed(0.0)
        want.feed(0.0)
        a, b = got.snapshot()[0], want.snapshot()[0]
        assert list(a) == list(b) == list(DetectorState._fields)
        for k in a:
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
    finally:
        got.close()


# -- anti-entropy through the port's faultwire ----------------------------------


def _bare_snapshot_fn(det, offsets, lock):
    def snapshot():
        with lock:
            arrays = state_to_numpy(det.state)._asdict()
            clock_t_prev = det.clock._t_prev
        return arrays, {
            "offsets": dict(offsets),
            "service_names": [],
            "clock_t_prev": clock_t_prev,
            "config": list(det.config._replace(sketch_impl=None)),
        }

    return snapshot


def _drive(det, tz, rng, steps, lock, t0=0.0, dt=0.05):
    t = t0
    for _ in range(steps):
        batch = qualbench._batch(rng, tz)
        with lock:
            det.observe(batch, t)
        t += dt
    return t


def test_a_blackholed_standby_converges_by_merge_to_the_witness():
    """The reference's anti-entropy case on the port: deprive a standby
    of every delta through ``FaultWire`` (RST and refused reconnects)
    while the primary keeps observing across window rotations, heal,
    and the standby converges through one aggregate delta (no second
    snapshot), bit for bit equal to an unpartitioned witness."""
    det = AnomalyDetector(DetectorConfig(**SMALL), device="cpu")
    tz = tensorize.SpanTensorizer(num_services=qualbench.S, batch_size=qualbench.B)
    rng = np.random.default_rng(3)
    lock = threading.Lock()
    primary = replication.ReplicationPrimary(
        _bare_snapshot_fn(det, {0: 0}, lock), replication.EpochFence(), interval_s=0.05)
    primary.start()
    proxy = FaultWire("127.0.0.1", primary.port)
    proxy.start()
    partitioned = replication.ReplicationStandby(f"127.0.0.1:{proxy.port}", replication.EpochFence())
    partitioned.RECONNECT_BACKOFF_S = 0.1
    witness = replication.ReplicationStandby(f"127.0.0.1:{primary.port}", replication.EpochFence())
    current = lambda: _bare_snapshot_fn(det, {}, lock)()[0]  # noqa: E731
    try:
        partitioned.start()
        witness.start()
        assert partitioned.wait_for_state(10.0) and witness.wait_for_state(10.0)
        t = _drive(det, tz, rng, 10, lock)
        assert _wait_equal(partitioned, current)
        proxy.rst_connects = True
        proxy.kill_connections()
        # A frame already past the proxy may still land: read the
        # standby's position once the cut has settled.
        time.sleep(0.3)
        acked_seq = partitioned.applied_seq
        _drive(det, tz, rng, 25, lock, t0=t)
        time.sleep(0.3)  # several missed intervals
        assert partitioned.applied_seq == acked_seq  # truly deprived
        proxy.clear()
        assert _wait_equal(partitioned, current)
        assert partitioned.snapshots_applied == 1, "convergence must come from merge, not a snapshot"
        assert _wait_equal(witness, current)
        part, part_meta = partitioned.snapshot()
        wit, _ = witness.snapshot()
        for k in wit:
            assert part[k].dtype == wit[k].dtype and part[k].tobytes() == wit[k].tobytes(), k
        assert part_meta["offsets"] == {"0": 0}
    finally:
        partitioned.stop()
        witness.stop()
        proxy.stop()
        primary.stop()


# -- fencing: all three write paths ------------------------------------------


def test_a_stale_primary_is_fenced_on_all_three_paths(tmp_path):
    det = AnomalyDetector(DetectorConfig(**SMALL), device="cpu")
    fence_old = replication.EpochFence(0)
    primary = replication.ReplicationPrimary(
        _bare_snapshot_fn(det, {0: 0}, threading.Lock()), fence_old, interval_s=0.05)
    primary.start()
    fence_new = replication.EpochFence(0)
    standby = replication.ReplicationStandby(f"127.0.0.1:{primary.port}", fence_new)
    broker = KafkaBroker()
    broker.start()
    try:
        standby.start()
        assert standby.wait_for_state(10.0)
        new_epoch = fence_new.bump()
        assert new_epoch == 1
        # Replication frame: the stale primary's next delta is answered
        # FENCED, never applied.
        applied_before = standby.applied_seq
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not fence_old.stale():
            time.sleep(0.05)
        assert fence_old.stale(), "the stale primary never learned the epoch"
        assert standby.fenced_sent >= 1 and standby.applied_seq == applied_before
        # Checkpoint save: the fence and the on-disk epoch both refuse.
        path = str(tmp_path / "shared")
        checkpoint.save(path, det, epoch=new_epoch, dispatch_lock=None)
        with pytest.raises(StaleEpochError):
            fence_old.check("checkpoint")
        with pytest.raises(StaleEpochError):
            checkpoint.save(path, det, epoch=fence_old.epoch, dispatch_lock=None)
        # Kafka offset commit: the stale side is refused, and a
        # resurrected one reads the promoted epoch from the broker.
        broker.ensure_topic("orders")
        promoted = OrdersSource(f"127.0.0.1:{broker.port}")
        promoted.fence = fence_new
        promoted.commit({0: 7}, epoch=new_epoch)
        stale = OrdersSource(f"127.0.0.1:{broker.port}")
        stale.fence = fence_old
        with pytest.raises(StaleEpochError):
            stale.commit({0: 3}, epoch=fence_old.epoch)
        resurrected = OrdersSource(f"127.0.0.1:{broker.port}")
        assert resurrected.last_committed_epoch() == new_epoch
        assert fence_old.fenced_by_path == {"checkpoint": 1, "kafka-offset-commit": 1}
        for src in (promoted, stale, resurrected):
            src.close()
    finally:
        standby.stop()
        primary.stop()
        broker.stop()


# -- detection across failover ------------------------------------------------


WARM, WINDOW, FAILOVER_AT = 100, 40, 50


def _replicate_and_promote(m, snapshot_fn):
    """Replicate a state over a real link, promote the standby, kill
    the primary (RST): the promoted mirror (arrays, meta)."""
    primary = m.ReplicationPrimary(snapshot_fn, m.EpochFence(), interval_s=0.02)
    primary.start()
    fence_s = m.EpochFence()
    standby = m.ReplicationStandby(f"127.0.0.1:{primary.port}", fence_s)
    standby.start()
    try:
        assert standby.wait_for_state(10.0)
        assert _wait_equal(standby, lambda: snapshot_fn()[0])
        assert fence_s.bump() == 1
        return standby.snapshot()
    finally:
        standby.stop()
        primary.kill()


def _port_failover_clone(det):
    arrays, meta = _replicate_and_promote(replication, _bare_snapshot_fn(det, {0: 0}, threading.Lock()))
    det2 = AnomalyDetector(DetectorConfig(**SMALL), device="cpu")
    det2.state = state_from_numpy(DetectorState(**arrays), "cpu")
    det2.clock._t_prev = meta.get("clock_t_prev")
    return det2


def _reference_failover_clone(det):
    def snapshot():
        return {k: np.asarray(v) for k, v in det.state._asdict().items()}, {
            "offsets": {}, "service_names": [], "clock_t_prev": det.clock._t_prev,
            "config": list(det.config._replace(sketch_impl=None)),
        }

    arrays, meta = _replicate_and_promote(jrepl, snapshot)
    det2 = JDetector(JConfig(**SMALL))
    det2.state = JState(**{k: jax.device_put(v) for k, v in arrays.items()})
    det2.clock._t_prev = meta.get("clock_t_prev")
    return det2


def _ttd(with_failover, make_detector, clone, qb, tz_mod):
    rng = np.random.default_rng(11)
    frng = np.random.default_rng(7)
    det = make_detector()
    tz = tz_mod.SpanTensorizer(num_services=qb.S, batch_size=qb.B)
    mutate = qb.error_burst(frng, 5, 1.0)
    for step in range(WARM):
        det.observe(qb._batch(rng, tz), step * qb.DT_S)
        if with_failover and step == FAILOVER_AT:
            det = clone(det)
    for k in range(WINDOW):
        report = det.observe(qb._batch(rng, tz, mutate=mutate, step=k), (WARM + k) * qb.DT_S)
        flags = report.flags.numpy() if hasattr(report.flags, "numpy") else np.asarray(report.flags)
        if bool(flags[5]):
            return k + 1
    return None


def test_a_promoted_mirror_detects_within_two_batches_as_the_reference():
    port = lambda: AnomalyDetector(DetectorConfig(**SMALL), device="cpu")  # noqa: E731
    ref = lambda: JDetector(JConfig(**SMALL))  # noqa: E731
    baseline = _ttd(False, port, None, qualbench, tensorize)
    promoted = _ttd(True, port, _port_failover_clone, qualbench, tensorize)
    assert baseline is not None and promoted is not None
    assert abs(promoted - baseline) <= 2, (promoted, baseline)
    ref_baseline = _ttd(False, ref, None, jqualbench, jtz)
    ref_promoted = _ttd(True, ref, _reference_failover_clone, jqualbench, jtz)
    assert (baseline, promoted) == (ref_baseline, ref_promoted)


# -- the failover drill ----------------------------------------------------------


def test_measure_failover_converges_with_the_references_keys():
    holds: list = []
    mirror: dict = {}
    got = replbench.measure_failover(seconds=0.5, device="cpu", lock_holds=holds, mirror=mirror)
    want = jreplbench.measure_failover(seconds=0.5)
    assert list(got) == list(want)
    assert got["converged_exact"] is True and want["converged_exact"] is True
    assert got["promoted_epoch"] == 1
    assert got["replicated_offsets"] == {"0": got["spans_fed"]}
    assert got["snapshots_shipped"] >= 1 and got["deltas_shipped"] >= 1
    # One dispatch-lock hold per primary snapshot: the HELLO's check,
    # each ship, and the drill's own reads of the final state.
    assert len(holds) >= got["snapshots_shipped"] + got["deltas_shipped"]
    for k, v in mirror["final"].items():
        assert mirror["arrays"][k].tobytes() == v.tobytes(), k


# -- the evictor's flight hook ----------------------------------------------


def _spans(module, names, n, seed):
    rng = np.random.default_rng(seed)
    return [
        module.SpanRecord(service=name, duration_us=float(rng.normal(300.0, 10.0)),
                          trace_id=int(rng.integers(1, 2**63)), attr="P-1")
        for name in names for _ in range(n)
    ]


def test_the_evictor_records_the_references_flight_events(monkeypatch):
    """A cardinality bomb through both packages on one virtual clock,
    each evictor with a ``FlightRecorder``: the ``keyspace`` events
    (``op="evict"``, keys, generation, fill, RSS, the first eight
    names) are equal, timestamps aside."""
    clock = {"t": 5000.0}
    virtual = types.SimpleNamespace(monotonic=lambda: clock["t"], perf_counter=time.perf_counter,
                                    time=time.time, sleep=time.sleep)
    for mod in (jpipe, pipeline):
        monkeypatch.setattr(mod, "time", virtual)
    kw = dict(keyspace_enable=True, keyspace_hold_s=2.0, keyspace_newkey_rate=1.0)
    ref = jpipe.DetectorPipeline(JDetector(JConfig(**SMALL)), on_report=lambda *a: None,
                                 batch_size=256, **kw)
    got = pipeline.DetectorPipeline(AnomalyDetector(DetectorConfig(**SMALL), device="cpu"),
                                    on_report=lambda *a: None, batch_size=256, **kw)
    flights = [jflightrec.FlightRecorder(clock=lambda: 0.0), flightrec.FlightRecorder(clock=lambda: 0.0)]
    mgrs = [mod.KeyspaceManager(p, idle_s=1.5, evict_batch=2, now_fn=lambda: clock["t"],
                                rss_fn=lambda: 3 << 20, flight=f)
            for mod, p, f in ((jks, ref, flights[0]), (keyspace, got, flights[1]))]
    for r in range(20):
        names = ["real-a", "real-b", "real-c"] + ([f"bomb-{r}-{i}" for i in range(3)] if r < 10 else [])
        ref.submit(_spans(jtz, names, 4, r))
        got.submit(_spans(tensorize, names, 4, r))
        for p in (ref, got):
            p.pump(clock["t"])
        assert mgrs[1].tick() == mgrs[0].tick(), r
        clock["t"] += 1.0
    events = [[{k: v for k, v in ev.items() if k != "t"} for ev in f.snapshot() if ev["kind"] == "keyspace"]
              for f in flights]
    assert events[1] == events[0]
    assert events[1] and all(ev["op"] == "evict" for ev in events[1])
    assert sum(ev["keys"] for ev in events[1]) == mgrs[1].evictions > 0
    assert events[1][-1]["generation"] == got.tensorizer.generation
    assert events[1][0]["rss_mb"] == 3.0
