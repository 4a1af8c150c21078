"""The port's key lifecycle plane against the JAX reference.

The same key streams and ladder clocks go through both packages: the
bounded interner (dense ids, overflow without memorising, recycled ids
behind a generation bump, tombstones honoured by ``adopt_names``), the
keyspace ladder (two-edge hysteresis, per-tenant throttle, collapse),
and the evictor (fold record, zeroed rows, retired ids). Ids, names,
tombstones, generations, levels, counters, the fold record and the
detector state after each sweep must be equal: integer banks and the
zeroed rows bit for bit, float heads within rtol 1e-4 / atol 1e-5 (the
detector's stated tolerance).
"""

import time
import types

import jax
import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import AnomalyDetector as JDetector
from opentelemetry_demo_tpu.models import DetectorConfig as JConfig
from opentelemetry_demo_tpu.runtime import checkpoint as jckpt
from opentelemetry_demo_tpu.runtime import keyspace as jks
from opentelemetry_demo_tpu.runtime import pipeline as jpipe
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu_torch.models import detector as tdet
from opentelemetry_demo_tpu_torch.runtime import checkpoint, frame, keyspace, pipeline, tensorize

RTOL, ATOL = 1e-4, 1e-5
SMALL = dict(num_services=8, hll_p=8, cms_width=512)
EXACT = ("hll_bank", "cms_bank", "step_idx", "span_total")


def _spans(module, names, n=32, seed=0):
    rng = np.random.default_rng(seed)
    return [
        module.SpanRecord(
            service=name,
            duration_us=float(rng.normal(300.0, 10.0)),
            trace_id=int(rng.integers(1, 2**63)),
            attr="P-1",
        )
        for name in names
        for _ in range(n)
    ]


def _tensorizers(n):
    return jtz.SpanTensorizer(num_services=n), tensorize.SpanTensorizer(num_services=n)


def _table(tz):
    return (dict(tz._svc_snapshot), tz.service_names, tz.generation, tz.free_ids,
            tz.live_keys, tz.capacity, tz.evicted_total, tz.overflow_assigns_total)


def test_the_sentinel_is_the_references():
    assert tensorize.EVICTED_SLOT == jtz.EVICTED_SLOT


# -- the bounded interner ------------------------------------------------------


def test_saturated_intern_many_dense_and_bit_stable():
    names = [f"key-{i:02d}" for i in range(20)]
    for tz in _tensorizers(8):
        ids = tz.intern_many(names)
        assert ids[:7] == list(range(7)) and ids[7:] == [7] * 13
        assert tz.intern_many(names) == ids
        assert tz.overflow_assigns_total == 26
        assert tz.intern_many(list(reversed(names[:7]))) == list(reversed(range(7)))
        assert tz.service_id(names[3]) == 3
        assert tz.service_id("fresh-after-saturation") == 7
        assert "fresh-after-saturation" not in tz._svc_snapshot
    ref, got = _tensorizers(8)
    for batch in (names[:3], names, ["x", "key-01", "y"], names[5:12]):
        assert got.intern_many(batch) == ref.intern_many(batch)
        assert _table(got) == _table(ref)


def test_all_overflow_flush_roundtrips_the_frame_format():
    """A saturated table folds a bomb of fresh names into the overflow
    bucket without memorising them, and the columns round-trip a frame."""
    results = []
    for mod, tz in zip((jtz, tensorize), _tensorizers(4)):
        tz.intern_many(["a", "b", "c"])
        cols = tz.columns_from_records([
            mod.SpanRecord(service=f"bomb-{i:04d}", duration_us=1.0 + i, trace_id=i + 1, attr="k")
            for i in range(16)
        ])
        assert (np.asarray(cols.svc) == 3).all()
        assert tz.live_keys == 3 and tz.overflow_assigns_total == 16
        arrays = {k: np.asarray(getattr(cols, k)) for k in cols._fields}
        results.append(frame.encode(arrays, meta={"generation": tz.generation}))
    assert results[0] == results[1]
    fr = frame.decode(results[1])
    assert fr.meta == {"generation": 0} and (fr.arrays["svc"] == 3).all()


def test_retire_recycles_ids_behind_a_generation_bump():
    ref, got = _tensorizers(8)
    for tz in (ref, got):
        tz.intern_many(["a", "b", "c"])
    steps = [
        ("retire", ["b"]), ("retire", ["never-interned"]), ("id", "d"), ("id", "b"),
        ("retire", ["a", "c", "overflow?"]), ("id", "e"), ("id", "f"), ("id", "g"),
    ]
    for op, arg in steps:
        if op == "retire":
            assert got.retire_services(arg) == ref.retire_services(arg)
        else:
            assert got.service_id(arg) == ref.service_id(arg)
        assert _table(got) == _table(ref), (op, arg)
    assert got.generation == 2 and got.service_names[:4] == ["e", "d", "f", "b"]


def test_adopt_names_honors_tombstones_positionally():
    ref, got = _tensorizers(8)
    for tz in (ref, got):
        tz.adopt_names(["a", tensorize.EVICTED_SLOT, "c", None])
    assert _table(got) == _table(ref)
    assert got._svc_snapshot == {"a": 0, "c": 2} and got.free_ids == 2
    for name in ("d", "e", "f"):
        assert got.service_id(name) == ref.service_id(name)
    assert got.service_names == ref.service_names == ["a", "d", "c", "e", "f"]


# -- the ladder ----------------------------------------------------------------


def _pipes(**kw):
    """A reference and a port pipeline with the keyspace plane on."""
    kw.setdefault("keyspace_enable", True)
    jdet_ = JDetector(JConfig(**SMALL))
    ref = jpipe.DetectorPipeline(jdet_, on_report=lambda *a: None, batch_size=64, **kw)
    tdet_ = tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device="cpu")
    got = pipeline.DetectorPipeline(tdet_, on_report=lambda *a: None, batch_size=64, **kw)
    return ref, got


def test_ladder_constants_are_the_references():
    for name in ("KEYSPACE_LEVEL_EVICT", "KEYSPACE_LEVEL_THROTTLE", "KEYSPACE_LEVEL_COLLAPSE",
                 "KEYSPACE_LEVEL_SHED", "KEYSPACE_MAX_LEVEL"):
        assert getattr(pipeline, name) == getattr(jpipe, name), name


@pytest.mark.parametrize("fills", [
    # spike, climb to the top, hysteresis band, descend
    [(0.9, 0.0), (0.9, 1.01), (0.9, 2.02), (0.9, 3.03), (0.9, 4.04), (0.9, 9.0), (0.6, 10.0),
     (0.4, 11.0), (0.4, 12.01), (0.4, 13.02), (0.4, 14.03), (0.4, 15.04)],
    # flapping fill never staircases
    [(0.9, 0.0), (0.4, 0.5), (0.9, 0.9), (0.4, 1.4), (0.9, 1.8), (0.9, 2.9), (0.9, 3.5)],
])
def test_two_edge_hysteresis_one_rung_per_hold(fills):
    ref, got = _pipes(keyspace_hold_s=1.0, keyspace_high_watermark=0.8, keyspace_low_watermark=0.5)
    t0 = time.monotonic() + 100.0
    for fill, dt in fills:
        assert got.keyspace_update(fill, now=t0 + dt) == ref.keyspace_update(fill, now=t0 + dt), dt
        assert got.keyspace_level == ref.keyspace_level
    assert got.stats.keyspace_pressure_events == ref.stats.keyspace_pressure_events


def test_rss_breach_saturates_at_any_fill():
    ref, got = _pipes(keyspace_hold_s=0.0)
    t0 = time.monotonic() + 100.0
    for k, rss in enumerate((True, True, False, False, False)):
        now = t0 + 0.1 * k
        assert got.keyspace_update(0.01, rss_over=rss, now=now) == ref.keyspace_update(
            0.01, rss_over=rss, now=now)
    assert got.keyspace_level <= 1


def test_throttle_rung_isolates_tenants():
    ref, got = _pipes(keyspace_hold_s=0.0, keyspace_newkey_rate=1.0,
                      tenant_of=lambda n: n.split(".", 1)[0])
    t0 = time.monotonic() + 100.0
    for p in (ref, got):
        p.keyspace_update(1.0, now=t0)
        p.keyspace_update(1.0, now=t0 + 0.1)
        assert p.keyspace_level == pipeline.KEYSPACE_LEVEL_THROTTLE
    for name in ("tA.svc-1", "tA.svc-2", "tB.svc-1"):
        assert got.keyspace_newkey_gate(name) == ref.keyspace_newkey_gate(name), name
    assert got.stats.newkey_throttled_tenant == ref.stats.newkey_throttled_tenant == {"tA": 1}


def test_collapse_rung_folds_new_keys_to_overflow():
    ref, got = _pipes(keyspace_hold_s=0.0, tenant_of=lambda n: n.split(".", 1)[0])
    assert got.tensorizer.new_key_gate == got.keyspace_newkey_gate
    t0 = time.monotonic() + 100.0
    out = []
    for p in (ref, got):
        tz = p.tensorizer
        for k in range(pipeline.KEYSPACE_LEVEL_COLLAPSE):
            p.keyspace_update(1.0, now=t0 + 0.1 * k)
        row = [p.keyspace_level, tz.service_id("tC.fresh"), "tC.fresh" in tz._svc_snapshot,
               tz.overflow_assigns_total, dict(p.stats.overflow_keys_tenant)]
        for k in range(4):
            p.keyspace_update(0.0, now=t0 + 10.0 + 0.1 * k)
        sid = tz.service_id("tC.known")
        for k in range(pipeline.KEYSPACE_LEVEL_COLLAPSE):
            p.keyspace_update(1.0, now=t0 + 20.0 + 0.1 * k)
        row += [p.keyspace_level, sid, tz.service_id("tC.known")]
        out.append(row)
    assert out[0] == out[1]
    assert out[1][:5] == [pipeline.KEYSPACE_LEVEL_COLLAPSE, 7, False, 1, {"tC": 1}]


# -- the evictor ---------------------------------------------------------------


class _StubWriter:
    def __init__(self):
        self.calls = []

    def record_eviction(self, record, rec_meta, now=None):
        self.calls.append((record, rec_meta, now))


def _loaded_pipes(names=("ghost", "zombie", "keeper"), **kw):
    ref, got = _pipes(**kw)
    ref.submit(_spans(jtz, names))
    got.submit(_spans(tensorize, names))
    for p in (ref, got):
        p.pump(1000.0)
        p.pump(1000.25)
    return ref, got


def _assert_state(ref_state, got_state, what):
    ref_np = jax.device_get(ref_state)
    got_np = tdet.state_to_numpy(got_state)
    for name in tdet.DetectorState._fields:
        r, g = np.asarray(getattr(ref_np, name)), getattr(got_np, name)
        assert r.dtype == g.dtype and r.shape == g.shape, name
        if name in EXACT:
            np.testing.assert_array_equal(r, g, err_msg=f"{what}: {name}")
        else:
            np.testing.assert_allclose(r, g, rtol=RTOL, atol=ATOL, err_msg=f"{what}: {name}")


def test_evict_folds_zeroes_and_retires_idle_keys():
    ref, got = _loaded_pipes()
    before = tdet.state_to_numpy(got.detector.state)
    sids = {n: got.tensorizer._svc_snapshot[n] for n in ("ghost", "zombie", "keeper")}
    writers = _StubWriter(), _StubWriter()
    now = time.monotonic() + 1.0
    mgrs = [
        mod.KeyspaceManager(p, idle_s=0.0, evict_batch=8, protected=("keeper",),
                            history_writer=w, wall_fn=lambda: 123.0)
        for mod, p, w in ((jks, ref, writers[0]), (keyspace, got, writers[1]))
    ]
    evicted = [m.evict_idle(now=now) for m in mgrs]
    assert sorted(evicted[1]) == sorted(evicted[0]) == ["ghost", "zombie"]
    assert (mgrs[1].evictions, mgrs[1].sweeps) == (mgrs[0].evictions, mgrs[0].sweeps) == (2, 1)
    assert _table(got.tensorizer) == _table(ref.tensorizer)
    # The fold record: the same keys, arrays and meta as the reference's.
    (rrec, rmeta, rnow), = writers[0].calls
    (grec, gmeta, gnow), = writers[1].calls
    assert gnow == rnow == 123.0
    assert list(grec) == list(rrec)
    for k in rrec:
        r, g = np.asarray(rrec[k]), grec[k]
        assert r.dtype == g.dtype and r.shape == g.shape, k
        if r.dtype.kind == "f" and k != "span_total":
            np.testing.assert_allclose(r, g, rtol=RTOL, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(r, g, err_msg=k)
    assert {k: v for k, v in gmeta.items() if k != "evicted"} == {
        k: v for k, v in rmeta.items() if k != "evicted"}
    assert sorted(gmeta["evicted"]) == sorted(rmeta["evicted"])
    np.testing.assert_array_equal(grec["hll_bank"], before.hll_bank[0, 0])
    # The state: the evictees' rows zeroed, everything else untouched.
    after = tdet.state_to_numpy(got.detector.state)
    for name in tdet.DetectorState._fields:
        want = np.array(getattr(before, name), copy=True)
        if name == "hll_bank":
            want[:, :, [sids["ghost"], sids["zombie"]], :] = 0
        elif name in keyspace.MERGE_HEAD_ROWS:
            want[[sids["ghost"], sids["zombie"]]] = 0
        assert getattr(after, name).tobytes() == want.tobytes(), name
    _assert_state(ref.detector.state, got.detector.state, "after the sweep")
    assert got.tensorizer.service_id("newcomer") == ref.tensorizer.service_id("newcomer") == min(
        sids["ghost"], sids["zombie"])


def test_protected_and_recent_keys_survive():
    ref, got = _loaded_pipes()
    for mod, p in ((jks, ref), (keyspace, got)):
        assert mod.KeyspaceManager(p, idle_s=3600.0, evict_batch=8).evict_idle(
            now=time.monotonic()) == []
        assert p.tensorizer.generation == 0


def test_tick_engages_evictor_only_at_ladder_pressure():
    ref, got = _loaded_pipes()
    rss = {"v": 0}
    samples = []
    for mod, p in ((jks, ref), (keyspace, got)):
        p.keyspace_hold_s = 0.0
        mgr = mod.KeyspaceManager(p, idle_s=0.0, evict_batch=8, rss_budget_mb=1.0,
                                  rss_fn=lambda: rss["v"])
        t0 = time.monotonic() + 100.0
        rss["v"] = 0
        calm = mgr.tick(now=t0)
        rss["v"] = 16 << 20
        hot = mgr.tick(now=t0 + 1.0)
        hot["evicted"] = sorted(hot["evicted"])
        stats = mgr.stats()
        rss["v"] = 0
        levels = [mgr.tick(now=t0 + 2.0 + k)["level"] for k in range(6)]
        samples.append((calm, hot, stats, levels))
    assert samples[1] == samples[0]
    calm, hot, stats, levels = samples[1]
    assert calm["level"] == 0 and calm["evicted"] == []
    assert hot["level"] >= pipeline.KEYSPACE_LEVEL_EVICT and len(hot["evicted"]) == 3
    assert stats["generation"] == 1 and stats["rows"] == 0 and levels[-1] == 0
    _assert_state(ref.detector.state, got.detector.state, "after the tick")


def test_a_bomb_replayed_through_both_packages_keeps_them_equal(monkeypatch):
    """Twenty rounds of real keys beside fresh bomb names, the ladder and
    the evictor on one virtual clock: after every round the two
    packages' tables, levels, counters and states agree. The reference
    stamps last-seen times and refills token buckets from
    ``time.monotonic``, as the port does, so both modules read the
    virtual clock here."""
    clock = {"t": 5000.0}
    virtual = types.SimpleNamespace(monotonic=lambda: clock["t"], perf_counter=time.perf_counter,
                                    time=time.time, sleep=time.sleep)
    for mod in (jpipe, pipeline):
        monkeypatch.setattr(mod, "time", virtual)
    kw = dict(keyspace_enable=True, keyspace_hold_s=2.0, keyspace_newkey_rate=1.0)
    ref = jpipe.DetectorPipeline(JDetector(JConfig(**SMALL)), on_report=lambda *a: None,
                                 batch_size=256, **kw)
    got = pipeline.DetectorPipeline(
        tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device="cpu"),
        on_report=lambda *a: None, batch_size=256, **kw,
    )
    mgrs = [mod.KeyspaceManager(p, idle_s=1.5, evict_batch=2, now_fn=lambda: clock["t"],
                                rss_fn=lambda: 0)
            for mod, p in ((jks, ref), (keyspace, got))]
    levels, gens = [], []
    for r in range(20):
        names = ["real-a", "real-b", "real-c"] + ([f"bomb-{r}-{i}" for i in range(3)] if r < 10 else [])
        ref.submit(_spans(jtz, names, n=4, seed=r))
        got.submit(_spans(tensorize, names, n=4, seed=r))
        for p in (ref, got):
            p.pump(clock["t"])
        ticks = [m.tick() for m in mgrs]
        assert ticks[1] == ticks[0], r
        assert _table(got.tensorizer) == _table(ref.tensorizer), r
        assert got.stats.newkey_throttled_tenant == ref.stats.newkey_throttled_tenant
        assert got.stats.overflow_keys_tenant == ref.stats.overflow_keys_tenant
        _assert_state(ref.detector.state, got.detector.state, f"round {r}")
        levels.append(ticks[1]["level"])
        gens.append(got.tensorizer.generation)
        clock["t"] += 1.0
    assert max(levels) >= pipeline.KEYSPACE_LEVEL_THROTTLE and levels[-1] == 0
    assert gens[-1] > 0 and got.tensorizer.overflow_assigns_total > 0
    assert {"real-a", "real-b", "real-c"} <= set(got.tensorizer._svc_snapshot)


def test_checkpoint_roundtrips_generation_and_tombstones(tmp_path):
    names = ["alpha", tensorize.EVICTED_SLOT, "gamma"]
    det = tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device="cpu")
    checkpoint.save(str(tmp_path / "p"), det, service_names=names, generation=3, dispatch_lock=None)
    jckpt.save(str(tmp_path / "r"), JDetector(JConfig(**SMALL)), service_names=names, generation=3,
               dispatch_lock=None)
    for path in ("p", "r"):
        for load in (lambda p: checkpoint.load(p, device="cpu"), jckpt.load):
            _, meta = load(str(tmp_path / path))
            assert meta["generation"] == 3 and meta["service_names"] == names
            ref, got = _tensorizers(8)
            for tz in (ref, got):
                tz.adopt_names(meta["service_names"])
            assert _table(got) == _table(ref)
            assert got._svc_snapshot == {"alpha": 0, "gamma": 2}
            assert got.service_id("delta") == ref.service_id("delta") == 1


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the eviction writes state on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_eviction_matches_the_cpu(cuda_device):
    """The sweep on the card zeroes the same rows in place as the CPU run
    and retires the same ids; integer banks exact, heads within
    tolerance, the zeroed rows exactly zero."""
    pipes = [
        pipeline.DetectorPipeline(
            tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device=dev),
            on_report=lambda *a: None, batch_size=64, keyspace_enable=True,
        )
        for dev in (cuda_device, "cpu")
    ]
    for p in pipes:
        p.submit(_spans(tensorize, ("ghost", "zombie", "keeper")))
        p.pump(1000.0)
        p.pump(1000.25)
    now = time.monotonic() + 1.0
    out = [keyspace.KeyspaceManager(p, idle_s=0.0, protected=("keeper",)).evict_idle(now=now)
           for p in pipes]
    assert sorted(out[0]) == sorted(out[1]) == ["ghost", "zombie"]
    assert _table(pipes[0].tensorizer) == _table(pipes[1].tensorizer)
    card, cpu = (tdet.state_to_numpy(p.detector.state) for p in pipes)
    for name in tdet.DetectorState._fields:
        a, b = getattr(card, name), getattr(cpu, name)
        if name in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    for sid in pipes[1].tensorizer._free_ids:
        assert not card.hll_bank[:, :, sid].any() and not card.lat_mean[sid].any()
