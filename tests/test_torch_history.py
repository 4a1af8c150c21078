"""The port's time-travel tier against the JAX reference.

Both packages' writers are driven by ``tick(now)`` from one snapshot
sequence (numpy arrays made from a seed): their segment files must be
byte-identical, header and frame, and each package's reader must read
the other's store with equal answers. Beside that: corruption, fencing,
span capture through the pipelines (spine off and on, and the native
``submit_columnar`` route), the sample policy, the query plane's ranged,
evicted-key and Grafana documents through both packages' ``dispatch``,
and the wiring of ``runtime.timetravel``.

Tolerance: the store's bytes and every integer array compare exactly.
Documents over the same store and the same live snapshot compare
exactly, apart from the fields that carry each call's wall clock
(``meta.staleness_s``, and ``meta.from``/``meta.to`` of the evicted-key
answer, which spans "now"). Pipelines fed the same stream record equal
span columns exactly; their head state is float and is not compared
here (``test_torch_pipeline.py`` holds it within its tolerance).
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

from opentelemetry_demo_tpu.models import detector as jdet
from opentelemetry_demo_tpu.runtime import frame as jframe
from opentelemetry_demo_tpu.runtime import history as jhistory
from opentelemetry_demo_tpu.runtime import pipeline as jpipeline
from opentelemetry_demo_tpu.runtime import query as jquery
from opentelemetry_demo_tpu.runtime import replication as jreplication
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu.runtime.checkpoint import StaleEpochError as JStale
from opentelemetry_demo_tpu_torch.models import detector as tdet
from opentelemetry_demo_tpu_torch.runtime import frame, history, query, replication, tensorize, timetravel
from opentelemetry_demo_tpu_torch.runtime.checkpoint import StaleEpochError
from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

S, R, D, C = 4, 16, 2, 32
NAMES = ["frontend", "cart", "checkout", "payment"]
PKGS = {"port": (history, frame, replication.EpochFence, StaleEpochError),
        "reference": (jhistory, jframe, jreplication.EpochFence, JStale)}


def _config_list() -> list:
    cfg = tdet.DetectorConfig(num_services=S, hll_p=4, cms_depth=D, cms_width=C, windows_s=(1.0,))
    return list(cfg._replace(sketch_impl=None))


def _state(step: int, rng) -> dict:
    """A state snapshot with the just-completed window's banks in the
    [0, 1] (previous) slots."""
    arrays = {
        "hll_bank": np.zeros((1, 2, S, R), np.int32),
        "cms_bank": np.zeros((1, 2, D, C), np.int32),
        "span_total": np.zeros((1, 2), np.float32),
        "lat_mean": rng.random((S, 3)).astype(np.float32),
        "lat_var": rng.random((S, 3)).astype(np.float32),
        "err_mean": rng.random((S, 3)).astype(np.float32) * 0.1,
        "rate_mean": rng.random((S, 3)).astype(np.float32) * 100,
        "rate_var": rng.random((S, 3)).astype(np.float32),
        "card_mean": rng.random((S, 1)).astype(np.float32) * 50,
        "card_var": rng.random((S, 1)).astype(np.float32),
        "obs_batches": np.full((S,), float(step), np.float32),
        "obs_windows": np.full((S, 1), float(step), np.float32),
        "cusum": (rng.random((S, 3)) * 3).astype(np.float32),
        "step_idx": np.asarray(step, np.int32),
    }
    arrays["hll_bank"][0, 0] = rng.integers(0, 20, (S, R))
    arrays["hll_bank"][0, 1] = rng.integers(0, 20, (S, R))
    arrays["cms_bank"][0, 0] = rng.integers(0, 50, (D, C))
    arrays["cms_bank"][0, 1] = rng.integers(0, 50, (D, C))
    arrays["span_total"][0] = (40.0 + step, 30.0 + step)
    return arrays


def _meta(t_clock: float, anomalies=(), names=NAMES, generation=0) -> dict:
    return {
        "clock_t_prev": t_clock,
        "service_names": list(names),
        "config": _config_list(),
        "generation": generation,
        "query": {"anomalies": list(anomalies), "hh_candidates": {"1": [7, 9, 11]}},
    }


def _snapshots(steps: int, wall0: float, seed: int = 0, anomaly_at=None):
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        events = ()
        if anomaly_at is not None and step == anomaly_at:
            events = ({"t": wall0 + step, "t_batch": float(step), "service": 1,
                       "signals": ["latency"], "exemplars": ["aabbccdd00112233"]},)
        out.append((_state(step, rng), _meta(step + 0.5, anomalies=events)))
    return out


def _bundle(i: int, t: float) -> dict:
    return {"id": f"b{i:04d}", "t": t, "service": NAMES[i % S], "signals": ["latency"],
            "exemplars": ["00ff" * 4], "state": {"seq": i}}


def _drive(mod, directory, snaps, wall0, rungs=(1.0, 60.0), fence=None, explains=(), spans=()):
    """Tick ``mod``'s writer once per snapshot at ``wall0 + step``; the
    span batches and bundles of a step are captured just before its
    tick. Returns (store, writer)."""
    store = mod.HistoryStore(str(directory), segment_bytes=1 << 16,
                             retention_s=(3600.0, 86400.0)[: len(rungs)], fence=fence)
    cur = {}
    writer = mod.HistoryWriter(store, lambda: cur["snap"], rungs=rungs, capture_spans=True,
                               span_queue_max=256)
    explains, spans = dict(explains), dict(spans)
    for step, snap in enumerate(snaps):
        cur["snap"] = snap
        if step in spans:
            writer.capture(spans[step], float(step))
        if step in explains:
            writer.capture_explain(explains[step])
        writer.tick(now=wall0 + step)
    return store, writer


def _span_cols(mod, seed: int, rows: int = 96):
    rng = np.random.default_rng(seed)
    return mod.SpanColumns(
        svc=rng.integers(0, S, rows).astype(np.int32),
        lat_us=rng.gamma(4.0, 250.0, rows).astype(np.float32),
        is_error=(rng.random(rows) < 0.05).astype(np.float32),
        trace_key=rng.integers(0, 2**63, rows, dtype=np.uint64),
        attr_crc=rng.integers(1, 99, rows).astype(np.uint64),
    )


def _files(directory) -> dict[str, bytes]:
    return {n: open(os.path.join(directory, n), "rb").read() for n in sorted(os.listdir(directory))}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Both writers over one snapshot sequence (130 one-second windows,
    an anomaly at step 50, span batches and bundles along the way),
    written to two directories and sealed."""
    wall0 = 1.7e9
    snaps = _snapshots(130, wall0, anomaly_at=50)
    out = {}
    for name, (mod, *_rest) in PKGS.items():
        tz_mod = tensorize if name == "port" else jtz
        d = tmp_path_factory.mktemp(f"hist-{name}")
        store, writer = _drive(
            mod, d, snaps, wall0,
            explains=[(i, _bundle(i, wall0 + i + 0.25)) for i in (12, 51, 90)],
            spans=[(i, _span_cols(tz_mod, i)) for i in range(0, 130, 9)],
        )
        writer.close()
        out[name] = dict(dir=str(d), store=store, writer=writer)
    out["wall0"] = wall0
    return out


# --- the store's bytes and the ladder ----------------------------------


def test_segment_files_are_byte_identical(stores):
    port, ref = _files(stores["port"]["dir"]), _files(stores["reference"]["dir"])
    assert list(port) == list(ref)
    assert {n[0] for n in port} == {"b", "s", "e"}
    for name in ref:
        assert port[name] == ref[name], name
    assert stores["port"]["writer"].stats() == stores["reference"]["writer"].stats()
    assert stores["port"]["store"].stats() == stores["reference"]["store"].stats()


def test_rung_folds_equal_and_equal_the_merge_of_their_children(stores):
    for name in ("port", "reference"):
        store = stores[name]["store"]
        coarse = store.records(rung=1)
        assert len(coarse) == 2 and stores[name]["writer"].compactions == 2
        for rec1 in coarse:
            parent = store.read_frame(rec1).arrays
            children = [store.read_frame(r).arrays for r in store.records(rung=0)
                        if r.t_start >= rec1.t_start - 1e-9 and r.t_end <= rec1.t_end + 1e-9]
            assert len(children) == 60
            acc = None
            for c in children:
                acc = history.merge_record_arrays(acc, c)
            for k in parent:
                assert parent[k].tobytes() == acc[k].tobytes(), (name, k)
    pa = [stores["port"]["store"].read_frame(r).arrays for r in stores["port"]["store"].records(rung=1)]
    ra = [stores["reference"]["store"].read_frame(r).arrays
          for r in stores["reference"]["store"].records(rung=1)]
    for p, r in zip(pa, ra):
        assert list(p) == list(r)
        for k in r:
            np.testing.assert_array_equal(p[k], np.asarray(r[k]))


@pytest.mark.parametrize("rungs", [(1.0,), (1.0, 4.0), (1.0, 4.0, 16.0)])
def test_merge_record_arrays_equals_the_reference(rungs):
    rng = np.random.default_rng(len(rungs))
    recs = [history.HistoryWriter._bank_record(_state(i, rng)) for i in range(int(rungs[-1]))]
    got = want = None
    for r in recs:
        got = history.merge_record_arrays(got, r)
        want = jhistory.merge_record_arrays(want, r)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_missed_windows_are_counted_as_the_reference_counts_them(tmp_path):
    counts = []
    for name, (mod, *_rest) in PKGS.items():
        rng = np.random.default_rng(0)
        store = mod.HistoryStore(str(tmp_path / name))
        cur = {}
        writer = mod.HistoryWriter(store, lambda: cur["snap"], rungs=(1.0,))
        for step, t_clock in enumerate([0.5, 1.5, 7.5, 8.5, 20.5]):
            cur["snap"] = (_state(step, rng), _meta(t_clock))
            writer.tick(now=1000.0 + t_clock)
        counts.append((writer.windows_recorded, writer.windows_missed))
    assert counts[0] == counts[1] == (4, 16)


# --- cross-reads -------------------------------------------------------


def _reader_answers(mod, directory, wall0):
    reader = mod.HistoryReader(mod.HistoryStore(directory), rungs=(1.0, 60.0))
    out = {}
    for a, b, res in [(10, 40, None), (0, 129, None), (0, 129, 60.0), (55, 57, 1.0)]:
        arrays, meta = reader.range_state(wall0 + a, wall0 + b, res)
        out[("range", a, b, res)] = ({k: np.asarray(v).tobytes() for k, v in arrays.items()}, meta)
    out["timeline"] = reader.timeline(wall0 + 5, wall0 + 100)
    out["timeline_coarse"] = reader.timeline(wall0, wall0 + 129, resolution=60.0)
    out["anomalies"] = reader.anomaly_events(wall0, wall0 + 129)
    out["explains"] = reader.explain_events(wall0, wall0 + 129)
    out["service"] = reader.service_range_state("cart", wall0, wall0 + 129)[1]
    out["spans"] = [({k: np.asarray(v).tobytes() for k, v in a.items()}, t) for a, t in reader.span_batches()]
    return out


@pytest.mark.parametrize("writer_pkg", ["port", "reference"])
def test_each_reader_reads_the_others_store(stores, writer_pkg):
    d, wall0 = stores[writer_pkg]["dir"], stores["wall0"]
    got = _reader_answers(history, d, wall0)
    want = _reader_answers(jhistory, d, wall0)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert len(got["spans"]) == 15 and len(got["explains"]) == 3
    assert got["anomalies"][0][0]["service"] == 1


# --- corruption and fencing --------------------------------------------


def _flip(rec, at: int) -> None:
    with open(rec.path, "r+b") as f:
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_a_flipped_byte_quarantines_the_same_record(tmp_path):
    wall0 = 1000.0
    snaps = _snapshots(40, wall0)
    out = {}
    for name, (mod, fmod, *_rest) in PKGS.items():
        store, writer = _drive(mod, tmp_path / name / "log", snaps, wall0)
        writer.close()
        rec = store.records(rung=0)[5]
        _flip(rec, rec.offset + rec.length // 2)
        qdir = tmp_path / name / "quarantine"
        fresh = mod.HistoryStore(str(tmp_path / name / "log"))
        fmod.configure(quarantine_dir=str(qdir))
        try:
            reader = mod.HistoryReader(fresh, rungs=(1.0, 60.0))
            arrays, meta = reader.range_state(rec.t_start - 3, rec.t_end + 3)
        finally:
            fmod.configure(quarantine_dir="")
        out[name] = ({k: np.asarray(v).tobytes() for k, v in arrays.items()}, meta, fresh.stats(),
                     sorted(n.split("-")[0] for n in os.listdir(qdir)))
    assert out["port"] == out["reference"]
    assert out["port"][1]["skipped_corrupt"] == 1 and out["port"][2]["frames_corrupt"] == 1
    assert out["port"][3] == ["history"]


def test_a_header_crc_miss_stops_the_scan_at_the_same_place(tmp_path):
    wall0 = 1000.0
    snaps = _snapshots(40, wall0)
    out = {}
    for name, (mod, *_rest) in PKGS.items():
        store, writer = _drive(mod, tmp_path / name, snaps, wall0)
        writer.close()
        recs = store.records(rung=0)
        victim = recs[10]
        _flip(victim, victim.offset - 6)  # inside the header, under its CRC
        fresh = mod.HistoryStore(str(tmp_path / name))
        survivors = fresh.records(rung=0)
        for rec in survivors[:3]:
            fresh.read_frame(rec)  # still verifiably intact
        out[name] = ([(r.offset, r.length, r.t_start) for r in survivors], fresh.stats())
    assert out["port"] == out["reference"]
    # Records past the damage in the same segment are gone; later
    # segments still scan.
    assert 0 < len(out["port"][0]) < 39 and out["port"][1]["frames_corrupt"] == 1


def test_a_bumped_fence_fences_both_writers(tmp_path):
    wall0 = 1000.0
    snaps = _snapshots(6, wall0)
    out = {}
    for name, (mod, fmod, Fence, Stale) in PKGS.items():
        fence = Fence(1)
        store, writer = _drive(mod, tmp_path / name, snaps[:3], wall0, fence=fence)
        assert {r.epoch for r in store.records(rung=0)} == {1}
        successor = Fence(1)
        assert successor.bump() == 2
        fence.observe(successor.epoch)
        with pytest.raises(Stale):
            store.append(mod.KIND_BANK, 0, 0.0, 1.0, fmod.encode({"x": np.zeros(2, np.int32)}))
        cur = {}
        writer._snapshot_fn = lambda: cur["snap"]
        for step in range(3, 6):
            cur["snap"] = snaps[step]
            writer.tick(now=wall0 + step)
        writer.record_eviction(history.HistoryWriter._bank_record(snaps[5][0]), {"evicted": ["x"]}, now=wall0)
        store.close()
        stale = Fence(0)
        mod.HistoryStore(str(tmp_path / name), fence=stale)  # the epoch on disk is evidence
        out[name] = (writer.fenced, writer.stats(), fence.fenced_by_path, len(store.records(rung=0)),
                     stale.stale(), stale.observed)
    assert out["port"] == out["reference"]
    assert out["port"][0] is True and out["port"][2] == {"history": 2}


def test_the_fence_checks_orders_commits_as_the_reference_fence_does():
    """``OrdersSource.fence`` takes the real fence: a stale process's
    offset commit raises before it reaches the broker."""
    from opentelemetry_demo_tpu_torch.runtime.kafka_orders import OrdersSource

    fence = replication.EpochFence(3)
    src = OrdersSource("127.0.0.1:1")
    src.fence = fence
    fence.observe(4)
    with pytest.raises(StaleEpochError):
        src.commit({0: 5}, epoch=fence.epoch)
    assert fence.fenced_by_path == {"kafka-offset-commit": 1} and fence.stale()


# --- capture through the pipelines ------------------------------------


def _stream(n: int = 12, rows: int = 80):
    rng = np.random.default_rng(11)
    return [dict(
        svc=rng.integers(0, S, rows).astype(np.int32),
        lat_us=rng.gamma(4.0, 250.0, rows).astype(np.float32) * (10.0 if k >= 9 else 1.0),
        is_error=(rng.random(rows) < 0.02).astype(np.float32),
        trace_key=rng.integers(0, 2**63, rows, dtype=np.uint64),
        attr_crc=rng.integers(1, 99, rows).astype(np.uint64),
    ) for k in range(n)]


def _captured(pipe, writer_mod, directory, stream, submit, policy=None, names=None):
    store = writer_mod.HistoryStore(str(directory))
    writer = writer_mod.HistoryWriter(store, lambda: ({}, {}), capture_spans=True, span_queue_max=256,
                                      span_sample=policy, service_names_fn=lambda: names or NAMES)
    pipe.history_capture = writer.capture
    for k, cols in enumerate(stream):
        submit(cols)
        pipe.pump(k * 0.25)
    pipe.drain()
    pipe.close()
    writer.tick(now=5000.0)
    writer.close()
    reader = writer_mod.HistoryReader(writer_mod.HistoryStore(str(directory)))
    return [({k: np.asarray(v) for k, v in a.items()}, t) for a, t in reader.span_batches()]


def _ref_pipe(batch=64):
    return jpipeline.DetectorPipeline(
        jdet.AnomalyDetector(jdet.DetectorConfig(num_services=S, hll_p=8, cms_width=256)), batch_size=batch)


def _port_pipe(batch=64, **kw):
    return DetectorPipeline(
        tdet.AnomalyDetector(tdet.DetectorConfig(num_services=S, hll_p=8, cms_width=256), device="cpu"),
        batch_size=batch, **kw)


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for (ga, gt), (wa, wt) in zip(got, want):
        assert gt == wt and list(ga) == list(wa) == list(history.SPAN_CAPTURE_COLUMNS)
        for k in wa:
            assert ga[k].dtype == wa[k].dtype and ga[k].tobytes() == wa[k].tobytes(), k


@pytest.mark.parametrize("spine_ring", [0, 2])
def test_both_pipelines_record_the_same_span_frames(tmp_path, spine_ring):
    stream = _stream()
    ref = _ref_pipe()
    want = _captured(ref, jhistory, tmp_path / "ref", stream,
                     lambda c: ref.submit_columns(jtz.SpanColumns(**c)))
    pipe = _port_pipe(spine_ring=spine_ring)
    got = _captured(pipe, history, tmp_path / "port", stream,
                    lambda c: pipe.submit_columns(tensorize.SpanColumns(**c)))
    _same_batches(got, want)
    # 12 × 80 rows in batches of 64: every dispatched row was recorded.
    assert sum(a["svc"].shape[0] for a, _t in got) == 12 * 80


def test_capture_through_the_native_columnar_route(tmp_path):
    """``submit_columnar`` from the native decoder records the columns
    the record path records for the same bodies (decoded by the Python
    decoder)."""
    from opentelemetry_demo_tpu_torch.runtime import native
    from opentelemetry_demo_tpu_torch.runtime.otlp import (
        MONITORED_ATTR_KEYS, decode_export_request, encode_export_request,
    )

    if not native.available():
        pytest.fail(f"the native decoder did not build: {native.load_error()}")
    rng = np.random.default_rng(3)
    bodies = []
    for k in range(6):
        recs = [tensorize.SpanRecord(NAMES[i % S], float(rng.gamma(4.0, 250.0)), rng.bytes(16),
                                     bool(rng.random() < 0.05), f"p-{int(rng.integers(0, 9))}", "op")
                for i in range(50)]
        bodies.append(encode_export_request(recs, 10**18 + k))
    records = [decode_export_request(b) for b in bodies]
    pipes = {}
    for route in ("records", "columnar"):
        p = _port_pipe()
        for n in NAMES:
            p.tensorizer.service_id(n)
        pipes[route] = p
    got_rec = _captured(pipes["records"], history, tmp_path / "rec", records,
                        lambda recs: pipes["records"].submit(recs))
    got_col = _captured(pipes["columnar"], history, tmp_path / "col", bodies,
                        lambda body: pipes["columnar"].submit_columnar(
                            native.decode_otlp(body, MONITORED_ATTR_KEYS), copy=True))
    _same_batches(got_col, got_rec)


@pytest.mark.parametrize("policy", [{"frontend": 1.0, "*": 0.0}, {"*": 0.5}, {"cart": 1.0, "*": 0.25},
                                    {"*": 0.0}])
def test_the_sample_policy_keeps_the_same_rows(tmp_path, policy):
    got = {}
    for name, (mod, *_rest) in PKGS.items():
        tz_mod = tensorize if name == "port" else jtz
        store = mod.HistoryStore(str(tmp_path / name))
        writer = mod.HistoryWriter(store, lambda: ({}, {}), capture_spans=True, span_sample=policy,
                                   service_names_fn=lambda: ["frontend", "cart", "payment"])
        for i in range(4):
            writer.capture(_span_cols(tz_mod, i), float(i))
        writer.set_span_sample({"payment": 1.0, "*": 0.0})
        writer.capture(_span_cols(tz_mod, 9), 9.0)
        writer.tick(now=100.0)
        writer.close()
        got[name] = (_files(tmp_path / name), writer.spans_sampled_out, writer.spans_recorded,
                     writer.span_sample_policy())
    assert got["port"] == got["reference"]


# --- the query plane over history ---------------------------------------


def _engines(directory, live, wall0=None, **kw):
    """The port's and the reference's engine over readers of one store
    and one live snapshot."""
    out = {}
    for name, mod, qmod in (("port", history, query), ("reference", jhistory, jquery)):
        reader = mod.HistoryReader(mod.HistoryStore(directory), rungs=(1.0, 60.0))
        out[name] = qmod.QueryEngine(snapshot_fn=lambda: live, history=reader, max_staleness_s=60.0, **kw)
    return out


def _norm(doc, drop=("staleness_s",)):
    if isinstance(doc, dict):
        meta = doc.get("meta")
        if isinstance(meta, dict):
            doc = dict(doc, meta={k: v for k, v in meta.items() if k not in drop})
    return doc


def _both(engines, path, params, drop=("staleness_s",)):
    sp, dp = query.dispatch(engines["port"], path, dict(params))
    sr, dr = jquery.dispatch(engines["reference"], path, dict(params))
    assert sp == sr, (dp, dr)
    assert _norm(dp, drop) == _norm(dr, drop), path
    return sp, dp


RANGE_CASES = [
    ("/query/cardinality", {"service": "cart", "from": 10, "to": 40}, 200),
    ("/query/cardinality", {"service": "payment", "from": 0, "to": 129, "resolution": "60"}, 200),
    ("/query/topk", {"service": "cart", "from": 10, "to": 40, "k": "2"}, 200),
    ("/query/topk", {"service": "frontend", "from": 60, "to": 125}, 200),
    ("/query/zscore", {"service": "cart", "from": 10, "to": 40}, 200),
    ("/query/zscore", {"service": "checkout", "from": 0, "to": 129, "resolution": "60"}, 200),
    ("/query/anomalies", {"from": 0, "to": 129}, 200),
    ("/query/anomalies", {"from": 0, "to": 129, "service": "cart", "limit": "1"}, 200),
    ("/query/explain", {"from": 0, "to": 129}, 200),
    ("/query/explain", {"from": 0, "to": 129, "service": "cart"}, 200),
    ("/query/cardinality", {"service": "nope", "from": 10, "to": 40}, 404),
    ("/query/cardinality", {"service": "cart", "from": -500, "to": -400}, 404),
    ("/query/cardinality", {"service": "cart", "from": 40, "to": 10}, 400),
    ("/query/cardinality", {"service": "cart", "from": "not-a-time"}, 400),
]


@pytest.mark.parametrize("path,params,want", RANGE_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(RANGE_CASES)])
def test_ranged_documents_equal_the_reference(stores, path, params, want):
    wall0 = stores["wall0"]
    live = (_state(999, np.random.default_rng(99)), _meta(10_000.5))
    engines = _engines(stores["port"]["dir"], live)
    params = {k: (wall0 + v if k in ("from", "to") and isinstance(v, int) else v) for k, v in params.items()}
    status, doc = _both(engines, path, params)
    assert status == want
    if want == 200:
        assert doc["meta"]["source"] == "history"


def test_a_range_reaching_now_stitches_the_live_bank_as_the_reference_does(tmp_path):
    wall0 = time.time() - 120.0
    store, writer = _drive(history, tmp_path, _snapshots(118, wall0), wall0)
    writer.close()
    live = (_state(999, np.random.default_rng(99)), _meta(10_000.5))
    engines = _engines(str(tmp_path), live)
    now = time.time()
    for path in ("/query/cardinality", "/query/topk", "/query/zscore"):
        status, doc = _both(engines, path, {"service": "cart", "from": now - 60.0, "to": now})
        assert status == 200 and doc["meta"]["source"] == "stitched" and doc["meta"]["records"] > 10
    # Another keyspace generation live: history alone, labelled so.
    engines = _engines(str(tmp_path), (live[0], _meta(10_000.5, generation=3)))
    status, doc = _both(engines, "/query/cardinality", {"service": "cart", "from": now - 60.0, "to": now})
    assert doc["meta"]["source"] == "history"


def test_grafana_series_and_annotations_over_history_equal_the_reference(stores):
    wall0 = stores["wall0"]
    live = (_state(999, np.random.default_rng(99)), _meta(10_000.5))
    engines = _engines(stores["port"]["dir"], live)
    for body in (
        {"range": {"from": (wall0 + 20) * 1000.0, "to": (wall0 + 50) * 1000.0},
         "targets": [{"target": "cardinality:cart"}, {"target": "cusum:payment"}]},
        {"range": {"from": wall0 - 500.0, "to": wall0 - 400.0}, "targets": [{"target": "cardinality:cart"}]},
    ):
        got = engines["port"].grafana_query(dict(body))
        assert got == engines["reference"].grafana_query(dict(body))
    assert len(got[0]["datapoints"]) == 0
    body = {"range": {"from": (wall0 + 25) * 1000.0, "to": (wall0 + 60) * 1000.0},
            "annotation": {"name": "anomalies"}}
    ann = engines["port"].grafana_annotations(dict(body))
    assert ann == engines["reference"].grafana_annotations(dict(body))
    assert any("cart" in a["title"] for a in ann)


# --- the wiring: keyspace bomb → eviction fold → evicted-key answer ----


def test_wired_tier_answers_an_evicted_key_as_the_reference_reader_does(tmp_path):
    """``TimeTravel`` over a port pipeline: a bomb of short-lived keys,
    an eviction sweep whose fold record lands in the writer, and the
    evicted key answered from history (``source: "evicted"``) equally by
    the port's engine and by the reference's engine over a reference
    reader of the same directory."""
    cfg = tdet.DetectorConfig(num_services=16, hll_p=8, cms_width=256)
    pipe = DetectorPipeline(tdet.AnomalyDetector(cfg, device="cpu"), batch_size=64, keyspace_enable=True)
    tt = timetravel.TimeTravel(pipe, str(tmp_path), rungs=(1.0, 60.0), capture_spans=True,
                               keyspace={"idle_s": 0.0, "evict_batch": 8, "protected": ("frontend", "cart")},
                               query={"max_staleness_s": 0.0})
    assert pipe.history_capture == tt.writer.capture
    rng = np.random.default_rng(2)
    wall0 = time.time() - 30.0
    for k in range(12):
        names = ["frontend", "cart"] + ([f"bomb-{k}-{j}" for j in range(3)] if k < 4 else [])
        ids = [pipe.tensorizer.service_id(n) for n in names]
        rows = 64
        pipe.submit_columns(tensorize.SpanColumns(
            svc=np.asarray(ids, np.int32)[rng.integers(0, len(ids), rows)],
            lat_us=rng.gamma(4.0, 250.0, rows).astype(np.float32),
            is_error=np.zeros(rows, np.float32),
            trace_key=rng.integers(0, 2**63, rows, dtype=np.uint64),
            attr_crc=rng.integers(1, 9, rows).astype(np.uint64)))
        pipe.pump(k * 0.5)
        pipe.drain()
        tt.tick(now=wall0 + k * 0.5)
    gen0 = pipe.tensorizer.generation
    pipe.keyspace_update(1.0, now=time.monotonic() + 100.0)
    pipe.keyspace_update(1.0, now=time.monotonic() + 200.0)
    evicted = tt.keyspace.evict_idle(now=time.monotonic() + 300.0)
    assert "bomb-0-0" in evicted and pipe.tensorizer.generation == gen0 + 1
    assert tt.writer.evictions_recorded == 1
    tt.tick(now=time.time())
    # Sealed first: a second store opening the directory adopts (seals)
    # the open segments, as a restarted process would.
    tt.close()
    assert pipe.history_capture is None
    ref_engine = jquery.QueryEngine(
        snapshot_fn=tt.snapshot, max_staleness_s=0.0,
        history=jhistory.HistoryReader(jhistory.HistoryStore(str(tmp_path)), rungs=(1.0, 60.0)))
    engines = {"port": tt.engine, "reference": ref_engine}
    for path in ("/query/cardinality", "/query/zscore", "/query/topk"):
        status, doc = _both(engines, path, {"service": "bomb-0-0"}, drop=("staleness_s", "from", "to"))
        assert status == 200 and doc["meta"]["source"] == "evicted" and doc["data"]["evicted"] is True
    status, _doc = _both(engines, "/query/cardinality", {"service": "never-seen"})
    assert status == 404
    spans = list(history.HistoryReader(history.HistoryStore(str(tmp_path))).span_batches())
    assert len(spans) == 12 and all(a["svc"].shape[0] == 64 for a, _t in spans)


def test_wired_tier_persists_the_harvesters_bundles(tmp_path):
    """The harvester's evidence bundles reach ``capture_explain`` and
    answer a ranged ``/query/explain`` from disk after a restart."""
    from opentelemetry_demo_tpu_torch.runtime.provenance import ProvenanceEngine

    cfg = tdet.DetectorConfig(num_services=8, hll_p=8, cms_width=256, warmup_batches=2.0, z_warmup_batches=3.0)
    det = tdet.AnomalyDetector(cfg, device="cpu")
    pipe = DetectorPipeline(det, batch_size=128, provenance=ProvenanceEngine(cfg))
    for n in NAMES:
        pipe.tensorizer.service_id(n)
    tt = timetravel.TimeTravel(pipe, str(tmp_path), rungs=(1.0, 60.0))
    rng = np.random.default_rng(5)
    for i in range(30):
        rows = 128
        svc = rng.integers(0, S, rows).astype(np.int32)
        lat = rng.gamma(4.0, 250.0, rows).astype(np.float32)
        if i >= 20:
            lat[svc == 2] *= 1000.0
        pipe.submit_columns(tensorize.SpanColumns(
            svc=svc, lat_us=lat, is_error=np.zeros(rows, np.float32),
            trace_key=rng.integers(0, 2**63, rows, dtype=np.uint64),
            attr_crc=rng.integers(1, 9, rows).astype(np.uint64)))
        pipe.pump(i * 0.25)
        pipe.drain()
        tt.tick(now=1000.0 + i * 0.25)
    tt.close()
    assert pipe.explanations_built > 0 and tt.writer.explains_recorded == pipe.explanations_built
    engine = query.QueryEngine(snapshot_fn=lambda: ({}, {}),
                               history=history.HistoryReader(history.HistoryStore(str(tmp_path))))
    # A bundle is stamped with its batch's time (0..7.25 here).
    status, doc = query.dispatch(engine, "/query/explain", {"from": 0.0, "to": 1000.0, "limit": "100"})
    assert status == 200 and doc["meta"]["source"] == "history"
    assert len(doc["data"]["bundles"]) == pipe.explanations_built
    assert {b["service"] for b in doc["data"]["bundles"]} == {"checkout"}
