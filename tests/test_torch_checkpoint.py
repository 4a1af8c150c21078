"""The port's verified frame and checkpoint against the JAX reference.

Frames: for the same arrays, meta and version the port writes the
reference's bytes; each package decodes the other's frames and refuses
the same corruptions; the native CRC32C equals the portable one and the
reference's. Checkpoints: the same chained steps on both detectors, each
saved at step k; each file loads in the other package and the run goes
on. Integer banks and ``step_idx`` stay bit-exact, float state and
reports within rtol 1e-4 / atol 1e-5 (the detector's stated tolerance:
float32 sums in another order, exp/log/sqrt from another math library),
and flags identical. The elastic restore runs in one spawned four-rank
gloo world on the CPU.
"""

import json
import os
import pathlib
import struct

import jax
import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import detector as jdet
from opentelemetry_demo_tpu.models import metrics_head as jmh
from opentelemetry_demo_tpu.runtime import checkpoint as jckpt
from opentelemetry_demo_tpu.runtime import frame as jframe
from opentelemetry_demo_tpu.runtime import metrics_feed as jfeed
from opentelemetry_demo_tpu.runtime import otlp_metrics as jom
from opentelemetry_demo_tpu.runtime.tensorize import EVICTED_SLOT
from opentelemetry_demo_tpu.runtime.tensorize import SpanTensorizer as JSpanTensorizer
from opentelemetry_demo_tpu_torch.models import detector as tdet
from opentelemetry_demo_tpu_torch.models import metrics_head as tmh
from opentelemetry_demo_tpu_torch.parallel import launch
from opentelemetry_demo_tpu_torch.runtime import checkpoint, frame, metrics_feed

RTOL, ATOL = 1e-4, 1e-5
EXACT_FIELDS = ("hll_bank", "cms_bank", "step_idx", "span_total")

SMALL = dict(
    num_services=8, hll_p=8, cms_width=512, windows_s=(0.5, 1.0, 2.5),
    warmup_batches=3.0, z_warmup_batches=5.0, warmup_windows=1.0,
)
METRICS = dict(num_services=4, num_metrics=3, warmup_obs=3.0)
DT = 0.25
N_STEPS, SAVE_AT = 14, 6


def _stream(seed, n_steps, b=256, s=8):
    """Packed batches from a seed; service 2 turns five times slower in
    the second half."""
    rng = np.random.default_rng(seed)
    tz = JSpanTensorizer(num_services=s, batch_size=b)
    out = []
    for step in range(n_steps):
        n = b - 7
        svc = rng.integers(0, s, size=n).astype(np.int32)
        lat = rng.gamma(4.0, 250.0, size=n).astype(np.float32)
        if step >= n_steps // 2:
            lat = np.where(svc == 2, lat * 5.0, lat).astype(np.float32)
        out.append(tz.pack_arrays(
            svc=svc, lat_us=lat,
            trace_id=rng.integers(0, 200, size=n, dtype=np.uint64) * 2654435761 + 1,
            is_error=(rng.random(n) < 0.05).astype(np.float32),
            attr_key=rng.zipf(1.5, size=n).astype(np.uint64),
        ))
    return out


def _metric_bodies(seed, n):
    """OTLP metrics bodies: a counter and a gauge for four services."""
    rng = np.random.default_rng(seed)
    totals = np.zeros(4)
    bodies = []
    for k in range(n):
        totals += rng.normal(100.0, 5.0, 4) * 10.0
        payload = [
            (f"svc-{i}", [("requests_total", float(totals[i]), True),
                          ("queue_depth", float(rng.normal(50.0, 2.0)), False)])
            for i in range(4)
        ]
        bodies.append(jom.encode_metrics_request(payload, t_ns=10**18 + k * 10**10))
    return bodies


def _state_np(state):
    if isinstance(state, tdet.DetectorState) and isinstance(state.hll_bank, torch.Tensor):
        return tdet.state_to_numpy(state)
    return jax.device_get(state)


def _assert_states(ref, got, what):
    for name in jdet.DetectorState._fields:
        r, g = np.asarray(getattr(ref, name)), np.asarray(getattr(got, name))
        assert r.dtype == g.dtype and r.shape == g.shape, f"{what}: {name}"
        if name in EXACT_FIELDS:
            np.testing.assert_array_equal(r, g, err_msg=f"{what}: {name}")
        else:
            np.testing.assert_allclose(r, g, rtol=RTOL, atol=ATOL, err_msg=f"{what}: {name}")


def _assert_flags(ref_report, got_report, what):
    g = got_report.flags
    g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
    np.testing.assert_array_equal(np.asarray(ref_report.flags), g, err_msg=what)


# -- frames ---------------------------------------------------------------


def _sample_arrays():
    return {
        "hll_bank": np.arange(48, dtype=np.int32).reshape(2, 4, 6),
        "cms_bank": (np.arange(16, dtype=np.int64) * 7).reshape(4, 4),
        "lat_mean": np.linspace(-1, 1, 6).astype(np.float32),
        "trace_keys": np.arange(5, dtype=np.uint64) << np.uint64(40),
        "step_idx": np.asarray(9, dtype=np.int32),
        "flags": np.array([True, False, True]),
        "strided": np.arange(12, dtype=np.float32).reshape(3, 4).T,
        "empty": np.zeros((0, 3), np.float32),
    }


META = {"offsets": {"0": 7}, "epoch": 3, "services": ["a", None, EVICTED_SLOT], "t": 0.125}


@pytest.mark.parametrize("version", [1, 2])
def test_encode_is_byte_identical_to_the_reference(version):
    assert frame.encode(_sample_arrays(), META, version) == jframe.encode(_sample_arrays(), META, version)


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_each_package_decodes_the_others_frames(writer, reader):
    enc = {"port": frame.encode, "ref": jframe.encode}[writer]
    dec = {"port": frame.decode, "ref": jframe.decode}[reader]
    arrays = _sample_arrays()
    for version in (1, 2):
        f = dec(enc(arrays, META, version))
        assert f.version == version and f.meta == META
        for k, v in arrays.items():
            assert f.arrays[k].dtype == v.dtype and f.arrays[k].shape == v.shape, k
            np.testing.assert_array_equal(f.arrays[k], v)


def _truncated(buf):
    return buf[:-3]


def _column_flip(buf):
    bad = bytearray(buf)
    bad[len(buf) - 40] ^= 0x10  # inside the last column's payload
    return bytes(bad)


def _trailer_flip(buf):
    bad = bytearray(buf)
    bad[-1] ^= 0x01
    return bytes(bad)


@pytest.mark.parametrize("corrupt", [_truncated, _column_flip, _trailer_flip])
def test_both_packages_refuse_the_same_corruptions(corrupt):
    buf = frame.encode({"a": np.arange(64, dtype=np.uint32), "b": np.ones(8, np.float32)}, {"m": 1})
    bad = corrupt(buf)
    for dec in (frame.decode, jframe.decode):
        with pytest.raises(frame.FrameCorrupt if dec is frame.decode else jframe.FrameCorrupt):
            dec(bad)


def test_a_version_outside_the_window_is_a_version_error():
    future = bytearray(frame.encode(_sample_arrays()))
    future[4:6] = int(frame.FRAME_VERSION + 1).to_bytes(2, "little")
    with pytest.raises(frame.FrameCorrupt):
        frame.decode(bytes(future))  # the trailer says: flipped bits
    future[-4:] = struct.pack("<I", frame.crc32c(bytes(future[:-4])))
    with pytest.raises(frame.FrameVersionError):
        frame.decode(bytes(future))
    with pytest.raises(jframe.FrameVersionError):
        jframe.decode(bytes(future))
    with pytest.raises(ValueError):
        frame.encode(_sample_arrays(), version=frame.FRAME_VERSION + 1)


def test_peek_reads_the_header_only(tmp_path):
    p = tmp_path / "x.ckpt"
    blob = bytearray(frame.encode(_sample_arrays(), meta={"epoch": 5}))
    blob[-12] ^= 0xFF  # a corrupt payload does not hide the header
    p.write_bytes(bytes(blob))
    assert frame.peek_file_meta(str(p)).meta["epoch"] == 5
    assert frame.peek_file_meta(str(p)) == jframe.peek_file_meta(str(p))
    p.write_bytes(bytes(blob[:10]))
    with pytest.raises(frame.FrameError):
        frame.peek_file_meta(str(p))


def test_native_crc32c_equals_the_portable_one_and_the_reference():
    assert frame.crc_backend() == "native"
    rng = np.random.default_rng(0)
    for n in range(18):
        b = rng.bytes(n)
        assert frame.crc32c(b) == frame._py_crc32c(b) == jframe.crc32c(b), n
        assert frame.crc32c(bytearray(b)) == frame.crc32c(memoryview(b)) == frame.crc32c(b)
    big = np.frombuffer(rng.bytes((1 << 20) + 8), np.uint8)
    for off in range(8):  # unaligned views
        view = big[off:off + 1000]
        assert frame.crc32c(view) == frame._py_crc32c(view.tobytes()) == jframe.crc32c(view), off
    mib = big[:1 << 20]
    assert frame.crc32c(mib) == jframe.crc32c(mib)
    assert frame.crc32c(mib[::2]) == frame._py_crc32c(mib[::2].tobytes())  # strided
    # A running checksum continues across pieces.
    assert frame.crc32c(mib[4096:], frame.crc32c(mib[:4096])) == frame.crc32c(mib)


def test_host_crc_build_uses_only_the_ports_sources(tmp_path):
    root = pathlib.Path(__file__).resolve().parent.parent
    csrc = root / "opentelemetry_demo_tpu_torch" / "csrc"
    cmd = frame.crc_build_command(tmp_path / "lib.so")
    sources = [a for a in cmd if a.endswith((".cc", ".cpp", ".c", ".cu", ".h", ".cuh"))]
    assert sources == [str(frame.CRC_SOURCE)]
    assert frame.CRC_SOURCE.is_relative_to(csrc)
    assert not any("opentelemetry_demo_tpu/native" in a or a.startswith("-I") for a in cmd)
    src = frame.CRC_SOURCE.read_text()
    assert "#include \"" not in src  # no header from elsewhere in the repo
    assert frame.BUILD_DIR == root / "build" / "torch_kernels"


# -- checkpoints across the two packages -------------------------------------


def _feeds():
    jf = jfeed.MetricsFeed(jmh.MetricsHeadConfig(**METRICS))
    tf = metrics_feed.MetricsFeed(tmh.MetricsHeadConfig(**METRICS), device="cpu")
    return jf, tf


def _run_pair(batches, bodies, start, stop, ref, got, jf, tf):
    for step in range(start, stop):
        t = 100.0 + step * DT
        r, g = ref.observe(batches[step], t), got.observe(batches[step], t)
        _assert_flags(r, g, f"flags @ step {step}")
        recs = jom.decode_metrics_request(bodies[step])
        jf.submit(recs)
        tf.submit(recs)
        mr, mg = jf.pump(10.0 * step), tf.pump(10.0 * step)
        if mr is not None:
            _assert_flags(mr, mg, f"metric flags @ step {step}")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Both detectors and metrics feeds through the same SAVE_AT steps,
    each saved; then each carries on uninterrupted to N_STEPS."""
    tmp = tmp_path_factory.mktemp("ckpt")
    batches, bodies = _stream(3, N_STEPS), _metric_bodies(4, N_STEPS)
    jcfg, tcfg = jdet.DetectorConfig(**SMALL), tdet.DetectorConfig(**SMALL)
    ref, got = jdet.AnomalyDetector(jcfg), tdet.AnomalyDetector(tcfg, device="cpu")
    jf, tf = _feeds()
    _run_pair(batches, bodies, 0, SAVE_AT, ref, got, jf, tf)
    kw = dict(offsets={"0": SAVE_AT, "1": 44}, service_names=["a", EVICTED_SLOT, "c"],
              epoch=2, generation=5)
    paths = {"ref": str(tmp / "ref"), "port": str(tmp / "port")}
    jckpt.save(paths["ref"], ref, metrics_feed=jf, dispatch_lock=None, **kw)
    checkpoint.save(paths["port"], got, metrics_feed=tf, dispatch_lock=None, **kw)
    at_save = {"ref": _state_np(ref.state), "port": _state_np(got.state)}
    _run_pair(batches, bodies, SAVE_AT, N_STEPS, ref, got, jf, tf)
    return dict(paths=paths, batches=batches, bodies=bodies, at_save=at_save, kw=kw,
                final={"ref": _state_np(ref.state), "port": _state_np(got.state)},
                final_heads={"ref": jax.device_get(jf.head.state),
                             "port": tmh.MetricsHeadState(*(t.numpy() for t in tf.head.state))})


def test_the_two_files_hold_equal_arrays_and_meta(saved):
    fr = {k: frame.decode(open(p + checkpoint.SUFFIX, "rb").read()) for k, p in saved["paths"].items()}
    assert fr["ref"].meta == fr["port"].meta
    assert list(fr["ref"].arrays) == list(fr["port"].arrays)
    for name, r in fr["ref"].arrays.items():
        g = fr["port"].arrays[name]
        assert r.dtype == g.dtype and r.shape == g.shape, name
        if name in EXACT_FIELDS or r.dtype.kind != "f":
            np.testing.assert_array_equal(r, g, err_msg=name)
        else:
            np.testing.assert_allclose(r, g, rtol=RTOL, atol=ATOL, err_msg=name)


def test_save_state_of_the_same_state_writes_the_reference_bytes(saved, tmp_path):
    """Given the reference's state (numpy), the port's writer produces
    the reference writer's file byte for byte."""
    state = saved["at_save"]["ref"]
    cfg = tdet.DetectorConfig(**SMALL)
    kw = dict(offsets={"0": 3}, service_names=["x", EVICTED_SLOT], clock_t_prev=101.25,
              epoch=1, generation=4)
    checkpoint.save_state(str(tmp_path / "p"), tdet.DetectorState(*state), cfg, **kw)
    jckpt.save_state(str(tmp_path / "r"), state, jdet.DetectorConfig(**SMALL), **kw)
    assert (tmp_path / "p.ckpt").read_bytes() == (tmp_path / "r.ckpt").read_bytes()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_snapshot_resumes_in_the_other_package(saved, writer):
    """Each file loads in the other package, and that run carries on
    beside the writer's uninterrupted one: integer banks bit-exact,
    floats within tolerance, flags identical; the metrics head too."""
    path = saved["paths"][writer]
    batches, bodies = saved["batches"], saved["bodies"]
    if writer == "ref":
        got, meta = checkpoint.load(path, tdet.DetectorConfig(**SMALL), device="cpu")
        ref, _ = jckpt.load(path, jdet.DetectorConfig(**SMALL))
        jf, tf = _feeds()
        assert checkpoint.restore_metrics_feed(meta, tf)
        assert jckpt.restore_metrics_feed(jckpt.load(path)[1], jf)
    else:
        ref, meta = jckpt.load(path, jdet.DetectorConfig(**SMALL))
        got, _ = checkpoint.load(path, tdet.DetectorConfig(**SMALL), device="cpu")
        jf, tf = _feeds()
        assert jckpt.restore_metrics_feed(meta, jf)
        assert checkpoint.restore_metrics_feed(checkpoint.load(path, device="cpu")[1], tf)
    assert meta["offsets"] == {"0": SAVE_AT, "1": 44}
    assert meta["service_names"] == ["a", EVICTED_SLOT, "c"]
    assert meta["epoch"] == 2 and meta["generation"] == 5
    assert meta["clock_t_prev"] == 100.0 + (SAVE_AT - 1) * DT
    assert got.clock._t_prev == ref.clock._t_prev == meta["clock_t_prev"]
    _assert_states(saved["at_save"][writer], _state_np(got.state), "restored")
    # The feeds restart their rate clock at the first pump after restore,
    # as in the reference (no pump time is persisted).
    _run_pair(batches, bodies, SAVE_AT, N_STEPS, ref, got, jf, tf)
    _assert_states(saved["final"][writer], _state_np(got.state), "resumed vs uninterrupted")
    _assert_states(_state_np(ref.state), _state_np(got.state), "resumed pair")
    for name in tmh.MetricsHeadState._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(jax.device_get(jf.head.state), name)),
            getattr(tf.head.state, name).numpy(), rtol=RTOL, atol=ATOL, err_msg=name,
        )


def test_v0_npz_snapshot_migrates(tmp_path):
    """The pre-frame layout (npz + __meta__ + sha256 digest) restores,
    and the next save writes a frame and retires the npz."""
    det = tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device="cpu")
    for step, batch in enumerate(_stream(5, 3)):
        det.observe(batch, step * DT)
    path = str(tmp_path / "v0")
    arrays = dict(tdet.state_to_numpy(det.state)._asdict())
    meta = {"offsets": {"0": 44}, "service_names": ["cart"],
            "config": list(det.config._replace(sketch_impl=None)), "clock_t_prev": 123.0, "epoch": 2}
    meta_json = json.dumps(meta)
    assert checkpoint._content_digest(arrays, meta_json) == jckpt._content_digest(arrays, meta_json)
    with open(path + ".npz", "wb") as f:
        f.write(frame.write_npz({
            "__meta__": np.asarray(meta_json),
            "__digest__": np.asarray(checkpoint._content_digest(arrays, meta_json)),
            **arrays,
        }))
    assert checkpoint.exists(path) and checkpoint.peek_epoch(path) == 2
    det2, meta2, corrupt = checkpoint.load_resilient(path, tdet.DetectorConfig(**SMALL), device="cpu")
    assert not corrupt and det2 is not None and meta2["offsets"] == {"0": 44}
    _assert_states(tdet.DetectorState(**arrays), _state_np(det2.state), "migrated")
    checkpoint.save(path, det2, offsets={0: 45}, epoch=2, dispatch_lock=None)
    assert os.path.exists(path + checkpoint.SUFFIX) and not os.path.exists(path + ".npz")
    assert checkpoint.peek_epoch(path) == 2
    assert checkpoint.load(path, tdet.DetectorConfig(**SMALL), device="cpu")[1]["offsets"] == {"0": 45}
    # The reference reads the migrated file too.
    assert jckpt.load(path, jdet.DetectorConfig(**SMALL))[1]["offsets"] == {"0": 45}


def test_a_stale_epoch_save_is_refused(tmp_path):
    det = tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device="cpu")
    path = str(tmp_path / "fenced")
    checkpoint.save(path, det, epoch=3, dispatch_lock=None)
    with pytest.raises(checkpoint.StaleEpochError):
        checkpoint.save(path, det, epoch=2, dispatch_lock=None)
    # A reference writer at an older epoch is refused by the port's file.
    with pytest.raises(jckpt.StaleEpochError):
        jckpt.save(path, jdet.AnomalyDetector(jdet.DetectorConfig(**SMALL)), epoch=1, dispatch_lock=None)
    checkpoint.save(path, det, epoch=4, dispatch_lock=None)
    assert checkpoint.peek_epoch(path) == 4


@pytest.mark.parametrize("corrupt", [_truncated, _column_flip])
def test_load_resilient_quarantines_a_corrupt_file(tmp_path, corrupt):
    det = tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device="cpu")
    path = str(tmp_path / "bad")
    checkpoint.save(path, det, offsets={0: 3}, dispatch_lock=None)
    file = path + checkpoint.SUFFIX
    with open(file, "rb") as f:
        blob = f.read()
    with open(file, "wb") as f:
        f.write(corrupt(blob))
    det2, meta2, was_corrupt = checkpoint.load_resilient(path, tdet.DetectorConfig(**SMALL), device="cpu")
    assert det2 is None and meta2 is None and was_corrupt is True
    assert os.path.exists(file + ".corrupt") and not checkpoint.exists(path)
    assert checkpoint.load_resilient(path, device="cpu") == (None, None, False)


def test_a_config_mismatch_raises(tmp_path):
    det = tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device="cpu")
    path = str(tmp_path / "cfg")
    checkpoint.save(path, det, dispatch_lock=None)
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.load(path, tdet.DetectorConfig(**{**SMALL, "cms_width": 1024}), device="cpu")
    # sketch_impl is a backend knob, not state: any choice restores.
    got, _ = checkpoint.load(path, tdet.DetectorConfig(**SMALL, sketch_impl="pallas"), device="cpu")
    assert got.config.sketch_impl == "pallas"


def test_restore_metrics_feed_refuses_another_geometry(tmp_path):
    det = tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device="cpu")
    _, tf = _feeds()
    tf.submit(jom.decode_metrics_request(_metric_bodies(1, 1)[0]))
    path = str(tmp_path / "m")
    checkpoint.save(path, det, metrics_feed=tf, dispatch_lock=None)
    _, meta = checkpoint.load(path, device="cpu")
    other = metrics_feed.MetricsFeed(tmh.MetricsHeadConfig(**{**METRICS, "num_metrics": 4}), device="cpu")
    assert checkpoint.restore_metrics_feed(meta, other) is False
    assert other.service_names == []
    same = metrics_feed.MetricsFeed(tmh.MetricsHeadConfig(**METRICS), device="cpu")
    assert checkpoint.restore_metrics_feed(meta, same) is True
    assert same.service_names == tf.service_names and same.metric_names == tf.metric_names
    # A snapshot with no metrics leg restores nothing, silently.
    checkpoint.save(path, det, dispatch_lock=None)
    assert checkpoint.restore_metrics_feed(checkpoint.load(path, device="cpu")[1], same) is False


_CARD_DEFAULTS = {
    "checkpoint.load": lambda p: checkpoint.load(p),
    "checkpoint.load_resilient": lambda p: checkpoint.load_resilient(p),
    "MetricsHead": lambda p: tmh.MetricsHead(),
    "metrics_head_init": lambda p: tmh.metrics_head_init(tmh.MetricsHeadConfig()),
    "MetricsFeed": lambda p: metrics_feed.MetricsFeed(),
}


@pytest.mark.parametrize("name", sorted(_CARD_DEFAULTS))
def test_entry_points_take_the_card_or_raise(monkeypatch, tmp_path, name):
    det = tdet.AnomalyDetector(tdet.DetectorConfig(**SMALL), device="cpu")
    path = str(tmp_path / "card")
    checkpoint.save(path, det, dispatch_lock=None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _CARD_DEFAULTS[name](path)


# -- elastic restore on a (2 x 2) gloo world ---------------------------------

MESH_CFG = dict(num_services=8, cms_depth=4, hll_p=8, cms_width=512)
MESH_B, MESH_STEPS, MESH_SAVE = 256, 6, 3


def _mesh_batches():
    return [tuple(b) for b in _stream(7, MESH_STEPS, b=MESH_B)]


def _mesh_rotates():
    return [np.array([k % 2 == 1, False, k == 5]) for k in range(MESH_STEPS)]


def _single(cfg, batches, rotates, state=None):
    state = state if state is not None else tdet.detector_init(cfg, "cpu")
    dt = torch.tensor(DT)
    for batch, rot in zip(batches, rotates):
        lanes = [torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x) for x in batch]
        state, _ = tdet.detector_step(cfg, state, *lanes, dt, torch.from_numpy(rot))
    return state


@pytest.fixture(scope="module")
def mesh_resume(tmp_path_factory):
    """A one-device snapshot at step MESH_SAVE resumes on the mesh; a
    fresh mesh run's gathered state is saved for the reverse move."""
    tmp = tmp_path_factory.mktemp("mesh")
    cfg = tdet.DetectorConfig(**MESH_CFG)
    batches, rotates = _mesh_batches(), _mesh_rotates()
    state = _single(cfg, batches[:MESH_SAVE], rotates[:MESH_SAVE])
    path = str(tmp / "one")
    checkpoint.save_state(path, state, cfg, offsets={"0": 1234}, clock_t_prev=0.75)
    scen = [
        launch.Scenario(cfg, batches[MESH_SAVE:], rotates[MESH_SAVE:], DT, snapshot=path + ""),
        launch.Scenario(cfg, batches[:MESH_SAVE], rotates[:MESH_SAVE], DT),
    ]
    out = launch.run_world(launch.replay_sharded, 4, "cpu", None, 120.0, (2, 2), "cpu", scen)
    return dict(cfg=cfg, batches=batches, rotates=rotates, out=out, tmp=tmp)


def _assert_mesh_state(ref, got, what):
    for name in tdet.DetectorState._fields:
        r, g = np.asarray(getattr(ref, name)), np.asarray(getattr(got, name))
        if name in ("hll_bank", "cms_bank", "step_idx"):
            np.testing.assert_array_equal(r, g, err_msg=f"{what}: {name}")
        else:  # stats summed across ranks in another order
            np.testing.assert_allclose(r, g, rtol=1e-4, atol=1e-4, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("direction", ["one_to_mesh", "mesh_to_one"])
def test_elastic_restore_across_layouts(mesh_resume, direction):
    """A one-device snapshot continues on the (2 × 2) mesh, and a mesh
    run's gathered snapshot continues on one device; integer banks
    bit-exact against the one-device run of the whole stream."""
    cfg, batches, rotates = mesh_resume["cfg"], mesh_resume["batches"], mesh_resume["rotates"]
    ref = tdet.state_to_numpy(_single(cfg, batches, rotates))
    if direction == "one_to_mesh":
        for rank_out in mesh_resume["out"]:
            _assert_mesh_state(ref, rank_out[0]["state"], "mesh resumed")
        return
    gathered = mesh_resume["out"][0][1]["state"]
    path = str(mesh_resume["tmp"] / "gathered")
    checkpoint.save_state(path, gathered, cfg, offsets={"0": 9})
    det, meta = checkpoint.load(path, cfg, device="cpu")
    assert meta["offsets"] == {"0": 9}
    state = _single(cfg, batches[MESH_SAVE:], rotates[MESH_SAVE:], det.state)
    _assert_mesh_state(ref, tdet.state_to_numpy(state), "one device resumed")


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the state-holding entry points run on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("impl", [None, "xla"])
def test_card_resume_is_bit_identical_to_an_uninterrupted_run(tmp_path, cuda_device, impl):
    """On one card the kernels are deterministic: a run saved at step k,
    loaded and continued equals the uninterrupted run bit for bit, and
    the snapshot read on the CPU equals the card's state."""
    cfg = tdet.DetectorConfig(**SMALL, sketch_impl=impl)
    batches = _stream(8, N_STEPS)
    whole = tdet.AnomalyDetector(cfg, device=cuda_device)
    part = tdet.AnomalyDetector(cfg, device=cuda_device)
    for step, batch in enumerate(batches):
        whole.observe(batch, step * DT)
        if step < SAVE_AT:
            part.observe(batch, step * DT)
    path = str(tmp_path / "card")
    checkpoint.save(path, part, dispatch_lock=None)
    on_cpu, _ = checkpoint.load(path, cfg, device="cpu")
    for name, a, b in zip(tdet.DetectorState._fields, tdet.state_to_numpy(part.state),
                          tdet.state_to_numpy(on_cpu.state)):
        assert a.tobytes() == b.tobytes(), name
    resumed, _ = checkpoint.load(path, cfg, device=cuda_device)
    for step in range(SAVE_AT, N_STEPS):
        resumed.observe(batches[step], step * DT)
    for name, a, b in zip(tdet.DetectorState._fields, tdet.state_to_numpy(whole.state),
                          tdet.state_to_numpy(resumed.state)):
        assert a.tobytes() == b.tobytes(), name
