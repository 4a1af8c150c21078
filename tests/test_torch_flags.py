"""The port's flagd layer and the pipeline's gating against the reference.

The evaluator, the file store, the flag editor and the OFREP client of
``opentelemetry_demo_tpu_torch.utils`` answer as the JAX package's
``utils`` do on the same documents and requests (the cases of
``tests/test_runtime.py::TestFlags``, ``tests/test_flag_ui.py`` and the
OFREP cases of ``tests/test_gateway.py``, here against a local
``http.server`` stub). Then the pipeline's gating on the CPU against the
JAX pipeline: the off switch drops the queue and the spine's staged
batches and leaves the state as it was, and a raised z-threshold
re-derives the flags from each report's z-scores while CUSUM alarms hold.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import AnomalyDetector as JAnomalyDetector
from opentelemetry_demo_tpu.models import DetectorConfig as JDetectorConfig
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu.runtime.pipeline import DetectorPipeline as JDetectorPipeline
from opentelemetry_demo_tpu.utils import flag_ui as jflag_ui
from opentelemetry_demo_tpu.utils import flags as jflags
from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
from opentelemetry_demo_tpu_torch.runtime.pipeline import (
    FLAG_ENABLED,
    FLAG_THRESHOLD,
    DetectorPipeline,
)
from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanColumns
from opentelemetry_demo_tpu_torch.utils import flag_ui, flags

DOC = {
    "flags": {
        "anomalyDetectorEnabled": {
            "state": "ENABLED",
            "variants": {"on": True, "off": False},
            "defaultVariant": "on",
        },
        "paymentFailure": {
            "state": "ENABLED",
            "variants": {"on": 1.0, "off": 0.0, "50%": 0.5},
            "defaultVariant": "off",
        },
        "disabledFlag": {
            "state": "DISABLED",
            "variants": {"on": True},
            "defaultVariant": "on",
        },
        "fractionalFlag": {
            "state": "ENABLED",
            "variants": {"a": "A", "b": "B", "c": "C"},
            "defaultVariant": "a",
            "targeting": {"fractional": [["a", 25], ["b", 50], ["c", 25]]},
        },
        "zeroWeights": {
            "state": "ENABLED",
            "variants": {"a": 1, "b": 2},
            "defaultVariant": "b",
            "targeting": {"fractional": [["a", 0], ["b", 0]]},
        },
        "danglingDefault": {
            "state": "ENABLED",
            "variants": {"on": 1},
            "defaultVariant": "nope",
        },
    }
}
KEYS = sorted(DOC["flags"]) + ["missing"]
# DOC without the flag the editor refuses (its defaultVariant is not a variant).
VALID = {"flags": {k: v for k, v in DOC["flags"].items() if k != "danglingDefault"}}


def _both(doc=None):
    return flags.FlagEvaluator(doc), jflags.FlagEvaluator(doc)


def _resolve(ev, key, tk=""):
    try:
        return ev.resolve(key, tk)
    except KeyError as e:
        return ("KeyError", str(e))


# -- the evaluator -------------------------------------------------------------------


@pytest.mark.parametrize("key", KEYS)
def test_evaluator_answers_equal_the_reference(key):
    port, ref = _both(DOC)
    assert port.evaluate(key, "dflt") == ref.evaluate(key, "dflt")
    assert _resolve(port, key) == _resolve(ref, key)
    assert port.flag_spec(key) == ref.flag_spec(key)


def test_fractional_buckets_equal_the_reference_over_400_keys():
    port, ref = _both(DOC)
    got = [port.evaluate("fractionalFlag", "?", f"user-{i}") for i in range(400)]
    want = [ref.evaluate("fractionalFlag", "?", f"user-{i}") for i in range(400)]
    assert got == want
    assert [_resolve(port, "fractionalFlag", f"s{i}") for i in range(400)] == [
        _resolve(ref, "fractionalFlag", f"s{i}") for i in range(400)
    ]
    # Sticky and split: each variant takes its weight's share, roughly.
    assert got == [port.evaluate("fractionalFlag", "?", f"user-{i}") for i in range(400)]
    share_b = sum(v == "B" for v in got) / len(got)
    assert 0.35 < share_b < 0.65


def test_snapshot_replace_and_version_equal_the_reference():
    port, ref = _both()
    assert port.flag_keys() == ref.flag_keys() == []
    for ev in (port, ref):
        ev.replace(DOC)
        snap = ev.snapshot()
        snap["flags"]["paymentFailure"]["defaultVariant"] = "on"
        assert ev.evaluate("paymentFailure", -1.0) == 0.0  # a copy
        ev.replace(snap)
    assert port.version == ref.version == 2 == port.poll_version()
    assert port.flag_keys() == ref.flag_keys()
    assert port.flag_specs() == ref.flag_specs()
    assert port.evaluate("paymentFailure", -1.0) == ref.evaluate("paymentFailure", -1.0) == 1.0


def test_backoff_equals_the_reference_on_one_seed():
    got, want = [], []
    for out, mod in ((got, flags), (want, jflags)):
        random.seed(11)
        out.extend(mod.capped_jitter_backoff(a, 0.05, 0.5) for a in range(8))
    assert got == want
    assert all(0.025 <= b < 0.75 for b in got)


# -- the file store ------------------------------------------------------------------


def _bump(path):
    os.utime(path, (time.time() + 5, time.time() + 5))


def test_file_store_hot_reload_equals_the_reference(tmp_path):
    path = tmp_path / "flags.json"
    path.write_text(json.dumps(DOC))
    port, ref = flags.FlagFileStore(str(path)), jflags.FlagFileStore(str(path))
    v0 = port.version
    assert port.evaluate(FLAG_ENABLED, False) is ref.evaluate(FLAG_ENABLED, False) is True
    doc2 = json.loads(json.dumps(DOC))
    doc2["flags"][FLAG_ENABLED]["defaultVariant"] = "off"
    doc2["flags"]["newFlag"] = {"state": "ENABLED", "variants": {"on": 1}, "defaultVariant": "on"}
    path.write_text(json.dumps(doc2))
    _bump(path)
    # Every read path reloads, not only evaluate().
    assert _resolve(port, FLAG_ENABLED) == _resolve(ref, FLAG_ENABLED) == (False, "off", "STATIC")
    assert "newFlag" in port.flag_keys() and port.flag_keys() == ref.flag_keys()
    assert port.version > v0 and port.poll_version() == ref.poll_version()


def test_file_store_keeps_its_snapshot_over_a_torn_write(tmp_path):
    path = tmp_path / "flags.json"
    path.write_text(json.dumps(DOC))
    port, ref = flags.FlagFileStore(str(path)), jflags.FlagFileStore(str(path))
    path.write_text('{"flags": {bad json')
    _bump(path)
    assert port.evaluate(FLAG_ENABLED, False) is ref.evaluate(FLAG_ENABLED, False) is True
    # A missing file keeps the snapshot too.
    path.unlink()
    assert port.evaluate("paymentFailure", -1.0) == ref.evaluate("paymentFailure", -1.0) == 0.0


def test_atomic_write_doc_is_read_by_both_stores(tmp_path):
    path = tmp_path / "flags.json"
    flags.atomic_write_doc(str(path), DOC)
    assert json.loads(path.read_text()) == DOC
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".tmp"]
    assert jflags.FlagFileStore(str(path)).snapshot() == flags.FlagFileStore(str(path)).snapshot() == DOC


# -- the flag editor -----------------------------------------------------------------

BAD_DOCS = [
    {"not_flags": {}},
    {"flags": 3},
    {"flags": {"x": 1}},
    {"flags": {"x": {"variants": {}, "defaultVariant": "on", "state": "ENABLED"}}},
    {"flags": {"x": {"variants": {"on": 1}, "defaultVariant": "off", "state": "ENABLED"}}},
    {"flags": {"x": {"variants": {"on": 1}, "defaultVariant": "on", "state": "weird"}}},
]


@pytest.mark.parametrize("doc", BAD_DOCS)
def test_editor_refuses_what_the_reference_refuses(doc):
    with pytest.raises(flag_ui.FlagValidationError) as got:
        flag_ui.validate_flag_doc(doc)
    with pytest.raises(jflag_ui.FlagValidationError) as want:
        jflag_ui.validate_flag_doc(doc)
    assert str(got.value) == str(want.value)


def _requests():
    good = {"flags": {"paymentFailure": DOC["flags"]["paymentFailure"]}}
    return [
        ("GET", "/", b""),
        ("POST", "/api/write-to-file", json.dumps({"data": good}).encode()),
        ("GET", "/api/read-file", b""),
        ("GET", "/advanced", b""),
        ("POST", "/api/set-variant", json.dumps({"flag": "paymentFailure", "variant": "on"}).encode()),
        ("POST", "/api/set-variant", json.dumps({"flag": "nope", "variant": "on"}).encode()),
        ("POST", "/api/set-variant", json.dumps({"flag": "paymentFailure", "variant": "bogus"}).encode()),
        ("POST", "/api/write-to-file", b'{"data": {"flags": 3}}'),
        ("POST", "/api/write-to-file", b"{not json"),
        ("POST", "/api/write-to-file", json.dumps(DOC).encode()),
        ("GET", "/", b""),
        ("GET", "/nope", b""),
    ]


@pytest.mark.parametrize("store", ["memory", "file"])
def test_editor_routes_answer_as_the_reference(store, tmp_path):
    answers = {}
    for name, mod, fmod in (("port", flag_ui, flags), ("ref", jflag_ui, jflags)):
        if store == "file":
            path = tmp_path / f"{name}.json"
            path.write_text(json.dumps(DOC))
            ev = fmod.FlagFileStore(str(path))
        else:
            ev = fmod.FlagEvaluator(json.loads(json.dumps(DOC)))
        ui = mod.FlagEditorUI(ev)
        seen = []
        for method, route, body in _requests():
            status, ctype, out = ui.handle(method, route, body)
            seen.append((status, ctype, out, ev.evaluate("paymentFailure", -1.0)))
        answers[name] = seen
    assert answers["port"] == answers["ref"]
    statuses = [s for s, *_ in answers["port"]]
    # DOC holds a flag whose defaultVariant is not among its variants.
    assert statuses == [200, 200, 200, 200, 200, 404, 400, 400, 400, 400, 200, 404]
    # The set-variant flip took effect and the refused one did not undo it.
    assert [v for *_, v in answers["port"]][4:8] == [1.0, 1.0, 1.0, 1.0]


def test_editor_write_reaches_a_second_file_store(tmp_path):
    """The operator's path: a write through the editor's route lands in
    the file that a pipeline's store reads."""
    path = tmp_path / "flags.json"
    path.write_text(json.dumps(VALID))
    ui = flag_ui.FlagEditorUI(flags.FlagFileStore(str(path)))
    reader = flags.FlagFileStore(str(path))
    assert reader.evaluate(FLAG_ENABLED, False) is True
    doc = json.loads(json.dumps(VALID))
    doc["flags"][FLAG_ENABLED]["defaultVariant"] = "off"
    assert ui.handle("POST", "/api/write-to-file", json.dumps({"data": doc}).encode())[0] == 200
    _bump(path)
    assert reader.evaluate(FLAG_ENABLED, True) is False


# -- the OFREP client ----------------------------------------------------------------


class _Ofrep:
    """A flagd OFREP stub: ``/ofrep/v1/evaluate/flags/<key>``."""

    def __init__(self):
        self.values = {"paymentFailure": 0.25, "anomalyDetectorZThreshold": 9.0}
        self.fail_first = {}  # key → number of 500s before the answer
        self.calls: dict[str, int] = {}
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                key = self.path.rsplit("/", 1)[-1]
                stub.calls[key] = stub.calls.get(key, 0) + 1
                ctx = json.loads(body or b"{}").get("context", {})
                if key == "busy":
                    code, out = 429, {}
                elif stub.fail_first.get(key, 0) >= stub.calls[key]:
                    code, out = 500, {}
                elif key in stub.values:
                    code, out = 200, {"key": key, "value": stub.values[key], "ctx": ctx}
                else:
                    code, out = 404, {"errorCode": "FLAG_NOT_FOUND"}
                data = json.dumps(out).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)


@pytest.fixture
def ofrep():
    stub = _Ofrep()
    yield stub
    stub.close()


def test_ofrep_answers_equal_the_reference(ofrep):
    port = flags.OfrepClient(ofrep.url, timeout_s=1.0, retries=2)
    ref = jflags.OfrepClient(ofrep.url, timeout_s=1.0, retries=2)
    for key, default in (("paymentFailure", 0.0), (FLAG_THRESHOLD, 6.0), ("noSuchFlag", "fb")):
        assert port.evaluate(key, default, "sess-1") == ref.evaluate(key, default, "sess-1")
    assert port.evaluate("paymentFailure", 0.0) == 0.25
    assert port.evaluate("noSuchFlag", "fb") == "fb"
    # A definitive 404 answers at once: no retry, no transient count.
    assert port.transient_failures == ref.transient_failures == 0
    assert ofrep.calls["noSuchFlag"] == 3


def test_ofrep_retries_transient_faults_with_bounded_backoff(ofrep):
    ofrep.fail_first = {"paymentFailure": 2}
    port = flags.OfrepClient(ofrep.url, timeout_s=1.0, retries=2)
    t0 = time.monotonic()
    assert port.evaluate("paymentFailure", 0.0) == 0.25  # the third try answers
    assert port.transient_failures == 2 and ofrep.calls["paymentFailure"] == 3
    # 429 is transient too: every attempt fails, then the default, and
    # the circuit opens: the next call makes one attempt only.
    assert port.evaluate("busy", "fb") == "fb"
    assert port.transient_failures == 5 and ofrep.calls["busy"] == 3
    assert port.evaluate("busy", "fb") == "fb"
    assert port.transient_failures == 6 and ofrep.calls["busy"] == 4
    # Two backoffs per burst, each at most cap × 1.5.
    assert time.monotonic() - t0 < 4 * 0.75 + 2.0
    # The first success closes the circuit.
    assert port.evaluate("paymentFailure", 0.0) == 0.25
    assert port._down_until == 0.0
    ref = jflags.OfrepClient(ofrep.url, timeout_s=1.0, retries=2)
    assert ref.evaluate("busy", "fb") == "fb" and ref.transient_failures == 3


def test_ofrep_degrades_to_the_default_with_no_server():
    dead = flags.OfrepClient("http://127.0.0.1:1", timeout_s=0.2, retries=2)
    t0 = time.monotonic()
    assert dead.evaluate("anyFlag", "fallback") == "fallback"
    assert dead.transient_failures == 3
    assert time.monotonic() - t0 < 3.0


# -- the pipeline's gating against the JAX pipeline ------------------------------------

CFG = dict(num_services=8, hll_p=8, cms_width=512, warmup_batches=5.0, z_warmup_batches=20.0)
SMALL = dict(num_services=8, hll_p=8, cms_width=512)


def _doc(key, value):
    return {"flags": {key: {"state": "ENABLED", "variants": {"v": value, "other": not value},
                            "defaultVariant": "v"}}}


def _columns(rng, n, k=0, fault_at=None):
    svc = rng.integers(0, 6, size=n).astype(np.int32)
    lat = rng.gamma(8.0, 25.0 * (svc + 1)).astype(np.float32)
    if fault_at is not None and k >= fault_at:
        lat[svc == 3] *= 3.0
    return SpanColumns(
        svc=svc, lat_us=lat, is_error=(rng.random(n) < 0.02).astype(np.float32),
        trace_key=rng.integers(0, 2**63, size=n, dtype=np.uint64),
        attr_crc=rng.zipf(1.5, size=n).astype(np.uint64),
    )


def _pipes(cfg, port_flags, ref_flags, **kw):
    seen = {"port": [], "ref": []}
    port = DetectorPipeline(AnomalyDetector(DetectorConfig(**cfg), device="cpu"), flags=port_flags,
                            on_report=lambda t, r, names: seen["port"].append((t, r, names)), **kw)
    ref = JDetectorPipeline(JAnomalyDetector(JDetectorConfig(**cfg)), flags=ref_flags,
                            on_report=lambda t, r, names: seen["ref"].append((t, r, names)), **kw)
    return port, ref, seen


def _ref_state(pipe):
    return {k: np.asarray(v) for k, v in pipe.detector.state._asdict().items()}


def _port_state(pipe):
    return state_to_numpy(pipe.detector.state)._asdict()


def test_pipeline_disabled_by_flag_equals_the_reference(rng):
    port, ref, _ = _pipes(SMALL, flags.FlagEvaluator(_doc(FLAG_ENABLED, False)),
                          jflags.FlagEvaluator(_doc(FLAG_ENABLED, False)), batch_size=256)
    cols = _columns(rng, 100)
    port.submit_columns(cols)
    ref.submit_columns(jtz.SpanColumns(*cols))
    port.pump(1000.0)
    ref.pump(1000.0)
    assert port.stats.batches == ref.stats.batches == 0
    assert port.stats.dropped_disabled == ref.stats.dropped_disabled == 100
    assert port.pending_rows() == ref.pending_rows() == 0


def test_flag_off_drops_staged_rows_as_the_reference():
    runs = {}
    for name, fmod in (("port", flags), ("ref", jflags)):
        ev = fmod.FlagEvaluator()
        if name == "port":
            pipe = DetectorPipeline(AnomalyDetector(DetectorConfig(**SMALL), device="cpu"), flags=ev,
                                    batch_size=128, spine_ring=2)
            wrap = lambda c: c  # noqa: E731
        else:
            pipe = JDetectorPipeline(JAnomalyDetector(JDetectorConfig(**SMALL)), flags=ev,
                                     batch_size=128, spine_ring=2)
            wrap = lambda c: jtz.SpanColumns(*c)  # noqa: E731
        rng = np.random.default_rng(4)
        pipe.submit_columns(wrap(_columns(rng, 128)))
        pipe.pump(0.0)
        pipe.submit_columns(wrap(_columns(rng, 128)))
        ev.replace(_doc(FLAG_ENABLED, False))
        pipe.pump(0.05)
        assert pipe._spine.pending() == 0
        runs[name] = (pipe.stats.spans, pipe.stats.dropped_disabled, pipe.stats.batches)
        pipe.close()
    assert runs["port"][0] + runs["port"][1] == 2 * 128
    assert runs["port"][1] > 0
    # The reference counts the same conservation; which of the two
    # batches was already dispatched depends on its stager's timing.
    assert runs["ref"][0] + runs["ref"][1] == 2 * 128


@pytest.mark.parametrize("spine_ring", [0, 2])
def test_a_disabled_window_leaves_the_state_and_the_verdicts_unchanged(spine_ring):
    """Off for five pumps mid-stream: the state after the window equals
    the state before it bit for bit, every row fed while off is counted
    dropped, fed = dispatched + dropped, and the stream around the
    window gives the reference's flags and state."""
    b, n = 256, 48
    stream = [_columns(np.random.default_rng(100 + k), b, k, fault_at=40) for k in range(n)]
    off = range(20, 25)
    out = {}
    for name, fmod in (("port", flags), ("ref", jflags)):
        ev = fmod.FlagEvaluator()
        seen = []
        if name == "port":
            pipe = DetectorPipeline(AnomalyDetector(DetectorConfig(**CFG), device="cpu"), flags=ev,
                                    batch_size=b, spine_ring=spine_ring,
                                    on_report=lambda t, r, names: seen.append((t, names)))
            snap, wrap = _port_state, (lambda c: c)
        else:
            pipe = JDetectorPipeline(JAnomalyDetector(JDetectorConfig(**CFG)), flags=ev,
                                     batch_size=b, spine_ring=spine_ring,
                                     on_report=lambda t, r, names: seen.append((t, names)))
            snap, wrap = _ref_state, (lambda c: jtz.SpanColumns(*c))
        before = None
        for k, cols in enumerate(stream):
            if k == off.start:
                pipe.drain()
                before = snap(pipe)
                ev.replace(_doc(FLAG_ENABLED, False))
            if k == off.stop:
                after = snap(pipe)
                for key in before:
                    np.testing.assert_array_equal(after[key], before[key], err_msg=f"{name} {key}")
                ev.replace({"flags": {}})
            pipe.submit_columns(wrap(cols))
            pipe.pump(k * 0.25)
        pipe.drain()
        fed = b * n
        assert pipe.stats.dropped_disabled == b * len(off)
        assert pipe.stats.spans + pipe.stats.dropped_disabled == fed
        out[name] = (seen, snap(pipe), pipe.stats.batches)
        if spine_ring:
            pipe.close()
    (seen, state, batches), (rseen, rstate, rbatches) = out["port"], out["ref"]
    assert batches == rbatches == 48 - len(off)
    assert seen == rseen
    flagged = [(t, names) for t, names in seen if names]
    assert (40 * 0.25, ["svc-3"]) in flagged
    assert all(t >= off.stop * 0.25 for t, _ in flagged)
    for key, want in rstate.items():
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(state[key], want, err_msg=key)
        else:
            np.testing.assert_allclose(state[key], want, rtol=1e-4, atol=1e-5, err_msg=key)


def _recomputed(report, cfg, threshold):
    z = np.maximum.reduce([np.abs(np.asarray(getattr(report, f))).max(axis=1)
                           for f in ("lat_z", "err_z", "rate_z", "card_z")])
    cusum = np.asarray(report.cusum) > np.asarray(cfg.cusum_thresholds, np.float32)[None, :]
    return (z > threshold) | cusum.any(axis=1), z, cusum.any(axis=1)


@pytest.mark.parametrize("threshold", [2.0, 1e6])
def test_a_threshold_flag_rederives_the_flags_as_the_reference(threshold):
    b, n = 256, 60
    stream = [_columns(np.random.default_rng(200 + k), b, k, fault_at=40) for k in range(n)]
    port, ref, seen = _pipes(CFG, flags.FlagEvaluator(_doc(FLAG_THRESHOLD, threshold)),
                             jflags.FlagEvaluator(_doc(FLAG_THRESHOLD, threshold)), batch_size=b)
    for k, cols in enumerate(stream):
        port.submit_columns(cols)
        ref.submit_columns(jtz.SpanColumns(*cols))
        port.pump(k * 0.25)
        ref.pump(k * 0.25)
    port.drain()
    ref.drain()
    assert [(t, names) for t, _, names in seen["port"]] == [(t, names) for t, _, names in seen["ref"]]
    cfg = DetectorConfig(**CFG)
    lifted = 0
    for t, report, names in seen["port"]:
        want, z, cusum = _recomputed(report, cfg, threshold)
        assert names == [f"svc-{i}" for i in np.nonzero(want)[0]], t
        lifted += int(((z > cfg.z_threshold) & ~(z > threshold) & cusum).any())
    if threshold > cfg.z_threshold:
        # The z-flag was lifted where the default would have raised it,
        # and the CUSUM alarm kept the service flagged there.
        assert lifted > 0
    assert port.stats.flag_events == ref.stats.flag_events > 0


# -- on the card -------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("spine_ring", [0, 2])
def test_the_gating_on_the_card_equals_the_cpu(cuda_device, spine_ring):
    """A disabled window and a raised threshold on the card, with and
    without the spine: the window leaves the state
    bit-identical and conserves rows, and the verdicts and the integer
    state equal the CPU run's."""
    b, n = 256, 60
    stream = [_columns(np.random.default_rng(300 + k), b, k, fault_at=40) for k in range(n)]
    runs = {}
    for device in (cuda_device, "cpu"):
        ev = flags.FlagEvaluator()
        seen = []
        pipe = DetectorPipeline(AnomalyDetector(DetectorConfig(**CFG), device=device), flags=ev, batch_size=b,
                                spine_ring=spine_ring,
                                on_report=lambda t, r, names, seen=seen: seen.append((t, names)))
        for k, cols in enumerate(stream):
            if k == 10:
                pipe.drain()
                before, spans = _port_state(pipe), pipe.stats.spans
                ev.replace(_doc(FLAG_ENABLED, False))
            if k == 15:
                after = _port_state(pipe)
                for key in before:
                    assert after[key].tobytes() == before[key].tobytes(), key
                assert pipe.stats.spans == spans
                ev.replace({"flags": {}})
            if k == 45:
                pipe.drain()
                ev.replace(_doc(FLAG_THRESHOLD, 1e6))
            pipe.submit_columns(cols)
            pipe.pump(k * 0.25)
        pipe.drain()
        assert pipe.stats.spans + pipe.stats.dropped_disabled == b * n
        assert pipe.stats.dropped_disabled == 5 * b
        runs[str(device)] = (seen, _port_state(pipe))
        pipe.close()
    (seen, state), (cseen, cstate) = runs["cuda"], runs["cpu"]
    assert seen == cseen
    for key, want in cstate.items():
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(state[key], want, err_msg=key)
        else:
            np.testing.assert_allclose(state[key], want, rtol=1e-4, atol=1e-5, err_msg=key)
