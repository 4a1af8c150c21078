"""The port's replay harness and shadow pre-flight against the reference.

``replaybench.record_incident`` and ``replay`` run in both packages on
the same seed at the reference's reduced geometry (S=8, hll_p=8, CMS
256, B=256): the recording runs' verdict maps, the replays' and the
shadow's must all be equal, and each package must replay the other's
recording. ``ShadowVerifier.verify`` with a would-help transform and a
wrong-service transform, and its fail-closed refusals, give equal
verdicts in both packages; ``suppress_transform`` gives equal columns.

Tolerance: verdicts are boolean flag tuples keyed by ``round(t, 6)`` and
compare exactly; columns compare bit for bit. Wall-clock numbers (wall,
speedup) are not compared.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.runtime import history as jhistory
from opentelemetry_demo_tpu.runtime import replaybench as jreplaybench
from opentelemetry_demo_tpu.runtime import shadow as jshadow
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu_torch.runtime import history, replaybench, shadow, tensorize

WARM, FAULT = 24, 24


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    """The same incident recorded by each package (48 batches)."""
    out = {}
    for name, mod, kw in (("port", replaybench, {"device": "cpu"}), ("reference", jreplaybench, {})):
        d = str(tmp_path_factory.mktemp(f"rec-{name}"))
        out[name] = (d, mod.record_incident(d, seed=3, warm_steps=WARM, fault_steps=FAULT, **kw))
    return out


def test_recording_runs_flag_alike(recordings):
    port, ref = recordings["port"][1], recordings["reference"][1]
    assert port == ref
    assert len(port) == WARM + FAULT
    assert any(any(f) for f in port.values())


@pytest.mark.parametrize("store_of", ["port", "reference"])
def test_each_package_replays_either_recording_as_recorded(recordings, store_of):
    d, recorded = recordings[store_of]
    got, _virtual, _wall, batches = replaybench.replay(d, device="cpu")
    want, _v, _w, ref_batches = jreplaybench.replay(d)
    assert batches == ref_batches == WARM + FAULT
    assert got == want == recorded


def test_span_corpus_files_are_equal(recordings):
    """Beyond the header's wall stamps (each recording's own clock) the
    span records are the same frames."""
    frames = {}
    for name, mod in (("port", history), ("reference", jhistory)):
        store = mod.HistoryStore(recordings[name][0])
        frames[name] = [store.read_frame(r) for r in store.records(kind=mod.KIND_SPANS)]
    assert len(frames["port"]) == len(frames["reference"]) == WARM + FAULT
    for p, r in zip(frames["port"], frames["reference"]):
        assert p.meta == r.meta
        for k in r.arrays:
            assert np.asarray(p.arrays[k]).tobytes() == np.asarray(r.arrays[k]).tobytes(), k


def test_range_query_measure_answers_alike(recordings):
    d = recordings["port"][0]
    got = replaybench.measure_range_queries(d, samples=5)
    want = jreplaybench.measure_range_queries(d, samples=5)
    assert set(got) == set(want) and got["history_range_query_samples"] == 5


def _verifiers(d, **kw):
    out = {}
    for name, mod, hmod, extra in (("port", shadow, history, {"device": "cpu"}),
                                   ("reference", jshadow, jhistory, {})):
        reader = hmod.HistoryReader(hmod.HistoryStore(d), rungs=(1.0, 60.0))
        recs = reader.span_records()
        now = recs[-1].t_end + 1.0
        kw2 = dict(dict(window_s=now - recs[0].t_start + 1.0, deadline_s=300.0, min_records=1), **kw)
        out[name] = (mod.ShadowVerifier(reader, replaybench._replay_config(), batch_size=replaybench.B,
                                        **kw2, **extra), now)
    return out


def _strip(v):
    return v._replace(wall_s=0.0, speedup=0.0)


@pytest.mark.parametrize("target", ["none", "would_help", "wrong_service"])
def test_verify_gives_the_reference_verdict(recordings, target):
    d, recorded = recordings["port"]
    idx = {"none": None, "would_help": replaybench.FAULT_SVC,
           "wrong_service": (replaybench.FAULT_SVC + 1) % replaybench.S}[target]
    got = {}
    for name, (verifier, now) in _verifiers(d).items():
        mod = shadow if name == "port" else jshadow
        got[name] = verifier.verify(replaybench.FAULT_SVC, None if idx is None else mod.suppress_transform(idx),
                                    now=now)
    assert _strip(got["port"]) == _strip(got["reference"])
    v = got["port"]
    assert v.batches == WARM + FAULT and v.records == WARM + FAULT
    if target == "none":
        assert v.verdicts == recorded and not v.would_help
    assert v.would_help is (target == "would_help")
    assert v.reason == (shadow.REASON_CLEARED if target == "would_help" else shadow.REASON_STILL_FLAGGED)


@pytest.mark.parametrize("case", ["insufficient", "deadline", "error"])
def test_refusals_fail_closed_alike(recordings, case):
    d = recordings["port"][0]
    kw = {"insufficient": {"min_records": 10_000}, "deadline": {"deadline_s": 0.0}, "error": {}}[case]

    def boom(cols):
        raise ValueError("transform failed")

    got = {}
    for name, (verifier, now) in _verifiers(d, **kw).items():
        got[name] = verifier.verify(replaybench.FAULT_SVC, boom if case == "error" else None, now=now)
        assert verifier.refusals == 1 and verifier.runs == 1
    assert _strip(got["port"])._replace(batches=0) == _strip(got["reference"])._replace(batches=0)
    assert not got["port"].would_help
    assert got["port"].reason == {"insufficient": shadow.REASON_INSUFFICIENT, "deadline": shadow.REASON_DEADLINE,
                                  "error": shadow.REASON_ERROR}[case]


@pytest.mark.parametrize("svc", [0, 5, 7])
def test_suppress_transform_gives_the_reference_columns(svc):
    rng = np.random.default_rng(svc)
    arrays = replaybench._make_cols(rng, 0, True)._asdict()
    got = shadow.suppress_transform(svc)(tensorize.SpanColumns(**arrays))
    want = jshadow.suppress_transform(svc)(jtz.SpanColumns(**arrays))
    for k in want._fields:
        g, w = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
    assert not np.asarray(got.is_error)[np.asarray(got.svc) == svc].any()


def test_refused_and_the_verdict_shape_match_the_reference():
    assert shadow.PreflightVerdict._fields == jshadow.PreflightVerdict._fields
    assert shadow.refused(shadow.REASON_DEADLINE, batches=3) == jshadow.refused(jshadow.REASON_DEADLINE, batches=3)
    assert shadow.PREFLIGHT_BUCKETS == jshadow.PREFLIGHT_BUCKETS


def test_the_replay_skips_a_corrupt_span_record_as_the_reference_does(tmp_path):
    counts = []
    for name, mod, hmod, kw in (("port", replaybench, history, {"device": "cpu"}),
                                ("reference", jreplaybench, jhistory, {})):
        d = str(tmp_path / name)
        mod.record_incident(d, warm_steps=8, fault_steps=8, **kw)
        store = hmod.HistoryStore(d)
        rec = store.records(kind=hmod.KIND_SPANS)[4]
        with open(rec.path, "r+b") as f:
            f.seek(rec.offset + rec.length // 2)
            byte = f.read(1)
            f.seek(rec.offset + rec.length // 2)
            f.write(bytes([byte[0] ^ 0xFF]))
        verdicts, _virtual, _wall, batches = mod.replay(d, **kw)
        counts.append((batches, sorted(verdicts)))
    assert counts[0] == counts[1] and counts[0][0] == 15


def test_the_warm_up_leaves_no_thread_behind(recordings):
    d = recordings["port"][0]
    before = {t.ident for t in threading.enumerate()}
    verifier, now = _verifiers(d)["port"]
    verifier.verify(replaybench.FAULT_SVC, None, now=now)
    replaybench.replay(d, device="cpu")
    assert {t.ident for t in threading.enumerate() if t.is_alive()} <= before


def test_the_shadow_pipeline_owns_its_own_state():
    collect: dict = {}
    det1, pipe1 = shadow.build_shadow_pipeline(replaybench._replay_config(), replaybench.B, collect, device="cpu")
    det2, _pipe2 = shadow.build_shadow_pipeline(replaybench._replay_config(), replaybench.B, {}, device="cpu")
    pipe1.submit_columns(replaybench._make_cols(np.random.default_rng(0), 0, False))
    pipe1.pump(0.0)
    pipe1.close()
    assert list(collect) == [0.0] and len(collect[0.0]) == replaybench.S
    assert int(det1.state.step_idx) == 1 and int(det2.state.step_idx) == 0
    assert det1.state.hll_bank.data_ptr() != det2.state.hll_bank.data_ptr()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_card_replay_equals_the_cpu_recording(recordings, cuda_device):
    d, recorded = recordings["port"]
    got, _virtual, _wall, batches = replaybench.replay(d, device=cuda_device)
    assert batches == WARM + FAULT and got == recorded
