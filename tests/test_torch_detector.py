"""The PyTorch port's detector step against the JAX reference.

Both detectors see the same batches (packed with numpy from a seed) at
the same virtual times. Integer sketch state (HLL/CMS banks, the step
counter) and ``span_total`` must match bit for bit; float heads and
reports within the tolerance stated below; flags exactly.
"""

import jax
import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import detector as jdet
from opentelemetry_demo_tpu.runtime import qualbench
from opentelemetry_demo_tpu.runtime.tensorize import SpanTensorizer as JSpanTensorizer
from opentelemetry_demo_tpu_torch import resolve_device
from opentelemetry_demo_tpu_torch.models import detector as tdet
from opentelemetry_demo_tpu_torch.ops import _kernels
from opentelemetry_demo_tpu_torch.ops import cms as tcms
from opentelemetry_demo_tpu_torch.ops import ewma as tewma
from opentelemetry_demo_tpu_torch.ops import hashing as thashing
from opentelemetry_demo_tpu_torch.ops import hll as thll

# float32 sums taken in another order (one-hot products, per-block
# partials), and exp/log/sqrt from another math library, move each step
# by a few ulp; compounded over 20 chained EWMA steps that stays well
# inside 1e-4 relative / 1e-5 absolute.
RTOL, ATOL = 1e-4, 1e-5

INT_FIELDS = ("hll_bank", "cms_bank", "step_idx")
# span_total counts whole spans in float32: exact below 2**24.
EXACT_FIELDS = INT_FIELDS + ("span_total",)

# Small geometry, short windows (rotations every few steps at dt=0.25)
# and short warmups, so 20 steps exercise rotation, the card EWMA, both
# z gates and the CUSUM lanes.
SMALL = dict(
    num_services=8, hll_p=8, cms_width=512, windows_s=(0.5, 1.0, 2.5),
    warmup_batches=3.0, z_warmup_batches=5.0, warmup_windows=1.0,
)
DT = 0.25


def _configs(**kw):
    return jdet.DetectorConfig(**kw), tdet.DetectorConfig(**kw)


def _stream(rng, n_steps, b=256, s=8, out_of_range=True):
    """``n_steps`` packed batches; a few lanes carry service ids outside
    ``[0, S)`` (they count in the CMS only) and a few are padding."""
    tz = JSpanTensorizer(num_services=s, batch_size=b)
    out = []
    for step in range(n_steps):
        n = b - 7
        svc = rng.integers(0, s, size=n).astype(np.int32)
        lat = rng.gamma(4.0, 250.0, size=n).astype(np.float32)
        if step >= n_steps // 2:
            lat = np.where(svc == 2, lat * 5.0, lat).astype(np.float32)
        batch = tz.pack_arrays(
            svc=svc,
            lat_us=lat,
            trace_id=rng.integers(0, 200, size=n, dtype=np.uint64) * 2654435761 + 1,
            is_error=(rng.random(n) < 0.05).astype(np.float32),
            attr_key=rng.zipf(1.5, size=n).astype(np.uint64),
        )
        if out_of_range:
            batch.svc[:3] = [s, s + 5, -1]
        out.append(batch)
    return out


def _state_np(state):
    return jax.device_get(state)


def _assert_state(ref, got, step):
    for name in jdet.DetectorState._fields:
        r, g = np.asarray(getattr(ref, name)), np.asarray(getattr(got, name))
        assert r.dtype == g.dtype and r.shape == g.shape, name
        if name in EXACT_FIELDS:
            np.testing.assert_array_equal(r, g, err_msg=f"{name} @ step {step}")
        else:
            np.testing.assert_allclose(r, g, rtol=RTOL, atol=ATOL, err_msg=f"{name} @ step {step}")


def _assert_report(ref, got, step):
    for name in jdet.DetectorReport._fields:
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        if name == "flags":
            np.testing.assert_array_equal(r, g, err_msg=f"flags @ step {step}")
        else:
            np.testing.assert_allclose(r, g, rtol=RTOL, atol=ATOL, err_msg=f"{name} @ step {step}")


@pytest.mark.parametrize("impl", ["xla", "interpret", "pallas"])
def test_twenty_chained_steps_match_reference(rng, impl):
    """20 steps with rotations of every window: the port (composed path,
    plain fused update, and the kernel wrapper's CPU path) against the
    reference's composed path."""
    jcfg, tcfg = _configs(**SMALL, sketch_impl=None)
    tcfg = tcfg._replace(sketch_impl=impl)
    ref = jdet.AnomalyDetector(jcfg)
    got = tdet.AnomalyDetector(tcfg, device="cpu")
    for step, batch in enumerate(_stream(rng, 20)):
        t = 100.0 + step * DT
        _assert_report(ref.observe(batch, t), got.observe(batch, t), step)
        _assert_state(_state_np(ref.state), tdet.state_to_numpy(got.state), step)
    final = tdet.state_to_numpy(got.state)
    assert int(final.step_idx) == 20
    assert (final.hll_bank[:, 1] > 0).any(), "no window rotated in 20 steps"


@pytest.mark.parametrize("cms_width", [16384, 32768])
def test_wide_cms_steps_match_reference(rng, cms_width):
    """The composed path at 65,536 and 131,072 CMS bins (D = 4), which
    the reference counts and its daemon takes from ``ANOMALY_CMS_WIDTH``:
    the port's CMS count equals the reference's."""
    jcfg, tcfg = _configs(**dict(SMALL, cms_width=cms_width), sketch_impl=None)
    tcfg = tcfg._replace(sketch_impl="xla")
    ref = jdet.AnomalyDetector(jcfg)
    got = tdet.AnomalyDetector(tcfg, device="cpu")
    for step, batch in enumerate(_stream(rng, 3)):
        t = 20.0 + step * DT
        _assert_report(ref.observe(batch, t), got.observe(batch, t), step)
        _assert_state(_state_np(ref.state), tdet.state_to_numpy(got.state), step)


def test_chained_steps_match_reference_pallas_interpret(rng):
    """The reference's own fused Pallas kernel (interpret mode) against
    the port's kernel wrapper on the CPU."""
    kw = dict(SMALL)
    jcfg, tcfg = _configs(**kw, sketch_impl="interpret")
    tcfg = tcfg._replace(sketch_impl="pallas")
    ref = jdet.AnomalyDetector(jcfg)
    got = tdet.AnomalyDetector(tcfg, device="cpu")
    for step, batch in enumerate(_stream(rng, 8)):
        t = 50.0 + step * DT
        _assert_report(ref.observe(batch, t), got.observe(batch, t), step)
        _assert_state(_state_np(ref.state), tdet.state_to_numpy(got.state), step)


def test_state_carries_over_both_ways(rng):
    """The reference runs 10 steps; its state, pulled to numpy, continues
    in the port; then both step 10 more and agree. The port's state goes
    back to the reference bit for bit."""
    jcfg, tcfg = _configs(**SMALL)
    ref = jdet.AnomalyDetector(jcfg)
    batches = _stream(rng, 20)
    for step, batch in enumerate(batches[:10]):
        ref.observe(batch, 10.0 + step * DT)
    got = tdet.AnomalyDetector(tcfg, device="cpu")
    got.state = tdet.state_from_numpy(_state_np(ref.state), device="cpu")
    got.clock._t_prev = ref.clock._t_prev
    _assert_state(_state_np(ref.state), tdet.state_to_numpy(got.state), 10)
    for step, batch in enumerate(batches[10:], start=10):
        t = 10.0 + step * DT
        _assert_report(ref.observe(batch, t), got.observe(batch, t), step)
        _assert_state(_state_np(ref.state), tdet.state_to_numpy(got.state), step)
    back = jdet.DetectorState(**tdet.state_to_numpy(got.state)._asdict())
    for name in jdet.DetectorState._fields:
        g = getattr(got.state, name).numpy()
        b = np.asarray(getattr(back, name))
        assert b.dtype == g.dtype
        np.testing.assert_array_equal(
            np.atleast_1d(b).view(np.uint8), np.atleast_1d(g).view(np.uint8), err_msg=name
        )


def test_state_from_numpy_is_a_copy(rng):
    jcfg, tcfg = _configs(**SMALL)
    src = _state_np(jdet.detector_init(jcfg))
    state = tdet.state_from_numpy(src, device="cpu")
    state.cms_bank.add_(1)
    assert int(np.asarray(src.cms_bank).sum()) == 0


_STATE_NP = tdet.DetectorState(*(np.zeros(1, np.float32) for _ in tdet.DetectorState._fields))
_DEFAULT_DEVICE_CALLS = {
    "detector_init": lambda: tdet.detector_init(tdet.DetectorConfig(**SMALL)),
    "state_from_numpy": lambda: tdet.state_from_numpy(_STATE_NP),
    "hll_init": lambda: thll.hll_init(4, p=8),
    "cms_init": lambda: tcms.cms_init(2, 64),
    "ewma_init": lambda: tewma.ewma_init(4, 3),
    "hash_spans_synthetic": lambda: thashing.hash_spans_synthetic(0, 16),
}


@pytest.mark.parametrize("name", sorted(_DEFAULT_DEVICE_CALLS))
def test_device_none_means_the_card(monkeypatch, name):
    """With no device named, each entry point takes the card, and without
    one it raises instead of carrying on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _DEFAULT_DEVICE_CALLS[name]()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_reference_report_unpack_reads_the_packed_report(rng):
    jcfg, tcfg = _configs(**SMALL)
    got = tdet.AnomalyDetector(tcfg, device="cpu")
    ref = jdet.AnomalyDetector(jcfg)
    for step, batch in enumerate(_stream(rng, 12)):
        t = step * DT
        flat = got.observe_packed(batch, t)
        ref_flat = np.asarray(ref.observe_packed(batch, t))
    assert flat.dtype == torch.float32 and flat.dim() == 1
    assert flat.shape[0] == ref_flat.shape[0]
    by_ref = jdet.report_unpack(flat.numpy(), jcfg)
    by_port = tdet.report_unpack(flat.numpy(), tcfg)
    for name in jdet.DetectorReport._fields:
        np.testing.assert_array_equal(getattr(by_ref, name), getattr(by_port, name), err_msg=name)
    np.testing.assert_allclose(ref_flat, flat.numpy(), rtol=RTOL, atol=ATOL)


def test_report_unpack_rejects_a_drifted_layout():
    _, tcfg = _configs(**SMALL)
    with pytest.raises(ValueError, match="packed report length"):
        tdet.report_unpack(np.zeros(1000, np.float32), tcfg)


def test_config_mirrors_the_reference_field_for_field():
    assert tdet.DetectorConfig._fields == jdet.DetectorConfig._fields
    assert tuple(tdet.DetectorConfig()) == tuple(jdet.DetectorConfig())
    assert tdet.DetectorState._fields == jdet.DetectorState._fields
    assert tdet.DetectorReport._fields == jdet.DetectorReport._fields
    c = tdet.DetectorConfig(num_services=8, taus_s=(2.0, 30.0))
    assert (c.num_windows, c.num_taus, c.cusum_thresholds) == (3, 2, (5.0, 5.0, 8.0))


@pytest.mark.parametrize("b_total,bq", [(100, 100), (65536, 16384), (524288, 16384), (6000, 4096)])
def test_hh_sample_indices_equal_reference(b_total, bq):
    np.testing.assert_array_equal(
        tdet.hh_sample_indices(b_total, bq), jdet.hh_sample_indices(b_total, bq)
    )


def test_heavy_hitter_candidates_are_sampled_past_the_cap(rng):
    """A batch wider than HH_QUERY_CAP takes the strided candidate
    subsample; the port forms the indices on the device and must agree
    with the reference."""
    cfg = dict(SMALL, cms_width=512)
    jcfg, tcfg = _configs(**cfg)
    b = jdet.HH_QUERY_CAP + 3000
    ref = jdet.AnomalyDetector(jcfg)
    got = tdet.AnomalyDetector(tcfg, device="cpu")
    for step, batch in enumerate(_stream(rng, 2, b=b, out_of_range=False)):
        _assert_report(ref.observe(batch, step * DT), got.observe(batch, step * DT), step)


# -- verdicts: the reference's detection-quality scenarios ----------------


@pytest.mark.parametrize(
    "scenario", ["imageSlowLoad", "paymentFailure", "traceCardinalityExplosion"]
)
def test_verdicts_match_reference_on_quality_scenarios(scenario):
    """Warm up 120 steps, inject the fault, run to the first flag on the
    faulted service: the per-batch flags and the time to detect are the
    reference's, exactly."""
    rng = np.random.default_rng(0)
    fault_svc, mutate = qualbench.fault_shapes(rng)[scenario]
    jcfg = qualbench._quality_config()
    ref = jdet.AnomalyDetector(jcfg)
    got = tdet.AnomalyDetector(tdet.DetectorConfig(*jcfg), device="cpu")
    tz = JSpanTensorizer(num_services=qualbench.S, batch_size=qualbench.B)
    ttd = {}
    for step in range(qualbench.WARM_STEPS + qualbench.FAULT_WINDOW_STEPS):
        k = step - qualbench.WARM_STEPS
        batch = qualbench._batch(rng, tz, mutate=mutate if k >= 0 else None, step=max(k, 0))
        t = step * qualbench.DT_S
        r_flags = np.asarray(ref.observe(batch, t).flags)
        g_flags = got.observe(batch, t).flags.numpy()
        np.testing.assert_array_equal(r_flags, g_flags, err_msg=f"flags @ step {step}")
        for who, flags in (("ref", r_flags), ("port", g_flags)):
            if k >= 0 and flags[fault_svc] and who not in ttd:
                ttd[who] = k + 1
        if len(ttd) == 2:
            break
    assert "port" in ttd, f"{scenario} never flagged service {fault_svc}"
    assert ttd["port"] == ttd["ref"]


# -- the card is the default ----------------------------------------------


def test_entry_point_defaults_to_the_card():
    """Without a device argument the detector runs on CUDA; with no card
    it raises rather than carrying on on the CPU."""
    cfg = tdet.DetectorConfig(**SMALL)
    if torch.cuda.is_available():
        assert tdet.AnomalyDetector(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdet.AnomalyDetector(cfg)
    assert tdet.AnomalyDetector(cfg, device="cpu").device.type == "cpu"


def test_unported_mesh_step_raises(rng):
    """Any comm but NO_COMM takes the mesh (delta) path: an unknown merge
    raises before any reduction, and a comm with no groups — every
    reduction the identity — equals the single-device step over chained
    steps (integer state bit-exact), for every sketch impl."""
    from opentelemetry_demo_tpu_torch.ops.collectives import NO_COMM, Comm

    cfg = tdet.DetectorConfig(**SMALL)
    det = tdet.AnomalyDetector(cfg, device="cpu")
    args = det._args(_stream(rng, 1)[0], 0.0)
    with pytest.raises(ValueError, match="merge_impl"):
        tdet.detector_step(cfg, det.state, *args, comm=Comm(merge_impl="rign"))

    unsharded = Comm()
    assert unsharded == NO_COMM and unsharded is not NO_COMM
    batches = _stream(rng, 8)
    for impl in ("xla", "interpret", "pallas"):
        cfg = tdet.DetectorConfig(**SMALL, sketch_impl=impl)
        one, delta = (tdet.AnomalyDetector(cfg, device="cpu") for _ in range(2))
        for step, batch in enumerate(batches):
            t = 10.0 + step * DT
            args = one._args(batch, t)
            _, rep_one = tdet.detector_step(cfg, one.state, *args)
            _, rep_delta = tdet.detector_step(cfg, delta.state, *args, comm=unsharded)
            _assert_report(rep_one, rep_delta, step)
            _assert_state(tdet.state_to_numpy(one.state), tdet.state_to_numpy(delta.state), step)


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("impl,kernel", [(None, "fused_update"), ("xla", "cms_hist")])
def test_detector_on_the_card_matches_the_cpu(rng, cuda_device, impl, kernel):
    cfg = tdet.DetectorConfig(**SMALL, sketch_impl=impl)
    card = tdet.AnomalyDetector(cfg)
    cpu = tdet.AnomalyDetector(cfg._replace(sketch_impl="xla"), device="cpu")
    before = _kernels.LAUNCHES[kernel]
    for step, batch in enumerate(_stream(rng, 12)):
        g = card.observe(batch, step * DT)
        c = cpu.observe(batch, step * DT)
        torch.cuda.synchronize()
        _assert_report(c, tdet.DetectorReport(*(x.cpu() for x in g)), step)
    assert _kernels.LAUNCHES[kernel] >= before + 12
    _assert_state(tdet.state_to_numpy(cpu.state), tdet.state_to_numpy(card.state), 12)


@pytest.mark.gpu
@pytest.mark.parametrize("cms_width", [16384, 32768])
def test_wide_cms_on_the_card_matches_the_cpu(rng, cuda_device, cms_width):
    """``sketch_impl="xla"`` at 65,536 and 131,072 CMS bins on the card,
    where the histogram kernel once raised past 58,112 bins (it kept
    every bin in shared memory): each step equals the CPU's."""
    cfg = tdet.DetectorConfig(**dict(SMALL, cms_width=cms_width), sketch_impl="xla")
    card = tdet.AnomalyDetector(cfg)
    cpu = tdet.AnomalyDetector(cfg, device="cpu")
    before = _kernels.LAUNCHES["cms_hist"]
    for step, batch in enumerate(_stream(rng, 3)):
        g = card.observe(batch, step * DT)
        c = cpu.observe(batch, step * DT)
        torch.cuda.synchronize()
        _assert_report(c, tdet.DetectorReport(*(x.cpu() for x in g)), step)
        _assert_state(tdet.state_to_numpy(cpu.state), tdet.state_to_numpy(card.state), step)
    assert _kernels.LAUNCHES["cms_hist"] == before + 3
