"""The sketch kernels (K1 ``fused_update``, K3 ``sketch_delta``) at every
service count.

A warp's stats accumulators cover a tile of services in the 48 KB of
dynamic shared memory a block gets without opting in; past the tile the
kernel walks the services a tile at a time, and after the grid barrier
every block sums the partials of its own run of services and runs their
head cells. So shared memory does not grow with the service count, every
count gets whole warps, and the plan never refuses a count. The plan
tests pin that here on the CPU; the composed and plain paths at 2048 and
8192 services, and the detector step at 8192, equal the reference's; and
on the card (``gpu``) K1 and K3 at 2048-16384 services equal their plain
versions (banks exact, floats within rtol 1e-4 / atol 1e-5).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import detector as jdet
from opentelemetry_demo_tpu.ops import cms as jcms
from opentelemetry_demo_tpu.ops import fused as jfused
from opentelemetry_demo_tpu.ops import hashing as jhashing
from opentelemetry_demo_tpu.runtime.tensorize import SpanTensorizer as JSpanTensorizer
from opentelemetry_demo_tpu_torch.models import detector as tdet
from opentelemetry_demo_tpu_torch.ops import _kernels, fused

RTOL, ATOL = 1e-4, 1e-5
HEAD_KW = dict(taus_s=(1.0, 10.0, 60.0), warmup_batches=20.0, z_warmup_batches=60.0,
               cusum_k=0.5, cusum_cap=50.0, err_slack=0.01)
# The widths the main path, the benches and the soaks launch at.
MAIN_WIDTHS = (1, 31, 256, 1024, 2048, 4096, 8192, 32768, 65536)
SMEM_DEFAULT = 48 * 1024  # bytes a block gets without opting in to more


def _grid_and_lanes(b, n_sms=_kernels.N_SMS):
    """The grid and a block's run of lanes, as every plan has had them: at
    least 128 lanes, whole warp slices, at most a block per SM."""
    per_sm = -(-b // n_sms)
    lanes = max(128, -(-per_sm // 32) * 32)
    return max(1, -(-b // lanes)), lanes


def _check_flat(plan, b, s, n_sms=_kernels.N_SMS):
    """Whole warps (a thread per lane up to 512) and shared memory that
    the tile, not the service count, sizes."""
    grid, lanes = _grid_and_lanes(b, n_sms)
    assert (plan.grid, plan.lanes_per_block) == (grid, lanes)
    assert plan.threads == min(512, lanes)
    warps = plan.threads // 32
    assert 1 <= plan.tile <= s
    assert plan.smem_bytes == (warps * (4 * plan.tile + 64) + plan.threads) * 4 <= SMEM_DEFAULT
    # The tile is every service, or as many as 48 KB holds.
    one_more = (warps * (4 * (plan.tile + 1) + 64) + plan.threads) * 4
    assert plan.tile == s or one_more > SMEM_DEFAULT


@pytest.mark.parametrize("s", [8, 32, 512, 1524])
@pytest.mark.parametrize("n_sms", [114, 132])
def test_the_plan_below_the_ceiling_is_unchanged(s, n_sms):
    """qualbench (S=8), the main path (S=32), the churn soak (S=512) and
    1524 (once the last count one warp's stats fitted in 48 KB): the same
    grid and runs of lanes as every plan before, so each block owns the
    same lanes, now with whole warps at every count; at S=8 and 32 every
    service lies in one tile, so a block sums its warps as before."""
    for b in MAIN_WIDTHS:
        plan = fused.launch_plan(b, s, n_sms)
        _check_flat(plan, b, s, n_sms)
        if s <= 32:
            assert plan.tile == s


@pytest.mark.parametrize("s", [1525, 2048, 4096, 7252])
def test_above_the_ceiling_the_plan_opts_in_within_the_limit(s):
    """Past the count one warp's stats once fitted in 48 KB, the plan
    needs no opt-in: it stays within the default 48 KB with whole warps,
    and K1 and K3, launched with the same plan, sum in one order."""
    for b in MAIN_WIDTHS:
        plan = fused.launch_plan(b, s)
        _check_flat(plan, b, s)
        assert plan.tile < s
        assert 1 <= plan.grid <= _kernels.N_SMS
        assert fused.launch_plan(b, s) == plan


def test_the_soaks_geometry_takes_two_warps_a_block():
    """The million-key soak's geometry (B = 4096, 4096 services) once got
    two warps a block and 197,376 B of shared memory; it now gets a warp
    per 32 lanes (four) and 48 KB, walking its services in tiles of 744."""
    assert fused.launch_plan(4096, 4096) == fused.SketchPlan(32, 128, 128, 49152, 744)


@pytest.mark.parametrize("s", [1525, 2048, 4096, 7253, 8192, 16384, 65536])
def test_every_service_count_plans_in_flat_shared_memory(s):
    """No service count is refused, and shared memory does not grow with
    the count: past the tile, the plan at ``s`` is the plan at 65,536."""
    for b in MAIN_WIDTHS:
        plan = fused.launch_plan(b, s)
        _check_flat(plan, b, s)
        wide = fused.launch_plan(b, 65536)
        assert plan.smem_bytes <= wide.smem_bytes <= SMEM_DEFAULT
        if plan.tile < s:
            assert plan == wide


def _batch(rng, b, s, d, w):
    t_hi, t_lo = jhashing.split_hi_lo_np(jhashing.splitmix64_np(rng.integers(0, 2**63, size=b, dtype=np.uint64)))
    a_hi, a_lo = jhashing.split_hi_lo_np(jhashing.splitmix64_np(rng.integers(0, 2**20, size=b, dtype=np.uint64)))
    return dict(
        svc=rng.integers(-3, s + 3, size=b).astype(np.int32),
        log_lat=rng.gamma(2.0, 1.0, size=b).astype(np.float32),
        is_error=(rng.random(b) < 0.1).astype(np.float32),
        trace_hi=t_hi, trace_lo=t_lo,
        cidx=jcms.cms_indices_np(a_hi, a_lo, d, w),
        valid=rng.random(b) < 0.9,
    )


def _torch_args(batch):
    return [torch.from_numpy(np.ascontiguousarray(v, np.uint32).view(np.int32)) if k in ("trace_hi", "trace_lo")
            else torch.from_numpy(v) for k, v in batch.items()]


def test_the_composed_path_at_2048_services_equals_the_reference():
    """The plain path the card's kernel is held against, at a service
    count past the old ceiling: banks bit-exact, stats within tolerance."""
    rng = np.random.default_rng(3)
    b, s, p, d, w = 2048, 2048, 8, 4, 1024
    kw = dict(num_services=s, hll_p=p, cms_width=w)
    batch = _batch(rng, b, s, d, w)
    hll_cur = rng.integers(0, 20, size=(3, s, 1 << p)).astype(np.int32)
    cms_cur = rng.integers(0, 1000, size=(3, d, w)).astype(np.int32)
    ref = jfused.sketch_batch_update(jnp.asarray(hll_cur), jnp.asarray(cms_cur),
                                     *(jnp.asarray(v) for v in batch.values()), impl="xla", **kw)
    got_hll, got_cms = torch.from_numpy(hll_cur.copy()), torch.from_numpy(cms_cur.copy())
    got = fused.sketch_batch_update(got_hll, got_cms, *_torch_args(batch), impl="pallas", **kw)
    np.testing.assert_array_equal(np.asarray(ref[0]), got_hll.numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), got_cms.numpy())
    np.testing.assert_allclose(np.asarray(ref[2]), got[2].numpy(), rtol=RTOL, atol=ATOL)


def _heads_np(rng, s, t=3):
    return dict(
        lat_mean=rng.gamma(2.0, 1.0, (s, t)), lat_var=rng.gamma(1.0, 0.2, (s, t)),
        err_mean=rng.random((s, t)) * 0.2, rate_mean=rng.gamma(3.0, 10.0, (s, t)),
        rate_var=rng.gamma(1.0, 5.0, (s, t)), cusum=rng.random((s, 3)) * 3.0,
        obs_batches=rng.integers(0, 42, s),
    )


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_the_composed_path_at_8192_services_equals_the_reference(impl):
    """Past the service count the old plan refused (7,252): the port's
    composed path and the kernel's plain version (the CPU side of
    ``pallas``) with the head fold, against the reference's composed path
    at S = 8192, p = 4, CMS 4 × 1024: banks bit-exact, stats, heads and
    z's within tolerance."""
    rng = np.random.default_rng(11)
    b, s, p, d, w = 2048, 8192, 4, 4, 1024
    kw = dict(num_services=s, hll_p=p, cms_width=w)
    batch = _batch(rng, b, s, d, w)
    hll_cur = rng.integers(0, 20, size=(3, s, 1 << p)).astype(np.int32)
    cms_cur = rng.integers(0, 1000, size=(3, d, w)).astype(np.int32)
    heads = {k: np.asarray(v, np.float32) for k, v in _heads_np(rng, s).items()}
    ref = jfused.sketch_batch_update(
        jnp.asarray(hll_cur), jnp.asarray(cms_cur), *(jnp.asarray(v) for v in batch.values()), impl="xla",
        heads=jfused.HeadState(**{k: jnp.asarray(v) for k, v in heads.items()}),
        dt=jnp.float32(0.25), step_pos=jnp.asarray(True), **HEAD_KW, **kw,
    )
    got_heads = fused.HeadState(**{k: torch.from_numpy(v.copy()) for k, v in heads.items()})
    got = fused.sketch_batch_update(
        torch.from_numpy(hll_cur.copy()), torch.from_numpy(cms_cur.copy()), *_torch_args(batch), impl=impl,
        heads=got_heads, dt=0.25, step_pos=True, **HEAD_KW, **kw,
    )
    np.testing.assert_array_equal(np.asarray(ref[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())
    np.testing.assert_allclose(np.asarray(ref[2]), got[2].numpy(), rtol=RTOL, atol=ATOL)
    for name, r, g in zip(ref[3]._fields, ref[3], got_heads):
        np.testing.assert_allclose(np.asarray(r), g.numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
    for r, g in zip(ref[4], got[4]):
        np.testing.assert_allclose(np.asarray(r), g.numpy(), rtol=RTOL, atol=ATOL)


# A few of the 8192 slots carry traffic, among them the last ones, so the
# kernel's runs of services at both ends of the range hold live services.
LIVE = np.array([0, 1, 2, 3, 4095, 4096, 8190, 8191], np.int32)


def _stream_8192(rng, n_steps, b=512, s=8192, slow=8190):
    """Packed batches over the ``LIVE`` slots, ``slow`` ×5 from half way."""
    tz = JSpanTensorizer(num_services=s, batch_size=b)
    out = []
    for step in range(n_steps):
        n = b - 5
        svc = LIVE[rng.integers(0, len(LIVE), size=n)]
        lat = rng.gamma(4.0, 250.0, size=n).astype(np.float32)
        if step >= n_steps // 2:
            lat = np.where(svc == slow, lat * 5.0, lat).astype(np.float32)
        batch = tz.pack_arrays(
            svc=svc, lat_us=lat,
            trace_id=rng.integers(0, 200, size=n, dtype=np.uint64) * 2654435761 + 1,
            is_error=(rng.random(n) < 0.05).astype(np.float32),
            attr_key=rng.zipf(1.5, size=n).astype(np.uint64),
        )
        batch.svc[:2] = [s, -1]
        out.append(batch)
    return out


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_the_detector_step_at_8192_services_equals_the_reference(impl):
    """``detector_step`` at ``num_services=8192`` (p = 4, CMS 4 × 1024,
    short windows and warm-ups) on the same numpy-seeded batches as the
    reference's: integer state bit-exact, floats within tolerance, flags
    identical on every step, and the ×5 latency step flagged."""
    kw = dict(num_services=8192, hll_p=4, cms_width=1024, windows_s=(0.5, 1.0, 2.5),
              warmup_batches=3.0, z_warmup_batches=5.0, warmup_windows=1.0)
    ref = jdet.AnomalyDetector(jdet.DetectorConfig(**kw, sketch_impl="xla"))
    got = tdet.AnomalyDetector(tdet.DetectorConfig(**kw, sketch_impl=impl), device="cpu")
    flagged = set()
    for step, batch in enumerate(_stream_8192(np.random.default_rng(12), 12)):
        t = 100.0 + step * 0.25
        r, g = ref.observe(batch, t), got.observe(batch, t)
        np.testing.assert_array_equal(np.asarray(r.flags), g.flags.numpy(), err_msg=f"flags @ {step}")
        flagged.update(int(i) for i in np.flatnonzero(np.asarray(r.flags)))
        rs, gs = ref.state, tdet.state_to_numpy(got.state)
        for name in jdet.DetectorState._fields:
            a, c = np.asarray(getattr(rs, name)), np.asarray(getattr(gs, name))
            assert a.dtype == c.dtype and a.shape == c.shape, name
            if a.dtype.kind in "iu" or name == "span_total":
                np.testing.assert_array_equal(a, c, err_msg=f"{name} @ {step}")
            else:
                np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL, err_msg=f"{name} @ {step}")
    assert 8190 in flagged


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    return torch.device("cuda")


# (B, S, HLL p, CMS width): the million-key soak's geometry at 2048-16384
# services, and 8192 services at the default p and CMS width.
CARD_GEOMETRIES = [pytest.param(4096, s, 8, 1024, id=str(s)) for s in (2048, 4096, 8192, 16384)] + [
    pytest.param(2048, 8192, 12, 8192, id="8192-p12-cms8192")]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,p,w", CARD_GEOMETRIES)
def test_fused_update_kernel_above_the_ceiling_matches_plain(cuda_device, b, s, p, w):
    """K1 with heads (CMS depth 4), twice, against its plain version:
    banks exact, floats within tolerance, the two launches bit-identical."""
    rng = np.random.default_rng(s + p)
    d = 4
    args = [t.to(cuda_device) for t in _torch_args(_batch(rng, b, s, d, w))]
    hll_bank = torch.from_numpy(rng.integers(0, 20, (3, s, 1 << p)).astype(np.int32)).to(cuda_device)
    cms_bank = torch.from_numpy(rng.integers(0, 99, (3, d, w)).astype(np.int32)).to(cuda_device)
    heads = _heads_np(rng, s)
    before = _kernels.LAUNCHES["fused_update"]
    outs = []
    for update in (fused.fused_update, fused.fused_update, fused.fused_update_plain):
        hb, cb = hll_bank.clone(), cms_bank.clone()
        hs = fused.HeadState(**{k: torch.from_numpy(np.asarray(v, np.float32)).to(cuda_device)
                                for k, v in heads.items()})
        stats, zs = update(
            hb, cb, *args, num_services=s, hll_p=p, heads=hs, dt=torch.tensor(0.25, device=cuda_device),
            step_pos=torch.tensor(3, dtype=torch.int32, device=cuda_device), statics=HEAD_KW,
        )
        torch.cuda.synchronize()
        outs.append([hb.cpu(), cb.cpu(), stats.cpu(), *(h.cpu() for h in hs), *(z.cpu() for z in zs)])
    assert _kernels.LAUNCHES["fused_update"] == before + 2
    kernel, again, plain = outs
    assert torch.equal(kernel[0], plain[0]) and torch.equal(kernel[1], plain[1])
    for a, b_ in zip(kernel[2:], plain[2:]):
        np.testing.assert_allclose(b_.numpy(), a.numpy(), rtol=RTOL, atol=ATOL)
    assert all(torch.equal(a, b_) for a, b_ in zip(kernel, again))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,p,w", CARD_GEOMETRIES)
def test_sketch_delta_kernel_above_the_ceiling_matches_plain(cuda_device, b, s, p, w):
    """K3 twice against its plain version: integers exact, stats within
    tolerance, the two launches bit-identical, and the stats bit for bit
    K1's on the same batch (one plan, one summing order)."""
    rng = np.random.default_rng(7 + s + p)
    d = 4
    args = [t.to(cuda_device) for t in _torch_args(_batch(rng, b, s, d, w))]
    kw = dict(num_services=s, hll_p=p, cms_width=w)
    got = fused.sketch_delta(*args, **kw)
    again = fused.sketch_delta(*args, **kw)
    want = fused.sketch_delta_plain(*args, **kw)
    k1_stats = fused.fused_update(
        torch.zeros((1, s, 1 << p), dtype=torch.int32, device=cuda_device),
        torch.zeros((1, d, w), dtype=torch.int32, device=cuda_device), *args, num_services=s, hll_p=p,
    )
    torch.cuda.synchronize()
    assert torch.equal(got.hll, want.hll) and torch.equal(got.cms, want.cms)
    np.testing.assert_allclose(want.stats.cpu().numpy(), got.stats.cpu().numpy(), rtol=RTOL, atol=ATOL)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert torch.equal(got.stats, k1_stats)
