"""The sketch kernels (K1 ``fused_update``, K3 ``sketch_delta``) above
1,524 services.

Up to 1,524 services one warp's stats fit in the 48 KB of dynamic shared
memory a block gets without opting in, and the launch plan is what it
always was, so the summing order of every path below that count does
not move. Above it the plan budgets against the card's opt-in limit
(``_kernels.SMEM_LIMIT``; the launch opts the kernel in), up to 7,252
services. The plan tests pin both halves here on the CPU; the composed
path at 2048 services equals the reference's; and on the card (``gpu``)
K1 and K3 at 4096 services equal their plain versions (banks exact,
floats within rtol 1e-4 / atol 1e-5).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.ops import cms as jcms
from opentelemetry_demo_tpu.ops import fused as jfused
from opentelemetry_demo_tpu.ops import hashing as jhashing
from opentelemetry_demo_tpu_torch.ops import _kernels, fused

RTOL, ATOL = 1e-4, 1e-5
HEAD_KW = dict(taus_s=(1.0, 10.0, 60.0), warmup_batches=20.0, z_warmup_batches=60.0,
               cusum_k=0.5, cusum_cap=50.0, err_slack=0.01)
# The widths the main path, the benches and the soaks launch at.
MAIN_WIDTHS = (1, 31, 256, 1024, 2048, 4096, 8192, 32768, 65536)


def _plan_within_48kb(b, s, n_sms=_kernels.N_SMS):
    """The launch plan as it was before the opt-in: one warp's stats
    must fit in 48 KB."""
    per_sm = -(-b // n_sms)
    lanes = max(128, -(-per_sm // 32) * 32)
    max_warps = (48 * 1024 // 4 - 4 * s) // (4 * s + 96)
    assert max_warps >= 1
    threads = min(512, lanes, 32 * max_warps)
    smem = ((threads // 32) * (4 * s + 64) + threads + 4 * s) * 4
    return fused.SketchPlan(max(1, -(-b // lanes)), threads, lanes, smem)


@pytest.mark.parametrize("s", [8, 32, 512, 1524])
@pytest.mark.parametrize("n_sms", [114, 132])
def test_the_plan_below_the_ceiling_is_unchanged(s, n_sms):
    """qualbench (S=8), the main path (S=32), the churn soak (S=512) and
    the last count one warp fits in 48 KB: the same grid, threads and
    shared memory as before, so the summing order does not move."""
    for b in MAIN_WIDTHS:
        plan = fused.launch_plan(b, s, n_sms)
        assert plan == _plan_within_48kb(b, s, n_sms)
        assert plan.smem_bytes <= 48 * 1024


@pytest.mark.parametrize("s", [1525, 2048, 4096, 7252])
def test_above_the_ceiling_the_plan_opts_in_within_the_limit(s):
    for b in MAIN_WIDTHS:
        plan = fused.launch_plan(b, s)
        assert 48 * 1024 < plan.smem_bytes <= _kernels.SMEM_LIMIT
        warps = plan.threads // 32
        assert warps >= 1 and plan.smem_bytes == (warps * (4 * s + 64) + plan.threads + 4 * s) * 4
        # As many warps as the limit allows (at most one a 32 lanes).
        one_more = ((warps + 1) * (4 * s + 96) + 4 * s) * 4
        assert plan.threads == min(512, plan.lanes_per_block) or one_more > _kernels.SMEM_LIMIT
        assert 1 <= plan.grid <= _kernels.N_SMS
        # K1 and K3 launch with the same plan: one summing order.
        assert fused.launch_plan(b, s) == plan


def test_the_soaks_geometry_takes_two_warps_a_block():
    assert fused.launch_plan(4096, 4096) == fused.SketchPlan(32, 64, 128, 197376)


def test_past_the_opt_in_limit_the_plan_raises():
    fused.launch_plan(4096, 7252)
    with pytest.raises(ValueError, match="7252 services"):
        fused.launch_plan(4096, 7253)


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


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s", [2048, 4096])
def test_fused_update_kernel_above_the_ceiling_matches_plain(cuda_device, s):
    """K1 with heads at the soak's geometry (B = 4096, p = 8, CMS
    4 × 1024), twice, against its plain version."""
    rng = np.random.default_rng(s)
    b, p, d, w = 4096, 8, 4, 1024
    args = [t.to(cuda_device) for t in _torch_args(_batch(rng, b, s, d, w))]
    hll_bank = torch.from_numpy(rng.integers(0, 20, (3, s, 1 << p)).astype(np.int32)).to(cuda_device)
    cms_bank = torch.from_numpy(rng.integers(0, 99, (3, d, w)).astype(np.int32)).to(cuda_device)
    heads = dict(
        lat_mean=rng.gamma(2.0, 1.0, (s, 3)), lat_var=rng.gamma(1.0, 0.2, (s, 3)),
        err_mean=rng.random((s, 3)) * 0.2, rate_mean=rng.gamma(3.0, 10.0, (s, 3)),
        rate_var=rng.gamma(1.0, 5.0, (s, 3)), cusum=rng.random((s, 3)) * 3.0,
        obs_batches=rng.integers(0, 42, s),
    )
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
def test_sketch_delta_kernel_above_the_ceiling_matches_plain(cuda_device):
    rng = np.random.default_rng(7)
    b, s, p, d, w = 4096, 4096, 8, 4, 1024
    args = [t.to(cuda_device) for t in _torch_args(_batch(rng, b, s, d, w))]
    kw = dict(num_services=s, hll_p=p, cms_width=w)
    got = fused.sketch_delta(*args, **kw)
    want = fused.sketch_delta_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.hll, want.hll) and torch.equal(got.cms, want.cms)
    np.testing.assert_allclose(want.stats.cpu().numpy(), got.stats.cpu().numpy(), rtol=RTOL, atol=ATOL)
