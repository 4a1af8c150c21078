"""Sketch ops of the PyTorch port against the JAX reference.

The same inputs, made from a numpy seed, go through each reference op
and its counterpart in ``opentelemetry_demo_tpu_torch.ops``. Integer
outputs must match exactly; float outputs within the tolerance stated
at each assert. The reference's Pallas kernels run as its own tests run
them on the CPU (interpret mode). Kernel-vs-plain checks on the card are
marked ``gpu`` and skip without one.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opentelemetry_demo_tpu.ops import cms as jcms
from opentelemetry_demo_tpu.ops import ewma as jewma
from opentelemetry_demo_tpu.ops import fused as jfused
from opentelemetry_demo_tpu.ops import hashing as jhashing
from opentelemetry_demo_tpu.ops import hll as jhll
from opentelemetry_demo_tpu_torch.ops import _kernels
from opentelemetry_demo_tpu_torch.ops import cms, ewma, fused, hashing, hll

# float32 sums taken in another order (one-hot products, per-block
# partials) and libm differences in exp/log/sqrt move results by a few
# ulp; 1e-4 relative / 1e-5 absolute bounds that with room to spare.
RTOL, ATOL = 1e-4, 1e-5

HEAD_KW = dict(
    taus_s=(1.0, 10.0, 60.0), warmup_batches=20.0, z_warmup_batches=60.0,
    cusum_k=0.5, cusum_cap=50.0, err_slack=0.01,
)


def _u32_as_i32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))


def _i32_as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _batch(rng, b, s, d, w, svc_lo=0, svc_hi=None):
    """One batch as numpy arrays, the reference test_fused.py's recipe."""
    svc_hi = s if svc_hi is None else svc_hi
    t_hi, t_lo = jhashing.split_hi_lo_np(
        jhashing.splitmix64_np(rng.integers(0, 2**63, size=b, dtype=np.uint64))
    )
    a_hi, a_lo = jhashing.split_hi_lo_np(
        jhashing.splitmix64_np(rng.integers(0, 2**20, size=b, dtype=np.uint64))
    )
    cidx = jcms.cms_indices_np(a_hi, a_lo, d, w)
    return dict(
        svc=rng.integers(svc_lo, svc_hi, size=b).astype(np.int32),
        log_lat=rng.gamma(2.0, 1.0, size=b).astype(np.float32),
        is_error=(rng.random(b) < 0.1).astype(np.float32),
        trace_hi=t_hi,
        trace_lo=t_lo,
        cidx=cidx,
        valid=rng.random(b) < 0.9,
    )


def _jax_args(batch):
    return [jnp.asarray(v) for v in batch.values()]


def _torch_args(batch):
    out = []
    for k, v in batch.items():
        out.append(_u32_as_i32(v) if k in ("trace_hi", "trace_lo") else torch.from_numpy(v))
    return out


def _heads_np(rng, s, t=3):
    return dict(
        lat_mean=rng.gamma(2.0, 1.0, (s, t)).astype(np.float32),
        lat_var=rng.gamma(1.0, 0.2, (s, t)).astype(np.float32),
        err_mean=(rng.random((s, t)) * 0.2).astype(np.float32),
        rate_mean=rng.gamma(3.0, 10.0, (s, t)).astype(np.float32),
        rate_var=rng.gamma(1.0, 5.0, (s, t)).astype(np.float32),
        cusum=(rng.random((s, 3)) * 3.0).astype(np.float32),
        obs_batches=rng.integers(0, 100, s).astype(np.float32),
    )


def _assert_close(ref, got, msg=""):
    np.testing.assert_allclose(np.asarray(ref), np.asarray(got), rtol=RTOL, atol=ATOL, err_msg=msg)


# -- hashing ------------------------------------------------------------


def test_host_hashes_equal_reference(rng):
    x = rng.integers(0, 2**64, size=4096, dtype=np.uint64)
    h = hashing.splitmix64_np(x)
    np.testing.assert_array_equal(h, jhashing.splitmix64_np(x))
    for got, want in zip(hashing.split_hi_lo_np(h), jhashing.split_hi_lo_np(h)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7])
def test_device_hashes_equal_reference(rng, seed):
    x = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    np.testing.assert_array_equal(
        _i32_as_u32(hashing.fmix32(_u32_as_i32(x))),
        np.asarray(jhashing.fmix32(jnp.asarray(x))),
    )
    for got, want in zip(
        hashing.hash_u32_pair(_u32_as_i32(x), seed=seed),
        jhashing.hash_u32_pair(jnp.asarray(x), seed=seed),
    ):
        np.testing.assert_array_equal(_i32_as_u32(got), np.asarray(want))
    for got, want in zip(
        hashing.hash_spans_synthetic(123456, 1000, seed=seed, device="cpu"),
        jhashing.hash_spans_synthetic(123456, 1000, seed=seed),
    ):
        np.testing.assert_array_equal(_i32_as_u32(got), np.asarray(want))


# -- HLL ----------------------------------------------------------------


@pytest.mark.parametrize("p", [4, 8, 10, 12])
def test_hll_indices_equal_reference(rng, p):
    hi = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    # Edge lanes: zero high word (rank from the low word), all-zero hash,
    # top bit set, and a high word whose set bits all sit below p.
    hi[:5] = [0, 0, 0x80000000, (1 << p) - 1, 1]
    lo[:5] = [0xFFFFFFFF, 0, 0, 0x12345678, 0]
    b_ref, r_ref = jhll.hll_indices(jnp.asarray(hi), jnp.asarray(lo), p=p)
    b_got, r_got = hll.hll_indices(_u32_as_i32(hi), _u32_as_i32(lo), p=p)
    np.testing.assert_array_equal(np.asarray(b_ref), b_got.numpy())
    np.testing.assert_array_equal(np.asarray(r_ref), r_got.numpy())


def test_hll_update_merge_and_estimate_equal_reference(rng):
    s, p, b = 8, 8, 512
    regs = rng.integers(0, 6, size=(3, s, 1 << p)).astype(np.int32)
    key = rng.integers(-3, s + 3, size=b).astype(np.int32)  # out-of-range ids drop
    bucket = rng.integers(0, 1 << p, size=b).astype(np.int32)
    rank = rng.integers(1, 20, size=b).astype(np.int32)
    valid = rng.random(b) < 0.8
    ref = jhll.hll_update(
        jnp.asarray(regs), jnp.asarray(np.where(key < 0, s, key)),
        jnp.asarray(bucket), jnp.asarray(rank), jnp.asarray(valid),
    )
    got = hll.hll_update(
        torch.from_numpy(regs), torch.from_numpy(key), torch.from_numpy(bucket),
        torch.from_numpy(rank), torch.from_numpy(valid),
    )
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    other = rng.integers(0, 6, size=regs.shape).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jhll.hll_merge(jnp.asarray(regs), jnp.asarray(other))),
        hll.hll_merge(torch.from_numpy(regs), torch.from_numpy(other)).numpy(),
    )
    sparse = np.zeros_like(regs)
    sparse[:, :, :40] = regs[:, :, :40]  # linear-counting regime
    for bank in (regs, sparse):
        _assert_close(jhll.hll_estimate(jnp.asarray(bank)), hll.hll_estimate(torch.from_numpy(bank)))
        np.testing.assert_array_equal(jhll.hll_estimate_np(bank), hll.hll_estimate_np(bank))


# -- CMS ----------------------------------------------------------------


@pytest.mark.parametrize("d,w", [(4, 512), (2, 1024), (4, 8192)])
def test_cms_indices_equal_reference(rng, d, w):
    hi = rng.integers(0, 2**32, size=2048, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, size=2048, dtype=np.uint64).astype(np.uint32)
    hi[:2] = 0xFFFFFFFF  # lo + i·hi wraps modulo 2³²
    lo[:2] = 0xFFFFFFF0
    ref = np.asarray(jcms.cms_indices(jnp.asarray(hi), jnp.asarray(lo), d, w))
    np.testing.assert_array_equal(ref, cms.cms_indices(_u32_as_i32(hi), _u32_as_i32(lo), d, w).numpy())
    np.testing.assert_array_equal(ref, cms.cms_indices_np(hi, lo, d, w))


def test_cms_update_query_merge_equal_reference(rng):
    d, w, b = 4, 512, 512
    table = rng.integers(0, 100, size=(3, d, w)).astype(np.int32)
    idx = rng.integers(0, w, size=(d, b)).astype(np.int32)
    weight = rng.integers(0, 5, size=b).astype(np.int32)
    valid = rng.random(b) < 0.8
    for wt in (None, weight):
        ref = jcms.cms_update(
            jnp.asarray(table), jnp.asarray(idx),
            None if wt is None else jnp.asarray(wt), jnp.asarray(valid),
        )
        got = cms.cms_update(
            torch.from_numpy(table), torch.from_numpy(idx),
            None if wt is None else torch.from_numpy(wt), torch.from_numpy(valid),
        )
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    np.testing.assert_array_equal(
        np.asarray(jcms.cms_query(jnp.asarray(table), jnp.asarray(idx))),
        cms.cms_query(torch.from_numpy(table), torch.from_numpy(idx)).numpy(),
    )
    np.testing.assert_array_equal(jcms.cms_query_np(table, idx), cms.cms_query_np(table, idx))
    np.testing.assert_array_equal(
        np.asarray(jcms.cms_merge(jnp.asarray(table), jnp.asarray(table))),
        cms.cms_merge(torch.from_numpy(table), torch.from_numpy(table)).numpy(),
    )


@pytest.mark.parametrize(
    "d,w,b", [(4, 512, 512), (2, 1024, 128), (4, 512, 3), (4, 16384, 2048), (4, 32768, 3001)]
)
def test_cms_update_hist_equal_reference_sort_engine(rng, d, w, b):
    table = rng.integers(0, 100, size=(d, w)).astype(np.int32)
    idx = rng.integers(0, w, size=(d, b)).astype(np.int32)
    valid = rng.random(b) < 0.8
    ref = jcms.cms_update_hist(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(valid), impl="sort")
    got = cms.cms_update_hist(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_cms_hist_plain_skips_sentinel_and_out_of_range():
    keys = torch.tensor([0, 0, 3, 4, 4, 4, -1, 5], dtype=torch.int32)
    np.testing.assert_array_equal(cms.cms_hist_plain(keys, 4).numpy(), [2, 0, 0, 1])


def _hist_keys(rng, dist, d, w, b):
    """CMS row indices ``int32[D, B]`` and a validity mask: ``uniform``
    over the row, or ``zipf`` (the smoke's Zipf(1.3) attribute draw,
    hashed, so a quarter of the lanes share one counter per row)."""
    if dist == "uniform":
        idx = rng.integers(0, w, size=(d, b)).astype(np.int32)
    else:
        hi, lo = jhashing.split_hi_lo_np(jhashing.splitmix64_np(rng.zipf(1.3, b).astype(np.uint64)))
        idx = jcms.cms_indices_np(hi, lo, d, w)
    return idx, rng.random(b) < 0.85


def _pallas_hist(flat: np.ndarray, n_bins: int) -> np.ndarray:
    """The reference's TPU kernel ``_hist_mxu_kernel`` through
    ``pl.pallas_call(..., interpret=True)``, with ``_hist_mxu``'s grid,
    block specs and sentinel fold (keys past the last bin are clamped
    onto it and their number taken off after)."""
    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    n = flat.shape[0]
    keys = jnp.asarray(flat)
    sentinels = jnp.sum((keys >= n_bins).astype(jnp.int32))
    keys = jnp.minimum(keys, n_bins - 1)
    tile = jcms._HIST_TILE
    counts = pl.pallas_call(
        jcms._hist_mxu_kernel,
        grid=(n // tile,),
        out_shape=jax.ShapeDtypeStruct((n_bins // 256, 256), jnp.int32),
        in_specs=[pl.BlockSpec((1, tile), lambda i: (0, i), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((n_bins // 256, 256), lambda i: (0, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )(keys.reshape(1, n))
    return np.asarray(counts.reshape(-1).at[n_bins - 1].add(-sentinels))


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
@pytest.mark.parametrize("n_bins", [1024, 65536])
def test_hist_plain_equals_the_pallas_mxu_kernel(rng, dist, n_bins):
    """The port's plain histograms against the TPU kernel itself (two
    grid steps of 8192 keys, so its carried sum is exercised), exactly:
    four rows of ``n_bins / 4`` counters, invalid lanes on the sentinel
    ``n_bins``."""
    d, b = 4, 2 * jcms._HIST_TILE // 4
    w = n_bins // d
    idx, valid = _hist_keys(rng, dist, d, w, b)
    flat = np.where(valid[None, :], idx + (np.arange(d, dtype=np.int32) * w)[:, None], n_bins)
    flat = flat.reshape(-1).astype(np.int32)
    want = _pallas_hist(flat, n_bins)
    assert int(want.sum()) == d * int(valid.sum()) and (flat == n_bins).any()
    np.testing.assert_array_equal(cms.cms_hist_plain(torch.from_numpy(flat), n_bins).numpy(), want)
    got = cms.cms_count_plain(torch.from_numpy(idx), torch.from_numpy(valid), w)
    np.testing.assert_array_equal(got.numpy(), want.reshape(d, w))


@pytest.mark.parametrize("masked", [False, True])
def test_cms_count_equals_reference_on_a_zero_table(rng, masked):
    """``cms_count`` (its plain version on the CPU) is the count the
    reference's ``cms_update_hist`` adds to the table, with or without a
    mask."""
    d, w, b = 4, 2048, 5000
    idx, valid = _hist_keys(rng, "zipf", d, w, b)
    jv = jnp.asarray(valid) if masked else None
    ref = jcms.cms_update_hist(jcms.cms_init(d, w), jnp.asarray(idx), jv, impl="sort")
    got = cms.cms_count(torch.from_numpy(idx), torch.from_numpy(valid) if masked else None, w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_cms_count_plain_skips_invalid_lanes_and_out_of_range_indices():
    idx = torch.tensor([[0, 1, 1, 4, -1], [3, 3, 3, 0, 2]], dtype=torch.int32)
    valid = torch.tensor([True, True, False, True, True])
    np.testing.assert_array_equal(
        cms.cms_count_plain(idx, valid, 4).numpy(), [[1, 1, 0, 0], [1, 0, 1, 2]]
    )
    np.testing.assert_array_equal(
        cms.cms_count_plain(idx, None, 4).numpy(), [[1, 2, 0, 0], [1, 0, 1, 3]]
    )


# Bin counts from one counter to every index an int32 key addresses.
PLAN_BINS = [1, 1024, 32768, 58112, 58113, 65536, 131072, 1 << 20, (1 << 31) - 1]


@pytest.mark.parametrize("n_sms", [114, 132])
def test_hist_launch_plan_fits_the_card_with_no_bins_ceiling(n_sms):
    """The histogram kernel's plan, B = 1 … 140001 lanes and any bin count:
    at most one block per SM (the launch is cooperative), runs of whole
    warp slices that cover the lanes, enough blocks to spread the lanes
    and the clear, and no limit on the bins (no block keeps a histogram
    of its own)."""
    for b in PLAN_WIDTHS:
        for n_out in PLAN_BINS:
            plan = _kernels.hist_plan(b, n_out, n_sms)
            assert plan == _kernels.hist_plan(b, n_out, n_sms)
            assert 1 <= plan.grid <= n_sms
            assert plan.threads == _kernels.HIST_THREADS == 512
            assert plan.lanes_per_block % 32 == 0 and plan.lanes_per_block >= 32
            assert plan.grid * plan.lanes_per_block >= b
            assert plan.grid >= min(-(-b // 32), n_sms // 2), (b, n_out, plan)
            assert plan.grid >= min(n_sms, -(-n_out // (4 * plan.threads))), (b, n_out, plan)
    assert _kernels.hist_plan(0, 32768, n_sms).grid == 16
    assert _kernels.hist_plan(65536, 32768) == _kernels.hist_plan(65536, 32768, _kernels.N_SMS)


def test_kernel_wrappers_refuse_devices_without_a_kernel():
    """No fallback: only a CPU tensor takes the plain version."""
    keys = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cms.cms_hist(keys, 4)
    banks = torch.zeros((3, 8, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused.fused_update(banks, banks, *([keys] * 7), num_services=8, hll_p=8)
    with pytest.raises(ValueError, match="no kernel"):
        fused.sketch_delta(*([keys] * 7), num_services=8, hll_p=8, cms_width=512)


# -- EWMA ---------------------------------------------------------------


def test_segment_stats_and_ewma_update_equal_reference(rng):
    b, s = 512, 8
    values = rng.gamma(2.0, 1.0, size=b).astype(np.float32)
    seg = rng.integers(-2, s + 2, size=b).astype(np.int32)
    valid = rng.random(b) < 0.9
    ref = jewma.segment_stats(jnp.asarray(values), jnp.asarray(seg), s, jnp.asarray(valid))
    got = ewma.segment_stats(torch.from_numpy(values), torch.from_numpy(seg), s, torch.from_numpy(valid))
    for r, g in zip(ref, got):
        _assert_close(r, g)
    mean = rng.random((s, 3)).astype(np.float32)
    var = rng.random((s, 3)).astype(np.float32)
    x = rng.random((s, 1)).astype(np.float32)
    alpha = np.array([0.5, 0.1, 0.01], np.float32)
    obs = rng.random((s, 1)) < 0.7
    warm = rng.random((s, 1)) < 0.3
    ref = jewma.ewma_update(*map(jnp.asarray, (mean, var, x, alpha, obs, warm)))
    got = ewma.ewma_update(*map(torch.from_numpy, (mean, var, x, alpha, obs, warm)))
    for r, g in zip(ref, got):
        _assert_close(r, g)


# -- fused --------------------------------------------------------------


@pytest.mark.parametrize("step_pos", [True, False])
def test_head_update_equal_reference(rng, step_pos):
    s = 8
    stats = np.stack([
        rng.integers(0, 40, s).astype(np.float32),
        rng.gamma(2.0, 10.0, s).astype(np.float32),
        rng.gamma(2.0, 50.0, s).astype(np.float32),
        rng.integers(0, 3, s).astype(np.float32),
    ])
    heads = _heads_np(rng, s)
    dt = np.float32(0.25)
    ref_heads, ref_zs = jfused.head_update(
        jnp.asarray(stats), jfused.HeadState(**{k: jnp.asarray(v) for k, v in heads.items()}),
        jnp.asarray(dt), jnp.asarray(step_pos), **HEAD_KW,
    )
    got_heads, got_zs = fused.head_update(
        torch.from_numpy(stats),
        fused.HeadState(**{k: torch.from_numpy(v) for k, v in heads.items()}),
        torch.tensor(dt), torch.tensor(step_pos), **HEAD_KW,
    )
    for name, r, g in zip(ref_heads._fields, ref_heads, got_heads):
        _assert_close(r, g, name)
    for r, g in zip(ref_zs, got_zs):
        _assert_close(r, g)


@pytest.mark.parametrize(
    "b,s,p,d,w", [(256, 32, 8, 4, 1024), (128, 8, 10, 2, 512), (512, 32, 8, 4, 1024)]
)
def test_sketch_batch_delta_equal_reference(rng, b, s, p, d, w):
    kw = dict(num_services=s, hll_p=p, cms_width=w)
    # Out-of-slice ids on both sides, as a sketch-sharded shard sees them.
    batch = _batch(rng, b, s, d, w, svc_lo=-3, svc_hi=s + 3)
    ref = jfused.sketch_batch_delta(*_jax_args(batch), impl="xla", **kw)
    got = fused.sketch_batch_delta(*_torch_args(batch), impl="xla", **kw)
    np.testing.assert_array_equal(np.asarray(ref.hll), got.hll.numpy())
    np.testing.assert_array_equal(np.asarray(ref.cms), got.cms.numpy())
    _assert_close(ref.stats, got.stats)


@pytest.mark.parametrize("impl", ["pallas", "interpret"])
@pytest.mark.parametrize("b", [512, 4096, 12288])
def test_sketch_batch_delta_kernel_branch_equal_reference(rng, impl, b):
    """The delta kernel's branch against the reference's ``_delta_kernel``
    in interpret mode (one batch tile up to 4096 lanes, a three-tile grid
    at 12288). The port's ``"pallas"`` on a CPU tensor is the
    ``sketch_delta`` wrapper's plain version; ``"interpret"`` is that
    plain version on any device."""
    s, p, d, w = 8, 8, 4, 1024
    kw = dict(num_services=s, hll_p=p, cms_width=w)
    # Out-of-slice and negative ids, as a sketch-sharded shard sees them.
    batch = _batch(rng, b, s, d, w, svc_lo=-3, svc_hi=s + 3)
    ref = jfused.sketch_batch_delta(*_jax_args(batch), impl="interpret", **kw)
    got = fused.sketch_batch_delta(*_torch_args(batch), impl=impl, **kw)
    np.testing.assert_array_equal(np.asarray(ref.hll), got.hll.numpy())
    np.testing.assert_array_equal(np.asarray(ref.cms), got.cms.numpy())
    _assert_close(ref.stats, got.stats)
    assert int(got.stats[0].sum()) == int((batch["valid"] & (batch["svc"] >= 0) & (batch["svc"] < s)).sum())


def test_sketch_batch_delta_refuses_unknown_impl(rng):
    batch = _batch(rng, 64, 8, 4, 512)
    with pytest.raises(ValueError, match="unknown sketch impl"):
        fused.sketch_batch_delta(*_torch_args(batch), num_services=8, hll_p=8, cms_width=512, impl="cuda")


@pytest.mark.parametrize("ref_impl", ["xla", "interpret"])
@pytest.mark.parametrize("impl", ["xla", "interpret", "pallas"])
@pytest.mark.parametrize("b,s,p,d,w", [(256, 32, 8, 4, 1024), (128, 8, 10, 2, 512)])
def test_sketch_batch_update_equal_reference(rng, ref_impl, impl, b, s, p, d, w):
    """Banks bit-exact, stats within tolerance, against the reference's
    composed path and its Pallas kernel in interpret mode. The port's
    ``"pallas"`` on a CPU tensor is the kernel wrapper's plain version."""
    kw = dict(num_services=s, hll_p=p, cms_width=w)
    batch = _batch(rng, b, s, d, w, svc_lo=-3, svc_hi=s + 3)
    hll_cur = rng.integers(0, 20, size=(3, s, 1 << p)).astype(np.int32)
    cms_cur = rng.integers(0, 1000, size=(3, d, w)).astype(np.int32)
    ref = jfused.sketch_batch_update(
        jnp.asarray(hll_cur), jnp.asarray(cms_cur), *_jax_args(batch), impl=ref_impl, **kw
    )
    got_hll, got_cms = torch.from_numpy(hll_cur.copy()), torch.from_numpy(cms_cur.copy())
    got = fused.sketch_batch_update(got_hll, got_cms, *_torch_args(batch), impl=impl, **kw)
    assert got[0] is got_hll and got[1] is got_cms  # updated in place
    np.testing.assert_array_equal(np.asarray(ref[0]), got_hll.numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), got_cms.numpy())
    _assert_close(ref[2], got[2])


@pytest.mark.parametrize("ref_impl", ["xla", "interpret"])
@pytest.mark.parametrize("impl", ["xla", "interpret", "pallas"])
def test_sketch_batch_update_with_heads_equal_reference(rng, ref_impl, impl):
    b, s, p, d, w = 256, 8, 8, 4, 512
    kw = dict(num_services=s, hll_p=p, cms_width=w)
    batch = _batch(rng, b, s, d, w, svc_lo=-3, svc_hi=s + 3)
    hll_cur = rng.integers(0, 20, size=(3, s, 1 << p)).astype(np.int32)
    cms_cur = rng.integers(0, 1000, size=(3, d, w)).astype(np.int32)
    heads = _heads_np(rng, s)
    ref = jfused.sketch_batch_update(
        jnp.asarray(hll_cur), jnp.asarray(cms_cur), *_jax_args(batch), impl=ref_impl,
        heads=jfused.HeadState(**{k: jnp.asarray(v) for k, v in heads.items()}),
        dt=jnp.float32(0.05), step_pos=jnp.asarray(True), **HEAD_KW, **kw,
    )
    got_heads = fused.HeadState(**{k: torch.from_numpy(v.copy()) for k, v in heads.items()})
    got = fused.sketch_batch_update(
        torch.from_numpy(hll_cur.copy()), torch.from_numpy(cms_cur.copy()),
        *_torch_args(batch), impl=impl, heads=got_heads, dt=0.05, step_pos=True,
        **HEAD_KW, **kw,
    )
    np.testing.assert_array_equal(np.asarray(ref[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())
    _assert_close(ref[2], got[2])
    for name, r, g in zip(ref[3]._fields, ref[3], got_heads):
        _assert_close(r, g, name)
    for r, g in zip(ref[4], got[4]):
        _assert_close(r, g)


def test_sketch_batch_update_heads_require_constants(rng):
    batch = _batch(rng, 64, 8, 4, 512)
    heads = fused.HeadState(**{k: torch.from_numpy(v) for k, v in _heads_np(rng, 8).items()})
    with pytest.raises(TypeError, match="requires"):
        fused.sketch_batch_update(
            torch.zeros((3, 8, 256), dtype=torch.int32),
            torch.zeros((3, 4, 512), dtype=torch.int32),
            *_torch_args(batch), num_services=8, hll_p=8, cms_width=512, heads=heads,
        )


PLAN_WIDTHS = sorted({1, 2, 31, 32, 33, 127, 128, 129, 1000, 2047, 2048, 2049, 3001,
                      8192, 16896, 17000, 32768, 40000, 65535, 65536, 67585, 140001})


def _check_plan(plan, b, s, n_sms):
    assert 1 <= plan.grid <= n_sms, (b, plan)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert plan.lanes_per_block % 32 == 0 and plan.lanes_per_block >= plan.threads
    assert (plan.grid - 1) * plan.lanes_per_block < b <= plan.grid * plan.lanes_per_block
    warps = plan.threads // 32
    assert plan.smem_bytes == (warps * (4 * s + 64) + plan.threads + 4 * s) * 4
    assert plan.smem_bytes <= 48 * 1024 <= _kernels.SMEM_LIMIT
    # The grid spreads the lanes: one block per 128 lanes until the card
    # is three quarters full.
    assert plan.grid >= min(-(-b // 128), 3 * n_sms // 4), (b, plan)


@pytest.mark.parametrize("s,d", [(16, 2), (16, 4), (32, 2), (32, 4)])
def test_sketch_launch_plan_fits_the_h100(s, d):
    """The sketch kernel's launch plan, B = 1 … 65536: at most one block
    per SM, warp-slice runs of lanes that cover the batch exactly once,
    shared memory under the default 48 KB (so no opt-in) and far under
    the H100's limit, and no thread block clusters (so the portable
    cluster size of 8 is never exceeded). The plan depends on the batch,
    the service count and the card only, so K1 and K3 sum one batch's
    stats in the same order whatever the CMS depth ``d``."""
    for b in PLAN_WIDTHS:
        plan = fused.launch_plan(b, s)
        assert plan == fused.launch_plan(b, s) == fused.launch_plan(b, s, _kernels.N_SMS)
        _check_plan(plan, b, s, _kernels.N_SMS)
        assert plan.threads == min(512, plan.lanes_per_block)
    assert fused.launch_plan(0, s).grid == 1
    with pytest.raises(ValueError, match="shared memory"):
        fused.launch_plan(2048, 20000)


@pytest.mark.parametrize("n_sms", [114, 132])
@pytest.mark.parametrize("s", [64, 192, 1000, 1524])
def test_sketch_launch_plan_many_services_stays_under_48kb(s, n_sms):
    """Many services fill shared memory with per-warp stats: the plan
    takes fewer warps (each walking more slices) rather than opting in to
    more than 48 KB, on an H100 SXM (132 SMs) or PCIe (114 SMs), and
    raises only past the count whose single warp does not fit."""
    for b in PLAN_WIDTHS:
        plan = fused.launch_plan(b, s, n_sms)
        _check_plan(plan, b, s, n_sms)
        # As many warps as a thread per lane, 512 and 48 KB allow.
        one_more = (plan.threads // 32 + 1) * (4 * s + 96) + 4 * s
        assert plan.threads == min(512, plan.lanes_per_block) or one_more > 48 * 1024 // 4
    with pytest.raises(ValueError, match="shared memory"):
        fused.launch_plan(2048, 1525, n_sms)


def test_sketch_kernels_refuse_more_cms_rows_than_a_lane_keeps():
    batch = _torch_args(_batch(np.random.default_rng(0), 64, 8, 8, 512))
    lanes = (*batch[:5], batch[6])
    fused._check_lanes("sketch_delta", lanes, batch[5], 8)
    with pytest.raises(ValueError, match="at most 8 CMS rows"):
        fused._check_lanes("sketch_delta", lanes, torch.cat([batch[5], batch[5][:1]]), 8)


def test_resolve_impl_by_device():
    assert fused.resolve_impl(None, torch.device("cuda")) == "pallas"
    assert fused.resolve_impl(None, torch.device("cpu")) == "xla"
    assert fused.resolve_impl("interpret", torch.device("cuda")) == "interpret"
    with pytest.raises(ValueError):
        fused.resolve_impl("cuda", torch.device("cpu"))


# -- the port stands alone ----------------------------------------------


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "opentelemetry_demo_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 10
    parallel = {p.name for p in files if p.parent.name == "parallel"}
    assert {"__init__.py", "mesh.py", "ring.py", "spmd.py", "launch.py"} <= parallel
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "opentelemetry_demo_tpu"), (
                f"{path.relative_to(root)} imports {mod}"
            )


# -- kernels on the card --------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [2048, 8192])
def test_fused_update_kernel_matches_plain(rng, cuda_device, b):
    s, p, d, w = 32, 12, 4, 8192
    batch = _batch(rng, b, s, d, w, svc_lo=-3, svc_hi=s + 3)
    args = [t.to(cuda_device) for t in _torch_args(batch)]
    hll_bank = torch.from_numpy(rng.integers(0, 20, (3, 2, s, 1 << p)).astype(np.int32)).to(cuda_device)
    cms_bank = torch.from_numpy(rng.integers(0, 99, (3, 2, d, w)).astype(np.int32)).to(cuda_device)
    heads = _heads_np(rng, s)
    outs = []
    for impl in ("pallas", "interpret"):
        hb, cb = hll_bank.clone(), cms_bank.clone()
        hs = fused.HeadState(**{k: torch.from_numpy(v.copy()).to(cuda_device) for k, v in heads.items()})
        out = fused.sketch_batch_update(
            hb[:, 0], cb[:, 0], *args, num_services=s, hll_p=p, cms_width=w, impl=impl,
            heads=hs, dt=torch.tensor(0.25, device=cuda_device),
            step_pos=torch.tensor(3, dtype=torch.int32, device=cuda_device), **HEAD_KW,
        )
        torch.cuda.synchronize()
        outs.append((hb.cpu(), cb.cpu(), out[2].cpu(), [h.cpu() for h in hs], [z.cpu() for z in out[4]]))
    (h1, c1, s1, hd1, z1), (h2, c2, s2, hd2, z2) = outs
    assert torch.equal(h1, h2) and torch.equal(c1, c2)
    _assert_close(s2, s1)
    for a, b_ in zip(hd2 + z2, hd1 + z1):
        _assert_close(a, b_)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d", [(2048, 32, 4), (65536, 32, 4), (32768, 16, 2)])
def test_sketch_delta_kernel_matches_plain(rng, cuda_device, b, s, d):
    """K3 at the mesh path's shapes: one rank at full width (S=32, D=4)
    and a (2 batch x 2 sketch) rank's slice (S=16, D=2)."""
    p, w = 12, 8192
    batch = _batch(rng, b, s, d, w, svc_lo=-3, svc_hi=s + 3)
    args = [t.to(cuda_device) for t in _torch_args(batch)]
    kw = dict(num_services=s, hll_p=p, cms_width=w)
    before = _kernels.LAUNCHES["sketch_delta"]
    got = fused.sketch_delta(*args, **kw)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["sketch_delta"] == before + 1
    want = fused.sketch_delta_plain(*args, **kw)
    assert torch.equal(got.hll, want.hll) and torch.equal(got.cms, want.cms)
    _assert_close(want.stats.cpu(), got.stats.cpu())
    again = fused.sketch_delta(*args, **kw)  # outputs cleared by the kernel
    assert torch.equal(again.stats, got.stats) and torch.equal(again.cms, got.cms)


@pytest.mark.gpu
def test_cms_hist_kernel_matches_plain(rng, cuda_device):
    n_bins = 4 * 8192
    keys = torch.from_numpy(rng.integers(0, n_bins + 1, 4 * 65536).astype(np.int32)).to(cuda_device)
    before = _kernels.LAUNCHES["cms_hist"]
    got = cms.cms_hist(keys, n_bins)
    assert _kernels.LAUNCHES["cms_hist"] == before + 1
    assert torch.equal(got.cpu(), cms.cms_hist_plain(keys.cpu(), n_bins))


# (case, D, B, W) of the histogram kernel's card cases: the composed
# path's shape with uniform, Zipf and hot keys; no valid lane; one key;
# a lane count no block divides; 65,536 and 131,072 bins.
HIST_CASES = [
    ("uniform", 4, 65536, 8192), ("zipf", 4, 65536, 8192), ("hot", 4, 65536, 8192),
    ("invalid", 4, 2048, 8192), ("one", 1, 1, 8192), ("zipf", 4, 3001, 8192),
    ("zipf", 4, 65536, 16384), ("uniform", 4, 65536, 32768),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case,d,b,w", HIST_CASES)
def test_cms_hist_kernel_cases(rng, cuda_device, case, d, b, w):
    """Both entries of the histogram kernel twice against their plain
    versions: ``cms_count`` on ``idx[D, B]`` with a mask, ``cms_hist`` on
    the same keys flattened with sentinels. Bit-exact, the two launches
    bit-identical, one launch a call."""
    idx, valid = _hist_keys(rng, "uniform" if case == "uniform" else "zipf", d, w, b)
    if case == "hot":
        idx[:] = (np.arange(d, dtype=np.int32) * 101 + 7)[:, None]
        valid[:] = True
    elif case == "invalid":
        valid[:] = False
    elif case == "one":
        valid[:] = True
    idx_t = torch.from_numpy(idx).to(cuda_device)
    valid_t = torch.from_numpy(valid).to(cuda_device)
    rows = torch.arange(d, dtype=torch.int32, device=cuda_device)[:, None] * w
    flat = torch.where(valid_t[None, :], idx_t + rows, d * w).reshape(-1)
    before = _kernels.LAUNCHES["cms_hist"]
    counts = [cms.cms_count(idx_t, valid_t, w) for _ in range(2)]
    hists = [cms.cms_hist(flat, d * w) for _ in range(2)]
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["cms_hist"] == before + 4
    want = cms.cms_count_plain(idx_t, valid_t, w)
    assert torch.equal(counts[0], want) and torch.equal(counts[1], want)
    want_flat = cms.cms_hist_plain(flat, d * w)
    assert torch.equal(hists[0], want_flat) and torch.equal(hists[1], want_flat)
    assert torch.equal(want_flat.view(d, w), want)
    assert int(want.sum()) == d * int(valid.sum())
    if case == "hot":
        assert int(want.max()) == b


def _edge_batch(rng, case, b, s, d, w, p):
    """A batch for the sketch kernels' edge cases: ``hot`` puts every lane
    on one service, one CMS counter per row and one HLL bucket (ranks
    still differ); ``invalid`` marks every lane invalid; ``random`` is the
    usual recipe (used at B = 1 and at a width that no block divides)."""
    batch = _batch(rng, b, s, d, w, svc_lo=-3, svc_hi=s + 3)
    if case == "hot":
        batch["svc"][:] = 3
        batch["valid"][:] = True
        batch["cidx"] = np.ascontiguousarray(
            np.broadcast_to((np.arange(d, dtype=np.int32) * 101 + 7)[:, None], (d, b))
        )
        batch["trace_lo"] = (batch["trace_lo"] & ~np.uint32((1 << p) - 1)) | np.uint32(5)
    elif case == "invalid":
        batch["valid"][:] = False
    return batch


# B = 140001: more lanes than 512 threads on each of the 132 SMs take in
# one pass, so each warp walks several slices.
EDGE_CASES = [
    ("hot", 2048), ("hot", 65536), ("invalid", 2048), ("random", 1), ("random", 3001),
    ("random", 140001),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case,b", EDGE_CASES)
def test_fused_update_kernel_edge_cases(rng, cuda_device, case, b):
    """K1 twice and its plain version once on the same inputs: banks
    exact, floats within tolerance, the two launches bit for bit."""
    s, p, d, w = 32, 12, 4, 8192
    batch = _edge_batch(rng, case, b, s, d, w, p)
    args = [t.to(cuda_device) for t in _torch_args(batch)]
    hll_bank = torch.from_numpy(rng.integers(0, 20, (3, 2, s, 1 << p)).astype(np.int32)).to(cuda_device)
    cms_bank = torch.from_numpy(rng.integers(0, 99, (3, 2, d, w)).astype(np.int32)).to(cuda_device)
    heads = _heads_np(rng, s)
    outs = []
    for update in (fused.fused_update, fused.fused_update, fused.fused_update_plain):
        hb, cb = hll_bank.clone(), cms_bank.clone()
        hs = fused.HeadState(**{k: torch.from_numpy(v.copy()).to(cuda_device) for k, v in heads.items()})
        stats, zs = update(
            hb[:, 0], cb[:, 0], *args, num_services=s, hll_p=p, heads=hs,
            dt=torch.tensor(0.25, device=cuda_device),
            step_pos=torch.tensor(3, dtype=torch.int32, device=cuda_device), statics=HEAD_KW,
        )
        torch.cuda.synchronize()
        outs.append([hb.cpu(), cb.cpu(), stats.cpu(), *(h.cpu() for h in hs), *(z.cpu() for z in zs)])
    kernel, again, plain = outs
    assert torch.equal(kernel[0], plain[0]) and torch.equal(kernel[1], plain[1])
    for a, b_ in zip(kernel[2:], plain[2:]):
        _assert_close(b_, a)
    assert all(torch.equal(a, b_) for a, b_ in zip(kernel, again))
    if case == "invalid":
        assert int(kernel[2].abs().sum()) == 0 and torch.equal(kernel[1], cms_bank.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("case,b", EDGE_CASES)
@pytest.mark.parametrize("s,d", [(32, 4), (16, 2)])
def test_sketch_delta_kernel_edge_cases(rng, cuda_device, case, b, s, d):
    """K3 twice and its plain version once: integers exact, stats within
    tolerance, the two launches bit for bit."""
    p, w = 12, 8192
    batch = _edge_batch(rng, case, b, s, d, w, p)
    args = [t.to(cuda_device) for t in _torch_args(batch)]
    kw = dict(num_services=s, hll_p=p, cms_width=w)
    got = fused.sketch_delta(*args, **kw)
    again = fused.sketch_delta(*args, **kw)
    want = fused.sketch_delta_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.hll, want.hll) and torch.equal(got.cms, want.cms)
    _assert_close(want.stats.cpu(), got.stats.cpu())
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    if case == "hot":
        assert int(got.cms.sum()) == b * d and int((got.hll > 0).sum()) == 1


# Service counts whose head cells outnumber block 0's threads (128 at
# B = 2048), so the epilogue runs several passes, and one whose stats
# leave room for only two warps a block.
MANY_SERVICES = [(2048, 64), (2048, 192), (8192, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s", MANY_SERVICES)
def test_fused_update_kernel_many_services(rng, cuda_device, b, s):
    """K1 with heads at many services, twice, against its plain version:
    every cell reads its service's observation count and CUSUM as they
    were before the launch, whichever pass or warp writes them."""
    p, d, w = 12, 4, 8192
    batch = _batch(rng, b, s, d, w, svc_lo=-3, svc_hi=s + 3)
    args = [t.to(cuda_device) for t in _torch_args(batch)]
    hll_bank = torch.from_numpy(rng.integers(0, 20, (3, s, 1 << p)).astype(np.int32)).to(cuda_device)
    cms_bank = torch.from_numpy(rng.integers(0, 99, (3, d, w)).astype(np.int32)).to(cuda_device)
    heads = _heads_np(rng, s)
    # Around the warmups, so the flags the observation count sets differ
    # between services.
    heads["obs_batches"] = rng.integers(0, 2 * int(HEAD_KW["warmup_batches"]) + 2, s).astype(np.float32)
    outs = []
    for update in (fused.fused_update, fused.fused_update, fused.fused_update_plain):
        hb, cb = hll_bank.clone(), cms_bank.clone()
        hs = fused.HeadState(**{k: torch.from_numpy(v.copy()).to(cuda_device) for k, v in heads.items()})
        stats, zs = update(
            hb, cb, *args, num_services=s, hll_p=p, heads=hs,
            dt=torch.tensor(0.25, device=cuda_device),
            step_pos=torch.tensor(3, dtype=torch.int32, device=cuda_device), statics=HEAD_KW,
        )
        torch.cuda.synchronize()
        outs.append([hb.cpu(), cb.cpu(), stats.cpu(), *(h.cpu() for h in hs), *(z.cpu() for z in zs)])
    kernel, again, plain = outs
    assert torch.equal(kernel[0], plain[0]) and torch.equal(kernel[1], plain[1])
    for a, b_ in zip(kernel[2:], plain[2:]):
        _assert_close(b_, a)
    assert all(torch.equal(a, b_) for a, b_ in zip(kernel, again))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s", MANY_SERVICES)
def test_sketch_delta_kernel_many_services(rng, cuda_device, b, s):
    p, d, w = 12, 4, 8192
    batch = _batch(rng, b, s, d, w, svc_lo=-3, svc_hi=s + 3)
    args = [t.to(cuda_device) for t in _torch_args(batch)]
    kw = dict(num_services=s, hll_p=p, cms_width=w)
    got = fused.sketch_delta(*args, **kw)
    again = fused.sketch_delta(*args, **kw)
    want = fused.sketch_delta_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.hll, want.hll) and torch.equal(got.cms, want.cms)
    _assert_close(want.stats.cpu(), got.stats.cpu())
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
