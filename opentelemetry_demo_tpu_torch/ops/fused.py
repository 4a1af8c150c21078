"""The batch → sketch update of the detector step, fused.

One span batch changes three things: the HLL registers (a max per
(service, bucket) cell), the Count-Min counters (a count per counter)
and the per-service moment stats ``stats[4, S]`` = (count, Σlog-lat,
Σlog-lat², Σerr), which then advance the EWMA/CUSUM heads
(:func:`head_update`).

:func:`sketch_batch_update` folds a batch into every current window bank
and, given ``heads``, advances the heads too. Its impls:

- ``"pallas"``: :func:`fused_update` — on a CUDA tensor the hand-written
  kernel ``csrc/fused_update.cu`` (one launch: warp-merged HLL
  ``atomicMax`` and CMS ``atomicAdd`` into every bank, fixed-order stats
  summed and the head epilogue run over the whole grid, at any service
  count); on a CPU tensor its plain version.
- ``"xla"``: the composed path — :func:`sketch_batch_delta` (scatter-max
  HLL, the CMS count through :func:`cms.cms_count`, matmul segment
  stats), merged into the banks, then :func:`head_update`.
- ``"interpret"``: :func:`fused_update_plain`, the plain PyTorch version
  of the kernel, on any device.

:func:`sketch_batch_delta` reduces a batch to its standalone delta from
zero, the quantity the sharded step merges across the batch axis. Its
``"pallas"`` impl is :func:`sketch_delta` (on a CUDA tensor the kernel
``csrc/sketch_delta.cu``, on a CPU tensor :func:`sketch_delta_plain`),
``"interpret"`` the plain version on any device, ``"xla"`` the composed
path.

Unlike the reference, which is functional, the batch updates change the
banks (and the heads) **in place** and return them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _kernels, cms, ewma, hll


class SketchDelta(NamedTuple):
    """One batch's mergeable effect on the sketch bank."""

    hll: torch.Tensor  # int32[S, R] — max HLL rank per (service, bucket)
    cms: torch.Tensor  # int32[D, W] — count per CMS counter
    stats: torch.Tensor  # float32[4, S] — cnt, Σlog-lat, Σlog-lat², Σerr


class HeadState(NamedTuple):
    """The EWMA/CUSUM head memory one batch advances."""

    lat_mean: torch.Tensor  # float32[S, T]
    lat_var: torch.Tensor  # float32[S, T]
    err_mean: torch.Tensor  # float32[S, T]
    rate_mean: torch.Tensor  # float32[S, T]
    rate_var: torch.Tensor  # float32[S, T]
    cusum: torch.Tensor  # float32[S, 3] — {lat↑, err↑, rate↓}
    obs_batches: torch.Tensor  # float32[S]


_HEAD_STATICS = (
    "taus_s", "warmup_batches", "z_warmup_batches", "cusum_k",
    "cusum_cap", "err_slack",
)

# float32(0.15 * 0.15): the latency z's σ floor, rounded as the
# reference rounds it.
_LAT_FLOOR2 = float(np.float32(0.15 * 0.15))


def head_update(
    stats: torch.Tensor,  # float32[4, S]
    heads: HeadState,
    dt: torch.Tensor,  # float32[] — seconds since the previous batch
    step_pos: torch.Tensor,  # [] — positive past step 0 (bool or step count)
    *,
    taus_s: tuple,
    warmup_batches: float,
    z_warmup_batches: float,
    cusum_k: float,
    cusum_cap: float,
    err_slack: float,
) -> tuple[HeadState, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """One batch's EWMA/CUSUM head advance: ``(heads', (lat_z, err_z,
    rate_z))``. The formulas are the reference's ``head_update``
    verbatim; this function is functional (it returns new tensors)."""
    alphas = torch.stack([1.0 - torch.exp(-dt / float(t)) for t in taus_s])  # [T]
    cnt, lat_sum, lat_sumsq, err_sum = stats
    obs = heads.obs_batches
    seen = cnt > 0
    obs2d = seen[:, None]
    warm = (obs < warmup_batches)[:, None]
    z_warm = (obs < z_warmup_batches)[:, None]
    n = torch.clamp(cnt, min=1.0)[:, None]
    debias = 1.0 / (obs[:, None] + 1.0)
    alphas = torch.maximum(alphas, debias)  # [S, T]
    alpha_var = torch.maximum(
        1.0 - torch.exp(-dt / float(max(taus_s))), debias
    )  # [S, 1]

    mu = heads.lat_mean
    sigma2 = heads.lat_var
    xbar = (lat_sum / torch.clamp(cnt, min=1.0))[:, None]
    lat_z = (xbar - mu) / torch.sqrt(sigma2 / n + _LAT_FLOOR2)
    lat_z_cusum = torch.where(obs2d & ~warm, lat_z, 0.0)
    lat_z = torch.where(obs2d & ~z_warm, lat_z, 0.0)
    lat_mean = torch.where(obs2d, mu + alphas * (xbar - mu), mu)
    v_obs = (
        (lat_sumsq / torch.clamp(cnt, min=1.0))[:, None]
        - 2.0 * lat_mean * xbar
        + lat_mean * lat_mean
    )
    lat_var = torch.where(
        obs2d, sigma2 + alpha_var * (torch.clamp(v_obs, min=0.0) - sigma2), sigma2
    )

    p = heads.err_mean
    err_cnt = err_sum[:, None]
    err_z = (err_cnt - n * p) / torch.sqrt(n * p * (1.0 - p) + 1.0)
    err_z = torch.where(obs2d & ~z_warm, err_z, 0.0)
    phat = err_cnt / n
    err_mean = torch.where(obs2d, p + alphas * (phat - p), p)

    lam = heads.rate_mean
    dt_c = torch.clamp(dt, min=1e-3)
    expected = lam * dt_c
    emp_var = heads.rate_var * dt_c * dt_c
    rate_obs = (seen | (obs > 0))[:, None] & (step_pos > 0)
    rate_z = (cnt[:, None] - expected) / torch.sqrt(
        torch.maximum(expected, emp_var) + 1.0
    )
    rate_z_cusum = torch.where(rate_obs & ~warm, rate_z, 0.0)
    rate_z = torch.where(rate_obs & ~z_warm, rate_z, 0.0)
    rate_x = (cnt / dt_c)[:, None]
    dx = rate_x - lam
    rate_mean = torch.where(rate_obs, lam + alphas * dx, lam)
    rate_var = torch.where(
        rate_obs, heads.rate_var + alpha_var * (dx * dx - heads.rate_var),
        heads.rate_var,
    )

    obs_batches = obs + seen.to(torch.float32)

    active = seen & ~warm[:, 0]
    s_lat = torch.where(active, lat_z_cusum[:, -1] - cusum_k, 0.0)
    p_ref = err_mean[:, -1]
    err_sigma = torch.sqrt(n[:, 0] * p_ref * (1.0 - p_ref) + 1.0)
    s_err = torch.where(
        active,
        (err_cnt[:, 0] - n[:, 0] * (p_ref + err_slack)) / err_sigma - cusum_k,
        0.0,
    )
    s_rate = torch.where(
        rate_obs[:, 0] & ~warm[:, 0], -rate_z_cusum[:, -1] - cusum_k, 0.0
    )
    scores = torch.stack([s_lat, s_err, s_rate], dim=1)  # [S, 3]
    cusum = torch.clamp(heads.cusum + scores, 0.0, cusum_cap)

    new_heads = HeadState(
        lat_mean=lat_mean,
        lat_var=lat_var,
        err_mean=err_mean,
        rate_mean=rate_mean,
        rate_var=rate_var,
        cusum=cusum,
        obs_batches=obs_batches,
    )
    return new_heads, (lat_z, err_z, rate_z)


def sketch_batch_delta(
    svc: torch.Tensor,  # int[B] — local service ids (may be out of range)
    log_lat: torch.Tensor,  # float32[B]
    is_error: torch.Tensor,  # float32[B]
    trace_hi: torch.Tensor,  # int32[B] — uint32 bits
    trace_lo: torch.Tensor,  # int32[B]
    cidx: torch.Tensor,  # int32[D, B] — CMS row indices
    valid: torch.Tensor,  # bool[B]
    *,
    num_services: int,
    hll_p: int = hll.HLL_P,
    cms_width: int = cms.CMS_WIDTH,
    impl: str = "xla",  # "xla" | "pallas" | "interpret"
) -> SketchDelta:
    """Reduce one span batch to its mergeable sketch delta. HLL counts
    valid lanes with ``0 <= svc < S``; CMS counts every valid lane; stats
    are per service. ``"pallas"`` is the :func:`sketch_delta` kernel
    wrapper, ``"interpret"`` its plain version, ``"xla"`` the composed
    path (scatter-max, the CMS histogram, segment sums)."""
    kw = dict(num_services=num_services, hll_p=hll_p, cms_width=cms_width)
    lanes = (svc, log_lat, is_error, trace_hi, trace_lo, cidx, valid)
    if impl == "pallas":
        return sketch_delta(*lanes, **kw)
    if impl == "interpret":
        return sketch_delta_plain(*lanes, **kw)
    if impl != "xla":
        raise ValueError(f"unknown sketch impl {impl!r}")
    s = num_services
    r = 1 << hll_p
    svc = svc.to(torch.int64)
    in_slice = (svc >= 0) & (svc < s)
    bucket, rank = hll.hll_indices(trace_hi, trace_lo, p=hll_p)
    hll_d = hll.hll_update(
        torch.zeros((s, r), dtype=torch.int32, device=svc.device),
        torch.where(in_slice, svc, s),
        bucket,
        rank,
        valid,
    )
    cms_d = cms.cms_count(cidx, valid, cms_width)
    cnt, lat_sum, lat_sumsq = ewma.segment_stats(log_lat, svc, s, valid=valid)
    _, err_sum, _ = ewma.segment_stats(is_error, svc, s, valid=valid)
    stats = torch.stack([cnt, lat_sum, lat_sumsq, err_sum], dim=0)
    return SketchDelta(hll=hll_d, cms=cms_d, stats=stats)


def sketch_delta_plain(
    svc: torch.Tensor,
    log_lat: torch.Tensor,
    is_error: torch.Tensor,
    trace_hi: torch.Tensor,
    trace_lo: torch.Tensor,
    cidx: torch.Tensor,
    valid: torch.Tensor,
    *,
    num_services: int,
    hll_p: int,
    cms_width: int,
) -> SketchDelta:
    """Plain PyTorch version of the ``sketch_delta`` kernel, in the
    reference kernel's terms: rank 0 for invalid or out-of-slice lanes,
    flat cell ``where(in_slice, svc, 0)·R + bucket``, CMS weight
    ``valid``, the stats one-hot dropping ``svc ∉ [0, S)``, and features
    premasked by ``valid``."""
    s = num_services
    r = 1 << hll_p
    dev = svc.device
    svc = svc.to(torch.int64)
    in_slice = (svc >= 0) & (svc < s)
    bucket, rank = hll.hll_indices(trace_hi, trace_lo, p=hll_p)
    rank = torch.where(valid & in_slice, rank, 0)
    flat = torch.where(in_slice, svc, 0) * r + bucket.to(torch.int64)
    hll_d = torch.zeros(s * r, dtype=torch.int32, device=dev)
    hll_d.scatter_reduce_(0, flat, rank, reduce="amax", include_self=True)

    d = cidx.shape[0]
    keys = cidx.to(torch.int64) + torch.arange(d, device=dev)[:, None] * cms_width
    ones = valid.to(torch.int32).expand(d, -1)
    cms_d = torch.zeros(d * cms_width, dtype=torch.int32, device=dev)
    cms_d.index_add_(0, keys.reshape(-1), ones.reshape(-1))

    valid_f = valid.to(torch.float32)
    ll = log_lat.to(torch.float32) * valid_f
    feats = torch.stack([valid_f, ll, ll * ll, is_error.to(torch.float32) * valid_f])
    seg = torch.where(valid & in_slice, svc, s)
    onehot = (torch.arange(s, device=dev)[None, :] == seg[:, None]).to(torch.float32)
    return SketchDelta(
        hll=hll_d.view(s, r), cms=cms_d.view(d, cms_width), stats=feats @ onehot
    )


def _copy_heads(heads: HeadState, new: HeadState) -> None:
    for dst, src in zip(heads, new):
        dst.copy_(src)


def fused_update_plain(
    hll_cur: torch.Tensor,  # int32[W, S, R] — updated in place
    cms_cur: torch.Tensor,  # int32[W, D, Wc] — updated in place
    svc: torch.Tensor,
    log_lat: torch.Tensor,
    is_error: torch.Tensor,
    trace_hi: torch.Tensor,
    trace_lo: torch.Tensor,
    cidx: torch.Tensor,
    valid: torch.Tensor,
    *,
    num_services: int,
    hll_p: int,
    heads: HeadState | None = None,
    dt: torch.Tensor | None = None,
    step_pos: torch.Tensor | None = None,
    statics: dict | None = None,
):
    """Plain PyTorch version of the ``fused_update`` kernel: the delta's
    plain version merged into every bank. Returns ``stats`` or, with
    ``heads`` (advanced in place), ``(stats, (lat_z, err_z, rate_z))``."""
    delta = sketch_delta_plain(
        svc, log_lat, is_error, trace_hi, trace_lo, cidx, valid,
        num_services=num_services, hll_p=hll_p, cms_width=cms_cur.shape[-1],
    )
    hll_cur.copy_(torch.maximum(hll_cur, delta.hll[None]))
    cms_cur.add_(delta.cms[None])
    if heads is None:
        return delta.stats
    new_heads, zs = head_update(delta.stats, heads, dt, step_pos, **statics)
    _copy_heads(heads, new_heads)
    return delta.stats, zs


def _check_lanes(name, batch, cidx, hll_p) -> None:
    """What both sketch kernels take: one device, contiguous 1-D lanes of
    one length, int32 ``cidx[D, B]`` with D <= 8, and an HLL precision in
    [1, 31]."""
    dev = batch[0].device
    if any(t.device != dev for t in (*batch, cidx)):
        raise ValueError(f"{name}: all tensors must be on one device")
    want = (torch.int32, torch.float32, torch.float32, torch.int32, torch.int32, torch.bool)
    for lane, t, dtype in zip(
        ("svc", "log_lat", "is_error", "trace_hi", "trace_lo", "valid"), batch, want
    ):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: {lane} must be contiguous 1-D {dtype}")
    b = batch[0].shape[0]
    if any(t.shape[0] != b for t in batch) or cidx.dim() != 2 or cidx.shape[1] != b:
        raise ValueError(f"{name}: batch lanes disagree in length")
    if cidx.dtype != torch.int32 or not cidx.is_contiguous():
        raise ValueError(f"{name}: cidx must be contiguous int32 [D, B]")
    if not 1 <= hll_p <= 31:
        raise ValueError(f"{name}: hll_p={hll_p} out of range")
    if cidx.shape[0] > _SKETCH_MAX_DEPTH:
        raise ValueError(
            f"{name} keeps at most {_SKETCH_MAX_DEPTH} CMS rows a lane in registers"
        )


class SketchPlan(NamedTuple):
    """How the sketch kernel of ``fused_update`` and ``sketch_delta`` is
    launched for one batch."""

    grid: int  # blocks
    threads: int  # threads per block
    lanes_per_block: int  # each block's run of lanes; the last may be short
    smem_bytes: int  # dynamic shared memory per block
    tile: int  # services a warp's stats accumulators cover at a time


# Threads per block of the sketch kernel at most (its __launch_bounds__),
# and the CMS rows a lane keeps in registers (kMaxDepth).
_SKETCH_MAX_THREADS = 512
_SKETCH_MAX_DEPTH = 8
# Lanes per block at least: at B = 2048, runs of 32 or 64 lanes (64 or 32
# blocks) were slower on the H100 than 16 blocks of 128 (PERF.md): the
# kernel waits on memory, and more blocks add partials to sum.
_SKETCH_MIN_LANES = 128
# Dynamic shared memory of a block, in floats: the 48 KB a block gets
# without opting in to more, whatever the service count.
_SKETCH_SMEM_FLOATS = 48 * 1024 // 4


def launch_plan(b: int, num_services: int, n_sms: int = _kernels.N_SMS) -> SketchPlan:
    """The sketch kernel's launch for ``b`` lanes and ``num_services``
    services on a card of ``n_sms`` SMs: at most one block per SM, each
    over a run of whole 32-lane warp slices (at least 128 lanes), one
    thread per lane up to 512, so the grid spreads a batch over as many
    SMs as its lanes allow and each warp loads its lanes once. It depends
    on the batch, the service count and the card alone (not on the CMS
    depth or the window count), so ``fused_update`` and ``sketch_delta``
    sum the stats of one batch in the same order.

    Shared memory holds each warp's stats for a tile of services
    ``[4, tile]`` and a 32-lane staging slice, and the epilogue's stats
    of a chunk of services (a float a thread). The tile is every service
    where that fits in 48 KB (168 services at 16 warps, 744 at 4) and the
    most that does past it: the kernel then walks the services a tile at
    a time. So shared memory does not grow with the service count, every
    count gets whole warps, and none needs the opt-in.
    """
    per_sm = -(-b // n_sms)
    lanes = max(_SKETCH_MIN_LANES, -(-per_sm // 32) * 32)
    threads = min(_SKETCH_MAX_THREADS, lanes)
    warps = threads // 32
    room = (_SKETCH_SMEM_FLOATS - threads - 64 * warps) // (4 * warps)
    tile = max(1, min(num_services, room))
    smem = (warps * (4 * tile + 64) + threads) * 4
    return SketchPlan(max(1, -(-b // lanes)), threads, lanes, smem, tile)


def _check_kernel_args(hll_cur, cms_cur, batch, cidx, heads, hll_p) -> None:
    dev = hll_cur.device
    if any(t.device != dev for t in [cms_cur, batch[0], *(heads or ())]):
        raise ValueError("fused_update: all tensors must be on one device")
    _check_lanes("fused_update", batch, cidx, hll_p)
    for name, bank in (("hll_cur", hll_cur), ("cms_cur", cms_cur)):
        if (
            bank.dtype != torch.int32
            or bank.dim() != 3
            or bank.stride(2) != 1
            or bank.stride(1) != bank.shape[2]
        ):
            raise ValueError(
                f"fused_update: {name} must be int32 [W, rows, cols] with "
                "contiguous rows (any window stride)"
            )
    if hll_cur.shape[2] != 1 << hll_p or cms_cur.shape[1] != cidx.shape[0]:
        raise ValueError("fused_update: bank shapes disagree with hll_p / cidx")
    if hll_cur.shape[0] != cms_cur.shape[0]:
        raise ValueError("fused_update: HLL and CMS window counts differ")
    for h in heads or ():
        if h.dtype != torch.float32 or not h.is_contiguous():
            raise ValueError("fused_update: head arrays must be contiguous float32")


def fused_update(
    hll_cur: torch.Tensor,
    cms_cur: torch.Tensor,
    svc: torch.Tensor,
    log_lat: torch.Tensor,
    is_error: torch.Tensor,
    trace_hi: torch.Tensor,
    trace_lo: torch.Tensor,
    cidx: torch.Tensor,
    valid: torch.Tensor,
    *,
    num_services: int,
    hll_p: int,
    heads: HeadState | None = None,
    dt: torch.Tensor | None = None,
    step_pos: torch.Tensor | None = None,
    statics: dict | None = None,
):
    """The ``fused_update`` kernel's wrapper. CPU tensors run
    :func:`fused_update_plain`; CUDA tensors launch the kernel (or
    raise); other devices raise. Same returns as the plain version."""
    dev = hll_cur.device
    if dev.type == "cpu":
        return fused_update_plain(
            hll_cur, cms_cur, svc, log_lat, is_error, trace_hi, trace_lo,
            cidx, valid, num_services=num_services, hll_p=hll_p,
            heads=heads, dt=dt, step_pos=step_pos, statics=statics,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_update has no kernel for device {dev}")
    batch = (svc, log_lat, is_error, trace_hi, trace_lo, valid)
    _check_kernel_args(hll_cur, cms_cur, batch, cidx, heads, hll_p)
    s = num_services
    plan = launch_plan(svc.shape[0], s, _kernels.sm_count(dev.index))
    partials = torch.empty((plan.grid, 4, s), dtype=torch.float32, device=dev)
    stats = torch.empty((4, s), dtype=torch.float32, device=dev)
    zs = None
    step_idx = None
    if heads is not None:
        t = heads.lat_mean.shape[1]
        zs = tuple(torch.empty((s, t), dtype=torch.float32, device=dev) for _ in range(3))
        dt = dt.to(dtype=torch.float32).contiguous()
        step_idx = step_pos.to(dtype=torch.int32).contiguous()
    _kernels.launch_fused_update(
        svc=svc, log_lat=log_lat, is_error=is_error, trace_hi=trace_hi,
        trace_lo=trace_lo, cidx=cidx, valid=valid, num_services=s,
        hll_p=hll_p, cms_width=cms_cur.shape[2], hll_cur=hll_cur,
        cms_cur=cms_cur, partials=partials, stats=stats, plan=plan,
        heads=heads, dt=dt, step_idx=step_idx, zs=zs, statics=statics,
    )
    return stats if heads is None else (stats, zs)


def sketch_delta(
    svc: torch.Tensor,
    log_lat: torch.Tensor,
    is_error: torch.Tensor,
    trace_hi: torch.Tensor,
    trace_lo: torch.Tensor,
    cidx: torch.Tensor,
    valid: torch.Tensor,
    *,
    num_services: int,
    hll_p: int,
    cms_width: int,
) -> SketchDelta:
    """The ``sketch_delta`` kernel's wrapper. CPU tensors run
    :func:`sketch_delta_plain`; CUDA tensors launch the kernel (or
    raise); other devices raise."""
    dev = svc.device
    kw = dict(num_services=num_services, hll_p=hll_p, cms_width=cms_width)
    if dev.type == "cpu":
        return sketch_delta_plain(
            svc, log_lat, is_error, trace_hi, trace_lo, cidx, valid, **kw
        )
    if dev.type != "cuda":
        raise ValueError(f"sketch_delta has no kernel for device {dev}")
    _check_lanes(
        "sketch_delta", (svc, log_lat, is_error, trace_hi, trace_lo, valid),
        cidx, hll_p,
    )
    s, d, r = num_services, cidx.shape[0], 1 << hll_p
    plan = launch_plan(svc.shape[0], s, _kernels.sm_count(dev.index))
    # One buffer for both integer outputs; the kernel clears it.
    out = torch.empty(s * r + d * cms_width, dtype=torch.int32, device=dev)
    delta = SketchDelta(
        hll=out[: s * r].view(s, r),
        cms=out[s * r:].view(d, cms_width),
        stats=torch.empty((4, s), dtype=torch.float32, device=dev),
    )
    partials = torch.empty((plan.grid, 4, s), dtype=torch.float32, device=dev)
    _kernels.launch_sketch_delta(
        svc=svc, log_lat=log_lat, is_error=is_error, trace_hi=trace_hi,
        trace_lo=trace_lo, cidx=cidx, valid=valid, **kw, out=out,
        partials=partials, stats=delta.stats, plan=plan,
    )
    return delta


def sketch_batch_update(
    hll_cur: torch.Tensor,  # int32[W, S, R] — current window banks, in place
    cms_cur: torch.Tensor,  # int32[W, D, Wc] — current window banks, in place
    svc: torch.Tensor,  # int[B] — local service ids (may be out of range)
    log_lat: torch.Tensor,  # float32[B]
    is_error: torch.Tensor,  # float32[B]
    trace_hi: torch.Tensor,  # int32[B] — uint32 bits
    trace_lo: torch.Tensor,  # int32[B]
    cidx: torch.Tensor,  # int32[D, B]
    valid: torch.Tensor,  # bool[B]
    *,
    num_services: int,
    hll_p: int = hll.HLL_P,
    cms_width: int = cms.CMS_WIDTH,
    impl: str = "xla",  # "xla" | "pallas" | "interpret"
    heads: HeadState | None = None,
    dt: torch.Tensor | float | None = None,
    step_pos: torch.Tensor | bool | None = None,
    taus_s: tuple | None = None,
    warmup_batches: float | None = None,
    z_warmup_batches: float | None = None,
    cusum_k: float | None = None,
    cusum_cap: float | None = None,
    err_slack: float | None = None,
):
    """One-pass batch absorption into every current window bank.

    Returns ``(hll_cur, cms_cur, stats)``, or with ``heads`` (plus
    ``dt``, ``step_pos`` and the head constants, all required then)
    ``(hll_cur, cms_cur, stats, heads, (lat_z, err_z, rate_z))``. The
    banks and the heads are updated in place and returned as the same
    tensors. ``step_pos`` may be a bool or the step counter itself
    (positive past step 0).
    """
    if cms_cur.shape[-1] != cms_width:
        raise ValueError(f"cms_cur width {cms_cur.shape[-1]} != cms_width {cms_width}")
    statics = None
    if heads is not None:
        required = dict(
            taus_s=taus_s, warmup_batches=warmup_batches,
            z_warmup_batches=z_warmup_batches, cusum_k=cusum_k,
            cusum_cap=cusum_cap, err_slack=err_slack, dt=dt,
            step_pos=step_pos,
        )
        missing = [k for k, v in required.items() if v is None]
        if missing:
            raise TypeError(
                f"sketch_batch_update(heads=...) requires {missing} (the "
                "head constants come from DetectorConfig — no defaults here)"
            )
        statics = {k: required[k] for k in _HEAD_STATICS}
        statics["taus_s"] = tuple(float(t) for t in taus_s)
        dev = hll_cur.device
        dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
        step_pos = torch.as_tensor(step_pos, device=dev)

    if impl == "xla":
        delta = sketch_batch_delta(
            svc, log_lat, is_error, trace_hi, trace_lo, cidx, valid,
            num_services=num_services, hll_p=hll_p, cms_width=cms_width,
        )
        hll_cur.copy_(torch.maximum(hll_cur, delta.hll[None]))
        cms_cur.add_(delta.cms[None])
        if heads is None:
            return hll_cur, cms_cur, delta.stats
        new_heads, zs = head_update(delta.stats, heads, dt, step_pos, **statics)
        _copy_heads(heads, new_heads)
        return hll_cur, cms_cur, delta.stats, heads, zs
    if impl == "pallas":
        update = fused_update
    elif impl == "interpret":
        update = fused_update_plain
    else:
        raise ValueError(f"unknown sketch impl {impl!r}")
    out = update(
        hll_cur, cms_cur, svc, log_lat, is_error, trace_hi, trace_lo, cidx,
        valid, num_services=num_services, hll_p=hll_p, heads=heads, dt=dt,
        step_pos=step_pos, statics=statics,
    )
    if heads is None:
        return hll_cur, cms_cur, out
    stats, zs = out
    return hll_cur, cms_cur, stats, heads, zs


def resolve_impl(requested: str | None, device: torch.device) -> str:
    """A config's ``sketch_impl`` → a concrete impl: ``None`` is the
    kernel on CUDA and the composed path elsewhere."""
    if requested is None:
        return "pallas" if device.type == "cuda" else "xla"
    if requested not in ("xla", "pallas", "interpret"):
        raise ValueError(f"unknown sketch impl {requested!r}")
    return requested
