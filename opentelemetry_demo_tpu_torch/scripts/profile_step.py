"""Component timing of the detector step: where a step's time goes.

The slope method of the bench line: two state-chained regions of k and
3k steps, each ended by a fetch of ``step_idx`` and a synchronise; the
per-step cost is the difference over 2k, so the fixed costs cancel. On
the card each region is timed with CUDA events (start before its first
step, stop after its last), on the CPU with the host clock.

Rows, as the reference's ``scripts/profile_step.py`` prints them for the
composed (``"xla"``) path: the full step; the sketch delta alone (HLL,
CMS count, stats, merged into the banks); the delta without the CMS
count. Their differences give the CMS histogram (the histogram kernel
and the bank add) and the rest of the step (the heavy-hitter query, the
heads, the report). The reference needed its variant without the CMS
delta because XLA drops an unused result from a jitted function; eager
PyTorch drops nothing, so here that variant leaves the CMS count out of
its body, which is what the reference's dead-code elimination did, and
the row keeps the reference's name. The same split for the
``"pallas"`` path: the full step against the fused-update kernel alone
(banks and heads in one launch).

Usage: python -m opentelemetry_demo_tpu_torch.scripts.profile_step [B]
       [--device cuda|cpu]   (B defaults to 524288)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..bench import BASELINE_SPANS_PER_SEC, bench_device, make_batch_pool
from ..models import DetectorConfig, detector_init, detector_step
from ..ops import cms, ewma, fused, hll


def make_delta(config: DetectorConfig, use_cms: bool):
    """The composed path's sketch delta merged into the current banks;
    ``use_cms=False`` leaves the CMS count out. ONE body builds both, so
    they cannot measure different computations."""
    s, r = config.num_services, 1 << config.hll_p

    def fn(st, svc, lat_us, is_error, hi, lo, ahi, alo, valid, dt, mask):
        log_lat = torch.log1p(torch.clamp(lat_us, min=0.0))
        svc = svc.to(torch.int64)
        in_slice = (svc >= 0) & (svc < s)
        bucket, rank = hll.hll_indices(hi, lo, p=config.hll_p)
        hll_d = hll.hll_update(
            torch.zeros((s, r), dtype=torch.int32, device=svc.device),
            torch.where(in_slice, svc, s), bucket, rank, valid,
        )
        cnt, _, _ = ewma.segment_stats(log_lat, svc, s, valid=valid)
        cur = st.hll_bank[:, 0]
        cur.copy_(torch.maximum(cur, hll_d[None]))
        st.obs_batches.add_(cnt)
        st.step_idx.add_(1)
        if use_cms:
            cidx = cms.cms_indices(ahi, alo, config.cms_depth, config.cms_width)
            st.cms_bank[:, 0].add_(cms.cms_count(cidx, valid, config.cms_width)[None])
        return st, None

    return fn


def make_fused(config: DetectorConfig):
    """The fused-update kernel alone (``"pallas"``): banks and heads in
    one launch, on the step's own inputs."""
    head_kw = dict(
        taus_s=tuple(config.taus_s), warmup_batches=config.warmup_batches,
        z_warmup_batches=config.z_warmup_batches, cusum_k=config.cusum_k,
        cusum_cap=config.cusum_cap, err_slack=config.err_slack,
    )

    def fn(st, svc, lat_us, is_error, hi, lo, ahi, alo, valid, dt, mask):
        log_lat = torch.log1p(torch.clamp(lat_us, min=0.0))
        cidx = cms.cms_indices(ahi, alo, config.cms_depth, config.cms_width)
        heads = fused.HeadState(
            lat_mean=st.lat_mean, lat_var=st.lat_var, err_mean=st.err_mean, rate_mean=st.rate_mean,
            rate_var=st.rate_var, cusum=st.cusum, obs_batches=st.obs_batches,
        )
        fused.sketch_batch_update(
            st.hll_bank[:, 0], st.cms_bank[:, 0], svc, log_lat, is_error, hi, lo, cidx, valid,
            num_services=config.num_services, hll_p=config.hll_p, cms_width=config.cms_width,
            impl="pallas", heads=heads, dt=dt, step_pos=st.step_idx, **head_kw,
        )
        st.step_idx.add_(1)
        return st, None

    return fn


def main(argv: list[str] | None = None) -> dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=524288)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the step runs (default: the card)")
    args = parser.parse_args(argv)
    device = bench_device(args.device)
    b = args.batch
    config = DetectorConfig()
    pool = make_batch_pool(config, b, 2, np.random.default_rng(0), device)
    dt = torch.tensor(b / BASELINE_SPANS_PER_SEC, dtype=torch.float32, device=device)
    mask = torch.zeros(len(config.windows_s), dtype=torch.bool, device=device)
    cuda = device.type == "cuda"

    def slope(name, fn, cfg=config, iters=20):
        """Per-step seconds of a state-chained fn(state, *batch, dt, mask)."""

        def region(k, st):
            if cuda:
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            for i in range(k):
                st, _ = fn(st, *pool[i % 2], dt, mask)
            if cuda:
                stop.record()
            int(st.step_idx.item())  # the fetch forces the chain
            if cuda:
                torch.cuda.synchronize(device)
                return start.elapsed_time(stop) / 1e3, st
            return time.perf_counter() - t0, st

        st = detector_init(cfg, device)
        _, st = region(3, st)
        t1, st = region(iters, st)
        t2, st = region(3 * iters, st)
        per = (t2 - t1) / (2 * iters)
        print(f"{name:34s} {per*1e3:8.2f} ms   {b/per/1e6:7.1f}M spans/s")
        return per

    def step(cfg):
        return lambda st, *a: detector_step(cfg, st, *a)

    xla = config._replace(sketch_impl="xla")
    pallas = config._replace(sketch_impl="pallas")
    rows: dict[str, float] = {}
    rows["full step"] = slope("full step", step(xla), xla)
    rows["delta"] = slope("delta xla (hll+cms+stats, used)", make_delta(config, use_cms=True))
    rows["no_cms"] = slope("delta xla w/o cms hist (DCE'd)", make_delta(config, use_cms=False))
    print(f"{'-> cms histogram sort (xla)':34s} {(rows['delta'] - rows['no_cms'])*1e3:8.2f} ms")
    print(f"{'-> rest (queries/heads/report)':34s} {(rows['full step'] - rows['delta'])*1e3:8.2f} ms")
    rows["full step pallas"] = slope("full step (pallas)", step(pallas), pallas)
    rows["fused"] = slope("fused update (pallas) alone", make_fused(config))
    print(f"{'-> rest (pallas: queries/report)':34s} {(rows['full step pallas'] - rows['fused'])*1e3:8.2f} ms")
    return rows


if __name__ == "__main__":
    main()
