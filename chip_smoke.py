"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --nccl-cards 4   # the four-rank mesh leg over NCCL, one card per rank

Builds the hand-written kernels from ``opentelemetry_demo_tpu_torch/csrc``,
holds each against its plain PyTorch version at the main path's shapes
and on edge cases, checks the detector on the card against the CPU on a
small input and with 65,536 and 131,072 CMS bins, then
drives the main path end to end (OTLP protobuf bodies → decode →
``SpanTensorizer`` → ``DetectorPipeline`` → reports) at the default
``DetectorConfig`` with an injected latency fault, at batch width 2048
(``sketch_impl=None``: the fused-update kernel) and 65536
(``sketch_impl="xla"``: the CMS-histogram kernel).

The state that outlives a batch follows. Checkpoint resume, at the
default config (the fused-update kernel) and at
``DetectorConfig(cms_width=16384, sketch_impl="xla")`` (the
CMS-histogram kernel): a pipeline is saved with a report in flight,
resumed from the file on the card, and must equal an uninterrupted run
bit for bit with the same flags; a truncated and a bit-flipped file must
cold-start into quarantine. The metrics head: OTLP metric bodies for the
shop's services at a virtual 10 s cadence, the head on the card against
the CPU, with a ×10 rate step. The keyspace: a cardinality bomb on a
virtual clock, the ladder, idle-key eviction on the card against the CPU
twin, and the keyspace through a checkpoint. Each prints its times
(lock held, save, load, CRC rate; head step; lock held per sweep).

The ingest path follows, as a deployment runs it: the native OTLP
decoder (``csrc/host/ingest.cc``, built with the host compiler beside the
kernels) must give the Python decoder's columns bit for bit on the e2e
bodies; each e2e leg runs again through ``decode_otlp_many`` →
``submit_columnar`` → the device-put spine → the async harvester,
against a twin with the spine off and synchronous harvest (final states
bit-identical, the same flags, one launch a batch), and once more under
``torch.profiler`` for the card's busy share of that run's wall; a spin
kernel ahead of each step then queues the spine's copies behind running
steps, at ring depths 1 and 2, and the state must still equal the spine
off's bit for bit; overloadbench runs
at five times the B = 2048 native leg's span rate (error-lane shed 0,
rows conserved, brownout engaged and relaxed) and lagbench at its
default rate (p99 under 100 ms).

The OTLP front doors follow (``phase_doors``): the port's
``OtlpHttpReceiver`` and native ``FrontDoorServer`` (``csrc/host/frontdoor.cc``,
built beside the decoder) on 127.0.0.1, in front of an ``IngestPool`` and
the pipeline. One client POSTs the e2e legs' bodies at B = 2048 and
65536 and the final state must equal the in-process twin's bit for bit,
with the same reports and flags. A throughput leg at 65536 runs the
null-sink ``measure_frontdoor_vs_pool``, then 16 clients through each door
into the pipeline, as threads of this process and as a process of their
own: spans/s answered 200, rows conserved, lag p99. Then the verdicts:
400, 413, chunked, 429 with ``Retry-After`` (a full row budget and a full
pool queue), metrics into the ``MetricsFeed`` on the card and logs into
the ``LogStore``. Every leg recycles its decode scratch, finds none
corrupt and allocates a bounded number.

The Kafka orders leg follows (``phase_orders``), with no external
broker: the port's ``KafkaBroker`` in process with three partitions,
orders made from a seed, every leg consuming over the socket with
``OrdersSource``. The live leg (B = 2048, spine, async harvester) feeds
4,096 orders/s on a virtual clock pumped every 0.1 s; a producer flood
(each order four times) at 40 s must flag ``checkout-orders`` on its
first batch and never before; ``anomalyDetectorEnabled`` is switched off
for five pumps through the flag editor's route (state bit-identical,
rows conserved) and ``anomalyDetectorZThreshold`` raised for a flood
second (flags equal a numpy recomputation). The resume leg saves a
checkpoint with the per-partition offsets and resumes through a new
source's ``seek``, bit-identical, with a poison pill and a tombstone in
the stream and an epoch-tagged commit. The backlog leg replays 262,144
orders at B = 65536 through ``poll_batch`` → ``IngestPool.submit_records``
against the native ``decode_orders_columnar`` twin, bit-identical, and
prints the time split.

The mesh path follows (``parallel.make_sharded_step``, whose delta runs
the sketch-delta kernel on every rank): a one-rank NCCL world against the
single-device step at widths 2048 and 65536, then a four-rank gloo world
on the one card (NCCL refuses two ranks on one device) as a (2 batch × 2
sketch) mesh at global width 65536, with clean batches, a ×10 latency
step on one service, and a short ring-merge replay. Integer banks must
equal the single-device step's, batch replicas must be bit-identical,
and the fault must flag on the first batch after onset and not before.
Both worlds also resume a single-device snapshot
(``checkpoint.load_onto_mesh``) and must continue as the single-device
step does.

Each leg's detector step is timed and split into its device operations
(``torch.profiler``). It finishes with each kernel's time beside its
plain version, a library call where one exists, and its memory bound.

With ``--nccl-cards 4`` it runs only the four-rank mesh leg, each rank
on its own card over NCCL, against the single-device step: the path that
exists only across cards. Its record goes to
``chiprun_out/chip_smoke_nccl.json``.

Any failed phase raises, so the script exits non-zero and prints no
result. Without a CUDA device it exits non-zero at once. The last line
of standard output is ``{"ok": true, "device": {...}}``; the lines before
it are the kernel table as one JSON object and the card's name and power
limit. The build log goes to ``chiprun_out/chip_smoke_build.log``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# The H100 SXM's memory rate, bytes/s (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12

# Float outputs: sums taken in another order (per-block partials vs a
# one-hot product) move them by a few ulp.
RTOL, ATOL = 1e-4, 1e-5

N_SERVICES = 20
DT_S = 0.25  # virtual seconds between batches


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> tuple[float | None, float]:
    """``(device ms, wall ms)`` per call of ``fn``.

    Wall: ``iters`` calls back to back between two synchronises, on the
    host clock; for a small kernel that is its launch overhead. Device: a
    spin kernel (``torch.cuda._sleep``) holds the stream while the host
    enqueues the calls, so the CUDA events bracket the device work alone.
    If the spin ends before the host has enqueued every call (the host
    also blocks once the device's launch queue is full), the measurement
    is repeated with half the calls, down to one, then with a longer
    spin. Device is ``None`` when ``fn`` waits on the device itself, so
    that no spin stays ahead.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters * 1e3
    spin = 10_000_000  # cycles, a few ms at the H100's clock
    while spin <= 700_000_000:  # at most about a third of a second
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        ahead = not start.query()
        stop.synchronize()
        if ahead:
            return start.elapsed_time(stop) / iters, wall
        if iters > 1:
            iters //= 2
        else:
            spin *= 4
    return None, wall


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max().item())


def close(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.allclose(a, b, rtol=RTOL, atol=ATOL)


# -- inputs at the main path's shapes -----------------------------------------


def batch_lanes(rng, cfg, b: int, device, n_active: int = N_SERVICES):
    """One packed batch as the detector step hands it to the sketch update,
    over ``n_active`` services: a few lanes are padding, a few carry
    service ids ≥ S."""
    from opentelemetry_demo_tpu_torch.ops import cms
    from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanTensorizer

    n = b - b // 32
    svc = rng.integers(0, n_active, n).astype(np.int32)
    svc[: n // 64] = rng.integers(cfg.num_services, cfg.num_services + 8, n // 64)
    batch = SpanTensorizer(cfg.num_services, b).pack_arrays(
        svc,
        rng.gamma(4.0, 250.0, n).astype(np.float32),
        rng.integers(0, 2**63, n, dtype=np.uint64),
        (rng.random(n) < 0.02).astype(np.float32),
        rng.zipf(1.3, n).astype(np.uint64),
    )

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    attr_hi, attr_lo = dev(batch.attr_hi.view(np.int32)), dev(batch.attr_lo.view(np.int32))
    return dict(
        svc=dev(batch.svc),
        log_lat=torch.log1p(dev(batch.lat_us)),
        is_error=dev(batch.is_error),
        trace_hi=dev(batch.trace_hi.view(np.int32)),
        trace_lo=dev(batch.trace_lo.view(np.int32)),
        cidx=cms.cms_indices(attr_hi, attr_lo, cfg.cms_depth, cfg.cms_width),
        valid=dev(batch.valid),
    )


def random_state(rng, cfg, device):
    """Banks with history in both halves (so the current bank is a strided
    view) and heads past their warmups."""
    s, t, nw = cfg.num_services, cfg.num_taus, cfg.num_windows

    def dev(x):
        return torch.from_numpy(x).to(device)

    hll_bank = dev(rng.integers(0, 20, (nw, 2, s, 1 << cfg.hll_p)).astype(np.int32))
    cms_bank = dev(rng.integers(0, 500, (nw, 2, cfg.cms_depth, cfg.cms_width)).astype(np.int32))
    heads = dict(
        lat_mean=rng.gamma(40.0, 0.17, (s, t)),
        lat_var=rng.gamma(2.0, 0.1, (s, t)),
        err_mean=rng.random((s, t)) * 0.05,
        rate_mean=rng.gamma(4.0, 100.0, (s, t)),
        rate_var=rng.gamma(2.0, 500.0, (s, t)),
        cusum=rng.random((s, 3)) * 3.0,
        obs_batches=rng.integers(0, 120, s).astype(np.float64),
    )
    heads = {k: dev(v.astype(np.float32)) for k, v in heads.items()}
    return hll_bank, cms_bank, heads


def head_kw(cfg) -> dict:
    return dict(
        taus_s=tuple(float(x) for x in cfg.taus_s), warmup_batches=cfg.warmup_batches,
        z_warmup_batches=cfg.z_warmup_batches, cusum_k=cfg.cusum_k,
        cusum_cap=cfg.cusum_cap, err_slack=cfg.err_slack,
    )


def delta_bound_bytes(lanes, s: int, cfg) -> int:
    """Bytes the sketch delta must move: each lane read once (svc, log-lat,
    error, trace hi/lo, valid, D row indices) and each output written once
    whole (the delta is cleared and written: S×R registers, D×Wc counters,
    4×S stats)."""
    b, d = lanes["svc"].shape[0], lanes["cidx"].shape[0]
    return b * (4 * 5 + 1 + 4 * d) + (s * (1 << cfg.hll_p) + d * cfg.cms_width + 4 * s) * 4


def delta_args(lanes):
    return tuple(lanes[k] for k in ("svc", "log_lat", "is_error", "trace_hi", "trace_lo", "cidx", "valid"))


def fused_bound_bytes(lanes, cfg) -> int:
    """Bytes the fused update must move for this batch: each lane read once,
    each bank cell the batch touches read and written once in each
    window, the heads read and written, stats and z's written."""
    b, d = lanes["svc"].shape[0], cfg.cms_depth
    s, t, nw, r = cfg.num_services, cfg.num_taus, cfg.num_windows, 1 << cfg.hll_p
    lane_bytes = b * (4 * 5 + 1 + 4 * d)
    svc = lanes["svc"].long()
    ok = lanes["valid"] & (svc >= 0) & (svc < s)
    from opentelemetry_demo_tpu_torch.ops import hll

    bucket, _ = hll.hll_indices(lanes["trace_hi"], lanes["trace_lo"], cfg.hll_p)
    hll_cells = torch.unique((svc * r + bucket.long())[ok]).numel()
    keys = lanes["cidx"].long() + torch.arange(d, device=svc.device)[:, None] * cfg.cms_width
    cms_cells = torch.unique(keys[:, lanes["valid"]]).numel()
    bank_bytes = (hll_cells + cms_cells) * nw * 4 * 2
    head_bytes = (5 * s * t + 3 * s + s) * 4 * 2 + 3 * s * t * 4 + 4 * s * 4 + 8
    return lane_bytes + bank_bytes + head_bytes


# -- phases ------------------------------------------------------------------------


def phase_build():
    import threading

    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import native

    t0 = time.perf_counter()
    # The host libraries' g++ runs beside the kernels' nvcc builds, one
    # thread each.
    host_s = {}
    hosts = [
        threading.Thread(target=lambda name=name, fn=fn: host_s.setdefault(
            name, (fn(), time.perf_counter() - t0)[1]))
        for name, fn in (("decoder", native.available), ("frontdoor", native.frontdoor_available))
    ]
    for th in hosts:
        th.start()
    paths = _kernels.build_all()
    build_s = time.perf_counter() - t0
    for th in hosts:
        th.join()
    check(native.available(), f"the native OTLP decoder did not build: {native.load_error()}")
    check(native.frontdoor_available(), f"the native front door did not build: {native.frontdoor_load_error()}")
    print(f"build: native OTLP decoder {native.library_path().name} in {host_s['decoder']:.2f} s, "
          f"front door {native.library_path(native.FRONTDOOR_SOURCE).name} in {host_s['frontdoor']:.2f} s")
    OUT_DIR.mkdir(exist_ok=True)
    if _kernels.BUILD_LOG:
        (OUT_DIR / "chip_smoke_build.log").write_text(
            "\n".join(f"== {k}\n{v}" for k, v in _kernels.BUILD_LOG.items())
        )
    from opentelemetry_demo_tpu_torch.runtime import frame

    t0 = time.perf_counter()
    check(frame.crc_backend() == "native", f"host CRC32C did not build: {frame._crc_error}")
    print(f"build: {sorted(paths)} in {build_s:.2f} s; host CRC32C in {time.perf_counter() - t0:.2f} s")


def hot_keys(lanes, cfg):
    """The same lanes with every one on service 3, one CMS counter per
    row and one HLL bucket (ranks still differ): the warp-merge case."""
    out = dict(lanes)
    b = lanes["svc"].shape[0]
    d = lanes["cidx"].shape[0]
    out["svc"] = torch.full_like(lanes["svc"], 3)
    rows = torch.arange(d, dtype=torch.int32, device=lanes["cidx"].device)[:, None] * 101 + 7
    out["cidx"] = rows.expand(d, b).contiguous()
    out["trace_lo"] = (lanes["trace_lo"] & ~((1 << cfg.hll_p) - 1)) | 5
    return out


def all_invalid(lanes, cfg):
    return dict(lanes, valid=torch.zeros_like(lanes["valid"]))


def special_cases(rng, cfg, device):
    """``(name, lanes)`` for the edge cases both sketch kernels must hold:
    hot keys, no valid lane, one lane, and a width that is no multiple of
    a block's lanes."""
    base = batch_lanes(rng, cfg, 2048, device)
    return [
        ("hot keys B=2048", hot_keys(base, cfg)),
        ("hot keys B=65536", hot_keys(batch_lanes(rng, cfg, 65536, device), cfg)),
        ("all invalid B=2048", all_invalid(base, cfg)),
        ("B=1", batch_lanes(rng, cfg, 1, device)),
        ("ragged B=3001", batch_lanes(rng, cfg, 3001, device)),
        # More lanes than 512 threads on each SM take in one pass.
        ("ragged B=140001", batch_lanes(rng, cfg, 140001, device)),
    ]


# (B, S) with more head cells than block 0 has threads (128 at B = 2048),
# so the head epilogue takes several passes, and with stats for so many
# services that a block has room for two warps.
MANY_SERVICES = ((2048, 64), (2048, 192), (8192, 1000))


def k1_args(lanes):
    return tuple(lanes[k] for k in ("svc", "log_lat", "is_error", "trace_hi", "trace_lo", "cidx", "valid"))


def run_k1(update, cfg, device, lanes, state):
    """One fused update from a copy of ``state``: ``(hll, cms, floats)``."""
    from opentelemetry_demo_tpu_torch.ops import fused

    hll_bank, cms_bank, heads = state
    hb, cb = hll_bank.clone(), cms_bank.clone()
    hs = fused.HeadState(**{k: v.clone() for k, v in heads.items()})
    stats, zs = update(
        hb[:, 0], cb[:, 0], *k1_args(lanes), num_services=cfg.num_services, hll_p=cfg.hll_p,
        heads=hs, dt=torch.tensor(DT_S, device=device),
        step_pos=torch.tensor(7, dtype=torch.int32, device=device), statics=head_kw(cfg),
    )
    torch.cuda.synchronize()
    return hb, cb, [stats, *hs, *zs]


def check_k1(cfg, device, lanes, state, what, moved=True) -> float:
    """K1 twice and its plain version once on the same inputs: banks
    exact, floats within RTOL/ATOL, the two launches bit-identical."""
    from opentelemetry_demo_tpu_torch.ops import fused

    hk, ck, fk = run_k1(fused.fused_update, cfg, device, lanes, state)
    hk2, ck2, fk2 = run_k1(fused.fused_update, cfg, device, lanes, state)
    hp, cp, fp = run_k1(fused.fused_update_plain, cfg, device, lanes, state)
    check(torch.equal(hk, hp), f"fused_update HLL banks differ ({what})")
    check(torch.equal(ck, cp), f"fused_update CMS banks differ ({what})")
    if moved:
        check(not torch.equal(hk, state[0]) and not torch.equal(ck, state[1]), f"banks unchanged ({what})")
    check(torch.equal(hk, hk2) and torch.equal(ck, ck2), f"fused_update repeat banks differ ({what})")
    worst = 0.0
    for i, (a, a2, p) in enumerate(zip(fk, fk2, fp)):
        check(close(a, p), f"fused_update float output {i} differs ({what}): {max_err(a, p)}")
        check(torch.equal(a, a2), f"fused_update float output {i} differs between two launches ({what})")
        worst = max(worst, max_err(a, p))
    print(f"fused_update {what}: banks bit-exact, floats max abs err {worst:.3g}, repeat bit-identical")
    return worst


def phase_fused_update(cfg, device, results):
    """K1 against its plain version at B = 2048, 8192 and 65536 (the
    widths it is timed at), on the edge cases and at many services."""
    rng = np.random.default_rng(1)
    worst = 0.0
    for b in (2048, 8192, 65536):
        lanes = batch_lanes(rng, cfg, b, device)
        worst = max(worst, check_k1(cfg, device, lanes, random_state(rng, cfg, device), f"B={b}"))
    for what, lanes in special_cases(rng, cfg, device):
        worst = max(worst, check_k1(cfg, device, lanes, random_state(rng, cfg, device), what, moved=False))
    for b, s in MANY_SERVICES:
        c = cfg._replace(num_services=s)
        lanes = batch_lanes(rng, c, b, device, n_active=s)
        worst = max(worst, check_k1(c, device, lanes, random_state(rng, c, device), f"B={b} S={s}"))
    results["fused_update"] = {"max_abs_err": worst}


def flat_keys(idx, valid, width):
    """``idx[D, B]`` as the flat keys ``row·width + index`` with the
    sentinel ``D·width`` on invalid lanes: ``cms_hist``'s input for the
    count ``cms_count`` makes."""
    d = idx.shape[0]
    rows = torch.arange(d, dtype=torch.int32, device=idx.device)[:, None] * width
    return torch.where(valid[None, :], idx + rows, d * width).reshape(-1).contiguous()


def hist_cases(rng, cfg, device):
    """``(name, idx[D, B], valid, W)`` for K2: the composed path's call at
    B = 65536 with the smoke's Zipf(1.3) attributes and with uniform keys,
    hot keys (every key on one counter per row), no valid lane, one key,
    a ragged lane count, and 65,536 and 131,072 bins."""
    d, w = cfg.cms_depth, cfg.cms_width
    main = batch_lanes(rng, cfg, 65536, device)
    uniform = torch.from_numpy(rng.integers(0, w, (d, 65536)).astype(np.int32)).to(device)
    hot = (torch.arange(d, dtype=torch.int32, device=device)[:, None] * 101 + 7).expand(d, 65536).contiguous()
    ones = torch.ones(65536, dtype=torch.bool, device=device)
    ragged = batch_lanes(rng, cfg, 3001, device)
    cases = [
        ("B=65536 Zipf", main["cidx"], main["valid"], w),
        ("B=65536 uniform", uniform, main["valid"], w),
        ("hot keys B=65536", hot, ones, w),
        ("no valid lane B=2048", main["cidx"][:, :2048].contiguous(), torch.zeros_like(ones[:2048]), w),
        ("one key", main["cidx"][:1, :1].contiguous(), ones[:1], w),
        ("ragged 3001 x 4", ragged["cidx"], ragged["valid"], w),
    ]
    for width in (16384, 32768):
        wide = batch_lanes(rng, cfg._replace(cms_width=width), 65536, device)
        cases.append((f"{d * width} bins", wide["cidx"], wide["valid"], width))
    return cases


def check_k2(idx, valid, width, what) -> None:
    """Both entries of K2 twice and their plain versions once: bit-exact,
    the two launches bit-identical, every valid lane counted once a row."""
    from opentelemetry_demo_tpu_torch.ops import cms

    d = idx.shape[0]
    keys = flat_keys(idx, valid, width)
    counts = [cms.cms_count(idx, valid, width) for _ in range(2)]
    hists = [cms.cms_hist(keys, d * width) for _ in range(2)]
    want = cms.cms_count_plain(idx, valid, width)
    want_flat = cms.cms_hist_plain(keys, d * width)
    torch.cuda.synchronize()
    for i in range(2):
        check(torch.equal(counts[i], want), f"cms_count differs from its plain version ({what}, launch {i})")
        check(torch.equal(hists[i], want_flat), f"cms_hist differs from its plain version ({what}, launch {i})")
    check(torch.equal(want_flat.view(d, width), want), f"cms_hist and cms_count disagree ({what})")
    check(int(want.sum()) == d * int(valid.sum()), f"cms_count lost keys ({what})")
    print(f"cms_hist {what}: cms_count and cms_hist ({d} x {idx.shape[1]} keys, {d * width} bins) "
          "exact, repeat bit-identical")


def phase_cms_hist(cfg, device, results):
    """K2's two entries against their plain versions on its cases."""
    rng = np.random.default_rng(2)
    for what, idx, valid, width in hist_cases(rng, cfg, device):
        check_k2(idx, valid, width, what)
    results["cms_hist"] = {"max_abs_err": 0.0}


def check_k3(args, kw, what, nonempty=True) -> float:
    """K3 twice and its plain version once: integers exact, stats within
    RTOL/ATOL, the two launches bit-identical."""
    from opentelemetry_demo_tpu_torch.ops import fused

    got = fused.sketch_delta(*args, **kw)
    again = fused.sketch_delta(*args, **kw)
    want = fused.sketch_delta_plain(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got.hll, want.hll), f"sketch_delta HLL differs ({what})")
    check(torch.equal(got.cms, want.cms), f"sketch_delta CMS differs ({what})")
    if nonempty:
        check(int(got.hll.count_nonzero()) > 0, f"sketch_delta HLL empty ({what})")
    err = max_err(got.stats, want.stats)
    check(close(got.stats, want.stats), f"sketch_delta stats differ ({what}): {err}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"sketch_delta repeat differs ({what})")
    print(f"sketch_delta {what}: integers exact, stats max abs err {err:.3g}, repeat bit-identical")
    return err


def phase_sketch_delta(cfg, device, results):
    """K3 against its plain version at B = 2048, 32768 and 65536, on one
    rank's full width (S=32, D=4) and a (2 × 2) mesh rank's slice (S=16,
    D=2), on the edge cases and at many services."""
    rng = np.random.default_rng(7)
    worst = 0.0
    for s, d in ((32, 4), (16, 2)):
        c = cfg._replace(num_services=s, cms_depth=d)
        kw = dict(num_services=s, hll_p=c.hll_p, cms_width=c.cms_width)
        for b in (2048, 32768, 65536):
            args = delta_args(batch_lanes(rng, c, b, device))
            worst = max(worst, check_k3(args, kw, f"B={b} S={s} D={d}"))
        for what, lanes in special_cases(rng, c, device):
            nonempty = "invalid" not in what and what != "B=1"
            worst = max(worst, check_k3(delta_args(lanes), kw, f"{what} S={s} D={d}", nonempty))
    for b, s in MANY_SERVICES:
        c = cfg._replace(num_services=s)
        kw = dict(num_services=s, hll_p=c.hll_p, cms_width=c.cms_width)
        args = delta_args(batch_lanes(rng, c, b, device, n_active=s))
        worst = max(worst, check_k3(args, kw, f"B={b} S={s} D={c.cms_depth}"))
    results["sketch_delta"] = {"max_abs_err": worst}


def single_device(cfg, stream, rotates, device, keep=()):
    """The single-device step over a stream on the card: ``(final state,
    reports, {step: state after it})`` as numpy."""
    from opentelemetry_demo_tpu_torch.models.detector import (
        DetectorReport, detector_init, detector_step, state_to_numpy,
    )

    state = detector_init(cfg, device)
    dt = torch.tensor(DT_S, device=device)
    reports, kept = [], {}
    for k, (batch, rot) in enumerate(zip(stream, rotates)):
        lanes = [torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).to(device)
                 for x in batch]
        state, rep = detector_step(cfg, state, *lanes, dt, torch.from_numpy(rot).to(device))
        reports.append(DetectorReport(*(t.cpu().numpy() for t in rep)))
        if k + 1 in keep:
            kept[k + 1] = state_to_numpy(state)
    return state_to_numpy(state), reports, kept


def compare_to_single(got_state, got_reports, ref_state, ref_reports, what, skip=()):
    """Integer banks and svc_count exact, flags identical, floats within
    the sharded step's tolerances (stats summed across ranks in another
    order: state rtol 1e-4 / atol 1e-4, report rtol 1e-3 / atol 1e-3).
    Returns the largest float difference."""
    worst = 0.0
    for name in ("hll_bank", "cms_bank", "step_idx"):
        check(np.array_equal(getattr(got_state, name), getattr(ref_state, name)), f"{what}: {name} differs")
    for name in got_state._fields:
        a, b = getattr(got_state, name), getattr(ref_state, name)
        if a.dtype.kind == "f":
            check(np.allclose(a, b, rtol=1e-4, atol=1e-4), f"{what}: state {name} differs")
            worst = max(worst, float(np.abs(a.astype(np.float64) - b).max()))
    check(len(got_reports) == len(ref_reports), f"{what}: {len(got_reports)} reports")
    for k, (g, r) in enumerate(zip(got_reports, ref_reports)):
        check(np.array_equal(g.svc_count, r.svc_count), f"{what}: svc_count differs at step {k}")
        check(np.array_equal(g.flags, r.flags), f"{what}: flags differ at step {k}")
        for name in ("lat_z", "err_z", "rate_z", "card_z", "card_est", "hh_ratio", "cusum"):
            if name in skip:
                continue
            a, b = getattr(g, name), getattr(r, name)
            check(np.allclose(a, b, rtol=1e-3, atol=1e-3), f"{what}: {name} differs at step {k}")
            worst = max(worst, float(np.abs(a.astype(np.float64) - b).max()))
    return worst


def mesh_warmup(cfg, width):
    """A short scenario each world replays first, so the timed replays
    exclude first-use costs (communicators, CUDA context)."""
    from opentelemetry_demo_tpu_torch.parallel import launch

    stream = launch.SyntheticStream(seed=19, n_steps=2, width=width, num_services=cfg.num_services)
    return launch.Scenario(cfg, stream, launch.window_rotations(cfg.windows_s, 2, DT_S), DT_S)


def resume_snapshot(cfg, stream, rotates, device, k, name):
    """The single-device step over ``stream`` on the card, with its state
    after step ``k`` saved as a checkpoint (``checkpoint.save_state``):
    ``(path, final state, reports)``."""
    from opentelemetry_demo_tpu_torch.runtime import checkpoint

    ref_state, ref_reports, kept = single_device(cfg, stream, rotates, device, keep=(k,))
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = str(CKPT_DIR / name)
    checkpoint.save_state(path, kept[k], cfg, offsets={"0": k}, clock_t_prev=(k - 1) * DT_S)
    return path, ref_state, ref_reports


def phase_mesh_one_rank(cfg, device, widths=(2048, 65536), steps=(8, 6), resume=(8, 4)):
    """A one-rank NCCL world against the single-device step: any comm but
    NO_COMM takes the delta path, so the 1 × 1 mesh runs K3 at full
    width. Then the elastic resume: a single-device snapshot at step
    ``resume[1]`` of ``resume[0]`` (B = 2048) through
    ``checkpoint.load_onto_mesh`` and on through the sharded step."""
    from dataclasses import replace

    from opentelemetry_demo_tpu_torch.parallel import launch

    scen = []
    for i, (width, n) in enumerate(zip(widths, steps)):
        stream = launch.SyntheticStream(seed=20 + i, n_steps=n, width=width, num_services=cfg.num_services)
        scen.append(launch.Scenario(cfg, stream, launch.window_rotations(cfg.windows_s, n, DT_S), DT_S))
    n_rs, k_rs = resume
    rs_stream = launch.SyntheticStream(seed=23, n_steps=n_rs, width=widths[0], num_services=cfg.num_services)
    rs_rot = launch.window_rotations(cfg.windows_s, n_rs, DT_S)
    path, rs_state, rs_reports = resume_snapshot(cfg, rs_stream, rs_rot, device, k_rs, "mesh_one_rank")
    resumed = launch.Scenario(cfg, replace(rs_stream, start=k_rs), rs_rot[k_rs:], DT_S, snapshot=path)
    t0 = time.perf_counter()
    out = launch.run_world(launch.replay_sharded, 1, device.type, None, 300.0, (1, 1), device.type,
                           [mesh_warmup(cfg, widths[0]), *scen, resumed])
    (out,) = out
    world_s = time.perf_counter() - t0
    legs = {}
    for sc, got in zip(scen, out[1:]):
        width, n = sc.batches.width, sc.batches.n_steps
        ref_state, ref_reports, _ = single_device(cfg, sc.batches, sc.rotates, device)
        err = compare_to_single(got["state"], got["reports"], ref_state, ref_reports, f"1-rank NCCL B={width}")
        check(got["launches"]["sketch_delta"] == n, f"1-rank B={width}: sketch_delta launched {got['launches']}")
        legs[f"nccl_1x1_B{width}"] = dict(world_s=world_s, steps=n, step_wall_ms=got["wall_s"] / n * 1e3,
                                          launches=got["launches"], max_float_diff=err)
        print(f"mesh 1-rank NCCL B={width}: {n} steps == single-device step (ints exact, floats "
              f"≤ {err:.3g}); {got['wall_s'] / n * 1e3:.3f} ms/step wall; launches {got['launches']}")
    got = out[-1]
    err = compare_to_single(got["state"], got["reports"], rs_state, rs_reports[k_rs:], "1-rank NCCL resume")
    check(got["launches"]["sketch_delta"] == n_rs - k_rs, f"1-rank resume: launches {got['launches']}")
    legs["nccl_1x1_resume"] = dict(steps=n_rs - k_rs, saved_at=k_rs, launches=got["launches"], max_float_diff=err)
    print(f"mesh 1-rank NCCL resume: a single-device snapshot at step {k_rs} loaded with load_onto_mesh, "
          f"{n_rs - k_rs} steps == the single-device continuation (ints exact, floats ≤ {err:.3g}); "
          f"launches {got['launches']}")
    return legs


def phase_mesh_four_ranks(cfg, device, results, backend="gloo", width=65536,
                          n_clean=24, n_fault=3, n_ring=4, resume_at=20):
    """A four-rank (2 batch × 2 sketch) world at global width ``width``:
    clean batches, then a ×10 latency step on one service, and a short
    ring-merge replay of the same start, against the single-device step;
    then the same stream resumed from a single-device snapshot at step
    ``resume_at`` (``checkpoint.load_onto_mesh``). With gloo the four
    ranks share the one card (NCCL refuses two ranks on one device); with
    NCCL each rank takes its own card."""
    from dataclasses import replace

    from opentelemetry_demo_tpu_torch.parallel import launch

    slow = 7
    n = n_clean + n_fault
    fault = launch.SyntheticStream(seed=30, n_steps=n, width=width, num_services=cfg.num_services,
                                   fault_service=slow, fault_from=n_clean)
    rot = launch.window_rotations(cfg.windows_s, n, DT_S)
    ring = launch.SyntheticStream(seed=30, n_steps=n_ring, width=width, num_services=cfg.num_services)
    path, ref_state, ref_reports = resume_snapshot(cfg, fault, rot, device, resume_at, f"mesh_{backend}_2x2")
    scen = [launch.Scenario(cfg, fault, rot, DT_S),
            launch.Scenario(cfg, ring, rot[:n_ring], DT_S, "ring"),
            launch.Scenario(cfg, replace(fault, start=resume_at), rot[resume_at:], DT_S, snapshot=path)]
    t0 = time.perf_counter()
    out = launch.run_world(launch.replay_sharded, 4, device.type, backend, 400.0, (2, 2), device.type,
                           [mesh_warmup(cfg, width), *scen])
    out = [rank_out[1:] for rank_out in out]
    world_s = time.perf_counter() - t0
    what = f"4-rank {backend} (2x2) B={width}"
    _, _, kept = single_device(cfg, fault, rot, device, keep=(n_ring,))
    got = out[0][0]
    # Heavy-hitter candidates are sampled per batch shard past the query
    # cap (16384 of each shard's 32768 lanes, against 16384 of 65536 on
    # one device), so hh_ratio is a different sample and not compared.
    err = compare_to_single(got["state"], got["reports"], ref_state, ref_reports, what, skip=("hh_ratio",))
    ring_got = out[0][1]["state"]
    for name in ("hll_bank", "cms_bank"):
        check(np.array_equal(getattr(ring_got, name), getattr(kept[n_ring], name)), f"ring merge: {name} differs")
    for r, rank_out in enumerate(out):
        for sc_out in rank_out:
            check(sc_out["launches"]["sketch_delta"] > 0, f"rank {r}: sketch_delta never launched")
        replica = out[r ^ 2][0]  # same sketch coordinate, other batch shard
        check(rank_out[0]["coords"]["sketch"] == replica["coords"]["sketch"], "replica pairing")
        for name, a, b in zip(replica["local_state"]._fields, rank_out[0]["local_state"], replica["local_state"]):
            check(a.tobytes() == b.tobytes(), f"batch replicas differ in {name}")
        for ra, rb in zip(rank_out[0]["local_reports"], replica["local_reports"]):
            check(all(a.tobytes() == b.tobytes() for a, b in zip(ra, rb)), "batch replica reports differ")
    flags = [rep.flags for rep in got["reports"]]
    check(not any(f.any() for f in flags[:n_clean]), "flags before onset on the mesh")
    check(bool(flags[n_clean][slow]) and int(flags[n_clean].sum()) == 1,
          f"mesh: first batch after onset flags {np.flatnonzero(flags[n_clean])}, not [{slow}]")
    launches = sum(rank_out[0]["launches"]["sketch_delta"] for rank_out in out)
    check(launches == 4 * n, f"sketch_delta launched {launches} times on the mesh")
    resumed = out[0][2]
    rs_err = compare_to_single(resumed["state"], resumed["reports"], ref_state, ref_reports[resume_at:],
                               f"{what} resume", skip=("hh_ratio",))
    rs_flags = [rep.flags for rep in resumed["reports"]]
    check(not any(f.any() for f in rs_flags[: n_clean - resume_at]), "resumed mesh: flags before onset")
    check(bool(rs_flags[n_clean - resume_at][slow]), "resumed mesh: no flag on the first batch after onset")
    rs_launches = sum(rank_out[2]["launches"]["sketch_delta"] for rank_out in out)
    check(rs_launches == 4 * (n - resume_at), f"resumed mesh: sketch_delta launched {rs_launches} times")
    print(f"mesh {what} resume: a single-device snapshot at step {resume_at} loaded with load_onto_mesh on "
          f"every rank, {n - resume_at} steps == the single-device continuation (ints exact, floats "
          f"≤ {rs_err:.3g}), service {slow} flagged on the first batch after onset; launches {rs_launches}")
    step_ms = [rank_out[0]["wall_s"] / n * 1e3 for rank_out in out]
    print(f"mesh {what}: {n} steps == single-device step (ints exact, floats "
          f"≤ {err:.3g}), replicas bit-identical, service {slow} flagged on the first batch after "
          f"onset; ring merge banks exact; step wall ms per rank {[round(x, 3) for x in step_ms]}; "
          f"sketch_delta launches {launches}; world {world_s:.1f} s")
    results["sketch_delta"]["launches"] = launches
    return {f"{backend}_2x2_B{width}": dict(
        world_s=world_s, steps=n, step_wall_ms_per_rank=step_ms,
        launches_per_rank=[ro[0]["launches"] for ro in out], max_float_diff=err, ttd_batches=1,
        resume=dict(saved_at=resume_at, steps=n - resume_at, launches=rs_launches, max_float_diff=rs_err),
    )}


def phase_detector_vs_cpu(device):
    """The detector on the card against the CPU: on a small input with
    the kernel path and the composed path, then the composed path at the
    default config with 65,536 and 131,072 CMS bins (D = 4), where the
    histogram kernel once raised past 58,112 bins."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanTensorizer

    small = dict(num_services=8, hll_p=8, cms_width=512, windows_s=(0.5, 1.0, 2.5),
                 warmup_batches=3.0, z_warmup_batches=5.0, warmup_windows=1.0)
    cases = [
        (DetectorConfig(**small, sketch_impl=None), 8, 256, 16),
        (DetectorConfig(**small, sketch_impl="xla"), 8, 256, 16),
        (DetectorConfig(cms_width=16384, sketch_impl="xla"), N_SERVICES, 2048, 3),
        (DetectorConfig(cms_width=32768, sketch_impl="xla"), N_SERVICES, 2048, 3),
    ]
    for cfg, n_svc, width, n_steps in cases:
        what = f"impl={cfg.sketch_impl} cms {cfg.cms_depth} x {cfg.cms_width}"
        kernel = "fused_update" if cfg.sketch_impl is None else "cms_hist"
        rng = np.random.default_rng(3)
        tz = SpanTensorizer(cfg.num_services, width)
        card = AnomalyDetector(cfg, device=device)
        cpu = AnomalyDetector(cfg._replace(sketch_impl="xla"), device="cpu")
        before = _kernels.LAUNCHES[kernel]
        for step in range(n_steps):
            n = width - 16
            lat = rng.gamma(4.0, 250.0, n).astype(np.float32)
            svc = rng.integers(0, n_svc, n).astype(np.int32)
            if step >= n_steps // 2:
                lat = np.where(svc == 2, lat * 5, lat).astype(np.float32)
            batch = tz.pack_arrays(svc, lat, rng.integers(0, 300, n, dtype=np.uint64),
                                   (rng.random(n) < 0.05).astype(np.float32),
                                   rng.zipf(1.5, n).astype(np.uint64))
            g = card.observe(batch, step * DT_S)
            c = cpu.observe(batch, step * DT_S)
            for name, a, p in zip(c._fields, g, c):
                a = a.cpu()
                check(bool(torch.isfinite(a.float()).all()), f"{name} not finite")
                check(a.shape == p.shape, f"{name} shape {tuple(a.shape)}")
                if name == "flags":
                    check(torch.equal(a, p), f"flags differ at step {step} ({what})")
                else:
                    check(close(a, p), f"{name} differs at step {step} ({what}): {max_err(a, p)}")
        for name, a, p in zip(card.state._fields, card.state, cpu.state):
            a = a.cpu()
            check(torch.equal(a, p) if not a.is_floating_point() else close(a, p),
                  f"state {name} differs ({what})")
        check(_kernels.LAUNCHES[kernel] == before + n_steps, f"{kernel} not launched once a step ({what})")
        print(f"detector on the card == CPU, {n_steps} steps of {width} lanes ({what})")


def make_bodies(rng, n_bodies, spans, slow=None):
    """OTLP protobuf export bodies from the port's encoder: N_SERVICES
    services, ``slow`` (if given) ten times slower."""
    from opentelemetry_demo_tpu_torch.runtime.otlp import encode_export_request
    from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanRecord

    bodies = []
    for k in range(n_bodies):
        svc = rng.integers(0, N_SERVICES, spans)
        base = 300.0 * (1.0 + svc)
        lat = rng.gamma(8.0, base / 8.0) * np.where(svc == slow, 10.0, 1.0)
        err = rng.random(spans) < 0.01
        attrs = rng.zipf(1.3, spans) % 500
        tids = rng.bytes(16 * spans)
        recs = [
            SpanRecord(f"service-{svc[i]:02d}", float(lat[i]), tids[16 * i:16 * i + 16],
                       bool(err[i]), f"product-{attrs[i]}", "op")
            for i in range(spans)
        ]
        bodies.append(encode_export_request(recs, 10**18 + k * 250_000_000))
    return bodies


SLOW = 7  # the service the e2e legs slow down ten times
_E2E_BODIES: dict = {}


def e2e_bodies(width, n_warm, n_fault, bodies_per_batch):
    """``(clean, faulty, spans per body)``: the e2e legs' OTLP bodies,
    made once per leg shape and shared by the Python and native legs."""
    key = (width, n_warm, n_fault, bodies_per_batch)
    if key not in _E2E_BODIES:
        rng = np.random.default_rng(4)
        spans = width // bodies_per_batch
        pool = 8 * bodies_per_batch if width > 8192 else n_warm + n_fault
        clean = make_bodies(rng, pool, spans)
        faulty = make_bodies(rng, max(pool // 2, n_fault * bodies_per_batch), spans, slow=SLOW)
        _E2E_BODIES[key] = (clean, faulty, spans)
    return _E2E_BODIES[key]


def batch_bodies(clean, faulty, k, n_warm, bodies_per_batch):
    """The bodies of batch ``k``: clean before onset, faulty from it."""
    src, j = (clean, k) if k < n_warm else (faulty, k - n_warm)
    return [src[(j * bodies_per_batch + i) % len(src)] for i in range(bodies_per_batch)]


def phase_end_to_end(device, impl, width, n_warm, n_fault, bodies_per_batch, results):
    """Warm up on clean traffic, then a ×10 latency step on one service:
    it must flag, and nothing may flag before onset."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime.otlp import decode_export_request
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    slow = SLOW
    clean, faulty, spans = e2e_bodies(width, n_warm, n_fault, bodies_per_batch)
    cfg = DetectorConfig(sketch_impl=impl)
    reports = []
    pipe = DetectorPipeline(
        AnomalyDetector(cfg, device=device),
        on_report=lambda t, rep, names: reports.append((t, rep, names)),
        batch_size=width,
    )
    _kernels.reset_launches()
    decode_s = 0.0
    t0 = time.perf_counter()
    for k in range(n_warm + n_fault):
        for body in batch_bodies(clean, faulty, k, n_warm, bodies_per_batch):
            td = time.perf_counter()
            recs = decode_export_request(body)
            decode_s += time.perf_counter() - td
            pipe.submit(recs)
        pipe.pump(k * DT_S)
    pipe.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    n_batches = n_warm + n_fault
    check(pipe.stats.batches == n_batches, f"dispatched {pipe.stats.batches} batches")
    check(pipe.stats.spans == n_batches * width, f"{pipe.stats.spans} spans")
    check(len(reports) == n_batches, f"{len(reports)} reports harvested")
    names = pipe.tensorizer.service_names
    target = f"service-{slow:02d}"
    for t, rep, flagged in reports:
        for name in rep._fields:
            check(bool(np.isfinite(getattr(rep, name).astype(np.float64)).all()), f"{name} not finite")
        check(rep.lat_z.shape == (cfg.num_services, cfg.num_taus), "lat_z shape")
        check(float(rep.svc_count.sum()) == width, "svc_count does not sum to the batch")
    before = [flagged for t, _, flagged in reports[:n_warm] if flagged]
    check(not before, f"flags before onset: {before[:3]}")
    after = [flagged for _, _, flagged in reports[n_warm:] if flagged]
    check(bool(after), f"{target} never flagged")
    check(after[0] == [target], f"first flag after onset names {after[0]}, not {target}")
    check(target in names, "faulted service not interned")
    kernel = "fused_update" if impl is None else "cms_hist"
    check(launches[kernel] == n_batches, f"{kernel} launched {launches[kernel]} times")
    ttd = next(i for i, (_, _, f) in enumerate(reports[n_warm:]) if target in f) + 1
    rate = pipe.stats.spans / wall
    print(f"e2e B={width} impl={impl}: {n_batches} batches, {pipe.stats.spans} spans in "
          f"{wall:.3f} s = {rate:.0f} spans/s (decode {decode_s:.3f} s); "
          f"{target} flagged {ttd} batch(es) after onset; launches {launches}")
    results[kernel]["launches"] = launches[kernel]
    return dict(width=width, impl=impl, spans_per_s=rate, wall_s=wall, decode_s=decode_s,
                batches=n_batches, ttd_batches=ttd, launches=launches)


# -- the native ingest path ---------------------------------------------------------


def decode_threads() -> int:
    return min(8, os.cpu_count() or 1)


def phase_native_decode():
    """The native decoder (``csrc/host/ingest.cc``, built at first use)
    against the Python decoder on the e2e legs' bodies: the columns
    through ``columns_from_columnar`` must equal those through
    ``columns_from_records`` bit for bit, with the same intern table; a
    malformed body must raise on both paths. Then decode spans/s and MB/s
    on one B = 65536 batch (8 bodies), serial and threaded."""
    from opentelemetry_demo_tpu_torch.runtime import native
    from opentelemetry_demo_tpu_torch.runtime.otlp import (
        MONITORED_ATTR_KEYS,
        decode_export_request,
        decode_export_request_columnar,
    )
    from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanTensorizer

    check(native.available(), f"the native OTLP decoder did not build: {native.load_error()}")
    threads = decode_threads()
    compared = 0
    for width, n_warm, n_fault, per in ((2048, 40, 4, 1), (65536, 24, 3, 8)):
        clean, faulty, spans = e2e_bodies(width, n_warm, n_fault, per)
        # Every batch of the B = 2048 leg; the first clean and the first
        # faulty batch of the B = 65536 leg (the Python decode of all of
        # them takes half a minute).
        ks = range(n_warm + n_fault) if width == 2048 else (0, n_warm)
        tz_nat, tz_py = SpanTensorizer(32, width), SpanTensorizer(32, width)
        for k in ks:
            bodies = batch_bodies(clean, faulty, k, n_warm, per)
            cols, rows = native.decode_otlp_many(bodies, MONITORED_ATTR_KEYS, threads=threads)
            check(rows.tolist() == [spans] * per, f"native verdicts {rows.tolist()} (B={width}, batch {k})")
            got = tz_nat.columns_from_columnar(cols)
            ref = tz_py.columns_from_records([r for b in bodies for r in decode_export_request(b)])
            same_bits(got, ref, f"native vs Python columns (B={width}, batch {k})")
            one = tz_nat.columns_from_columnar(decode_export_request_columnar(bodies[0]))
            same_bits(one, ref.slice(0, spans), f"one-body native decode (B={width}, batch {k})")
            compared += got.rows
        check(tz_nat.service_names == tz_py.service_names, f"intern tables differ (B={width})")
    bad = b"\x0a\xff"  # a truncated length
    for what, fn in (("native", lambda: native.decode_otlp(bad, MONITORED_ATTR_KEYS)),
                     ("columnar", lambda: decode_export_request_columnar(bad)),
                     ("Python", lambda: decode_export_request(bad))):
        try:
            fn()
        except ValueError:
            continue
        raise RuntimeError(f"chip smoke check failed: a malformed body decoded on the {what} path")
    _, rows = native.decode_otlp_many([bad, clean[0]], MONITORED_ATTR_KEYS)
    check(rows.tolist() == [-1, 8192], f"per-body verdicts {rows.tolist()}")
    bodies = batch_bodies(clean, faulty, 0, 24, 8)
    n_bytes = sum(len(b) for b in bodies)
    rates = {}
    for n_threads in (1, threads):
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            native.decode_otlp_many(bodies, MONITORED_ATTR_KEYS, threads=n_threads)
            times.append(time.perf_counter() - t0)
        sec = float(np.median(times))
        rates[n_threads] = dict(s=sec, spans_per_s=65536 / sec, mb_per_s=n_bytes / sec / 1e6)
    print(f"native decode == Python decode on {compared} spans (columns and intern tables bit-identical); "
          f"a malformed body raises on both paths; B=65536 batch ({n_bytes} bytes): "
          + "; ".join(f"{t} thread(s) {r['s'] * 1e3:.3f} ms = {r['spans_per_s']:.0f} spans/s, "
                      f"{r['mb_per_s']:.0f} MB/s" for t, r in rates.items()))
    return dict(compared_spans=compared, batch_bytes=n_bytes, threads=threads,
                rates={str(t): r for t, r in rates.items()})


def phase_native_e2e(device, impl, width, n_warm, n_fault, bodies_per_batch, results):
    """The e2e leg on the production ingest path: each batch's bodies
    through ``decode_otlp_many`` into a reused scratch, then
    ``submit_columnar(copy=True)``, into a pipeline with the device-put
    spine (two slots) and the async harvester; beside it a twin with the
    spine off and synchronous harvest. The two final states must be
    bit-identical and every report the async run read must equal the
    twin's; ``service-07`` must flag on the first batch after onset and
    never before; the kernel must launch once a batch in each run. The
    kernel table's launch count is the timed spine run's. A last spine
    run under ``torch.profiler`` gives the card's busy share of its own
    wall (``device_busy``)."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import native
    from opentelemetry_demo_tpu_torch.runtime.otlp import MONITORED_ATTR_KEYS
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    clean, faulty, spans = e2e_bodies(width, n_warm, n_fault, bodies_per_batch)
    cfg = DetectorConfig(sketch_impl=impl)
    kernel = "fused_update" if impl is None else "cms_hist"
    n = n_warm + n_fault
    threads = decode_threads()
    biggest = max(sum(len(b) for b in batch_bodies(clean, faulty, k, n_warm, bodies_per_batch))
                  for k in range(n))
    scratch = native.alloc_scratch(*native.scratch_dims(biggest, bodies_per_batch))

    def run(spine_ring, harvest_async, profile=False):
        reports = []
        pipe = DetectorPipeline(
            AnomalyDetector(cfg, device=device),
            on_report=lambda t, rep, names: reports.append((t, rep, names)),
            batch_size=width, spine_ring=spine_ring, harvest_async=harvest_async,
        )
        _kernels.reset_launches()
        decode_s = tensorize_s = 0.0
        prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA])
                if profile else contextlib.nullcontext())
        with prof:
            t0 = time.perf_counter()
            for k in range(n):
                bodies = batch_bodies(clean, faulty, k, n_warm, bodies_per_batch)
                td = time.perf_counter()
                cols, rows = native.decode_otlp_many(bodies, MONITORED_ATTR_KEYS, scratch=scratch,
                                                     threads=threads)
                tt = time.perf_counter()
                decode_s += tt - td
                check(rows.tolist() == [spans] * bodies_per_batch, f"native verdicts {rows.tolist()}")
                pipe.submit_columnar(cols, copy=True)  # the scratch is reused next batch
                tensorize_s += time.perf_counter() - tt
                pipe.pump(k * DT_S)
            pipe.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        pipe.close()
        check(pipe.stats.batches == n and pipe.stats.spans == n * width,
              f"dispatched {pipe.stats.batches} batches, {pipe.stats.spans} spans")
        check(launches[kernel] == n, f"{kernel} launched {launches[kernel]} times in {n} batches")
        reports.sort(key=lambda r: r[0])
        check(len(reports) + pipe.stats.reports_skipped == n,
              f"{len(reports)} reports read + {pipe.stats.reports_skipped} skipped of {n}")
        out = dict(pipe=pipe, reports=reports, wall=wall, decode_s=decode_s, tensorize_s=tensorize_s,
                   launches=launches[kernel])
        if profile:
            out["device"] = device_activity(prof)
        return out

    # In turns (spine, twin, twin, spine): the first run of a width pays
    # its first-use costs; the times kept are each one's second run.
    first, twin0, twin, spine = run(2, True), run(0, False), run(0, False), run(2, True)
    # Each half alone, to split the cost: the spine with synchronous
    # harvest, and the async harvester with the spine off.
    spine_sync, async_only = run(2, False), run(0, True)
    traced = run(2, True, profile=True)
    busy = traced["device"]
    check(busy["ops"] > 0, f"the trace of the native B={width} run saw no device activity")
    busy["wall_ms"] = traced["wall"] * 1e3
    busy["share"] = busy["union_ms"] / busy["wall_ms"]
    busy["spans_per_s"] = n * width / traced["wall"]
    check(len(twin["reports"]) == n, f"the synchronous twin read {len(twin['reports'])} of {n} reports")
    ref_state = state_to_numpy(twin["pipe"].detector.state)
    for leg in (first, twin0, spine, spine_sync, async_only, traced):
        same_bits(state_to_numpy(leg["pipe"].detector.state), ref_state,
                  f"spine + async harvest vs spine off + sync harvest (B={width})")
    by_t = {t: (rep, names) for t, rep, names in twin["reports"]}
    for t, rep, names in first["reports"] + spine["reports"]:
        same_bits(rep, by_t[t][0], f"report at t={t} (B={width})")
        check(names == by_t[t][1], f"flags at t={t}: {names} vs {by_t[t][1]}")
    target = f"service-{SLOW:02d}"
    onset = n_warm * DT_S
    for leg in (first, spine, twin):
        before = [names for t, _, names in leg["reports"] if t < onset and names]
        check(not before, f"flags before onset: {before[:3]}")
        at_onset = [names for t, _, names in leg["reports"] if t == onset]
        check(at_onset == [[target]], f"the first batch after onset flags {at_onset}, not [{target}]")
    pipe = spine["pipe"]
    st = pipe.spine_stats()
    rate = n * width / spine["wall"]
    rec = dict(width=width, impl=impl, batches=n, spans_per_s=rate, wall_s=spine["wall"],
               decode_s=spine["decode_s"], tensorize_s=spine["tensorize_s"],
               lag_p99_ms=pipe.stats.lag_p99_ms(), reports_skipped=pipe.stats.reports_skipped,
               spine=st, launches=spine["launches"], decode_threads=threads,
               device_busy_share=busy["share"], device_busy=busy,
               first_run=dict(spans_per_s=n * width / first["wall"], lag_p99_ms=first["pipe"].stats.lag_p99_ms()),
               halves={name: dict(spans_per_s=n * width / leg["wall"], lag_p99_ms=leg["pipe"].stats.lag_p99_ms())
                       for name, leg in (("spine_sync_harvest", spine_sync), ("async_harvest_no_spine", async_only))},
               twin=dict(spans_per_s=n * width / twin["wall"], wall_s=twin["wall"],
                         decode_s=twin["decode_s"], tensorize_s=twin["tensorize_s"],
                         lag_p99_ms=twin["pipe"].stats.lag_p99_ms()))
    print(f"native e2e B={width} impl={impl}: {n} batches in {spine['wall']:.3f} s = {rate:.0f} spans/s "
          f"(decode {spine['decode_s']:.3f} s with {threads} threads, tensorize {spine['tensorize_s']:.3f} s), "
          f"lag p99 {rec['lag_p99_ms']:.3f} ms; spine puts {st['puts_total']}, overlap hits "
          f"{st['overlap_hits']} misses {st['overlap_misses']} (stager {st['stage_s']:.3f} s, pump waited "
          f"{st['take_wait_s']:.3f} s); reports skipped {pipe.stats.reports_skipped}; "
          f"{kernel} launches {spine['launches']}; state == the spine-off sync twin's "
          f"({rec['twin']['spans_per_s']:.0f} spans/s, lag p99 {rec['twin']['lag_p99_ms']:.3f} ms); "
          f"{target} flagged on the first batch after onset; the first run of each: "
          f"{rec['first_run']['spans_per_s']:.0f} spans/s, lag p99 {rec['first_run']['lag_p99_ms']:.3f} ms "
          f"(spine), {n * width / twin0['wall']:.0f} spans/s (twin); each half alone: "
          + "; ".join(f"{k} {v['spans_per_s']:.0f} spans/s, lag p99 {v['lag_p99_ms']:.3f} ms"
                      for k, v in rec["halves"].items()))
    print(f"  device busy share of a traced spine + async run (B={width}): {busy['share']:.6f} "
          f"({busy['union_ms']:.4f} ms of device activity, {busy['sum_ms']:.4f} ms summed over "
          f"{busy['ops']} kernels and copies, in {busy['wall_ms']:.3f} ms of wall; "
          f"{busy['spans_per_s']:.0f} spans/s under the profiler)")
    results[kernel]["launches"] = spine["launches"]
    return rec


def phase_spine_guard(device, width=2048, n=16, spin_cycles=40_000_000):
    """The spine's second guard under load: a spin kernel (~20 ms) queued
    on the dispatch stream ahead of each step keeps step k running while
    the stager issues the copy for batch k + depth into the same device
    slot. Without the side stream's wait on the step's event that copy
    would overwrite lanes step k has yet to read. At ring depths 1 and 2,
    with the async harvester, the final state must equal a spine-off
    run's bit for bit, and the spine must have queued copies behind a
    running step (``step_waits``: the guard was exercised)."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.runtime.lagbench import make_columns
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    rng = np.random.default_rng(21)
    chunks = [make_columns(rng, width) for _ in range(n)]

    def run(spine_ring):
        det = AnomalyDetector(DetectorConfig(), device=device)
        if spine_ring:
            step = det.observe_staged_packed

            def slow_step(lanes, t_now):
                torch.cuda._sleep(spin_cycles)
                return step(lanes, t_now)

            det.observe_staged_packed = slow_step
        pipe = DetectorPipeline(det, batch_size=width, spine_ring=spine_ring, harvest_async=bool(spine_ring))
        for k, cols in enumerate(chunks):
            pipe.submit_columns(cols)
            pipe.pump(k * DT_S)
        pipe.close()
        torch.cuda.synchronize()
        check(pipe.stats.batches == n, f"guard run dispatched {pipe.stats.batches} of {n}")
        return det, pipe

    ref = state_to_numpy(run(0)[0].state)
    out = {}
    for depth in (1, 2):
        det, pipe = run(depth)
        same_bits(state_to_numpy(det.state), ref, f"spine depth {depth} with a busy card vs spine off")
        st = pipe.spine_stats()
        check(st["step_waits"] > 0, f"depth {depth}: no copy was queued behind a running step")
        out[depth] = dict(reports_skipped=pipe.stats.reports_skipped, spine=st)
        print(f"spine guard, depth {depth}, B={width}, {n} batches with ~20 ms of spin ahead of each step: "
              f"state == spine off; copies queued behind a running step {st['step_waits']} of "
              f"{st['puts_total']}; reports skipped {pipe.stats.reports_skipped}; overlap hits "
              f"{st['overlap_hits']} misses {st['overlap_misses']}")
    return out


def device_activity(prof) -> dict:
    """The device work in a ``torch.profiler`` window: kernels, copies
    and memsets on every stream, as their count, their summed time and
    the time covered by their union (two streams at once count once)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    union_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union_us += b - max(a, end)
            end = b
    return dict(ops=len(spans), sum_ms=sum(b - a for a, b in spans) / 1e3, union_ms=union_us / 1e3)


def phase_overload(device, rate):
    """The port's overloadbench on the card at 5× the span rate the
    B = 2048 native leg sustained: error-lane shed 0, every fed row
    accounted for, brownout engaged under load and relaxed after."""
    from opentelemetry_demo_tpu_torch.runtime.overloadbench import measure_overload

    batch = 2048
    out = measure_overload(over_factor=5.0, seconds=3.0, batch=batch, queue_max_rows=8 * batch,
                           brownout_hold_s=0.25, error_fraction=0.02, pump_interval_s=batch / rate,
                           device=device)
    check(out["shed_error_rows"] == 0, f"{out['shed_error_rows']} error-lane rows shed")
    check(out["conserved"], f"rows not conserved: {out}")
    check(out["saturation_events"] >= 1 and out["max_pending_rows"] <= out["queue_max_rows"], f"{out}")
    check(out["brownout_max_level"] >= 1, f"brownout never engaged: {out}")
    check(out["recovery_s"] is not None, f"brownout never relaxed: {out}")
    out["pump_interval_s"] = batch / rate
    print(f"overload at 5x {rate:.0f} spans/s (B={batch}, one dispatch per {batch / rate * 1e3:.3f} ms): "
          f"fed {out['fed_rows']} rows, shed ok {out['shed_ok_rows']} / error {out['shed_error_rows']}, "
          f"brownout {out['brownout_rows']} rows up to level {out['brownout_max_level']}, dispatched "
          f"{out['dispatched_rows']} (conserved), recovered in {out['recovery_s']} s, lag p99 "
          f"{out['lag_p99_ms']} ms")
    return out


def phase_lag(device):
    """The port's lagbench on the card at its default rate: p99
    submit→harvest lag under the 100 ms budget."""
    from opentelemetry_demo_tpu_torch.runtime.lagbench import BASELINE_LAG_MS, measure_lag

    out = measure_lag(device=device)
    check(out["p99_ms"] < BASELINE_LAG_MS, f"lag p99 {out['p99_ms']} ms")
    print(f"lag at {out['rate']:.0f} spans/s (B=256): p99 {out['p99_ms']} ms over {out['batches']} batches, "
          f"net of the report copy's round trip p99 {out.get('p99_net_ms')} ms (RTT p50 "
          f"{out.get('rtt_p50_ms')} ms), reports skipped {out['reports_skipped']}")
    return out


# -- the OTLP front doors -----------------------------------------------------------


class DoorClient:
    """One HTTP client for a door: keep-alive where the server allows it
    (the front door); the receiver answers HTTP/1.0 and closes, and
    ``http.client`` then opens a new connection for the next request."""

    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)

    def post(self, path: str, body: bytes, ctype: str = "application/x-protobuf"):
        self.conn.request("POST", path, body=body, headers={"Content-Type": ctype})
        resp = self.conn.getresponse()
        resp.read()
        return resp.status, resp.getheader("Retry-After")

    def close(self) -> None:
        self.conn.close()


def raw_request(port: int, data: bytes, timeout: float = 30.0) -> bytes:
    """Send raw bytes; read until one header-only answer or the close."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(data)
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return buf


@contextlib.contextmanager
def open_door(kind: str, pool, **kw):
    """The port's ``OtlpHttpReceiver`` (``kind="http"``) or native
    ``FrontDoorServer`` in front of ``pool``, on 127.0.0.1 port 0;
    yields the server."""
    from opentelemetry_demo_tpu_torch.runtime.frontdoor import FrontDoorServer
    from opentelemetry_demo_tpu_torch.runtime.otlp import OtlpHttpReceiver

    if kind == "http":
        kw.pop("ticket_timeout_s", None)
        srv = OtlpHttpReceiver(lambda recs: None, host="127.0.0.1", port=0, on_payload=pool.submit, **kw)
        srv.start()
    else:
        srv = FrontDoorServer(pool, port=0, host="127.0.0.1", **kw)
    try:
        yield srv
    finally:
        srv.stop()


DOORS = ("http", "frontdoor")


def scratch_hygiene(st: dict, bound: int, what: str) -> None:
    """At the end of a leg: parked scratch recycled, none corrupt, and
    the allocations within ``bound`` (a bound that does not grow with
    the number of flushes)."""
    check(st["tickets_recycled"] >= st["tickets_parked"] - st["workers"],
          f"{what}: {st['tickets_recycled']} of {st['tickets_parked']} parked scratches recycled")
    check(st["corrupt_total"] == 0 and st["frames_corrupt"] == 0, f"{what}: corrupt scratch {st}")
    check(st["scratch_allocations"] <= bound,
          f"{what}: {st['scratch_allocations']} scratch allocations in {st['flushes']} flushes (bound {bound})")


def doors_exact(device, impl, width, n_warm, n_fault, per, results):
    """The e2e bodies and batch schedule POSTed to ``/v1/traces`` by one
    client, through each door into one ``IngestPool`` (one worker) in
    front of a spine + async-harvester pipeline, pumped after every body
    of a batch was answered 200. The final state must equal the
    in-process ``submit_columnar`` twin's bit for bit, every report the
    door's run read must equal the twin's, ``service-07`` must flag on
    the first batch after onset and never before, and the kernel must
    launch once a batch."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import native
    from opentelemetry_demo_tpu_torch.runtime.ingest_pool import IngestPool
    from opentelemetry_demo_tpu_torch.runtime.otlp import MONITORED_ATTR_KEYS
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    clean, faulty, _spans = e2e_bodies(width, n_warm, n_fault, per)
    cfg = DetectorConfig(sketch_impl=impl)
    kernel = "fused_update" if impl is None else "cms_hist"
    n = n_warm + n_fault

    def new_pipe(spine: bool):
        reports = []
        pipe = DetectorPipeline(
            AnomalyDetector(cfg, device=device),
            on_report=lambda t, rep, names: reports.append((t, rep, names)),
            batch_size=width, spine_ring=2 if spine else 0, harvest_async=spine,
        )
        return pipe, reports

    twin, twin_reports = new_pipe(False)
    for k in range(n):
        cols, _rows = native.decode_otlp_many(batch_bodies(clean, faulty, k, n_warm, per), MONITORED_ATTR_KEYS)
        twin.submit_columnar(cols)
        twin.pump(k * DT_S)
    twin.close()
    ref = state_to_numpy(twin.detector.state)
    by_t = {t: (rep, names) for t, rep, names in twin_reports}
    check(len(twin_reports) == n, f"the twin read {len(twin_reports)} of {n} reports")
    target = f"service-{SLOW:02d}"
    onset = n_warm * DT_S
    out = {}
    for kind in DOORS:
        pipe, reports = new_pipe(True)
        pool = IngestPool(pipe.submit_columns, pipe.tensorizer, workers=1)
        alloc_mid = None
        with open_door(kind, pool) as srv:
            client = DoorClient(srv.port)
            _kernels.reset_launches()
            t0 = time.perf_counter()
            for k in range(n):
                for body in batch_bodies(clean, faulty, k, n_warm, per):
                    status, _ = client.post("/v1/traces", body)
                    check(status == 200, f"{kind} B={width}: batch {k} answered {status}")
                pipe.pump(k * DT_S)
                if k == n // 2:
                    alloc_mid = pool.stats()["scratch_allocations"]
            pipe.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _kernels.LAUNCHES[kernel]
            client.close()
            rejects = dict(srv.rejects)
        pool.drain()
        st = pool.stats()
        pipe.close()
        pool.close()
        what = f"{kind} door B={width}"
        check(launches == n, f"{what}: {kernel} launched {launches} times in {n} batches")
        check(pipe.stats.batches == n and pipe.stats.spans == n * width,
              f"{what}: dispatched {pipe.stats.batches} batches, {pipe.stats.spans} spans")
        same_bits(state_to_numpy(pipe.detector.state), ref, f"{what} vs the in-process twin")
        reports.sort(key=lambda r: r[0])
        check(len(reports) + pipe.stats.reports_skipped == n, f"{what}: {len(reports)} reports read")
        for t, rep, names in reports:
            same_bits(rep, by_t[t][0], f"{what}: report at t={t}")
            check(names == by_t[t][1], f"{what}: flags at t={t}: {names} vs {by_t[t][1]}")
        before = [names for t, _, names in reports if t < onset and names]
        check(not before, f"{what}: flags before onset: {before[:3]}")
        at_onset = [names for t, _, names in reports if t == onset]
        check(at_onset == [[target]], f"{what}: the first batch after onset flags {at_onset}, not [{target}]")
        # A batch's flushes held until its pump, and the batches in the
        # spine and in flight (one flush each at B = 2048).
        scratch_hygiene(st, 2 * per + 8, what)
        check(not rejects, f"{what}: rejects {rejects}")
        out[kind] = dict(wall_s=wall, spans_per_s=n * width / wall, launches=launches,
                         lag_p99_ms=pipe.stats.lag_p99_ms(), reports_skipped=pipe.stats.reports_skipped,
                         allocations_mid=alloc_mid, pool=st)
        print(f"doors exact B={width} impl={impl}, {kind}: {n} batches of {per} POST(s), one client, one worker: "
              f"state == in-process twin, reports equal ({len(reports)} read, {pipe.stats.reports_skipped} "
              f"skipped), {target} flagged on the first batch after onset; {kernel} launches {launches}; "
              f"{n * width / wall:.0f} spans/s, lag p99 {out[kind]['lag_p99_ms']:.3f} ms; pool flushes "
              f"{st['flushes']}, scratch parked {st['tickets_parked']} recycled {st['tickets_recycled']} "
              f"corrupt {st['corrupt_total']}, allocations {alloc_mid} at batch {n // 2} / "
              f"{st['scratch_allocations']} at the end")
    results[kernel].setdefault("launches_doors", {})[f"exact_{width}"] = {k: v["launches"] for k, v in out.items()}
    return out


def door_bodies(n_clean=12, n_fault=12, spans=4096):
    """4096-span OTLP bodies of the e2e services: clean, and with
    ``service-07`` ten times slower."""
    rng = np.random.default_rng(12)
    return make_bodies(rng, n_clean, spans), make_bodies(rng, n_fault, spans, slow=SLOW)


def doors_throughput(device, results, width=65536, clients=16, depth=2, workers=2, warm_s=1.0, seconds=3.0):
    """Throughput at B = 65536 (K2). First the reference's
    ``measure_frontdoor_vs_pool`` on the clean bodies, null sink: the
    door's own cost against the in-process pool. Then the same clients
    through each door into the real pipeline on the card (two workers,
    spine + async harvester, a row budget of 8 batches with the
    receivers' Retry-After, a thread pumping), its baselines first
    learnt from 24 clean batches in process: clean bodies for ``warm_s``,
    then bodies with ``service-07`` ten times slower. The
    clients run as the reference's bench runs them, threads of this
    process, and for the front door again in a process of their own, as
    a collector is.
    Spans answered 200 must equal the rows dispatched from the doors +
    shed + brownout, the CMS row totals of the 60 s window must equal all
    rows dispatched,
    and ``service-07`` must flag after onset."""
    from opentelemetry_demo_tpu_torch.runtime import frontdoorbench as fb
    from opentelemetry_demo_tpu_torch.runtime.ingest_pool import IngestPool
    from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanTensorizer

    spans = 4096
    clean, faulty = door_bodies(spans=spans)
    null = fb.measure_frontdoor_vs_pool(workers=workers, spans_per_request=spans, clients=clients,
                                        depth=depth, payloads=clean)
    check(null["requests_ok"] > 0 and not null["client_errors"], f"null-sink front door: {null}")
    print(f"doors throughput, null sink (measure_frontdoor_vs_pool, {workers} workers, {clients} clients x "
          f"depth {depth}, {spans}-span bodies): front door {null['frontdoor_spans_per_sec']:.0f} spans/s, "
          f"in-process pool {null['pool_spans_per_sec']:.0f} spans/s, ratio {null['frontdoor_vs_pool']:.4f}")
    # The same null-sink door with its clients in a process of their own.
    pool = IngestPool(lambda cols: None, SpanTensorizer(num_services=32), workers=workers, coalesce_max=64,
                      max_pending=max(clients * depth * 4, 256))
    try:
        with open_door("frontdoor", pool, max_body_bytes=64 << 20, max_conns=clients + 4) as srv:
            _warm, timed = fb.run_clients_in_child(srv.port, [(clean, 1.0), (clean, seconds)], clients, depth)
    finally:
        pool.close()
    check(timed.get("ok", 0) > 0 and not timed.get("errors"), f"null-sink front door, clients apart: {timed}")
    null["frontdoor_clients_apart_spans_per_sec"] = timed["ok"] * spans / timed["elapsed"]
    null["frontdoor_clients_apart_vs_pool"] = null["frontdoor_clients_apart_spans_per_sec"] / null["pool_spans_per_sec"]
    print(f"  the same front door with its clients in a process of their own: "
          f"{null['frontdoor_clients_apart_spans_per_sec']:.0f} spans/s, ratio to the pool "
          f"{null['frontdoor_clients_apart_vs_pool']:.4f}")
    out = dict(null_sink=null, threads=torch.get_num_threads(), cpus=os.cpu_count())
    launches = {}
    # The receiver's 16 handler threads share the server's interpreter
    # wherever its clients run, so it runs with the clients as threads
    # only; PERF.md §5 has it measured both ways.
    for kind, where in (("http", "threads"), ("frontdoor", "threads"), ("frontdoor", "process")):
        leg = doors_pipeline_leg(device, kind, where, clean, faulty, spans, width, clients, depth, workers,
                                 warm_s, seconds)
        out[f"{kind}/{where}"] = leg
        launches[f"{kind}/{where}"] = leg["launches"]
    results["cms_hist"].setdefault("launches_doors", {})["throughput"] = launches
    return out


def doors_pipeline_leg(device, kind, where, clean, faulty, spans, width, clients, depth, workers, warm_s, seconds):
    """One door into the pipeline on the card, clients as threads of
    this process or in a process of their own (see doors_throughput)."""
    import threading

    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import frontdoorbench as fb
    from opentelemetry_demo_tpu_torch.runtime import native
    from opentelemetry_demo_tpu_torch.runtime.ingest_pool import IngestPool
    from opentelemetry_demo_tpu_torch.runtime.otlp import MONITORED_ATTR_KEYS
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
    from opentelemetry_demo_tpu_torch.runtime.spine import pinned_device

    cfg = DetectorConfig(sketch_impl="xla")
    w60 = list(cfg.windows_s).index(max(cfg.windows_s))
    dev = pinned_device(device)
    target = f"service-{SLOW:02d}"
    reports = []
    pipe = DetectorPipeline(
        AnomalyDetector(cfg, device=device),
        on_report=lambda t, rep, names: reports.append((t, names)),
        batch_size=width, spine_ring=2, harvest_async=True, queue_max_rows=8 * width,
    )
    # The detector's baselines first, in process and on a virtual clock,
    # as the e2e legs warm up: how many batches the doors dispatch in a
    # few seconds depends on the host, and a cold detector flags nothing.
    n_pre = 24
    for k in range(n_pre):
        bodies = [clean[(k * (width // spans) + i) % len(clean)] for i in range(width // spans)]
        pipe.submit_columnar(native.decode_otlp_many(bodies, MONITORED_ATTR_KEYS)[0])
        pipe.pump(k * DT_S)
    pipe.drain()
    pre_rows = pipe.stats.spans
    pool = IngestPool(pipe.submit_columns, pipe.tensorizer, workers=workers, coalesce_max=64,
                      max_pending=max(clients * depth * 4, 256))
    stop = threading.Event()
    t_zero = time.monotonic() - n_pre * DT_S

    def pump_loop():
        torch.cuda.set_device(dev)
        last = 0.0
        while not stop.is_set():
            now = time.monotonic()
            if pipe.pending_rows() >= width or now - last >= pipe.max_wait_s:
                pipe.pump(now - t_zero)
                last = now
            else:
                time.sleep(0.0005)

    pumper = threading.Thread(target=pump_loop, name="doors-pump", daemon=True)
    _kernels.reset_launches()
    batches_before = pipe.stats.batches
    pumper.start()
    cl_depth = depth if kind == "frontdoor" else 1  # the receiver closes after each answer
    try:
        with open_door(kind, pool, retry_after=pipe.admission_retry_after, max_body_bytes=64 << 20) as srv:
            if where == "threads":
                warm = fb._run_frontdoor_clients(srv.port, clean, warm_s, clients, cl_depth)
                timed = fb._run_frontdoor_clients(srv.port, faulty, seconds, clients, cl_depth)
            else:
                warm, timed = fb.run_clients_in_child(srv.port, [(clean, warm_s), (faulty, seconds)],
                                                      clients, cl_depth)
            rejects = dict(srv.rejects)
    finally:
        stop.set()
        pumper.join(timeout=60)
    check(not pumper.is_alive(), f"{kind}: the pump thread did not stop")
    onset = timed["t_start"] - t_zero
    pool.drain()
    pipe.drain()
    torch.cuda.synchronize()
    pool.drain()
    launches = _kernels.LAUNCHES["cms_hist"]
    st = pool.stats()
    ps = pipe.stats
    door_rows, door_batches = ps.spans - pre_rows, ps.batches - batches_before
    ok_spans = (warm.get("ok", 0) + timed.get("ok", 0)) * spans
    shed = ps.shed_rows["ok"] + ps.shed_rows["error"]
    cms = pipe.detector.state.cms_bank[w60, :, 0].sum().item()
    pipe.close()
    pool.close()
    what = f"{kind} throughput, clients as {where}"
    check(not warm.get("errors") and not timed.get("errors"), f"{what}: client errors {warm} {timed}")
    check(ok_spans == door_rows + shed + ps.brownout_rows,
          f"{what}: {ok_spans} spans answered 200 != dispatched {door_rows} + shed {shed} + brownout "
          f"{ps.brownout_rows}")
    check(int(cms) == ps.spans, f"{what}: the 60 s window's CMS row holds {cms} spans, dispatched {ps.spans}")
    check(ps.shed_rows["error"] == 0, f"{what}: {ps.shed_rows['error']} error-lane rows shed")
    check(launches == door_batches and launches > 0, f"{what}: cms_hist launched {launches} in {door_batches} batches")
    after = [t for t, names in reports if t >= onset and target in names]
    check(bool(after), f"{what}: {target} never flagged after onset")
    before = sum(1 for t, names in reports if t < onset and names)
    # The flushes whose views the pipeline may hold at once: the row
    # budget's, the spine's two slots' and two reports' in flight.
    scratch_hygiene(st, (pipe.queue_max_rows + 4 * width) // spans + 2 * workers, what)
    rate = timed.get("ok", 0) * spans / timed["elapsed"]
    leg = dict(spans_per_s=rate, ok_requests=timed.get("ok", 0),
               status={k: v for k, v in timed.items() if k.startswith("status_")},
               warm_ok=warm.get("ok", 0), dispatched=door_rows, batches=door_batches, shed=shed,
               brownout=ps.brownout_rows, lag_p99_ms=ps.lag_p99_ms(), launches=launches,
               reports=len(reports), reports_skipped=ps.reports_skipped, flags_before_onset=before,
               first_flag_after_onset_s=min(after) - onset if after else None, rejects=rejects, pool=st,
               client_depth=cl_depth,
               prewarm_batches=n_pre)
    print(f"doors throughput into the pipeline on the card, {kind}, clients as {where} ({clients} x depth "
          f"{cl_depth}, {workers} workers, spine + async, budget {8 * width} rows): {rate:.0f} spans/s answered "
          f"200 ({timed.get('ok', 0)} requests in {timed['elapsed']:.3f} s; other answers {leg['status']}); "
          f"dispatched {door_rows} in {door_batches} batches (after {n_pre} in process), shed {shed}, brownout "
          f"{ps.brownout_rows} (conserved: "
          f"{ok_spans} answered 200); CMS total == all dispatched; lag p99 {leg['lag_p99_ms']:.3f} ms; cms_hist "
          f"launches {launches}; pool flushes {st['flushes']}, coalesced requests {st['coalesced_requests']}, "
          f"scratch allocations {st['scratch_allocations']}; {target} first flagged "
          f"{leg['first_flag_after_onset_s']} s after onset ({before} flagged reports before); torch "
          f"threads {torch.get_num_threads()}, cpus {os.cpu_count()}")
    return leg


def log_payload(service: str, n: int, t_ns: int) -> bytes:
    """An OTLP ExportLogsServiceRequest: ``n`` records of ``service``,
    severity by number only on every other record."""
    from opentelemetry_demo_tpu_torch.runtime import wire

    def kv(k, v):
        return wire.encode_len(1, k.encode()) + wire.encode_len(2, wire.encode_len(1, v.encode()))

    recs = b""
    for i in range(n):
        rec = (wire.encode_fixed64(1, t_ns + i) + wire.encode_int(2, 17)
               + wire.encode_len(5, wire.encode_len(1, f"log line {i}".encode()))
               + wire.encode_len(6, kv("k", str(i))) + wire.encode_len(9, bytes(range(16))))
        if i % 2:
            rec += wire.encode_len(3, b"ERROR")
        recs += wire.encode_len(2, rec)
    rl = wire.encode_len(1, wire.encode_len(1, kv("service.name", service))) + wire.encode_len(2, recs)
    return wire.encode_len(1, rl)


def doors_taxonomy(device):
    """The verdicts on the card, through both doors in front of the
    pipeline at the default config: a malformed body 400 and the next
    valid one 200; an oversized body 413; a chunked body refused (front
    door); a flood into a one-batch row budget 429 with an integer
    Retry-After and no error-lane row shed; a pool with one pending slot
    held busy 429 with ``Retry-After: 1``; OTLP metric bodies into the
    ``MetricsFeed`` (its head steps on the card) and log bodies into the
    ``LogStore``, counted per index."""
    from opentelemetry_demo_tpu_torch.runtime.ingest_pool import IngestPool
    from opentelemetry_demo_tpu_torch.runtime.metrics_feed import MetricsFeed
    from opentelemetry_demo_tpu_torch.runtime.otlp_metrics import encode_metrics_request
    from opentelemetry_demo_tpu_torch.telemetry import LogStore

    width = 2048
    rng = np.random.default_rng(13)
    valid = make_bodies(rng, 8, width)
    max_body = 1 << 20
    store = LogStore()
    feed = MetricsFeed(device=device)
    feed.pump(0.0)  # the first pump only sets the timebase
    out = {}
    for kind in DOORS:
        got = {}
        pipe = default_pipeline(device, width, queue_max_rows=width)
        pool = IngestPool(pipe.submit_columns, pipe.tensorizer, workers=1)
        index = f"otel-{kind}"
        with open_door(kind, pool, retry_after=pipe.admission_retry_after, max_body_bytes=max_body,
                       on_metric_records=feed.submit,
                       on_log_records=lambda docs, index=index: [store.add(d, index) for d in docs]) as srv:
            client = DoorClient(srv.port)
            got["malformed"] = client.post("/v1/traces", b"\x0a\xff")
            got["valid_after_malformed"] = client.post("/v1/traces", valid[0])
            head = (f"POST /v1/traces HTTP/1.1\r\nHost: x\r\nContent-Length: {max_body + 1}\r\n\r\n").encode()
            got["oversized"] = raw_request(srv.port, head).split(b"\r\n", 1)[0].decode()
            if kind == "frontdoor":
                got["chunked"] = raw_request(
                    srv.port, b"POST /v1/traces HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
                    b"4\r\nwxyz\r\n0\r\n\r\n").split(b"\r\n", 1)[0].decode()
            flood = [client.post("/v1/traces", valid[1 + i % 7]) for i in range(6)]
            got["flood"] = flood
            for k in range(3):
                scrape = [(svc, [(name, value * (k + 1), counter) for name, value, counter in metrics])
                          for svc, metrics in metric_payload(rng, k)]
                got[f"metrics_{k}"] = client.post("/v1/metrics", encode_metrics_request(
                    scrape, t_ns=10**18 + k * 10**10))[0]
            got["logs"] = [client.post("/v1/logs", log_payload(f"service-{i:02d}", 5, 10**18))[0]
                           for i in range(4)]
            client.close()
            rejects = dict(srv.rejects)
        pool.drain()
        shed_error = pipe.stats.shed_rows["error"]
        pipe.close()
        pool.close()
        what = f"{kind} taxonomy"
        check(got["malformed"][0] == 400 and got["valid_after_malformed"][0] == 200, f"{what}: {got}")
        check(" 413 " in got["oversized"] + " ", f"{what}: oversized answered {got['oversized']}")
        if kind == "frontdoor":
            check(" 400 " in got["chunked"] + " ", f"{what}: chunked answered {got['chunked']}")
        statuses = [s for s, _ in flood]
        ra = [r for s, r in flood if s == 429]
        check(429 in statuses and all(r is not None and r.isdigit() and int(r) >= 1 for r in ra),
              f"{what}: flood answered {flood}")
        check(shed_error == 0, f"{what}: {shed_error} error-lane rows shed")
        check(all(got[f"metrics_{k}"] == 200 for k in range(3)) and got["logs"] == [200] * 4, f"{what}: {got}")
        check(store.count(index) == 20, f"{what}: {store.count(index)} log records in {index}")
        check(rejects.get("malformed") == 1 and rejects.get("oversized") == 1 and rejects.get("saturated", 0) >= 1,
              f"{what}: rejects {rejects}")
        got["busy_pool"] = busy_pool_429(kind, pipe_width=width, device=device)
        check(got["busy_pool"] == (429, "1"), f"{what}: a busy one-slot pool answered {got['busy_pool']}")
        out[kind] = dict(answers=got, rejects=rejects, log_count=store.count(index))
    report = feed.pump(10.0)
    check(report is not None and report.flags.is_cuda and bool(torch.isfinite(report.z).all()),
          "the metrics head did not step on the card" + ("" if report is None else f" ({report.flags.device})"))
    check(feed.points_total == 2 * 3 * N_SERVICES * 4, f"metric points {feed.points_total}")
    severities = {d.severity for d in store.search(index="otel-frontdoor", limit=100)}
    check(severities == {"ERROR"}, f"log severities {severities}")
    print("doors taxonomy on the card: " + "; ".join(
        f"{kind}: malformed {v['answers']['malformed'][0]} then valid {v['answers']['valid_after_malformed'][0]}, "
        f"oversized '{v['answers']['oversized']}', "
        + (f"chunked '{v['answers']['chunked']}', " if kind == "frontdoor" else "")
        + f"flood {[s for s, _ in v['answers']['flood']]} Retry-After "
        f"{sorted({r for s, r in v['answers']['flood'] if s == 429})}, busy one-slot pool "
        f"{v['answers']['busy_pool']}, {v['log_count']} log records in otel-{kind}, rejects {v['rejects']}"
        for kind, v in out.items()) + f"; metrics head stepped on {report.flags.device} "
        f"({feed.points_total} points)")
    out["metric_points"] = feed.points_total
    return out


def default_pipeline(device, width, **kw):
    """A pipeline at the default ``DetectorConfig`` on ``device``."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    return DetectorPipeline(AnomalyDetector(DetectorConfig(), device=device), batch_size=width, **kw)


def busy_pool_429(kind, pipe_width, device):
    """A pool with one pending slot whose worker is held in its sink: the
    third concurrent POST finds the queue full. Returns its answer."""
    import threading

    from opentelemetry_demo_tpu_torch.runtime.ingest_pool import IngestPool

    rng = np.random.default_rng(14)
    bodies = make_bodies(rng, 3, 64)
    pipe = default_pipeline(device, pipe_width)
    gate = threading.Event()
    entered = threading.Event()

    def held_sink(cols):
        entered.set()
        gate.wait(30)
        pipe.submit_columns(cols)

    pool = IngestPool(held_sink, pipe.tensorizer, workers=1, max_pending=1)
    answers = {}
    try:
        with open_door(kind, pool, ticket_timeout_s=0.2) as srv:
            def post(i):
                c = DoorClient(srv.port)
                try:
                    answers[i] = c.post("/v1/traces", bodies[i])
                finally:
                    c.close()

            first = threading.Thread(target=post, args=(0,), daemon=True)
            first.start()
            check(entered.wait(30), "the held pool never started its flush")
            second = threading.Thread(target=post, args=(1,), daemon=True)
            second.start()
            deadline = time.monotonic() + 30
            while pool.depth() < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            post(2)
            gate.set()
            for th in (first, second):
                th.join(timeout=30)
                check(not th.is_alive(), "a held request never got its answer")
    finally:
        gate.set()
        pool.close()
        pipe.close()
    check(answers.get(0, (0,))[0] == 200 and answers.get(1, (0,))[0] == 200,
          f"the held requests answered {answers}")
    return answers.get(2)


def phase_doors(device, results):
    """The OTLP front doors on the card: the port's ``OtlpHttpReceiver``
    and native ``FrontDoorServer`` in front of the decode pool and the
    pipeline at the default config. Order-exact legs at B = 2048 (K1)
    and 65536 (K2), a throughput leg at 65536, and the verdicts."""
    t0 = time.perf_counter()
    out = dict(
        exact=[doors_exact(device, None, 2048, 40, 4, 1, results),
               doors_exact(device, "xla", 65536, 24, 3, 8, results)],
        throughput=doors_throughput(device, results),
        taxonomy=doors_taxonomy(device),
    )
    out["wall_s"] = time.perf_counter() - t0
    print(f"doors phase: {out['wall_s']:.1f} s")
    return out


# -- the Kafka orders leg and the flagd gating ------------------------------------------

# The shop's catalog ids (its checkout publishes them), in popularity order.
CATALOG = ["TEL-DOB-10", "TEL-REF-80", "EYE-PLO-25", "FIL-OIII-2", "MNT-EQ6-GT",
           "CAM-ASI-294", "BIN-15X70", "RED-DOT-F", "CHA-ATLAS", "PWR-TANK-12"]
ORDER_RATE = 4096.0  # orders a second on the live leg's virtual clock
ORDER_DT = 0.1  # virtual seconds between pumps
FLOOD_DUP = 4  # kafkaQueueProblems: checkout publishes each order this many times
BACKLOG = 262_144  # a minute of the baseline rate, and then some
ORDERS = "checkout-orders"


def order_payloads(seed: int, n: int) -> list[bytes]:
    """``n`` OrderResult payloads from a seed: distinct order ids, one to
    three lines of Zipf-weighted (s = 1.1) catalog products with
    quantities 1-5, 60 / 25 / 15 % USD / EUR / JPY, lognormal shipping
    costs (median USD 8)."""
    from opentelemetry_demo_tpu_torch.currency_data import to_usd_factor
    from opentelemetry_demo_tpu_torch.runtime.kafka_orders import encode_order_result

    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, len(CATALOG) + 1) ** 1.1
    n_lines = rng.integers(1, 4, n)
    prods = rng.choice(len(CATALOG), (n, 3), p=w / w.sum())
    qty = rng.integers(1, 6, (n, 3))
    codes = np.array(["USD", "EUR", "JPY"])[rng.choice(3, n, p=[0.6, 0.25, 0.15])]
    factor = {c: to_usd_factor(c) for c in ("USD", "EUR", "JPY")}
    cost_usd = rng.lognormal(np.log(8.0), 0.5, n)
    salt = rng.integers(0, 2**48, n)
    track = rng.integers(0, 2**63, n)
    out = []
    for i in range(n):
        code = str(codes[i])
        local = float(cost_usd[i]) / factor[code]
        units = int(local)
        out.append(encode_order_result(
            f"{i:08x}-{int(salt[i]):012x}", f"{int(track[i]):016x}",
            (code, units, int((local - units) * 1e9)),
            [(CATALOG[prods[i, j]], int(qty[i, j]), None) for j in range(n_lines[i])]))
    return out


def live_pumps(seed: int, clean_s: float, flood_s: float) -> list[list[bytes]]:
    """The live stream cut into pumps: Poisson arrivals at ORDER_RATE on a
    virtual clock, the orders of each ORDER_DT in one pump, each order
    published FLOOD_DUP times from ``clean_s`` on."""
    n_pumps = int(round((clean_s + flood_s) / ORDER_DT))
    rng = np.random.default_rng(seed + 1)
    n = int((clean_s + flood_s) * ORDER_RATE * 1.1) + 64
    t = np.cumsum(rng.exponential(1.0 / ORDER_RATE, n))
    n = int(np.searchsorted(t, clean_s + flood_s))
    payloads = order_payloads(seed, n)
    pumps = [[] for _ in range(n_pumps)]
    for i in range(n):
        pumps[int(t[i] / ORDER_DT)].extend([payloads[i]] * (FLOOD_DUP if t[i] >= clean_s else 1))
    return pumps


class OrderTopic:
    """The ``orders`` topic of an in-process broker with three
    partitions; orders go round robin, through ``KafkaBroker.append`` or
    over the socket through a ``KafkaProducer``."""

    def __init__(self):
        from opentelemetry_demo_tpu_torch.runtime.kafka_broker import KafkaBroker

        self.broker = KafkaBroker(num_partitions=3)
        self.broker.start()
        self.addr = f"127.0.0.1:{self.broker.port}"
        self.n = self.junk = 0
        self.by_partition: list[list] = [[], [], []]

    def publish(self, payloads, producer=None) -> None:
        for p in payloads:
            part = self.n % 3
            if producer is None:
                self.broker.append("orders", p, partition=part)
            else:
                producer.send("orders", p, partition=part)
            self.by_partition[part].append(p)
            self.n += 1

    def publish_junk(self, value, partition: int) -> None:
        """A message that is not an order (a poison pill, a tombstone),
        outside the round robin: the orders around it keep their
        partitions and their order."""
        self.broker.append("orders", value, partition=partition)
        self.by_partition[partition].append(value)
        self.junk += 1

    def stop(self) -> None:
        self.broker.stop()


def consume(source, sink) -> tuple[dict, int]:
    """Poll ``source`` until it is caught up; each poll's records go to
    ``sink`` before its offsets are taken (a checkpoint's offsets must
    correspond to rows the pipeline holds). Returns (offsets, records)."""
    offsets, n = {}, 0
    while True:
        off, records = source.poll_batch(0.0)
        if not off:
            return offsets, n
        sink(records)
        n += len(records)
        offsets.update(off)


def flag_doc(enabled: bool = True, threshold: float | None = None) -> dict:
    """The detector's two flagd flags; ``threshold`` None leaves the
    config's z-threshold in force."""
    from opentelemetry_demo_tpu_torch.models import DetectorConfig

    thr = DetectorConfig().z_threshold if threshold is None else threshold
    return {"flags": {
        "anomalyDetectorEnabled": {"state": "ENABLED", "variants": {"on": True, "off": False},
                                   "defaultVariant": "on" if enabled else "off"},
        "anomalyDetectorZThreshold": {"state": "ENABLED", "variants": {"set": thr},
                                      "defaultVariant": "set"},
    }}


def recomputed_flags(report, cfg, threshold: float) -> np.ndarray:
    """The flags a report carries at ``threshold``, recomputed in numpy
    from its z-scores and CUSUM accumulators."""
    z = np.maximum.reduce([np.abs(getattr(report, f)).max(axis=1)
                           for f in ("lat_z", "err_z", "rate_z", "card_z")])
    cusum = (report.cusum > np.asarray(cfg.cusum_thresholds, np.float32)[None, :]).any(axis=1)
    return (z > threshold) | cusum


def max_abs_z(report) -> float:
    return float(max(np.abs(getattr(report, f)).max() for f in ("lat_z", "err_z", "rate_z", "card_z")))


def orders_live(device, clean_s=40.0, flood_s=4.0, off=(8, 13), producer_orders=300):
    """Flood, verdicts and flags at B = 2048 (K1), with the spine (two
    slots) and the async harvester. The flag file is rewritten through
    the flag editor's route and read by the pipeline's ``FlagFileStore``."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime.kafka_client import KafkaProducer
    from opentelemetry_demo_tpu_torch.runtime.kafka_orders import OrdersSource
    from opentelemetry_demo_tpu_torch.runtime.pipeline import FLAG_ENABLED, FLAG_THRESHOLD, DetectorPipeline
    from opentelemetry_demo_tpu_torch.utils.flag_ui import FlagEditorUI
    from opentelemetry_demo_tpu_torch.utils.flags import FlagFileStore, atomic_write_doc

    cfg = DetectorConfig()
    pumps = live_pumps(81, clean_s, flood_s)
    onset = int(round(clean_s / ORDER_DT))
    raise_from, raise_to = onset + 10, onset + 20  # the second flood second
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = str(CKPT_DIR / "flags.json")
    atomic_write_doc(path, flag_doc())
    store = FlagFileStore(path)
    editor = FlagEditorUI(FlagFileStore(path))

    def flip(doc):
        status, _, body = editor.handle("POST", "/api/write-to-file", json.dumps({"data": doc}).encode())
        check(status == 200, f"the flag editor answered {status}: {body!r}")
        want_on = doc["flags"][FLAG_ENABLED]["defaultVariant"] == "on"
        want_thr = doc["flags"][FLAG_THRESHOLD]["variants"]["set"]
        check(store.evaluate(FLAG_ENABLED, None) is want_on and store.evaluate(FLAG_THRESHOLD, None) == want_thr,
              "the pipeline's flag store did not reload the editor's write")

    topic = OrderTopic()
    producer = KafkaProducer(topic.addr)
    source = OrdersSource(topic.addr, group_id="live")
    reports: list = []
    pipe = DetectorPipeline(AnomalyDetector(cfg, device=device),
                            on_report=lambda t, rep, names: reports.append((t, rep, names)),
                            batch_size=2048, spine_ring=2, harvest_async=True, flags=store)
    fed = sent = 0
    off_rec: dict = {}
    raised = None
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for k, payloads in enumerate(pumps):
        if k == off[0]:
            flip(flag_doc(enabled=False))
            before = state_to_numpy(pipe.detector.state)
            off_rec = dict(spans_at_start=pipe.stats.spans, fed_at_start=fed,
                           undispatched_at_start=fed - pipe.stats.spans)
        if k == raise_from:
            pipe.drain()
            # Above every |z| of the flood's first second, with margin.
            raised = 2.0 * max(max_abs_z(rep) for t, rep, _ in reports if t >= onset * ORDER_DT)
            flip(flag_doc(threshold=raised))
        if k == raise_to:
            pipe.drain()
            flip(flag_doc())
        via_socket = sent < producer_orders
        topic.publish(payloads, producer if via_socket else None)
        sent += len(payloads) if via_socket else 0
        _, n = consume(source, pipe.submit)
        fed += n
        pipe.pump(k * ORDER_DT)
        if k == onset:
            pipe.drain()  # the onset's report is read, never skipped
        if k == off[1] - 1:
            after = state_to_numpy(pipe.detector.state)
            same_bits(after, before, "the state across the disabled window")
            check(pipe.stats.spans == off_rec["spans_at_start"], "a batch was dispatched while disabled")
            off_rec.update(fed_in_window=fed - off_rec["fed_at_start"], dropped=pipe.stats.dropped_disabled)
            check(off_rec["dropped"] == fed - off_rec["spans_at_start"],
                  f"dropped {off_rec['dropped']} rows while off, fed {fed - off_rec['spans_at_start']} "
                  "undispatched ones")
            flip(flag_doc())
    pipe.drain()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES["fused_update"]
    pipe.close()
    source.close()
    producer.close()
    topic.stop()
    check(fed == topic.n, f"consumed {fed} of {topic.n} orders")
    check(fed == pipe.stats.spans + pipe.stats.dropped_disabled,
          f"fed {fed} != dispatched {pipe.stats.spans} + dropped {pipe.stats.dropped_disabled}")
    check(launches == pipe.stats.batches, f"fused_update launched {launches} times for {pipe.stats.batches} batches")
    check(len(reports) + pipe.stats.reports_skipped == pipe.stats.batches,
          f"{len(reports)} reports + {pipe.stats.reports_skipped} skipped != {pipe.stats.batches} batches")
    t_onset = onset * ORDER_DT
    before_onset = [(t, names) for t, _, names in reports if t < t_onset and names]
    check(not before_onset, f"flags before the flood: {before_onset[:3]}")
    at_onset = [names for t, _, names in reports if t == t_onset]
    check(at_onset == [[ORDERS]], f"the first batch of the flood flags {at_onset}, not [{ORDERS}]")
    lo, hi = raise_from * ORDER_DT, raise_to * ORDER_DT
    in_window = [(t, rep, names) for t, rep, names in reports if lo <= t < hi]
    check(len(in_window) >= 5, f"{len(in_window)} reports read under the raised threshold")
    lifted = 0
    for t, rep, names in in_window:
        want = recomputed_flags(rep, cfg, raised)
        check(names == [ORDERS for i in np.nonzero(want)[0]],
              f"flags at t={t} under threshold {raised}: {names} vs the recomputation {np.nonzero(want)[0]}")
        lifted += int(rep.flags[0] and not want[0])
    outside = [(t, rep, names) for t, rep, names in reports if not lo <= t < hi]
    for t, rep, names in outside:
        check(names == ([ORDERS] if rep.flags[0] else []), f"flags at t={t} with the default threshold: {names}")
    flood_flags = [t for t, _, names in reports if t >= t_onset and names]
    rec = dict(pumps=len(pumps), orders=fed, via_producer=sent, batches=pipe.stats.batches, spans=pipe.stats.spans,
               wall_s=wall, orders_per_s=fed / wall, lag_p99_ms=pipe.stats.lag_p99_ms(),
               reports_skipped=pipe.stats.reports_skipped, launches=launches, disabled=off_rec,
               staged_rows_dropped=off_rec["dropped"] - off_rec["fed_in_window"],
               raised_threshold=raised, reports_under_raised=len(in_window), z_flags_lifted=lifted,
               flagged_after_onset=len(flood_flags), spine=pipe.spine_stats())
    print(f"orders live B=2048: {fed} orders ({sent} through the producer) in {len(pumps)} pumps, "
          f"{wall:.3f} s = {rec['orders_per_s']:.0f} orders/s, lag p99 {rec['lag_p99_ms']:.3f} ms, "
          f"{pipe.stats.batches} batches, fused_update launches {launches}; {ORDERS} flagged on the first "
          f"batch of the flood (t={t_onset}) and never before; disabled for pumps {off[0]}-{off[1] - 1}: "
          f"state bit-identical, {off_rec['dropped']} rows dropped ({rec['staged_rows_dropped']} staged or "
          f"queued at the switch), fed {fed} = dispatched {pipe.stats.spans} + dropped "
          f"{pipe.stats.dropped_disabled}; threshold {raised:.3f} for t in [{lo}, {hi}): {len(in_window)} "
          f"reports equal the numpy recomputation, {lifted} z-flags lifted")
    return rec


def orders_resume(device, clean_s=12.0, flood_s=2.0, save_at=80, pill_at=50, tomb_at=100):
    """Resume at B = 2048 (K1): saved mid-stream with the offsets after
    the poll's records reached the pipeline, resumed from the file by a
    fresh pipeline and a new source that seeks them. A poison pill and a
    tombstone in the resumed stream advance their offsets and change
    nothing else; an epoch-tagged commit reads back, a stale fence
    blocks one."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import checkpoint
    from opentelemetry_demo_tpu_torch.runtime.kafka_orders import OrdersSource
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    cfg = DetectorConfig()
    pumps = live_pumps(82, clean_s, flood_s)
    onset = int(round(clean_s / ORDER_DT))
    n = len(pumps)

    def pipe_for(det, flags):
        return DetectorPipeline(det, on_report=lambda t, rep, names: flags.append((t, names)), batch_size=2048)

    # The uninterrupted run, without the pill and the tombstone.
    topic_a = OrderTopic()
    src_a = OrdersSource(topic_a.addr, group_id="resume")
    flags_a: list = []
    a = pipe_for(AnomalyDetector(cfg, device=device), flags_a)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for k in range(n):
        topic_a.publish(pumps[k])
        offsets_a, _ = consume(src_a, a.submit)
        a.pump(k * ORDER_DT)
    a.drain()
    wall_a = time.perf_counter() - t0
    launches = _kernels.LAUNCHES["fused_update"]
    final_a = state_to_numpy(a.detector.state)
    check(launches == n, f"fused_update launched {launches} times in {n} batches")
    src_a.close()
    topic_a.stop()

    # The interrupted run, with a poison pill before the save and a
    # tombstone after it.
    topic = OrderTopic()

    def publish(k):
        topic.publish(pumps[k])
        if k == pill_at:
            topic.publish_junk(b"\xff\xff\xff\xff", partition=1)
        if k == tomb_at:
            topic.publish_junk(None, partition=2)

    src_b = OrdersSource(topic.addr, group_id="resume")
    flags_b: list = []
    b = pipe_for(AnomalyDetector(cfg, device=device), flags_b)
    offsets: dict = {}
    for k in range(save_at + 1):
        publish(k)
        off, _ = consume(src_b, b.submit)
        offsets.update(off)
        b.pump(k * ORDER_DT)
    path = str(CKPT_DIR / "orders_resume")
    checkpoint.save(path, b.detector, offsets=offsets, service_names=b.tensorizer.service_names,
                    dispatch_lock=b._dispatch_lock)
    b.drain()
    spans_b = b.stats.spans
    check(src_b.decode_failures == 1 and len(src_b.quarantine) == 1 and src_b.quarantine[0][3] == b"\xff" * 4,
          f"the poison pill was not quarantined ({src_b.decode_failures} failures)")
    src_b.close()
    det, meta = checkpoint.load(path, cfg, device=device)
    check(all(isinstance(p, str) for p in meta["offsets"]), "the offsets did not come back with string keys")
    c = pipe_for(det, flags_b)
    c.tensorizer.adopt_names(meta["service_names"])
    src_c = OrdersSource(topic.addr, group_id="resume")
    src_c.seek(meta["offsets"])
    for k in range(save_at + 1, n):
        publish(k)
        off, _ = consume(src_c, c.submit)
        offsets.update(off)
        c.pump(k * ORDER_DT)
    c.drain()
    same_bits(state_to_numpy(c.detector.state), final_a, "the resumed orders run vs the uninterrupted one")
    check(flags_b == flags_a, "the resumed run's flags differ from the uninterrupted run's")
    check(spans_b + c.stats.spans == a.stats.spans,
          f"{spans_b} + {c.stats.spans} orders dispatched, {a.stats.spans} in the uninterrupted run")
    check(sum(offsets.values()) == sum(offsets_a.values()) + 2 == topic.n + topic.junk,
          f"offsets {offsets} vs {offsets_a}: the pill and the tombstone must advance theirs")
    flagged = [t for t, names in flags_a if names]
    check(flagged and flagged[0] == onset * ORDER_DT and all(t >= onset * ORDER_DT for t in flagged),
          f"the resume leg's flood flags at {flagged[:3]}")

    class StaleFence:
        def check(self, path=""):
            raise checkpoint.StaleEpochError(f"fenced at {path}")

    src_c.commit(offsets, epoch=3)
    epoch = src_c.last_committed_epoch()
    check(epoch == 3, f"the epoch tag reads {epoch}, not 3")
    check([topic.broker.committed("resume", "orders", p) for p in range(3)] == [offsets[p] for p in range(3)],
          "the committed offsets are not the run's")
    src_c.fence = StaleFence()
    try:
        src_c.commit({p: 0 for p in range(3)}, epoch=2)
        refused = False
    except checkpoint.StaleEpochError:
        refused = True
    check(refused and [topic.broker.committed("resume", "orders", p) for p in range(3)]
          == [offsets[p] for p in range(3)], "a stale fence did not block the commit")
    src_c.close()
    topic.stop()
    rec = dict(pumps=n, orders=a.stats.spans, wall_s=wall_a, orders_per_s=a.stats.spans / wall_a, launches=launches,
               saved_at=save_at, offsets=offsets, epoch=epoch, flagged=len(flagged))
    print(f"orders resume B=2048: {n} pumps, saved at {save_at} with offsets {meta['offsets']}, resumed from the "
          f"file: state bit-identical to the uninterrupted run, the same flags ({len(flagged)} flagged from "
          f"t={onset * ORDER_DT}), {spans_b} + {c.stats.spans} = {a.stats.spans} orders; pill quarantined, "
          f"tombstone passed, both offsets advanced; epoch tag 3 read back, a stale fence refused; "
          f"uninterrupted {rec['orders_per_s']:.0f} orders/s, fused_update launches {launches}")
    return rec


def orders_backlog(device, n=BACKLOG, width=65536):
    """Replay a backlog of ``n`` orders from offset 0 at B = 65536 with
    ``sketch_impl="xla"`` (K2): ``OrdersSource.poll_batch`` →
    ``IngestPool.submit_records`` → the pipeline (spine, async
    harvester), as a deployment's pump feeds it; then the same payloads,
    poll for poll, through the native ``decode_orders_columnar`` →
    ``submit_columns``. The two states must be bit-identical."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import native
    from opentelemetry_demo_tpu_torch.runtime.ingest_pool import IngestPool
    from opentelemetry_demo_tpu_torch.runtime.kafka_orders import OrdersSource, decode_orders_columnar
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    cfg = DetectorConfig(sketch_impl="xla")
    dt = width / ORDER_RATE  # virtual seconds of traffic a batch holds
    t_make = time.perf_counter()
    topic = OrderTopic()
    topic.publish(order_payloads(83, n))
    make_s = time.perf_counter() - t_make

    def pipeline(reports):
        return DetectorPipeline(AnomalyDetector(cfg, device=device), batch_size=width, spine_ring=2,
                                harvest_async=True,
                                on_report=lambda t, rep, names: reports.append((t, rep.flags.copy(), names)))

    def pump_full(pipe, k, final=False):
        while pipe.pending_rows() >= width or (final and pipe.pending_rows()):
            pipe.pump(k * dt)
            k += 1
        return k

    # The records path, timed by phase.
    reports_a: list = []
    a = pipeline(reports_a)
    pool = IngestPool(a.submit_columns, a.tensorizer, workers=1)
    source = OrdersSource(topic.addr, group_id="replay")
    wire_c = source._ensure_wire(raise_on_fail=True)
    fetch_s = [0.0]
    fetch = wire_c.poll

    def timed_fetch(*args, **kw):
        tf = time.perf_counter()
        try:
            return fetch(*args, **kw)
        finally:
            fetch_s[0] += time.perf_counter() - tf

    wire_c.poll = timed_fetch
    polls, pos = [], {0: 0, 1: 0, 2: 0}
    poll_s = submit_s = dispatch_s = 0.0
    k = 0
    _kernels.reset_launches()
    t0 = time.perf_counter()
    while True:
        tp = time.perf_counter()
        offsets, records = source.poll_batch(0.0)
        ts = time.perf_counter()
        poll_s += ts - tp
        if not offsets:
            break
        polls.append({p: (pos[p], o) for p, o in sorted(offsets.items())})
        pos.update(offsets)
        ticket = pool.submit_records(records)
        if ticket is not None:
            ticket.result(timeout=120.0)
        td = time.perf_counter()
        submit_s += td - ts
        k = pump_full(a, k)
        dispatch_s += time.perf_counter() - td
    td = time.perf_counter()
    pump_full(a, k, final=True)
    a.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dispatch_s += time.perf_counter() - td
    launches = _kernels.LAUNCHES["cms_hist"]
    tensorize_s = pool.stats()["phase_s"].get("tensorize", 0.0)
    pool.close()
    a.close()
    source.close()
    check(a.stats.spans == n and sum(b - s for poll in polls for s, b in poll.values()) == n,
          f"replayed {a.stats.spans} of {n} orders")
    check(launches == a.stats.batches == -(-n // width), f"cms_hist launched {launches} times, "
          f"{a.stats.batches} batches")

    # The native twin, poll for poll.
    reports_b: list = []
    b = pipeline(reports_b)
    decode_s = 0.0
    k = 0
    t1 = time.perf_counter()
    for poll in polls:
        payloads = [p for part, (s, e) in poll.items() for p in topic.by_partition[part][s:e]]
        tn = time.perf_counter()
        cols = decode_orders_columnar(payloads, b.tensorizer)
        decode_s += time.perf_counter() - tn
        b.submit_columns(cols)
        k = pump_full(b, k)
    pump_full(b, k, final=True)
    b.drain()
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t1
    b.close()
    same_bits(state_to_numpy(b.detector.state), state_to_numpy(a.detector.state),
              "the native orders twin vs the records path")
    by_t = {t: (f.tobytes(), nm) for t, f, nm in reports_a}
    check(len(reports_a) + a.stats.reports_skipped == a.stats.batches, "a report was lost on the records path")
    check(all(by_t[t] == (f.tobytes(), nm) for t, f, nm in reports_b if t in by_t),
          "the twin's reports differ from the records path's")
    every = [p for part in range(3) for p in topic.by_partition[part]]
    tn = time.perf_counter()
    native.decode_orders(every[:width])
    one_call = time.perf_counter() - tn
    topic.stop()
    rec = dict(orders=n, batches=a.stats.batches, launches=launches, polls=len(polls), make_s=make_s,
               wall_s=wall, orders_per_s=n / wall, lag_p99_ms=a.stats.lag_p99_ms(),
               split_s=dict(fetch_and_wire_decode=fetch_s[0], decode_order=poll_s - fetch_s[0],
                            tensorize=tensorize_s, submit_wait=submit_s - tensorize_s, dispatch=dispatch_s),
               twin=dict(wall_s=wall_b, orders_per_s=n / wall_b, native_decode_s=decode_s,
                         native_orders_per_s=n / decode_s, lag_p99_ms=b.stats.lag_p99_ms()),
               native_one_call=dict(orders=width, s=one_call, orders_per_s=width / one_call))
    sp = rec["split_s"]
    print(f"orders backlog B={width} impl=xla: {n} orders in {len(polls)} polls, {wall:.3f} s = "
          f"{rec['orders_per_s']:.0f} orders/s end to end (fetch + wire decode {sp['fetch_and_wire_decode']:.3f} s, "
          f"decode_order {sp['decode_order']:.3f} s, tensorize {sp['tensorize']:.3f} s, rest of the pool's hand-off "
          f"{sp['submit_wait']:.3f} s, dispatch {sp['dispatch']:.3f} s), lag p99 {rec['lag_p99_ms']:.3f} ms, "
          f"cms_hist launches {launches}; the native twin: state bit-identical, {rec['twin']['orders_per_s']:.0f} "
          f"orders/s, decode_orders_columnar alone {rec['twin']['native_orders_per_s']:.0f} orders/s "
          f"({width} in one call: {rec['native_one_call']['orders_per_s']:.0f} orders/s); "
          f"{make_s:.3f} s to make and load the topic")
    return rec


def phase_orders(device, results):
    """The Kafka ``orders`` leg on the card, with no external broker: the
    port's ``KafkaBroker`` (three partitions) in process, orders made
    from a seed, every leg consuming over the socket with
    ``OrdersSource``; the live leg (flood, verdicts, flagd gating), the
    resume leg and the backlog replay."""
    t0 = time.perf_counter()
    out = dict(live=orders_live(device), resume=orders_resume(device), backlog=orders_backlog(device))
    out["wall_s"] = time.perf_counter() - t0
    results["fused_update"]["launches_orders"] = {"live": out["live"]["launches"],
                                                  "resume": out["resume"]["launches"]}
    results["cms_hist"]["launches_orders"] = {"backlog": out["backlog"]["launches"]}
    print(f"orders phase: {out['wall_s']:.1f} s ({gpu_line()})")
    return out


# -- the state that outlives a batch ------------------------------------------------

CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"


class TimedLock:
    """A lock that records how long each holder kept it, in ms."""

    def __init__(self, lock):
        self.lock = lock
        self.held_ms: list[float] = []

    def __enter__(self):
        self.lock.acquire()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.held_ms.append((time.perf_counter() - self._t0) * 1e3)
        self.lock.release()


def same_bits(a, b, what):
    for name, x, y in zip(a._fields, a, b):
        check(x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(),
              f"{what}: {name} differs")


def phase_checkpoint(device, impl, cms_width, results, n_warm=40, n_fault=4, save_at=25):
    """Resume on the card: a pipeline is saved with a report in flight
    (``checkpoint.save`` under its dispatch lock), a fresh detector and
    pipeline are built from the file (``load_resilient``, ``adopt_names``,
    the window clock from the file), and the stream carries on through a
    ×10 latency step. The resumed run must equal an uninterrupted run of
    the same stream bit for bit, with the same flags; the file read on
    the CPU must equal the card's state at the save; a truncated file and
    a file with one flipped column byte must each cold-start and be
    quarantined. Saves taken while the card is busy must hold the lock
    for a fraction of the busy time."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import checkpoint, frame
    from opentelemetry_demo_tpu_torch.runtime.otlp import decode_export_request
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    check(frame.crc_backend() == "native", "the checkpoint CRC is not the native one")
    cfg = DetectorConfig(cms_width=cms_width, sketch_impl=impl)
    kernel = "fused_update" if impl is None else "cms_hist"
    width, slow, n = 2048, 7, n_warm + n_fault
    rng = np.random.default_rng(9)
    bodies = make_bodies(rng, n_warm, width) + make_bodies(rng, n_fault, width, slow=slow)
    records = [decode_export_request(b) for b in bodies]

    def pipe_for(det, flags):
        return DetectorPipeline(det, on_report=lambda t, rep, names: flags.append((rep.flags, names)),
                                batch_size=width)

    # The uninterrupted run, keeping the state at the save point.
    flags_a: list = []
    a = pipe_for(AnomalyDetector(cfg, device=device), flags_a)
    _kernels.reset_launches()
    for k in range(n):
        a.submit(records[k])
        a.pump(k * DT_S)
        if k == save_at:
            at_save = state_to_numpy(a.detector.state)
    a.drain()
    check(_kernels.LAUNCHES[kernel] == n, f"uninterrupted run: {kernel} launched {_kernels.LAUNCHES[kernel]}")
    final_a = state_to_numpy(a.detector.state)

    # The interrupted run: batches 0..save_at, the last one still in
    # flight when the snapshot is taken.
    flags_b: list = []
    b = pipe_for(AnomalyDetector(cfg, device=device), flags_b)
    _kernels.reset_launches()
    for k in range(save_at):
        b.submit(records[k])
        b.pump(k * DT_S)
    b.submit(records[save_at])
    b.submit(records[save_at + 1])
    b.pump(save_at * DT_S)  # dispatches batch save_at and leaves it in flight
    check(len(b._inflight) == 1, f"{len(b._inflight)} reports in flight at the save")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    path = str(CKPT_DIR / f"resume_{kernel}")
    lock = TimedLock(b._dispatch_lock)
    t0 = time.perf_counter()
    checkpoint.save(path, b.detector, offsets={"0": save_at + 1}, service_names=b.tensorizer.service_names,
                    generation=b.tensorizer.generation, dispatch_lock=lock)
    save_ms = (time.perf_counter() - t0) * 1e3
    lock_ms = lock.held_ms[0]
    b.drain()

    # A fresh detector and pipeline from the file, on the card.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det, meta, corrupt = checkpoint.load_resilient(path, cfg, device=device)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    check(det is not None and not corrupt, "the snapshot did not load")
    check(meta["offsets"] == {"0": save_at + 1}, f"offsets {meta['offsets']}")
    same_bits(state_to_numpy(det.state), at_save, "state loaded on the card vs the state at the save")
    on_cpu, _ = checkpoint.load(path, cfg, device="cpu")
    same_bits(state_to_numpy(on_cpu.state), at_save, "state loaded on the CPU vs the card's at the save")
    flags_c: list = []
    c = pipe_for(det, flags_c)
    c.tensorizer.adopt_names(meta["service_names"])
    check(c.tensorizer.service_names == b.tensorizer.service_names, "intern table not restored")
    for k in range(save_at + 1, n):
        c.submit(records[k])
        c.pump(k * DT_S)
    c.drain()
    launches = _kernels.LAUNCHES[kernel]
    check(launches == n + 1, f"interrupted + resumed runs: {kernel} launched {launches}, not {n + 1}")
    same_bits(state_to_numpy(c.detector.state), final_a, "resumed run vs uninterrupted run")
    stitched = flags_b[: save_at + 1] + flags_c
    check(len(stitched) == n == len(flags_a), f"{len(stitched)} reports")
    for k, ((fa, na), (fs, ns)) in enumerate(zip(flags_a, stitched)):
        check(np.array_equal(fa, fs) and na == ns, f"flags differ at batch {k}: {na} vs {ns}")
    target = f"service-{slow:02d}"
    check(not any(names for _, names in stitched[:n_warm]), "flags before onset")
    check(stitched[n_warm][1] == [target], f"first batch after onset flags {stitched[n_warm][1]}")

    # Corrupt files cold-start and are quarantined.
    with open(path + checkpoint.SUFFIX, "rb") as f:
        blob = f.read()
    # The byte offset of the cms_bank column: decode's arrays view the buffer.
    col_off = frame.decode(blob).arrays["cms_bank"].ctypes.data - np.frombuffer(blob, np.uint8).ctypes.data
    for what, bad in (("truncated", blob[: len(blob) // 2]),
                      ("one flipped column byte", blob[:col_off + 5] + bytes([blob[col_off + 5] ^ 0x40])
                       + blob[col_off + 6:])):
        cpath = str(CKPT_DIR / "corrupt")
        with open(cpath + checkpoint.SUFFIX, "wb") as f:
            f.write(bad)
        det_x, meta_x, was_corrupt = checkpoint.load_resilient(cpath, cfg, device=device)
        check(det_x is None and meta_x is None and was_corrupt, f"a {what} file did not cold-start")
        check(os.path.exists(cpath + checkpoint.SUFFIX + ".corrupt") and not checkpoint.exists(cpath),
              f"a {what} file was not quarantined")
        os.remove(cpath + checkpoint.SUFFIX + ".corrupt")

    # Saves with the card busy: a step in flight, then ~20 ms of spin on
    # the stream. The lock must not wait for the card, and the file must
    # hold the state after that step (the copy-out is stream-ordered).
    busy_holds, busy_ms = [], []
    for r in range(5):
        c.submit(records[n - 2])
        c.submit(records[n - 1])
        c.pump((n + 2 * r) * DT_S)  # one step in flight, one batch queued
        check(len(c._inflight) == 1, f"{len(c._inflight)} reports in flight at a busy save")
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(40_000_000)
        e1.record()
        lock = TimedLock(c._dispatch_lock)
        checkpoint.save(path, c.detector, service_names=c.tensorizer.service_names, dispatch_lock=lock)
        saved, _ = checkpoint.load(path, cfg, device="cpu")
        same_bits(state_to_numpy(saved.state), state_to_numpy(c.detector.state), f"busy save {r}")
        c.drain()
        busy_ms.append(e0.elapsed_time(e1))
        busy_holds.append(lock.held_ms[0])
    check(max(busy_holds) < min(busy_ms) / 4,
          f"the lock waited for the card: held {busy_holds} ms with the card busy {busy_ms} ms")

    # The same save and load again, quiesced, and the CRC's rate.
    saves, loads, holds = [], [], []
    for _ in range(5):
        lock = TimedLock(c._dispatch_lock)
        t0 = time.perf_counter()
        checkpoint.save(path, c.detector, service_names=c.tensorizer.service_names, dispatch_lock=lock)
        saves.append((time.perf_counter() - t0) * 1e3)
        holds.append(lock.held_ms[0])
        t0 = time.perf_counter()
        checkpoint.load(path, cfg, device=device)
        torch.cuda.synchronize()
        loads.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(20):
        frame.crc32c(blob)
    crc_mb_s = 20 * len(blob) / (time.perf_counter() - t0) / 1e6
    # The frame encode alone (two CRC passes and the host copies), the
    # part of a save between the copy-out and the write.
    fr = frame.decode(blob)
    encodes = []
    for _ in range(5):
        t0 = time.perf_counter()
        frame.encode(fr.arrays, fr.meta)
        encodes.append((time.perf_counter() - t0) * 1e3)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    rec = dict(kernel=kernel, cms_width=cms_width, batches=n, save_at=save_at, launches=launches,
               file_bytes=len(blob), lock_held_ms=lock_ms, save_ms=save_ms, load_ms=load_ms,
               quiesced_lock_held_ms=holds, quiesced_save_ms=saves, quiesced_load_ms=loads,
               busy_lock_held_ms=busy_holds, busy_card_ms=busy_ms,
               encode_ms=encodes, crc_mb_per_s=crc_mb_s, crc_backend=frame.crc_backend())
    print(f"checkpoint resume ({kernel}, cms width {cms_width}): {n} batches, saved at {save_at} with a "
          f"report in flight and resumed on the card == uninterrupted run (state bit-identical, flags "
          f"identical, {target} flagged on the first batch after onset); file {len(blob)} bytes read on the "
          f"CPU == the card's state; truncated and flipped files quarantined; {kernel} launches {launches}")
    print(f"  checkpoint times: lock held (copy-out enqueued) {lock_ms:.4f} ms, save {save_ms:.3f} ms, "
          f"load {load_ms:.3f} ms; quiesced median lock {np.median(holds):.4f} ms, save "
          f"{np.median(saves):.3f} ms (frame encode {np.median(encodes):.3f} ms), load "
          f"{np.median(loads):.3f} ms; CRC32C {crc_mb_s:.0f} MB/s (native)")
    print(f"  saves with the card busy: lock held {[round(x, 4) for x in busy_holds]} ms while the card "
          f"spun {[round(x, 2) for x in busy_ms]} ms; each file == the state after the in-flight step")
    results[kernel]["launches_resume"] = launches
    return rec


def metric_payload(rng, k, slow=None):
    """One scrape of N_SERVICES services: two cumulative counters and two
    gauges each; ``slow`` sends its request counter ten times faster."""
    out = []
    for i in range(N_SERVICES):
        rate = 50.0 * (1 + i % 7) * (10.0 if i == slow else 1.0)
        out.append((f"service-{i:02d}", [
            ("http.server.requests", rate, True),
            ("http.server.errors", 0.01 * rate, True),
            ("queue.depth", float(rng.normal(40.0 + i, 1.5)), False),
            ("process.cpu.utilization", float(rng.normal(0.3, 0.01)), False),
        ]))
    return out


def phase_metrics_head(device, n_warm=20, n_fault=3, scrape_s=10.0):
    """OTLP metric bodies for the shop's services at a virtual 10 s
    cadence through ``decode_metrics_request`` and ``MetricsFeed`` with the
    head on the card, beside the same feed on the CPU; after warm-up one
    service's request counter runs ten times faster. Flags must fire on
    the first pump after onset and never before, equal the CPU run's, and
    the head state must equal the CPU's within rtol 1e-4 / atol 1e-5."""
    from opentelemetry_demo_tpu_torch.runtime.metrics_feed import MetricsFeed
    from opentelemetry_demo_tpu_torch.runtime.otlp_metrics import decode_metrics_request, encode_metrics_request

    rng = np.random.default_rng(10)
    slow = 11
    card, cpu = MetricsFeed(device=device), MetricsFeed(device="cpu")
    totals: dict = {}
    flagged = []
    for k in range(n_warm + n_fault):
        scrape = []
        for svc, metrics in metric_payload(rng, k, slow if k >= n_warm else None):
            row = []
            for name, value, counter in metrics:
                if counter:
                    # Cumulative: the rate over the scrape interval, with
                    # a little noise in each interval's increment.
                    inc = value * scrape_s * (1.0 + rng.normal(0.0, 0.02))
                    value = totals[(svc, name)] = totals.get((svc, name), 0.0) + inc
                row.append((name, value, counter))
            scrape.append((svc, row))
        body = encode_metrics_request(scrape, t_ns=10**18 + k * int(scrape_s * 1e9))
        recs = decode_metrics_request(body)
        card.submit(recs)
        cpu.submit(recs)
        rc, rp = card.pump(k * scrape_s), cpu.pump(k * scrape_s)
        check((rc is None) == (rp is None), f"pump {k}: a report on one side only")
        if rc is None:
            continue
        check(torch.equal(rc.flags.cpu(), rp.flags) and torch.equal(rc.cell_flags.cpu(), rp.cell_flags),
              f"metric flags differ at pump {k}")
        check(bool(torch.isfinite(rc.z).all()), f"z not finite at pump {k}")
        if rc.flags.any():
            flagged.append((k, card.flagged_services(rc, card.service_names)))
    check(bool(flagged) and flagged[0] == (n_warm, [f"service-{slow:02d}"]),
          f"metric flags {flagged[:3]}: not service-{slow:02d} on the first pump after onset alone")
    worst = 0.0
    for name, a, b in zip(card.head.state._fields, card.head.state, cpu.head.state):
        a = a.cpu()
        check(torch.allclose(a.double(), b.double(), rtol=RTOL, atol=ATOL), f"head state {name} differs")
        worst = max(worst, float((a.double() - b.double()).abs().max()))
    # One head step at full width: device and wall time, device operations.
    x = rng.gamma(4.0, 50.0, (32, 32)).astype(np.float32)
    obs = rng.random((32, 32)) < 0.5
    step_ms, wall_ms = time_ms(lambda: card.head.observe(x, obs, scrape_s), 50)
    ops = profile_ops(lambda: card.head.observe(x, obs, scrape_s), 20)
    print(f"metrics head: {n_warm + n_fault} pumps of {N_SERVICES} services x 4 metrics on the card == CPU "
          f"(flags identical, state within {worst:.3g}); service-{slow:02d} flagged on the first pump after "
          f"onset; head step device {step_ms} ms, wall {wall_ms:.4f} ms")
    print(f"  device operations per head step ({sum(v['per_call'] for v in ops.values()):g}): "
          f"{show_breakdown(ops)}")
    return dict(pumps=n_warm + n_fault, ttd_pumps=1, max_state_diff=worst, step_device_ms=step_ms,
                step_wall_ms=wall_ms, step_ops=ops)


def phase_keyspace(device, results, ticks=44, bomb_until=30, bomb_per_tick=4):
    """A cardinality bomb on a virtual 1 s clock: the shop's services
    beside fresh names that fill the intern table, through a pipeline on
    the card and its twin on the CPU, each with a ``KeyspaceManager``. The
    ladder climbs, the throttle and collapse rungs fold new keys to
    overflow, ``evict_idle`` zeroes idle keys' rows on the card, ids
    recycle behind generation bumps, and the ladder comes back down. After
    each sweep the names, generation and free ids equal the CPU run's, the
    card's state is its pre-sweep state with exactly the evicted rows
    zeroed, and the integer banks equal the CPU's. Then the keyspace goes
    through a checkpoint and back."""
    from opentelemetry_demo_tpu_torch.runtime import pipeline

    # The pipeline stamps last-seen times and refills the throttle's
    # token buckets from ``time.monotonic``: both pipelines read the
    # virtual clock while the bomb runs.
    clock = {"t": 1000.0}
    wall = pipeline.time
    pipeline.time = types.SimpleNamespace(monotonic=lambda: clock["t"], perf_counter=time.perf_counter,
                                          time=time.time, sleep=time.sleep)
    try:
        return _keyspace_bomb(device, results, clock, ticks, bomb_until, bomb_per_tick)
    finally:
        pipeline.time = wall


def _keyspace_bomb(device, results, clock, ticks, bomb_until, bomb_per_tick):
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import checkpoint, keyspace
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
    from opentelemetry_demo_tpu_torch.runtime.tensorize import EVICTED_SLOT, SpanRecord

    cfg = DetectorConfig()
    pipes, mgrs, flags = [], [], ([], [])
    for dev, fl in zip((device, "cpu"), flags):
        p = DetectorPipeline(AnomalyDetector(cfg, device=dev), batch_size=2048,
                             on_report=lambda t, rep, names, fl=fl: fl.append(rep.flags),
                             keyspace_enable=True, keyspace_newkey_rate=2.0)
        pipes.append(p)
        mgrs.append(keyspace.KeyspaceManager(p, idle_s=3.0, now_fn=lambda: clock["t"], rss_fn=lambda: 0))
    card, cpu = pipes
    timed = TimedLock(card._dispatch_lock)
    rng = np.random.default_rng(11)
    real = [f"service-{i:02d}" for i in range(N_SERVICES)]
    levels, sweeps, holds = [], 0, []
    _kernels.reset_launches()
    for k in range(ticks):
        names = real * 90 + [f"bomb-{k}-{i}" for i in range(bomb_per_tick if k < bomb_until else 0)
                             for _ in range(10)]
        lat = rng.gamma(8.0, 40.0, len(names))
        tids = rng.integers(1, 2**63, len(names))
        recs = [SpanRecord(nm, float(lat[j]), int(tids[j]), False, f"p-{j % 37}") for j, nm in enumerate(names)]
        for p in pipes:
            p.submit(recs)
            p.pump(clock["t"])
            p.drain()
        before = state_to_numpy(card.detector.state)
        names_before = card.tensorizer.service_names
        card._dispatch_lock, timed.held_ms = timed, []
        ticks_out = [m.tick() for m in mgrs]
        card._dispatch_lock = timed.lock
        check(ticks_out[0]["level"] == ticks_out[1]["level"] and ticks_out[0]["evicted"] == ticks_out[1]["evicted"],
              f"tick {k}: card {ticks_out[0]} vs CPU {ticks_out[1]}")
        tz, tz_cpu = card.tensorizer, cpu.tensorizer
        check((tz.service_names, tz.generation, tz.free_ids, tz.overflow_assigns_total)
              == (tz_cpu.service_names, tz_cpu.generation, tz_cpu.free_ids, tz_cpu.overflow_assigns_total),
              f"tick {k}: interner differs from the CPU run's")
        after = state_to_numpy(card.detector.state)
        if ticks_out[0]["evicted"]:
            sweeps += 1
            holds.extend(timed.held_ms)
            freed = [i for i, (was, now) in enumerate(zip(names_before, tz.service_names))
                     if now == EVICTED_SLOT and was != EVICTED_SLOT]
            check(len(freed) == len(ticks_out[0]["evicted"]), f"tick {k}: freed ids {freed}")
            for name in after._fields:
                want = np.array(getattr(before, name), copy=True)
                if name == "hll_bank":
                    want[:, :, freed, :] = 0
                elif name in keyspace.MERGE_HEAD_ROWS:
                    want[freed] = 0
                check(getattr(after, name).tobytes() == want.tobytes(), f"tick {k}: {name} after the sweep")
        ref = state_to_numpy(cpu.detector.state)
        for name in ("hll_bank", "cms_bank", "step_idx"):
            check(np.array_equal(getattr(after, name), getattr(ref, name)), f"tick {k}: {name} differs from CPU")
        for name in after._fields:
            a, b = getattr(after, name), getattr(ref, name)
            if a.dtype.kind == "f":
                check(np.allclose(a, b, rtol=RTOL, atol=ATOL), f"tick {k}: {name} differs from CPU")
        levels.append(ticks_out[0]["level"])
        clock["t"] += 1.0
    launches = _kernels.LAUNCHES["fused_update"]
    check(launches == ticks, f"fused_update launched {launches} times in {ticks} ticks")
    check(len(flags[0]) == len(flags[1]) == ticks and all(np.array_equal(a, b) for a, b in zip(*flags)),
          "flags differ from the CPU run's")
    check(max(levels) >= 3 and levels[-1] == 0, f"ladder levels {levels}")
    tz = card.tensorizer
    check(tz.generation >= 2 and tz.overflow_assigns_total > 0 and sweeps >= 2,
          f"generation {tz.generation}, overflow {tz.overflow_assigns_total}, sweeps {sweeps}")
    check(set(real) <= set(tz._svc_snapshot), "a real service lost its slot")
    throttled = dict(card.stats.newkey_throttled_tenant)
    collapsed = dict(card.stats.overflow_keys_tenant)
    check(bool(throttled) and bool(collapsed), f"throttled {throttled}, collapsed {collapsed}")

    # The keyspace through a checkpoint and back.
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    path = str(CKPT_DIR / "keyspace")
    checkpoint.save(path, card.detector, service_names=tz.service_names, generation=tz.generation,
                    dispatch_lock=card._dispatch_lock)
    det, meta, _ = checkpoint.load_resilient(path, cfg, device=device)
    back = DetectorPipeline(det, batch_size=2048)
    back.tensorizer.adopt_names(meta["service_names"])
    check(meta["generation"] == tz.generation, "generation not restored")
    check(back.tensorizer.service_names == tz.service_names and back.tensorizer._svc_snapshot == tz._svc_snapshot
          and back.tensorizer._free_ids == tz._free_ids, "names, tombstones or free ids not restored")
    same_bits(state_to_numpy(det.state), state_to_numpy(card.detector.state), "keyspace checkpoint state")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    print(f"keyspace: {ticks} ticks ({bomb_per_tick} fresh names a tick for {bomb_until}) on the card == CPU; "
          f"ladder {levels}; {sweeps} sweeps, generation {tz.generation}, {tz.evicted_total} ids retired, "
          f"overflow assigns {tz.overflow_assigns_total}, throttled {throttled}, collapsed {collapsed}; "
          f"lock held per sweep {[round(x, 4) for x in holds]} ms; checkpoint round trip kept the "
          f"tombstones; fused_update launches {launches}")
    results["fused_update"]["launches_keyspace"] = launches
    return dict(ticks=ticks, levels=levels, sweeps=sweeps, generation=tz.generation,
                evicted_total=tz.evicted_total, overflow_assigns=tz.overflow_assigns_total,
                throttled=throttled, collapsed=collapsed, lock_held_ms=holds, launches=launches)


def phase_step_time(device, impl, width):
    """One detector step at this width: ``(device ms, wall ms, device
    operations per step)``, the last from ``profile_ops``."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import detector_step, report_pack
    from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanTensorizer

    rng = np.random.default_rng(5)
    det = AnomalyDetector(DetectorConfig(sketch_impl=impl), device=device)
    n = width
    batch = SpanTensorizer(32, width).pack_arrays(
        rng.integers(0, N_SERVICES, n).astype(np.int32), rng.gamma(4.0, 250.0, n).astype(np.float32),
        rng.integers(0, 2**63, n, dtype=np.uint64), np.zeros(n, np.float32),
        rng.zipf(1.3, n).astype(np.uint64),
    )
    args = det._args(batch, 0.0)

    def step():
        report_pack(detector_step(det.config, det.state, *args)[1])

    return (*time_ms(step, 5), profile_ops(step, 20))


def profile_ops(fn, iters: int = 50) -> dict:
    """Device time per call of each device operation that ``fn`` runs,
    from a ``torch.profiler`` window (CUPTI) over ``iters`` calls:
    ``{operation: {"ms": device ms per call, "per_call": operations per
    call}}``. Empty when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, dict] = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = evt.key.replace("(anonymous namespace)::", "").split("(")[0]
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        row = out.setdefault(name.removeprefix("void ").strip(), {"ms": 0.0, "per_call": 0.0})
        row["ms"] += us / 1e3 / iters
        row["per_call"] += evt.count / iters
    return out


def time_kernel(plain_fn, kernel_fn, plain_iters: int, kernel_iters: int = 200) -> dict:
    """A kernel and its plain version on the same inputs in turns (plain,
    kernel, kernel, plain), and the kernel's device operations from the
    profiler."""
    turns = [time_ms(f, n) for f, n in (
        (plain_fn, plain_iters), (kernel_fn, kernel_iters), (kernel_fn, kernel_iters), (plain_fn, plain_iters),
    )]
    check(all(t[0] is not None for t in turns), "a device time could not be taken")
    return dict(turns=turns, ms=turns[1][0], plain_ms=turns[0][0], breakdown=profile_ops(kernel_fn))


def show_breakdown(ops: dict) -> str:
    if not ops:
        return "profiler saw no device activity"
    return "; ".join(f"{k}: {v['ms']:.5f} ms x{v['per_call']:g}" for k, v in ops.items())


def phase_times(cfg, device, results):
    """Each kernel, its plain version and the library call on the same
    inputs, in turns (plain, kernel, kernel, plain), at the shapes of its
    paths; and each kernel's device time split by device operation. K1 is
    timed at B = 2048 (the main path), 8192 and 65536; K3 at a (2 × 2)
    mesh rank's shape and at one rank's full width, B = 2048 and 65536
    (the one-rank mesh leg's widths). Both also at B = 1, and K1 at 2048
    without its head epilogue, to show the launch's fixed cost."""
    from opentelemetry_demo_tpu_torch.ops import cms, fused

    rng = np.random.default_rng(6)
    k1 = results["fused_update"]
    k1["shapes"] = {}
    for b in (2048, 8192, 65536):
        lanes = batch_lanes(rng, cfg, b, device)
        hll_bank, cms_bank, heads = random_state(rng, cfg, device)
        kw = dict(num_services=cfg.num_services, hll_p=cfg.hll_p, heads=fused.HeadState(**heads),
                  dt=torch.tensor(DT_S, device=device),
                  step_pos=torch.tensor(7, dtype=torch.int32, device=device), statics=head_kw(cfg))
        args = (hll_bank[:, 0], cms_bank[:, 0], *k1_args(lanes))
        k1["shapes"][f"B={b}"] = dict(
            time_kernel(lambda: fused.fused_update_plain(*args, **kw), lambda: fused.fused_update(*args, **kw),
                        10 if b < 65536 else 4),
            bound_ms=fused_bound_bytes(lanes, cfg) / HBM_BYTES_PER_S * 1e3,
        )
        if b == 2048:
            # Without the head epilogue, and with one lane: what the heads
            # and the lanes add to the launch's fixed cost.
            kw_nh = dict(num_services=cfg.num_services, hll_p=cfg.hll_p)
            k1["shapes"]["B=2048 no heads"] = dict(
                time_kernel(lambda: fused.fused_update_plain(*args, **kw_nh),
                            lambda: fused.fused_update(*args, **kw_nh), 10),
                bound_ms=fused_bound_bytes(lanes, cfg) / HBM_BYTES_PER_S * 1e3,
            )
            one = {k: v[..., :1].contiguous() for k, v in lanes.items()}
            args1 = (hll_bank[:, 0], cms_bank[:, 0], *k1_args(one))
            k1["shapes"]["B=1"] = dict(
                time_kernel(lambda: fused.fused_update_plain(*args1, **kw),
                            lambda: fused.fused_update(*args1, **kw), 10),
                bound_ms=fused_bound_bytes(one, cfg) / HBM_BYTES_PER_S * 1e3,
            )
    k1.update(k1["shapes"]["B=2048"], library_ms=None)

    lanes = batch_lanes(rng, cfg, 65536, device)
    n_bins = cfg.cms_depth * cfg.cms_width
    keys = flat_keys(lanes["cidx"], lanes["valid"], cfg.cms_width)
    idx, valid, width = lanes["cidx"], lanes["valid"], cfg.cms_width
    k2 = results["cms_hist"]
    # cms_hist on the flat keys (the shape every tree can time, so a
    # parent and a change compare in turns); cms_count on the lanes, the
    # call the composed path makes: each lane's D indices and valid byte
    # read once, the counts written once.
    k2["shapes"] = {f"{keys.numel()} keys": dict(
        time_kernel(lambda: cms.cms_hist_plain(keys, n_bins), lambda: cms.cms_hist(keys, n_bins), 20),
        bound_ms=(keys.numel() * 4 + n_bins * 4) / HBM_BYTES_PER_S * 1e3,
    )}
    k2["shapes"][f"cms_count B={idx.shape[1]} D={idx.shape[0]}"] = dict(
        time_kernel(lambda: cms.cms_count_plain(idx, valid, width), lambda: cms.cms_count(idx, valid, width), 20),
        bound_ms=(idx.shape[1] * (4 * idx.shape[0] + 1) + n_bins * 4) / HBM_BYTES_PER_S * 1e3,
    )
    k2.update(k2["shapes"][f"cms_count B={idx.shape[1]} D={idx.shape[0]}"])
    # The yardstick: one PyTorch call computing the same histogram from
    # the flat keys. Its wall time includes a host read (bincount sizes
    # its output from the keys' maximum); its device time is the sum over
    # the CUDA kernels the profiler sees in the call (its memsets and its
    # copy of the maximum to the host are listed beside it).
    library = lambda: torch.bincount(keys, minlength=n_bins + 1)[:n_bins]  # noqa: E731
    k2["library_wall_ms"] = time_ms(library, 50)[1]
    k2["library_breakdown"] = profile_ops(library)
    k2["library_ms"] = sum(
        v["ms"] for k, v in k2["library_breakdown"].items() if not k.startswith(("Memcpy", "Memset"))
    ) or None

    k3 = results["sketch_delta"]
    k3["shapes"] = {}
    for b, s, d in ((32768, 16, 2), (2048, cfg.num_services, cfg.cms_depth),
                    (65536, cfg.num_services, cfg.cms_depth), (1, cfg.num_services, cfg.cms_depth)):
        c = cfg._replace(num_services=s, cms_depth=d)
        lanes = batch_lanes(rng, c, b, device)
        args = delta_args(lanes)
        kw = dict(num_services=s, hll_p=c.hll_p, cms_width=c.cms_width)
        k3["shapes"][f"B={b} S={s} D={d}"] = dict(
            time_kernel(lambda: fused.sketch_delta_plain(*args, **kw), lambda: fused.sketch_delta(*args, **kw), 20),
            bound_ms=delta_bound_bytes(lanes, s, c) / HBM_BYTES_PER_S * 1e3,
        )
    k3.update(k3["shapes"]["B=32768 S=16 D=2"], library_ms=None)

    for name, r in results.items():
        for label, t in r["shapes"].items():
            (p1, pw), (k1_, kw_), (k2_, _), (p2, _) = t["turns"]
            print(f"time {name} {label}: device kernel {k1_:.5f} / {k2_:.5f} ms, plain {p1:.5f} / "
                  f"{p2:.5f} ms; wall kernel {kw_:.5f} ms, plain {pw:.5f} ms; bound {t['bound_ms']:.6f} ms")
            print(f"  device operations per call ({name} {label}): {show_breakdown(t['breakdown'])}")
    print(f"time torch.bincount (yardstick of cms_hist): device {k2['library_ms']} ms "
          f"({show_breakdown(k2['library_breakdown'])}), wall {k2['library_wall_ms']:.5f} ms")


def mesh_on_cards(n_cards: int) -> int:
    """The four-rank mesh leg with NCCL between ``n_cards`` cards, held
    against the single-device step on card 0; no other phase."""
    from opentelemetry_demo_tpu_torch.models import DetectorConfig

    check(n_cards == 4, "the mesh leg is a (2 × 2) layout of four ranks")
    check(torch.cuda.device_count() >= n_cards, f"{torch.cuda.device_count()} cards, not {n_cards}")
    t_start = time.perf_counter()
    card = gpu_line()
    print(f"card: {card} (x{torch.cuda.device_count()}); torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build()
    results = {"sketch_delta": {}}
    mesh = phase_mesh_four_ranks(DetectorConfig(), torch.device("cuda"), results, backend="nccl")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_nccl.json").write_text(json.dumps(
        {"card": card, "count": torch.cuda.device_count(), "mesh": mesh,
         "wall_s": time.perf_counter() - t_start}, indent=1, default=str))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on the card.")
    ap.add_argument("--nccl-cards", type=int, default=0,
                    help="run only the four-rank mesh leg over NCCL, one card per rank")
    ap.add_argument("--times-only", metavar="JSON",
                    help="build the kernels and run only the timing phase, writing its record "
                         "to JSON (to compare two trees on one card in one call)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.nccl_cards:
        return mesh_on_cards(args.nccl_cards)
    # The composed path's segment stats are a float32 matmul: keep it in
    # full float32 (PyTorch's default, stated here).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    from opentelemetry_demo_tpu_torch.models import DetectorConfig

    cfg = DetectorConfig()
    if args.times_only:
        phase_build()
        results = {name: {} for name in ("fused_update", "cms_hist", "sketch_delta")}
        phase_times(cfg, device, results)
        Path(args.times_only).write_text(json.dumps({"card": card, "root": str(ROOT), "times": results},
                                                    indent=1, default=str))
        print(card)
        return 0
    results: dict[str, dict] = {}
    phase_build()
    phase_fused_update(cfg, device, results)
    phase_cms_hist(cfg, device, results)
    phase_sketch_delta(cfg, device, results)
    phase_detector_vs_cpu(device)
    e2e = [
        phase_end_to_end(device, None, 2048, n_warm=40, n_fault=4, bodies_per_batch=1, results=results),
        phase_end_to_end(device, "xla", 65536, n_warm=24, n_fault=3, bodies_per_batch=8, results=results),
    ]
    for leg in e2e:
        leg["step_device_ms"], leg["step_wall_ms"], leg["step_ops"] = phase_step_time(
            device, leg["impl"], leg["width"])
        leg["device_busy_share"] = (
            None if leg["step_device_ms"] is None
            else leg["step_device_ms"] * leg["batches"] / (leg["wall_s"] * 1e3)
        )
        print(f"step B={leg['width']} impl={leg['impl']}: device {leg['step_device_ms']} ms, "
              f"wall {leg['step_wall_ms']:.4f} ms; device busy share of the e2e run "
              f"{leg['device_busy_share']}")
        ops = sorted(leg["step_ops"].items(), key=lambda kv: -kv[1]["ms"])
        print(f"  device operations per step (B={leg['width']} impl={leg['impl']}, "
              f"{sum(v['per_call'] for _, v in ops):g} in all, {sum(v['ms'] for _, v in ops):.5f} ms): "
              f"{show_breakdown(dict(ops))}")
    native_rec = dict(decode=phase_native_decode())
    native_rec["e2e"] = [
        phase_native_e2e(device, None, 2048, n_warm=40, n_fault=4, bodies_per_batch=1, results=results),
        phase_native_e2e(device, "xla", 65536, n_warm=24, n_fault=3, bodies_per_batch=8, results=results),
    ]
    native_rec["spine_guard"] = phase_spine_guard(device)
    native_rec["overload"] = phase_overload(device, native_rec["e2e"][0]["spans_per_s"])
    native_rec["lag"] = phase_lag(device)
    doors = phase_doors(device, results)
    orders = phase_orders(device, results)
    state = dict(
        checkpoint=[phase_checkpoint(device, None, cfg.cms_width, results),
                    phase_checkpoint(device, "xla", 16384, results)],
        metrics_head=phase_metrics_head(device),
        keyspace=phase_keyspace(device, results),
    )
    mesh = phase_mesh_one_rank(cfg, device)
    mesh.update(phase_mesh_four_ranks(cfg, device, results))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    phase_times(cfg, device, results)

    src = "opentelemetry_demo_tpu_torch/csrc"
    meta = {
        "fused_update": ("cuda", f"{src}/fused_update.cu", "opentelemetry_demo_tpu/ops/fused.py:317"),
        "cms_hist": ("cuda", f"{src}/cms_hist.cu", "opentelemetry_demo_tpu/ops/cms.py:181"),
        "sketch_delta": ("cuda", f"{src}/sketch_delta.cu", "opentelemetry_demo_tpu/ops/fused.py:243"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        r = results[name]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by="bytes",
            library_ms=r["library_ms"], launches_doors=r.get("launches_doors"),
            launches_orders=r.get("launches_orders"),
        ))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "repeat": results, "e2e": e2e, "native": native_rec,
         "doors": doors, "orders": orders, "state": state, "mesh": mesh,
         "wall_s": time.perf_counter() - t_start}, indent=1, default=str))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
