"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --nccl-cards 4   # the four-rank mesh leg over NCCL, one card per rank

Builds the hand-written kernels from ``opentelemetry_demo_tpu_torch/csrc``,
holds each against its plain PyTorch version at the main path's shapes,
on edge cases and (the sketch kernels) at 2048-16384 services, checks the detector on the card against the CPU on a
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

The read side follows (``phase_read_side``): the main path at B = 2048
and 65536 with every read-side hook on (the flag-time state snapshot off
the card, one evidence bundle per flagged service, ``export_report``
into a ``MetricRegistry`` scraped from ``PrometheusExporter``, a
``QueryService`` answering a paced client while the pump runs, every
batch traced through ``make_traces_poster`` to a local sink, the
bundles as OTLP logs into the port's receiver). Each flag-time snapshot
must equal ``state_to_numpy`` at its step bit for bit, the query
documents the CPU's answer to the same state (and the gRPC twin's,
where ``grpc`` imports); a snapshot taken while a step spins on another
stream must equal the state after that step, and so must a checkpoint saved
with the pipeline's ``step_stream``, and an eviction sweep must zero
the evicted rows behind that step and leave the rest as the step left
them. It prints the snapshot's
lock hold and wall, the provenance snapshot and bundle build per flag,
the ``/metrics`` scrape, the tracer's cost at sample 0.01 and 1.0, and
querybench at the default config.

The time-travel tier and the counterfactual loop follow. ``phase_history``
records the native legs' bodies (64 clean and 4 faulty batches at a
virtual 1 s a batch, so the 1 s rung folds into one 60 s record) through
``submit_columnar`` → spine → async harvester with
``runtime.timetravel.TimeTravel`` ticked after each batch (span capture
on), at B = 2048 (the fused-update kernel) and 65536 (the CMS-histogram
kernel), with a twin run without the tier; the recorded span frames must
equal the dispatched columns, every 60 s record the fold of its 60
children, the replay through ``build_shadow_pipeline`` and a
transform-less ``ShadowVerifier`` the recording's flags bit for bit, and
the ranged ``/query/*`` documents of the card's engine those of an engine
over a CPU copy of the state. ``phase_quality`` runs qualbench on the
card and on the CPU (per scenario the same time to detect, warm-up false
flags and FP rate); ``phase_mitigation`` runs mitigbench's closed loop
and its shadow leg on the card with every gate held. They print the
replay and shadow speedups, the writer's lock hold and wall per tick,
the bytes on disk, the capture's cost, and TTD and TTM per scenario.

The hot-standby and fleet tier follows (``phase_fleet``).
``runtime.replbench.measure_failover`` runs on the card at its own
config (S=8, p=8, CMS 512, B=256) and at the daemon's ``DetectorConfig()``
with B=2048 and 65536: the primary ships deltas to a standby over a
real socket, is killed (RST), and the standby promotes at epoch 1 with a
mirror equal to the primary's last state and offsets. The B=2048 mirror
is hydrated onto the card into a fresh detector and, beside the
primary's own detector, takes four batches with a ×10 fault: flags and
integer state bit for bit. The native B=2048 leg runs with a primary
shipping to a live standby at 1.0 s and 0.05 s against a twin without
the link, in turns. The in-process reshard drill
(``measure_reshard``) runs on the card and on the CPU at two configs:
``fleet_ok``, a labelled partial answer, and the victim's documents
card = CPU. The churn soak (512 services) and the million-key soak
(4096 services: the sketch kernel walks them a tile at a time) run
through the native front door at their defaults. It prints the TTD,
the lag p99, the bytes of a delta frame, the dispatch-lock hold per
ship, the link's cost in spans/s, the soaks' keys/s and RSS per million
keys.

The detector daemon follows (``phase_daemon``): ``DetectorDaemon`` on the
card at its default knobs with ephemeral ports, the native front door,
a checkpoint, a history directory and a flagd file each. The native
B = 2048 corpus by one client through its front door, a ``step(t)``
after each batch: state bit for bit the in-process ``submit_columnar``
twin's and within tolerance a CPU twin daemon's, ``service-07`` flagged
on its first faulty batch and never before, ``/metrics``, ``/query`` and
``/healthz`` answering, no component restart, no warm-up error. Then a
second daemon boots from the first's shutdown checkpoint with its state,
names, offsets and epoch, and takes 4 faulty batches as the
uninterrupted twin does; a daemon at ``ANOMALY_NUM_SERVICES=8192``,
``ANOMALY_HLL_P=8``, ``ANOMALY_CMS_WIDTH=1024`` and B = 4096 takes the
same corpus two bodies a batch through its front door against a CPU
twin daemon (flags identical, the fault flagged on its first batch and
never before, one fused-update launch a batch); the orders corpus and its ×4 flood go through
the daemon's own Kafka pump (flagged on the flood's first batch, every
order counted, offsets committed); a primary and a standby daemon, the
standby promoted by its watchdog with the primary's final state on the
card bit for bit; the B = 65536 corpus through a ``sketch_impl="xla"``
daemon; ``python -m opentelemetry_demo_tpu_torch`` as a process on the
card (announce, a flagged fault, SIGTERM exit 0 with its checkpoint);
and ``replbench``'s live drills with daemon processes on the card. It
prints boot times, spans/s and orders/s through the daemon, the
failover TTD, the replication lag and the lock hold per ship.

The shop follows (``phase_shop``): the Locust-profile load of the
reference's default 5 users on a virtual clock through the shop's
services, tracer and collector into the port's ``DetectorPipeline`` on
the card (``services/rig.py``, B = 512, the daemon's default
``DetectorConfig`` with the rig's warm-ups: the fused-update kernel each
step). Three legs: ``shop_quiet`` (seed 0, 300 virtual s, no fault
flag: flagged reports after the warm-up within the reference's
false-alarm limit of 0.02, every admitted span reaches the pipeline);
``shop_faults`` (the eight flagd scenarios of the reference's shop tests
at seed 7: no flag before onset, the case's service flagged); and
``shop_kafka`` (``kafkaQueueProblems`` with the shop's async tier on
``KafkaBus`` against the port's ``KafkaBroker`` on 127.0.0.1: a consumer
flagged, the consumer counts of the in-process bus's run). Every run's
flushes are replayed into a CPU pipeline at the same config: every
report's flags equal, the final state equal. Each leg prints virtual
seconds, spans, wall, spans/s, steps, the card's busy share of the
traced leg and the lag p99.

The standalone stack follows (``phase_stack``), started the way its
users start it. ``stack_http``: ``serve_shop.build`` on the card (the
gateway with its web, mobile, ``/jaeger``, ``/grafana``, ``/loadgen``,
``/feature``, ``/metrics`` and ``/otlp-http`` surfaces, B = 512, 32
services), ``LoadControl`` at 5 users for 30 s beside 4 client threads
running cart + checkout on ``/api``, every edge route fetched once,
``paymentFailure`` through the flag editor and ``payment`` flagged after
it and not before; every ``on_spans`` flush recorded and replayed into a
CPU pipeline (reports and state equal), and the fused-update kernel's
launches equal to the steps and to the sketch kernels in the trace.
``stack_grpc`` (where ``grpc`` imports): ``GetProduct``,
``ListProducts`` and ``PlaceOrder`` over the gRPC edge against the HTTP
routes. ``stack_compose``: the port's daemon and ``serve_shop
--otlp-endpoint`` as processes on the card, ``payment`` flagged on the
daemon's ``/metrics`` and the shop's logs stored there.
``stack_kafka``: ``serve_kafka``, ``serve_shop --kafka`` and the daemon
with ``KAFKA_ADDR`` as three processes, ``kafkaQueueProblems`` flagging
``checkout-orders`` and all three consumer groups committed.
``stack_spine``: spinebench's ``measure_e2e`` with its kernel
reference. The kernel line gains ``launches_stack``.

The deployment surface follows (``phase_deploy``), as ``deploy/torch``
defines it. Each image's build step (the ``RUN`` line of its
Dockerfile that calls ``opentelemetry_demo_tpu_torch.build``) runs in a
copy of the package under ``build/chip_smoke_deploy``, the image's
``/app``, with the card hidden
(``CUDA_VISIBLE_DEVICES=""``) and an empty ``build/torch_kernels``: every
kernel's and host library's ``.so`` must land there. Then the services
of ``docker-compose.self.yml`` (kafka, shop, detector) and the overlay's
primary, standby and aggregator run as processes from those copies, each
with its entrypoint, command, environment and healthcheck taken from
the compose file and the Dockerfile. Only what a container network
provides is rewritten, and printed: host names and ports to free ports
on 127.0.0.1, mounted paths into that directory, ``python`` to
this interpreter. Every healthcheck must exit 0, the standby's
``--role`` probe must print STANDBY, the shop's spans must reach the
detector (its ``/metrics``: spans and batches dispatched on the card),
the three Kafka consumer groups must commit, ``paymentFailure`` must
flag ``payment`` after the flip and never before, neither copy's
``build/torch_kernels`` may change (nothing compiles at run time), and
each process's peak resident set must fit the memory limit its compose
file gives. ``docker build`` itself is not run.

The bench line follows (``phase_bench``): the fused-update kernel at the
bench's width, B = 2,097,152, in two detector steps from one seeded
state against its plain version, and the CMS-histogram kernel at the
matrix's widest composed call, 4 × 524,288 keys, exactly against its
plain version, both timed; then ``opentelemetry_demo_tpu_torch.bench``'s
``main`` on the card at that width with the sketch-impl matrix (the legs
other phases drive on the card at 0): one JSON line with the reference's
keys and this card's name and power limit, a finite throughput, eight
finite matrix entries, ``legs_skipped`` naming the knobs at 0. The
kernel line gains ``launches_bench``.

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
result: its last two lines, on standard output and on standard error
alike, are the walls of the phases that finished and ``chip_smoke FAILED
in <phase> after <s> s: <message>``. Without a CUDA device it exits
non-zero at once. The last line of standard output is ``{"ok": true,
"device": {...}}``; the lines before it are the phases' walls, the
kernel table as one JSON object and the card's name and power limit.
The build log goes to ``chiprun_out/chip_smoke_build.log``.
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


class Phases:
    """Runs ``main``'s phases one at a time and keeps each one's wall, so
    a failure can say which phase it was in and how far the run got."""

    def __init__(self):
        self.t_start = time.perf_counter()
        self.walls: dict[str, float] = {}
        self.current: str | None = None
        self._t_phase = self.t_start

    def __call__(self, name: str, fn, *args, **kw):
        self.current, self._t_phase = name, time.perf_counter()
        out = fn(*args, **kw)
        self.walls[name] = time.perf_counter() - self._t_phase
        self.current = None
        return out

    def walls_line(self) -> str:
        return (f"phase walls (s; {time.perf_counter() - self.t_start:.1f} in all): "
                + json.dumps({k: round(v, 2) for k, v in self.walls.items()}))

    def failed(self, exc: BaseException) -> None:
        """The traceback, then the finished phases' walls and the failing
        phase as the last two lines of standard output and standard
        error."""
        import traceback

        traceback.print_exc()
        where = self.current or "main"
        message = " ".join(f"{type(exc).__name__}: {exc}".split())
        lines = (self.walls_line(),
                 f"chip_smoke FAILED in {where} after {time.perf_counter() - self._t_phase:.1f} s: "
                 f"{message[:2000]}")
        for stream in (sys.stdout, sys.stderr):
            stream.flush()
            print(*lines, sep="\n", file=stream, flush=True)


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


def partials_bytes(plan, s: int) -> int:
    """Bytes of the stats partials the sketch kernel moves besides its
    inputs and outputs: each of the plan's blocks writes its row [4, S]
    whole, and the reduction reads every row once."""
    return 2 * plan.grid * 4 * s * 4


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
    """Every kernel and host library, through the function the images
    build with (``opentelemetry_demo_tpu_torch.build``)."""
    from opentelemetry_demo_tpu_torch import build
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import frame, native

    built = build.build()
    check(native.available(), f"the native OTLP decoder did not load: {native.load_error()}")
    check(native.frontdoor_available(), f"the native front door did not load: {native.frontdoor_load_error()}")
    check(frame.crc_backend() == "native", f"host CRC32C did not load: {frame._crc_error}")
    print("build: " + ", ".join(f"{name} {path.name} at {s:.2f} s" for name, (path, s) in sorted(built.items())))
    OUT_DIR.mkdir(exist_ok=True)
    if _kernels.BUILD_LOG:
        (OUT_DIR / "chip_smoke_build.log").write_text(
            "\n".join(f"== {k}\n{v}" for k, v in _kernels.BUILD_LOG.items())
        )


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
# Service counts past a warp's tile of stats (the kernel walks them a tile
# at a time, and every block sums its own run of services after the grid
# barrier), up to twice the million-key soak's 8192 slots, at its geometry
# (B = 4096, HLL p = 8, CMS 4 x 1024).
TILED_SERVICES = (2048, 4096, 8192, 16384)


def soak_config(cfg, s):
    return cfg._replace(num_services=s, hll_p=8, cms_width=1024)


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
    widths it is timed at), on the edge cases and at many services, up
    to 16384 (walked a tile of services at a time)."""
    from opentelemetry_demo_tpu_torch.ops import fused

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
    for s in TILED_SERVICES:
        c = soak_config(cfg, s)
        lanes = batch_lanes(rng, c, 4096, device, n_active=s)
        plan = fused.launch_plan(4096, s)
        worst = max(worst, check_k1(c, device, lanes, random_state(rng, c, device),
                                    f"B=4096 S={s} p=8 Wc=1024 ({plan.threads} threads, tiles of {plan.tile} "
                                    f"services, shared memory {plan.smem_bytes} B)"))
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
    D=2), on the edge cases and at many services, up to 16384; there its
    stats must also equal K1's bit for bit (one plan, one summing
    order)."""
    from opentelemetry_demo_tpu_torch.ops import fused

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
    for s in TILED_SERVICES:
        c = soak_config(cfg, s)
        kw = dict(num_services=s, hll_p=c.hll_p, cms_width=c.cms_width)
        args = delta_args(batch_lanes(rng, c, 4096, device, n_active=s))
        worst = max(worst, check_k3(args, kw, f"B=4096 S={s} p={c.hll_p} Wc={c.cms_width}"))
        k1 = fused.fused_update(torch.zeros((1, s, 1 << c.hll_p), dtype=torch.int32, device=device),
                                torch.zeros((1, c.cms_depth, c.cms_width), dtype=torch.int32, device=device),
                                *args, num_services=s, hll_p=c.hll_p)
        check(torch.equal(k1, fused.sketch_delta(*args, **kw).stats), f"K1 and K3 stats differ at S={s}")
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
          f"{st['overlap_hits']} misses {st['overlap_misses']} (pack + copy issue {st['stage_s']:.3f} s, puts blocked "
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
    the pump issues the copy for batch k + depth into the same device
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
                    dispatch_lock=b._dispatch_lock, stream=b.step_stream)
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


# -- the read side -------------------------------------------------------------

READ_PATHS = (
    "/query/services", "/query/topk?service=service-07", "/query/cardinality?service=service-07",
    "/query/zscore?service=service-07", "/query/anomalies", "/query/explain",
)


class RawSink:
    """A local OTLP/HTTP sink that keeps each POSTed body whole, so the
    self-traces can be read back with ``decode_selftrace_request``."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        bodies = self.bodies = []
        lock = self.lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 (http.server API)
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                with lock:
                    bodies.append((self.path, body))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    def take(self, path: str) -> list[bytes]:
        with self.lock:
            out = [b for p, b in self.bodies if p == path]
            self.bodies[:] = [(p, b) for p, b in self.bodies if p != path]
        return out

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10.0)


def http_json(port: int, path: str) -> tuple[int, dict]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30.0)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def cpu_engine_like(pipe):
    """The port's query engine on the CPU over a copy of ``pipe``'s state
    taken by ``state_to_numpy`` (not by the snapshot under test) and the
    same query block."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector
    from opentelemetry_demo_tpu_torch.models.detector import state_from_numpy, state_to_numpy
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
    from opentelemetry_demo_tpu_torch.runtime.query import QueryEngine
    from opentelemetry_demo_tpu_torch.runtime.querybench import state_snapshot_fn

    det = pipe.detector
    torch.cuda.synchronize()
    cpu = AnomalyDetector(det.config, device="cpu")
    cpu.state = state_from_numpy(state_to_numpy(det.state), device="cpu")
    cpu.clock._t_prev = det.clock._t_prev
    twin = DetectorPipeline(cpu, batch_size=pipe.tensorizer.batch_size)
    twin.tensorizer.adopt_names(pipe.tensorizer.service_names)
    twin.restore_query_meta(json.loads(json.dumps(pipe.query_meta())))
    twin.explanations_built = pipe.explanations_built  # a process counter, never restored
    return QueryEngine(snapshot_fn=state_snapshot_fn(twin), max_staleness_s=1e9)


def read_side_leg(device, impl, width, n_warm, n_fault, bodies_per_batch, sink, logs_rx, logs_got):
    """One main-path run with every read-side hook on: native decode →
    ``submit_columnar`` → spine (2 slots) → synchronous harvest (so the
    step of each flag is known) → ``ProvenanceEngine`` with the flag-time
    snapshot off the card → bundles in the explain ring and
    ``query_meta``; ``export_report`` into a ``MetricRegistry`` served by
    ``PrometheusExporter``; a ``QueryService`` over the snapshot function
    answering a paced client while the pump runs; every batch traced
    (sample 1.0) through ``make_traces_poster`` to a local sink; the
    bundles exported as OTLP logs to the port's receiver."""
    import threading
    import urllib.request

    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import DetectorState, state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import native, selftrace
    from opentelemetry_demo_tpu_torch.runtime.otlp import MONITORED_ATTR_KEYS
    from opentelemetry_demo_tpu_torch.runtime.otlp_export import OtlpHttpLogsExporter, make_traces_poster
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
    from opentelemetry_demo_tpu_torch.runtime.provenance import ProvenanceEngine, log_doc
    from opentelemetry_demo_tpu_torch.runtime.query import QueryEngine, QueryGrpcService, QueryService, dispatch
    from opentelemetry_demo_tpu_torch.runtime.querybench import state_snapshot_fn
    from opentelemetry_demo_tpu_torch.telemetry import MetricRegistry, PrometheusExporter
    from opentelemetry_demo_tpu_torch.telemetry.metrics import ANOMALY_PHASE_SECONDS, export_report

    clean, faulty, spans = e2e_bodies(width, n_warm, n_fault, bodies_per_batch)
    cfg = DetectorConfig(sketch_impl=impl)
    kernel = "fused_update" if impl is None else "cms_hist"
    n = n_warm + n_fault
    biggest = max(sum(len(b) for b in batch_bodies(clean, faulty, k, n_warm, bodies_per_batch))
                  for k in range(n))
    scratch = native.alloc_scratch(*native.scratch_dims(biggest, bodies_per_batch))
    registry = MetricRegistry()
    det = AnomalyDetector(cfg, device=device)
    prov = ProvenanceEngine(cfg, topk=5, trajectory_windows=16)
    poster = make_traces_poster(f"http://127.0.0.1:{sink.port}", queue_max=256)
    tracer = selftrace.SelfTracer(submit=poster.submit, sample=1.0)
    reports: list = []
    flag_snaps: list = []  # (snapshot arrays, state_to_numpy at that moment, seconds)

    def on_report(t, report, flagged):
        export_report(registry, pipe.tensorizer.service_names, report, flagged)
        reports.append((t, flagged))

    pipe = DetectorPipeline(
        det, on_report=on_report, batch_size=width, spine_ring=2, harvest_async=False,
        exemplar_ring=8, provenance=prov, selftrace=tracer,
        phase_observe=lambda p, s: registry.histogram_observe(
            ANOMALY_PHASE_SECONDS, s, selftrace.PHASE_BUCKETS, phase=p),
    )
    snapshot = pipe._provenance_snapshot

    def flag_snapshot():
        # The harvest is synchronous and nothing else is in flight, so the
        # detector's state now is the state the snapshot must hold.
        t0 = time.perf_counter()
        arrays = snapshot()
        secs = time.perf_counter() - t0
        flag_snaps.append((arrays, state_to_numpy(det.state), secs))
        return arrays

    pipe._provenance_snapshot = flag_snapshot
    engine = QueryEngine(snapshot_fn=state_snapshot_fn(pipe), max_staleness_s=0.05, topk_default=10)
    service = QueryService(engine, registry=registry, host="127.0.0.1", port=0)
    exporter = PrometheusExporter(registry, host="127.0.0.1", port=0)
    logs_exp = OtlpHttpLogsExporter(f"http://127.0.0.1:{logs_rx.port}")
    grpc_svc = None
    service.start()
    exporter.start()
    stop = threading.Event()
    live = {"ok": 0, "bad": []}

    def client():
        i = 0
        while not stop.is_set():
            path = READ_PATHS[i % len(READ_PATHS)]
            i += 1
            status, _doc = http_json(service.port, path)
            if status == 200:
                live["ok"] += 1
            else:
                live["bad"].append((path, status))
            stop.wait(0.01)

    poller = threading.Thread(target=client, name="query-client", daemon=True)
    try:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        for k in range(n):
            bodies = batch_bodies(clean, faulty, k, n_warm, bodies_per_batch)
            cols, rows = native.decode_otlp_many(bodies, MONITORED_ATTR_KEYS, scratch=scratch,
                                                 threads=decode_threads())
            check(rows.tolist() == [spans] * bodies_per_batch, f"native verdicts {rows.tolist()}")
            pipe.submit_columnar(cols, copy=True)
            pipe.pump(k * DT_S)
            if k == 0:
                # The client starts once the first batch has named the
                # services it asks about (an unknown name is a 404).
                poller.start()
        pipe.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _kernels.LAUNCHES[kernel]
        stop.set()
        poller.join(timeout=30.0)
        check(launches == n, f"{kernel} launched {launches} times in {n} batches of the read-side run")
        check(len(reports) == n, f"{len(reports)} reports read of {n}")
        check(not live["bad"] and live["ok"] > 0,
              f"queries during the run: {live['ok']} answered, failures {live['bad'][:3]}")
        # Flags: the faulty service on the first batch after onset, never before.
        target = f"service-{SLOW:02d}"
        onset = n_warm * DT_S
        before = [names for t, names in reports if t < onset and names]
        check(not before, f"read side B={width}: flags before onset {before[:3]}")
        at_onset = [names for t, names in reports if t == onset]
        check(at_onset == [[target]], f"read side B={width}: the first batch after onset flags {at_onset}")
        # Bundles: one per flagged service per flag, each citing the
        # state at its flag bit for bit.
        flags = sum(len(names) for _, names in reports)
        meta = pipe.query_meta()
        bundles = meta["explains"]
        check(len(bundles) == pipe.explanations_built == flags,
              f"{len(bundles)} bundles, {pipe.explanations_built} built, for {flags} flagged services")
        check(pipe.stats.provenance_misses == 0, f"{pipe.stats.provenance_misses} flag-time snapshots failed")
        check(len(flag_snaps) == pipe.stats.flag_events, f"{len(flag_snaps)} snapshots for "
              f"{pipe.stats.flag_events} flags")
        for arrays, want, _secs in flag_snaps:
            same_bits(DetectorState(**arrays), want, f"flag-time snapshot (B={width})")
        by_seq = {int(want.step_idx): want for _a, want, _s in flag_snaps}
        for b in bundles:
            check(b["service"] == target, f"a bundle for {b['service']}")
            want = {}
            prov._attach_state(want, by_seq[b["seq"]]._asdict(), b["service_id"],
                               [int(k["attr_crc"], 16) for k in b["top_keys"]])
            for key in ("ewma", "cusum", "cardinality"):
                check(b[key] == want[key], f"bundle {b['id']}: {key} differs from state_to_numpy")
            check(b["top_keys"] == want["top_keys"], f"bundle {b['id']}: top keys differ from state_to_numpy")
            check(len(b["trajectory"]) == min(16, n) and b["exemplars"], f"bundle {b['id']}: trajectory/exemplars")
        # /metrics over a socket.
        ts = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}/metrics", timeout=30.0) as resp:
            text = resp.read().decode()
        scrape_ms = (time.perf_counter() - ts) * 1e3
        for i in range(N_SERVICES):
            check(f'app_anomaly_z_score{{service="service-{i:02d}",signal="latency"}}' in text,
                  f"/metrics lacks the z-score of service-{i:02d}")
        check(f'app_anomaly_flags_total{{service="{target}"}}' in text, "/metrics lacks the flag counter")
        check('anomaly_phase_seconds_bucket{le="+Inf",phase="dispatch"}' in text, "/metrics lacks the phases")
        # Self-traces through the poster.
        check(poster.flush(30.0) and poster.errors == 0 and poster.dropped == 0,
              f"trace poster: sent {poster.sent}, errors {poster.errors}, dropped {poster.dropped}")
        traces = [selftrace.decode_selftrace_request(b) for b in sink.take("/v1/traces")]
        check(len(traces) == n == tracer.traces_exported, f"{len(traces)} traces for {n} batches")
        by_trace = {}
        for spans_ in traces:
            names = [s["name"] for s in spans_]
            check({selftrace.SPAN_BATCH, selftrace.SPAN_DISPATCH, selftrace.SPAN_HARVEST,
                   selftrace.SPAN_STAGE, selftrace.SPAN_PUT} <= set(names), f"trace spans {names}")
            root = spans_[-1]
            check(all(s["parent_span_id"] == root["span_id"] for s in spans_[:-1]), "a span off the root")
            by_trace[root["trace_id"]] = spans_
        for b in bundles:
            spans_ = by_trace.get(b["selftrace"])
            check(spans_ is not None, f"bundle {b['id']}: no trace {b['selftrace']}")
            flag = [s for s in spans_ if s["name"] == selftrace.SPAN_FLAG]
            check(len(flag) == 1 and [x[:16] for x in flag[0]["links"]] == b["exemplars"],
                  f"bundle {b['id']}: the flag span's links are not its exemplars")
        n_flag_traces = sum(any(s["name"] == selftrace.SPAN_FLAG for s in t) for t in traces)
        check(n_flag_traces == pipe.stats.flag_events, f"{n_flag_traces} traces with a flag span")
        # The bundles as OTLP logs into the port's receiver.
        logs_exp(0.0, [log_doc(b) for b in pipe.take_explain_exports()])
        check(logs_exp.flush(30.0) and logs_exp.sent == 1 and logs_exp.errors == 0, "explain log export")
        got_ids = {d.attrs.get("anomaly.bundle_id") for d in logs_got}
        check(got_ids == {b["id"] for b in bundles}, f"explain logs carry {len(got_ids)} bundle ids "
              f"of {len(bundles)}")
        logs_got.clear()
        # The query documents against the CPU's answer to the same state.
        engine.max_staleness_s = 1e9
        check(engine.refresh(), "query refresh failed")
        cpu = cpu_engine_like(pipe)
        for path in READ_PATHS:
            status, doc = http_json(service.port, path)
            route, _, q = path.partition("?")
            params = dict(p.split("=", 1) for p in q.split("&") if p)
            c_status, c_doc = dispatch(cpu, route, params)
            check(status == c_status == 200, f"{path}: {status} on the card, {c_status} on the CPU")
            got, want = dict(doc["data"]), dict(c_doc["data"])
            if "timeline" in got:
                check(got.pop("timeline")[-1]["estimate"] == want.pop("timeline")[-1]["estimate"],
                      f"{path}: timeline differs")
            check(got == want, f"{path}: the card's document differs from the CPU's")
            check(doc["meta"]["seq"] == c_doc["meta"]["seq"] == n, f"{path}: seq {doc['meta']['seq']}")
        grpc_note = "not run: grpc does not import here"
        try:
            import grpc  # noqa: F401
        except ImportError:
            grpc = None
        if grpc is not None:
            from opentelemetry_demo_tpu_torch.runtime.query import grpc_query

            grpc_svc = QueryGrpcService(engine, host="127.0.0.1", port=0)
            grpc_svc.start()
            for path in READ_PATHS:
                route, _, q = path.partition("?")
                params = dict(p.split("=", 1) for p in q.split("&") if p)
                doc = grpc_query(f"127.0.0.1:{grpc_svc.port}", route, params)
                check(doc["data"] == http_json(service.port, path)[1]["data"], f"gRPC {path} differs from HTTP")
            grpc_note = f"gRPC twin answered the {len(READ_PATHS)} documents as HTTP did"
        check(engine.refresh_errors == 0, f"refresh_errors {engine.refresh_errors}")
        # One state snapshot, timed after the run (nothing else takes
        # the lock now).
        timed = pipe._dispatch_lock = TimedLock(pipe._dispatch_lock)
        walls = []
        for _ in range(20):
            ts = time.perf_counter()
            pipe.state_snapshot()
            walls.append((time.perf_counter() - ts) * 1e3)
        pipe._dispatch_lock = timed.lock
        holds = timed.held_ms
        builds = [s * 1e3 for s in prov.take_build_samples()]
        snap_ms = [s * 1e3 for _a, _w, s in flag_snaps]
        rec = dict(
            width=width, impl=impl, batches=n, wall_s=wall, launches=launches,
            flags=pipe.stats.flag_events, bundles=len(bundles), queries_during_run=live["ok"],
            snapshot_hold_ms=dict(p50=float(np.median(holds)), max=float(max(holds))),
            snapshot_wall_ms=dict(p50=float(np.median(walls)), max=float(max(walls))),
            state_bytes=int(sum(t.numel() * t.element_size() for t in det.state)),
            provenance_snapshot_ms=snap_ms, bundle_build_ms=builds, scrape_ms=scrape_ms,
            metrics_bytes=len(text), traces=len(traces), grpc=grpc_note,
        )
        print(f"read side B={width} impl={impl}: {n} batches, {kernel} launches {launches}; "
              f"{target} flagged on the first batch after onset, none before; {len(bundles)} bundles, "
              f"each flag-time snapshot == state_to_numpy at its step; state snapshot "
              f"({rec['state_bytes']} bytes): lock held p50 {rec['snapshot_hold_ms']['p50']:.4f} ms "
              f"(max {rec['snapshot_hold_ms']['max']:.4f}), wall p50 {rec['snapshot_wall_ms']['p50']:.4f} ms "
              f"(max {rec['snapshot_wall_ms']['max']:.4f}); per flag: provenance snapshot "
              f"{', '.join(f'{x:.4f}' for x in snap_ms)} ms, bundle build "
              f"{', '.join(f'{x:.4f}' for x in builds)} ms; /metrics scrape {scrape_ms:.3f} ms "
              f"({len(text)} bytes); {len(traces)} traces and {len(bundles)} explain logs arrived and decoded; "
              f"{live['ok']} queries answered during the run; the {len(READ_PATHS)} query documents == the "
              f"CPU's; {grpc_note} ({gpu_line()})")
        return rec
    finally:
        stop.set()
        if poller.is_alive():
            poller.join(timeout=30.0)
        pipe.close()
        poster.close()
        logs_exp.close()
        service.stop()
        exporter.stop()
        if grpc_svc is not None:
            grpc_svc.stop()


def behind_a_spun_step(device, reader, feed, what, warm=None, spin_cycles=200_000_000):
    """One step on each stream first, then a step dispatched on a side
    stream behind ~100 ms of spin; while it is still queued, another
    thread (whose current stream is the default one) runs
    ``reader(pipe)`` under a timed dispatch lock. ``feed(pipe, k)``
    submits batch ``k``; ``warm(pipe)`` runs once after the warm-up
    steps (a reader's first use of a kernel or a buffer size waits for
    the card, once per process). Returns the pipeline (open: the caller closes
    it), the state before the spun step, the reader's result, the lock
    hold and the pump's time."""
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    import threading

    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    det = AnomalyDetector(DetectorConfig(), device=device)
    pipe = DetectorPipeline(det, batch_size=2048, harvest_interval_s=1e9)
    side = torch.cuda.Stream(device)
    # One step on each stream first, so neither the allocator's pools
    # nor the pinned buffers are new when the spun step goes out.
    for k, stream in enumerate((torch.cuda.current_stream(device), side)):
        with torch.cuda.stream(stream):
            feed(pipe, k)
            pipe.pump(k * DT_S)
            pipe.drain()
    if warm is not None:
        warm(pipe)
    torch.cuda.synchronize()
    before = state_to_numpy(det.state)
    with torch.cuda.stream(side):
        torch.cuda._sleep(spin_cycles)
        t0 = time.perf_counter()
        feed(pipe, 2)
        pipe.pump(2 * DT_S)
        pump_ms = (time.perf_counter() - t0) * 1e3
        probe = torch.cuda.Event()
        probe.record(side)
    check(pipe.step_stream == side, "the pipeline did not record the step's stream")
    running = not probe.query()
    timed = pipe._dispatch_lock = TimedLock(pipe._dispatch_lock)
    out = {}
    th = threading.Thread(target=lambda: out.update(got=reader(pipe)), name=f"{what}-reader")
    th.start()
    th.join(timeout=60.0)
    pipe._dispatch_lock = timed.lock
    check(running, f"{what}: the step was done before the reader enqueued (the pump took {pump_ms:.3f} ms "
                   f"behind {spin_cycles} cycles of spin)")
    check("got" in out, f"{what}: the reader thread did not finish")
    torch.cuda.synchronize()
    hold = timed.held_ms[-1]
    check(hold < 5.0, f"{what}: held the dispatch lock {hold:.3f} ms behind a ~100 ms spin")
    return pipe, before, out["got"], hold, pump_ms


def snapshot_order(device):
    """A state snapshot taken from another thread while a step spins on a
    side stream: enqueued on the step's stream under the dispatch lock,
    it must equal the state after that step, and the lock must be held
    for a small part of the spin."""
    from opentelemetry_demo_tpu_torch.models.detector import DetectorState, state_to_numpy
    from opentelemetry_demo_tpu_torch.runtime.lagbench import make_columns

    rng = np.random.default_rng(31)
    pipe, before, snap, hold, pump_ms = behind_a_spun_step(
        device, lambda p: p.state_snapshot(), lambda p, k: p.submit_columns(make_columns(rng, 2048)), "snapshot")
    try:
        after = state_to_numpy(pipe.detector.state)
        check(int(after.step_idx) == int(before.step_idx) + 1, "the spun step did not run")
        same_bits(DetectorState(**snap[0]), after, "snapshot behind a spinning step vs the state after it")
        check(before.hll_bank.tobytes() != after.hll_bank.tobytes(), "the step left the banks unchanged")
        print(f"snapshot order: a step on a side stream behind ~100 ms of spin, snapshot taken from another "
              f"thread while it ran: == the state after the step (step_idx {int(after.step_idx)}); lock held "
              f"{hold:.4f} ms; the pump took {pump_ms:.3f} ms")
        return dict(hold_ms=hold, pump_ms=pump_ms, running=True)
    finally:
        pipe.close()


def save_order(device):
    """``checkpoint.save`` from another thread while a step spins on a
    side stream, given the pipeline's ``step_stream``: the saved file's
    state must equal the state after that step."""
    from opentelemetry_demo_tpu_torch.models import DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.runtime import checkpoint
    from opentelemetry_demo_tpu_torch.runtime.lagbench import make_columns

    rng = np.random.default_rng(32)
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = str(CKPT_DIR / "save_order")

    def save(pipe):
        checkpoint.save(path, pipe.detector, service_names=pipe.tensorizer.service_names,
                        dispatch_lock=pipe._dispatch_lock, stream=pipe.step_stream)

    pipe, _before, _, hold, pump_ms = behind_a_spun_step(
        device, save, lambda p, k: p.submit_columns(make_columns(rng, 2048)), "save")
    try:
        after = state_to_numpy(pipe.detector.state)
        check(int(after.step_idx) == 3, f"the spun step did not run (step_idx {int(after.step_idx)})")
        saved, _meta = checkpoint.load(path, DetectorConfig(), device="cpu")
        same_bits(state_to_numpy(saved.state), after, "checkpoint saved behind a spinning step vs the state after it")
        print(f"save order: checkpoint.save from another thread while a step spun on a side stream: the file "
              f"== the state after the step; lock held {hold:.4f} ms; the pump took {pump_ms:.3f} ms")
        return dict(hold_ms=hold, pump_ms=pump_ms)
    finally:
        pipe.close()


def sweep_order(device, n_services=20, n_evict=4):
    """An eviction sweep (``KeyspaceManager.evict_idle``, with a history
    fold) from another thread while a step that writes the evicted rows
    spins on a side stream: the evicted rows must be zero and every
    other row equal a twin's state after the same steps, with no sweep;
    the fold record must hold the evicted rows as the step left them."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import DetectorState, state_to_numpy
    from opentelemetry_demo_tpu_torch.runtime.keyspace import MERGE_HEAD_ROWS, KeyspaceManager
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
    from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanRecord

    names = [f"svc-{i:02d}" for i in range(n_services)]

    def records(k):
        rng = np.random.default_rng(40 + k)
        return [SpanRecord(service=names[i % n_services], duration_us=float(rng.gamma(4.0, 250.0)),
                           trace_id=int(rng.integers(1, 2**63)), is_error=bool(rng.random() < 0.02),
                           attr=f"a{int(rng.integers(0, 8))}") for i in range(2048)]

    twin = DetectorPipeline(AnomalyDetector(DetectorConfig(), device=device), batch_size=2048,
                            harvest_interval_s=1e9)
    for k in range(3):
        twin.submit(records(k))
        twin.pump(k * DT_S)
        twin.drain()
    torch.cuda.synchronize()
    want = state_to_numpy(twin.detector.state)
    twin.close()

    class Writer:
        def __init__(self):
            self.calls = []

        def record_eviction(self, record, meta, now=None):
            self.calls.append((record, meta))

    writer = Writer()

    def sweep(pipe):
        mgr = KeyspaceManager(pipe, idle_s=0.0, evict_batch=n_evict, history_writer=writer)
        return mgr.evict_idle(now=time.monotonic() + 3600.0)

    def warm(pipe):
        # A sweep of a key no batch carries (its rows are zero, as in the
        # twin), so the real sweep's kernels and buffers are not new.
        mgr = KeyspaceManager(pipe, idle_s=0.0, evict_batch=1, history_writer=Writer(), protected=names)
        check(mgr.evict_idle(now=time.monotonic() + 3600.0) == ["warm-up"], "the warm-up sweep")

    sids = {}

    def feed(pipe, k):
        pipe.submit(records(k))
        if k == 0:
            pipe.tensorizer.service_id("warm-up")  # after the batch's names: the ids stay the twin's
        sids.update(pipe.tensorizer._svc_snapshot)

    pipe, _before, evicted, hold, pump_ms = behind_a_spun_step(device, sweep, feed, "sweep", warm=warm)
    try:
        check(len(evicted) == n_evict, f"the sweep evicted {evicted}")
        rows = sorted(sids[n] for n in evicted)
        after = state_to_numpy(pipe.detector.state)
        expect = {}
        for name in DetectorState._fields:
            w = np.array(getattr(want, name), copy=True)
            if name == "hll_bank":
                w[:, :, rows, :] = 0
            elif name in MERGE_HEAD_ROWS:
                w[rows] = 0
            expect[name] = w
        same_bits(after, DetectorState(**expect), "state after a sweep behind a spinning step vs the twin's")
        check(not np.all(want.hll_bank[0, 0, rows] == 0), "the spun step did not write the evicted rows")
        (record, meta), = writer.calls
        check(record["hll_bank"].tobytes() == want.hll_bank[0, 0].tobytes()
              and all(record[h].tobytes() == getattr(want, h).tobytes() for h in MERGE_HEAD_ROWS)
              and meta["seq"] == int(want.step_idx), "the fold record is not the state the step left")
        print(f"sweep order: evict_idle of {n_evict} keys from another thread while a step writing their rows "
              f"spun on a side stream: their rows zero, the rest == the twin after the step, the fold record "
              f"== the step's rows; lock held {hold:.4f} ms; the pump took {pump_ms:.3f} ms")
        return dict(hold_ms=hold, pump_ms=pump_ms, evicted=len(evicted))
    finally:
        pipe.close()


def tracer_cost(device, sink, width=2048, n_warm=40, n_fault=4):
    """The native B=2048 leg (spine + async harvester) with the tracer
    off, at sample 0.01 and at 1.0, in turns (off, 0.01, 1.0, 1.0, 0.01,
    off); each setting's second run is kept. The async harvester drops a
    report still copying while a newer one waits, and a dropped report's
    trace is never finished, in the reference as in the port
    (``tests/test_torch_selftrace.py``): each run exports exactly the
    traces of its harvested, sampled batches."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.runtime import native, selftrace
    from opentelemetry_demo_tpu_torch.runtime.otlp import MONITORED_ATTR_KEYS
    from opentelemetry_demo_tpu_torch.runtime.otlp_export import make_traces_poster
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    clean, faulty, spans = e2e_bodies(width, n_warm, n_fault, 1)
    n = n_warm + n_fault
    scratch = native.alloc_scratch(*native.scratch_dims(max(len(b) for b in clean + faulty), 1))
    threads = decode_threads()

    def run(sample):
        poster = tracer = None
        if sample is not None:
            poster = make_traces_poster(f"http://127.0.0.1:{sink.port}", queue_max=256)
            tracer = selftrace.SelfTracer(submit=poster.submit, sample=sample)
        harvested = []
        pipe = DetectorPipeline(AnomalyDetector(DetectorConfig(), device=device), batch_size=width,
                                spine_ring=2, harvest_async=True, selftrace=tracer,
                                on_report=lambda t, _r, _f: harvested.append(round(t / DT_S)))
        try:
            t0 = time.perf_counter()
            for k in range(n):
                cols, _rows = native.decode_otlp_many(batch_bodies(clean, faulty, k, n_warm, 1),
                                                      MONITORED_ATTR_KEYS, scratch=scratch, threads=threads)
                pipe.submit_columnar(cols, copy=True)
                pipe.pump(k * DT_S)
            pipe.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            pipe.close()
        out = dict(spans_per_s=n * width / wall, traces=0, reports_skipped=pipe.stats.reports_skipped)
        check(len(harvested) + pipe.stats.reports_skipped == n,
              f"{len(harvested)} reports harvested and {pipe.stats.reports_skipped} skipped of {n}")
        if poster is not None:
            check(poster.flush(30.0) and poster.errors == 0, f"trace poster errors {poster.errors}")
            out["traces"] = tracer.traces_exported
            poster.close()
            seqs = sorted(
                int(sp["attrs"]["batch.seq"]) for body in sink.take("/v1/traces")
                for sp in selftrace.decode_selftrace_request(body) if sp["name"] == selftrace.SPAN_BATCH
            )
            want = sorted(k for k in harvested if selftrace.sampled(k, sample))
            check(out["traces"] == len(seqs) and seqs == want,
                  f"traces of batches {seqs} at sample {sample}, harvested and sampled {want}")
        return out

    order = (None, 0.01, 1.0, 1.0, 0.01, None)
    runs = [(s, run(s)) for s in order]
    kept = {}
    for s, r in runs:
        kept.setdefault(str(s), []).append(r)
    rec = {k: dict(first=v[0], second=v[1]) for k, v in kept.items()}
    print(f"tracer cost, native B={width} (spine + async), in turns off/0.01/1.0/1.0/0.01/off: spans/s "
          + "; ".join(f"{k}: {v['first']['spans_per_s']:.0f} then {v['second']['spans_per_s']:.0f}"
                      for k, v in rec.items()) + "; reports skipped "
          + ", ".join(f"{k}: {v['first']['reports_skipped']}/{v['second']['reports_skipped']}" for k, v in rec.items())
          + f" of {n} ({gpu_line()})")
    return rec


def phase_read_side(device, results):
    """The detector's read side on the card (see ``read_side_leg``): at
    B=2048 (the fused-update kernel) and 65536 (``sketch_impl="xla"``,
    the CMS-histogram kernel), each with a ×10 latency fault after the
    CUSUM warm-up; the snapshot behind a spinning step; the tracer's
    cost on the native B=2048 leg; and querybench at the default
    ``DetectorConfig``."""
    from opentelemetry_demo_tpu_torch.models import DetectorConfig
    from opentelemetry_demo_tpu_torch.runtime.otlp import OtlpHttpReceiver
    from opentelemetry_demo_tpu_torch.runtime.querybench import measure_query

    t0 = time.perf_counter()
    sink = RawSink()
    logs_got: list = []
    logs_rx = OtlpHttpReceiver(lambda recs: None, host="127.0.0.1", port=0, on_log_records=logs_got.extend)
    logs_rx.start()
    try:
        legs = [
            read_side_leg(device, None, 2048, 40, 4, 1, sink, logs_rx, logs_got),
            read_side_leg(device, "xla", 65536, 24, 3, 8, sink, logs_rx, logs_got),
        ]
        order = dict(snapshot=snapshot_order(device), save=save_order(device), sweep=sweep_order(device))
        cost = tracer_cost(device, sink)
    finally:
        logs_rx.stop()
        sink.close()
    qb = measure_query(seconds=2.0, config=DetectorConfig(), device=device)
    check(qb["query_errors"] == 0 and qb["queries_total"] > 0, f"querybench: {qb}")
    print(f"querybench at the default DetectorConfig on the card: query p50 {qb['query_p50_ms']} ms, "
          f"p99 {qb['query_p99_ms']} ms, {qb['query_qps']} queries/s, explain p99 {qb['explain_p99_ms']} ms, "
          f"ingest_ratio {qb['ingest_ratio']} ({qb['ingest_spans_per_sec']} vs "
          f"{qb['ingest_spans_per_sec_baseline']} spans/s) ({gpu_line()})")
    results["fused_update"]["launches_read"] = legs[0]["launches"]
    results["cms_hist"]["launches_read"] = legs[1]["launches"]
    out = dict(legs=legs, snapshot_order=order, tracer_cost=cost, querybench=qb,
               wall_s=time.perf_counter() - t0)
    print(f"read-side phase: {out['wall_s']:.1f} s")
    return out


# -- the time-travel tier and the counterfactual loop ----------------------------------

HIST_DIR = ROOT / "build" / "chip_smoke_history"
HIST_DT_S = 1.0  # virtual seconds between batches: one shortest window each
E2E_SHAPE = {2048: (40, 4, 1), 65536: (24, 3, 8)}  # the e2e legs' body sets, shared


def pct(xs, q) -> float | None:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) else None


def history_record(device, cfg, width, n_warm, n_fault, directory, capture=True):
    """One recording run on the native path: bodies →
    ``decode_otlp_many`` → ``submit_columnar`` → spine (2 slots) → the
    async harvester, at ``HIST_DT_S`` a batch. With ``capture`` the
    time-travel tier (``runtime.timetravel.TimeTravel``: span capture on,
    rungs (1 s, 60 s)) is ticked after each batch, with the dispatch
    lock's holds timed; without it the same run has no tier (the cost
    comparison)."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import native
    from opentelemetry_demo_tpu_torch.runtime.history import SPAN_CAPTURE_COLUMNS
    from opentelemetry_demo_tpu_torch.runtime.otlp import MONITORED_ATTR_KEYS
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
    from opentelemetry_demo_tpu_torch.runtime.timetravel import TimeTravel

    clean, faulty, _spans = e2e_bodies(width, *E2E_SHAPE[width])
    bpb = E2E_SHAPE[width][2]
    n = n_warm + n_fault
    scratch = native.alloc_scratch(*native.scratch_dims(
        max(sum(len(b) for b in batch_bodies(clean, faulty, k, n_warm, bpb)) for k in range(n)), bpb))
    verdicts: dict = {}
    pipe = DetectorPipeline(
        AnomalyDetector(cfg, device=device),
        on_report=lambda t, rep, names: verdicts.__setitem__(
            round(float(t), 6), tuple(bool(f) for f in np.asarray(rep.flags))),
        batch_size=width, spine_ring=2, harvest_async=True,
    )
    tt = lock = None
    dispatched: list = []
    if capture:
        tt = TimeTravel(pipe, str(directory), rungs=(1.0, 60.0), capture_spans=True, span_queue_max=4 * n,
                        query={"max_staleness_s": 1e9})
        lock = pipe._dispatch_lock = TimedLock(pipe._dispatch_lock)
        writer_capture = pipe.history_capture

        def capture_and_keep(cols, t):
            dispatched.append(({c: np.array(getattr(cols, c), copy=True) for c in SPAN_CAPTURE_COLUMNS}, t))
            writer_capture(cols, t)

        pipe.history_capture = capture_and_keep
    holds, tick_ms = [], []
    wall0 = time.time()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for k in range(n):
        cols, rows = native.decode_otlp_many(batch_bodies(clean, faulty, k, n_warm, bpb), MONITORED_ATTR_KEYS,
                                             scratch=scratch, threads=decode_threads())
        pipe.submit_columnar(cols, copy=True)
        pipe.pump(k * HIST_DT_S)
        if tt is not None:
            # Only the tick takes the dispatch lock here: the pump has
            # returned, and the async harvester takes no lock.
            h0, tk = len(lock.held_ms), time.perf_counter()
            tt.tick(now=wall0 + k * HIST_DT_S)
            tick_ms.append((time.perf_counter() - tk) * 1e3)
            holds += lock.held_ms[h0:]
    pipe.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    kernel = "fused_update" if cfg.sketch_impl is None else "cms_hist"
    check(launches[kernel] == n, f"{kernel} launched {launches[kernel]} times in {n} recorded batches")
    check(len(verdicts) + pipe.stats.reports_skipped == n,
          f"{len(verdicts)} reports + {pipe.stats.reports_skipped} skipped of {n}")
    rec = dict(pipe=pipe, tt=tt, verdicts=verdicts, dispatched=dispatched, wall=wall, launches=launches[kernel],
               holds_ms=holds, tick_ms=tick_ms, wall0=wall0, n=n)
    if tt is not None:
        tt.tick(now=wall0 + n * HIST_DT_S)
        pipe.history_capture = None
        tt.close()
    pipe.close()
    return rec


def live_beside_shadow(device, cfg, width, verifier, now, n=100, pace_s=0.01):
    """The live native leg paced at one batch every ``pace_s`` (spine +
    async harvester), alone and with a thread replaying the recorded
    corpus through ``verifier`` (the shadow pre-flight, a second
    pipeline on the same card) for as long as the live leg runs; in
    turns alone, beside, alone, beside. The live state must be the same
    bits either way (the shadow never touches it); the lag p99 of each
    run is the cost of a shadow replay to the live path."""
    import threading

    from opentelemetry_demo_tpu_torch.models import AnomalyDetector
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.runtime import native
    from opentelemetry_demo_tpu_torch.runtime.otlp import MONITORED_ATTR_KEYS
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    clean, _faulty, _spans = e2e_bodies(width, *E2E_SHAPE[width])
    bpb = E2E_SHAPE[width][2]
    scratch = native.alloc_scratch(*native.scratch_dims(max(len(b) for b in clean) * bpb, bpb))

    def run(beside: bool):
        pipe = DetectorPipeline(AnomalyDetector(cfg, device=device), batch_size=width, spine_ring=2,
                                harvest_async=True)
        stop, verdicts = threading.Event(), []

        def shadow_loop():
            while not stop.is_set():
                verdicts.append(verifier.verify(SLOW, None, now=now))

        th = threading.Thread(target=shadow_loop, name="shadow-replay") if beside else None
        if th is not None:
            th.start()
        t0 = time.perf_counter()
        for k in range(n):
            delay = t0 + k * pace_s - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            cols, _rows = native.decode_otlp_many(batch_bodies(clean, clean, k, n, bpb), MONITORED_ATTR_KEYS,
                                                  scratch=scratch, threads=decode_threads())
            pipe.submit_columnar(cols, copy=True)
            pipe.pump(k * DT_S)
        pipe.drain()
        wall = time.perf_counter() - t0
        stop.set()
        if th is not None:
            th.join(timeout=120.0)
            check(not th.is_alive(), "the shadow thread did not stop")
        pipe.close()
        check(all(v.batches > 0 and v.reason != "error" for v in verdicts), "a shadow replay failed")
        return dict(state=state_to_numpy(pipe.detector.state), lag_p99_ms=pipe.stats.lag_p99_ms(), wall_s=wall,
                    replays=len(verdicts), skipped=pipe.stats.reports_skipped)

    runs = [run(False), run(True), run(False), run(True)]
    for r in runs[1:]:
        same_bits(r["state"], runs[0]["state"], f"the live state beside a shadow replay (B={width})")
    out = dict(pace_s=pace_s, batches=n, alone_lag_p99_ms=[runs[0]["lag_p99_ms"], runs[2]["lag_p99_ms"]],
               beside_lag_p99_ms=[runs[1]["lag_p99_ms"], runs[3]["lag_p99_ms"]],
               replays=[runs[1]["replays"], runs[3]["replays"]], wall_s=[r["wall_s"] for r in runs])
    check(min(out["replays"]) >= 1, "no shadow replay ran beside the live leg")
    print(f"live B={width} paced at {pace_s * 1e3:.0f} ms a batch ({width / pace_s:.0f} spans/s offered), "
          f"{n} batches: lag p99 alone {out['alone_lag_p99_ms'][0]:.3f} / {out['alone_lag_p99_ms'][1]:.3f} ms, "
          f"beside a looping shadow replay {out['beside_lag_p99_ms'][0]:.3f} / {out['beside_lag_p99_ms'][1]:.3f} ms "
          f"({out['replays']} replays of the corpus); the live state the same bits either way ({gpu_line()})")
    return out


def history_leg(device, impl, width, n_warm, n_fault, results):
    """The time-travel tier on the card at the default ``DetectorConfig``
    (``sketch_impl=impl``): record (capture on and off, in turns), then
    read back the span frames, check the ladder's fold, replay the corpus
    through ``build_shadow_pipeline`` (``replaybench.replay``) and a
    transform-less ``ShadowVerifier``, and hold the ranged query
    documents of the card's engine against a CPU snapshot's."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import state_from_numpy, state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import history, replaybench, shadow
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
    from opentelemetry_demo_tpu_torch.runtime.query import QueryEngine, dispatch
    from opentelemetry_demo_tpu_torch.runtime.timetravel import snapshot_fn

    cfg = DetectorConfig(sketch_impl=impl)
    kernel = "fused_update" if impl is None else "cms_hist"
    base = HIST_DIR / f"b{width}"
    shutil.rmtree(base, ignore_errors=True)
    # In turns: the first run of each pays first-use costs; the numbers
    # kept are the second run's.
    runs = [history_record(device, cfg, width, n_warm, n_fault, base / "rec0"),
            history_record(device, cfg, width, n_warm, n_fault, None, capture=False)]
    rec = history_record(device, cfg, width, n_warm, n_fault, base / "rec1")
    plain = history_record(device, cfg, width, n_warm, n_fault, None, capture=False)
    n, directory = rec["n"], str(base / "rec1")
    check(runs[0]["verdicts"] == {t: f for t, f in rec["verdicts"].items() if t in runs[0]["verdicts"]},
          "two recording runs flagged differently")
    store = history.HistoryStore(directory)
    reader = history.HistoryReader(store, rungs=(1.0, 60.0))
    # 1. The span frames read back are the columns that were dispatched.
    back = list(reader.span_batches())
    check(len(back) == len(rec["dispatched"]) == n, f"{len(back)} span frames for {n} dispatched batches")
    for (arrays, t), (want, t_want) in zip(back, rec["dispatched"]):
        check(t == t_want and all(np.asarray(arrays[c]).tobytes() == want[c].tobytes() for c in want),
              f"span frame at t={t} differs from the dispatched columns")
    # 2. Rung-1 records are the fold of their rung-0 children.
    coarse = store.records(rung=1)
    check(len(coarse) >= 1, f"no rung-1 record from {len(store.records(rung=0))} rung-0 records")
    for parent_rec in coarse:
        parent = store.read_frame(parent_rec).arrays
        acc = None
        kids = [r for r in store.records(rung=0)
                if r.t_start >= parent_rec.t_start - 1e-6 and r.t_end <= parent_rec.t_end + 1e-6]
        check(len(kids) == 60, f"rung-1 record over {len(kids)} rung-0 records")
        for r in kids:
            acc = history.merge_record_arrays(acc, store.read_frame(r).arrays)
        for k, v in parent.items():
            check(np.asarray(v).tobytes() == acc[k].tobytes(), f"rung-1 {k} differs from the fold of its children")
    # 3. Replay through the shared constructor: bit-identical flags.
    _kernels.reset_launches()
    replayed, virtual, replay_wall, batches = replaybench.replay(directory, device, config=cfg, batch_size=width)
    replay_launches = _kernels.LAUNCHES[kernel]
    check(batches == n and len(replayed) == n, f"replayed {batches} batches, {len(replayed)} verdicts of {n}")
    for t, flags in rec["verdicts"].items():
        check(replayed[t] == flags, f"replayed flags at t={t}: {replayed[t]} vs recorded {flags}")
    flagged = sum(1 for f in replayed.values() if any(f))
    check(flagged > 0, "the replayed corpus flagged nothing")
    # 4. The shadow verifier without a transform gives the same verdicts.
    recs = reader.span_records()
    now = recs[-1].t_end + 1.0
    verifier = shadow.ShadowVerifier(reader, cfg, batch_size=width, window_s=now - recs[0].t_start + 1.0,
                                     deadline_s=300.0, min_records=1, device=device)
    _kernels.reset_launches()
    v = verifier.verify(SLOW, None, now=now)
    shadow_launches = _kernels.LAUNCHES[kernel]
    check(v.reason != shadow.REASON_ERROR and v.batches == n, f"shadow verify: {v._replace(verdicts={})}")
    check(v.verdicts == replayed, "the shadow's verdicts differ from the replay's")
    beside = live_beside_shadow(device, cfg, width, verifier, now) if width == 2048 else None
    # 5. Ranged documents: the card's engine against a CPU snapshot's.
    pipe = rec["pipe"]
    torch.cuda.synchronize()
    cpu = AnomalyDetector(cfg, device="cpu")
    cpu.state = state_from_numpy(state_to_numpy(pipe.detector.state), device="cpu")
    cpu.clock._t_prev = pipe.detector.clock._t_prev
    twin = DetectorPipeline(cpu, batch_size=width)
    twin.tensorizer.adopt_names(pipe.tensorizer.service_names)
    twin.restore_query_meta(json.loads(json.dumps(pipe.query_meta())))
    engines = [rec["tt"].engine,
               QueryEngine(snapshot_fn(twin), history=reader, max_staleness_s=1e9)]
    w0 = rec["wall0"]
    span = {"from": w0, "to": w0 + n * HIST_DT_S}
    asks = [(p, dict(span, service=s)) for p in ("/query/cardinality", "/query/topk", "/query/zscore")
            for s in (f"service-{SLOW:02d}", "service-03")]
    asks += [("/query/cardinality", dict(span, service="service-03", resolution="60")),
             ("/query/anomalies", dict(span)), ("/query/explain", dict(span)),
             ("/query/cardinality", {"service": "service-05", "from": w0 + 10, "to": w0 + 20})]
    sources = []
    for path, params in asks:
        docs = [dispatch(e, path, dict(params)) for e in engines]
        for st, d in docs:
            d.get("meta", {}).pop("staleness_s", None)
        check(docs[0] == docs[1], f"{path} {params}: the card's document differs from the CPU's")
        check(docs[0][0] == 200, f"{path} {params}: {docs[0]}")
        sources.append(docs[0][1]["meta"]["source"])
    st = store.stats()
    nbytes = sum(f.stat().st_size for f in Path(directory).iterdir())
    tick_s = sum(rec["tick_ms"]) / 1e3
    cost = rec["wall"] / plain["wall"] - 1.0
    capture_cost = (rec["wall"] - tick_s) / plain["wall"] - 1.0
    out = dict(
        width=width, impl=impl, batches=n, dt_s=HIST_DT_S, record_wall_s=rec["wall"], plain_wall_s=plain["wall"],
        tier_cost=cost, capture_cost=capture_cost, tick_s=tick_s, record_spans_per_s=n * width / rec["wall"], plain_spans_per_s=n * width / plain["wall"],
        lock_hold_ms=dict(p50=pct(rec["holds_ms"], 50), p99=pct(rec["holds_ms"], 99), max=max(rec["holds_ms"])),
        tick_ms=dict(p50=pct(rec["tick_ms"], 50), p99=pct(rec["tick_ms"], 99), max=max(rec["tick_ms"])),
        bytes_on_disk=nbytes, store=st, writer=rec["tt"].writer.stats(), rung0=len(store.records(rung=0)),
        rung1=len(coarse), replay_speedup=virtual / replay_wall, replay_wall_s=replay_wall, replay_virtual_s=virtual,
        flagged_batches=flagged, shadow_speedup=v.speedup, shadow_wall_s=v.wall_s, query_sources=sources,
        launches=dict(record=rec["launches"], replay=replay_launches, shadow=shadow_launches),
        reports_skipped=pipe.stats.reports_skipped, live_beside_shadow=beside,
    )
    print(f"history B={width} impl={impl}: {n} batches at {HIST_DT_S} s recorded in {rec['wall']:.3f} s "
          f"({out['record_spans_per_s']:.0f} spans/s; without the tier {plain['wall']:.3f} s, "
          f"{out['plain_spans_per_s']:.0f} spans/s: capture + ticks cost {cost * 100:.1f}%, capture alone "
          f"{capture_cost * 100:.1f}% with the {tick_s:.3f} s of ticks taken out); writer tick "
          f"lock hold p50 {out['lock_hold_ms']['p50']:.4f} ms max {out['lock_hold_ms']['max']:.4f} ms, tick wall "
          f"p50 {out['tick_ms']['p50']:.3f} ms max {out['tick_ms']['max']:.3f} ms; {nbytes} bytes on disk "
          f"({out['rung0']} rung-0, {out['rung1']} rung-1 records, {n} span frames) ; span frames == dispatched "
          f"columns; rung-1 == fold of its 60 children; replay {batches} batches in {replay_wall:.4f} s = "
          f"{out['replay_speedup']:.1f}x the recorded clock, flags bit-identical ({flagged} flagged batches); "
          f"shadow verify == replay ({v.speedup}x); ranged documents card == CPU (sources {sorted(set(sources))}); "
          f"{kernel} launches: record {rec['launches']}, replay {replay_launches}, shadow {shadow_launches} "
          f"({gpu_line()})")
    results[kernel].setdefault("launches_history", {})[f"b{width}"] = out["launches"]
    return out


def phase_history(device, results):
    """The time-travel tier at full width on a virtual clock: B=2048
    (the fused-update kernel) and 65536 (``sketch_impl="xla"``, the
    CMS-histogram kernel), each 64 clean and 4 faulty batches (the
    ×10 fault on ``service-07``) so that the 1 s rung folds into one
    60 s record."""
    t0 = time.perf_counter()
    legs = [history_leg(device, None, 2048, 64, 4, results),
            history_leg(device, "xla", 65536, 64, 4, results)]
    shutil.rmtree(HIST_DIR, ignore_errors=True)
    out = dict(legs=legs, wall_s=time.perf_counter() - t0)
    print(f"history phase: {out['wall_s']:.1f} s")
    return out


def phase_quality(device, results):
    """qualbench at its own config (S=8, B=256, p=12, CMS 512; the
    fused-update kernel) on the card and on the CPU: per scenario the
    time to detect, ``false_flags_warmup`` and the FP rate must be
    equal. On the card every scenario detects with no warm-up false
    flag, and the FP rate stays within the reference's 0.02
    (``tests/test_e2e_detection.py``)."""
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import qualbench

    t0 = time.perf_counter()
    _kernels.reset_launches()
    card = qualbench.measure_detection_quality(device=device)
    launches = _kernels.LAUNCHES["fused_update"]
    card_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    cpu = qualbench.measure_detection_quality(device="cpu")
    cpu_s = time.perf_counter() - t1
    for name, got in card["ttd"].items():
        check(got == cpu["ttd"][name], f"qualbench {name}: card {got} vs CPU {cpu['ttd'][name]}")
        check(got["ttd_s"] is not None, f"qualbench {name}: not detected on the card ({got})")
        check(got["false_flags_warmup"] == 0, f"qualbench {name}: warm-up false flags on the card ({got})")
    check(card["fp_rate"] <= 0.02, f"FP rate {card['fp_rate']} on the card > 0.02")
    check(card["paymentFailure_ttd_by_rate"] == cpu["paymentFailure_ttd_by_rate"],
          f"payment sweep: card {card['paymentFailure_ttd_by_rate']} vs CPU {cpu['paymentFailure_ttd_by_rate']}")
    check((card["fp_rate"], card["fp_batches"]) == (cpu["fp_rate"], cpu["fp_batches"]),
          f"FP rate: card {card['fp_rate']} vs CPU {cpu['fp_rate']}")
    steps = launches
    print(f"qualbench on the card == on the CPU ({card_s:.1f} s vs {cpu_s:.1f} s, {steps} fused_update launches): "
          + "; ".join(f"{k} ttd {v['ttd_s']} s false_flags_warmup {v['false_flags_warmup']}"
                      for k, v in card["ttd"].items())
          + f"; payment sweep {card['paymentFailure_ttd_by_rate']}; fp_rate {card['fp_rate']} "
          f"({card['fp_batches']} of {card['quiet_batches']})")
    results["fused_update"].setdefault("launches_quality", {})["qualbench"] = launches
    return dict(card=card, cpu=cpu, card_s=card_s, cpu_s=cpu_s, launches=launches)


def phase_mitigation(device, results):
    """mitigbench on the card: TTM beside TTD per scenario, the rollback
    drill and zero flips on the clean run (``measure_mitigation``); then
    the shadow leg (``measure_shadow``): shadow == replay == recording,
    speedup ≥ the rate target, the released act's TTM within 2× the
    ungated one, and the refusal with zero flag writes. Every gate
    fails the run."""
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import mitigbench

    t0 = time.perf_counter()
    _kernels.reset_launches()
    mit = mitigbench.measure_mitigation(device=device)
    mit_launches = _kernels.LAUNCHES["fused_update"]
    check(mit["mitigation_ok"], f"mitigation gate: {json.dumps(mit, default=str)[:2000]}")
    check(mit["no_oscillation"]["ok"] and mit["no_oscillation"]["flag_writes"] == 0,
          f"no-oscillation gate: {mit['no_oscillation']}")
    for name, r in mit["scenarios"].items():
        check(r["verified"] and r["flag_state_end"] == "ENABLED", f"{name}: {r}")
    t1 = time.perf_counter()
    _kernels.reset_launches()
    sh = mitigbench.measure_shadow(device=device)
    sh_launches = _kernels.LAUNCHES["fused_update"]
    ref = sh["preflight_refusal"]
    check(sh["shadow_identical"], "shadow verdicts != replay != recording")
    check(sh["shadow_speedup"] >= sh["shadow_rate_target"],
          f"shadow speedup {sh['shadow_speedup']} < {sh['shadow_rate_target']}")
    check(sh["preflight_ttm_ratio"] is not None and sh["preflight_ttm_ratio"] <= 2.0,
          f"released TTM ratio {sh['preflight_ttm_ratio']}")
    check(sh["preflight_refusal_ok"] and ref["flag_writes"] == 0, f"refusal: {ref}")
    check(sh["shadow_ok"], "the shadow leg's gate")
    print(f"mitigbench on the card ({t1 - t0:.1f} s): " + "; ".join(
        f"{k} ttd {r['ttd_s']} s ttm {r['time_to_mitigate_s']} s" for k, r in mit["scenarios"].items())
        + f"; rollback drill rolled back {mit['rollback_drill']['rolled_back']} (flag "
        f"{mit['rollback_drill']['flag_state_end']}); clean run {mit['no_oscillation']['flag_writes']} flag "
        f"writes over {mit['no_oscillation']['quiet_batches']} batches ({mit_launches} fused_update launches)")
    print(f"shadow leg on the card ({time.perf_counter() - t1:.1f} s): identical {sh['shadow_identical']}, "
          f"speedup {sh['shadow_speedup']}x (target {sh['shadow_rate_target']}), TTM ungated "
          f"{sh['preflight_baseline_ttm_s']} s vs released {sh['preflight_ttm_s']} s (ratio "
          f"{sh['preflight_ttm_ratio']}), act→verdict {sh['preflight_verdict_s']} s; refusal: "
          f"{ref['refused']} refused ({ref['refused_reason']}), {ref['flag_writes']} flag writes; collector keep "
          f"ratio {sh['collector_keep_ratio']} ({sh_launches} fused_update launches) ({gpu_line()})")
    results["fused_update"].setdefault("launches_quality", {}).update(
        mitigbench=mit_launches, shadow=sh_launches)
    return dict(mitigation=mit, shadow=sh, wall_s=time.perf_counter() - t0)


# -- the hot-standby and fleet tier ------------------------------------------------


def ms_pcts(holds_s) -> dict:
    """p50 / p99 / max of a list of seconds, in ms."""
    a = np.asarray(holds_s, dtype=np.float64) * 1e3
    if not a.size:
        return dict(n=0, p50=None, p99=None, max=None)
    return dict(n=int(a.size), p50=float(np.percentile(a, 50)), p99=float(np.percentile(a, 99)),
                max=float(a.max()))


def delta_frame_bytes(arrays, meta) -> int:
    """Bytes of one DELTA envelope carrying a full state (the HLL banks
    ship whole, the CMS as a same-shape aggregate delta, the rest
    replace-latest), length prefix included."""
    from opentelemetry_demo_tpu_torch.runtime import replication

    return len(replication.encode_frame(replication.DELTA, 1, seq=3, base_seq=2, arrays=arrays,
                                        meta=dict(meta, hll_monotone=True)))


def fleet_failover(device, results):
    """``measure_failover`` on the card at its own config (S=8, p=8, CMS
    512, B=256) and at the daemon's ``DetectorConfig()`` with B=2048 and
    65536: the mirror converges exactly, the standby promotes at epoch 1
    and carries the fed offsets. The primary's dispatch-lock hold per
    snapshot (each ship and each HELLO check) is kept."""
    from opentelemetry_demo_tpu_torch.models import DetectorConfig
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime.replbench import measure_failover

    legs = {}
    mirrors = {}
    for name, kw in (("default", {}), ("b2048", dict(config=DetectorConfig(), batch=2048)),
                     ("b65536", dict(config=DetectorConfig(), batch=65536))):
        holds: list = []
        mirror: dict = {}
        _kernels.reset_launches()
        out = measure_failover(device=device, lock_holds=holds, mirror=mirror, **kw)
        launches = _kernels.LAUNCHES["fused_update"]
        check(out["converged_exact"], f"failover {name}: the mirror did not converge exactly: {out}")
        check(out["promoted_epoch"] == 1, f"failover {name}: promoted at epoch {out['promoted_epoch']}")
        check(out["replicated_offsets"] == {"0": out["spans_fed"]},
              f"failover {name}: replicated offsets {out['replicated_offsets']} vs {out['spans_fed']} fed")
        check(launches > 0, f"failover {name}: the sketch kernel never launched")
        out.update(lock_hold_ms=ms_pcts(holds), delta_frame_bytes=delta_frame_bytes(mirror["arrays"], mirror["meta"]),
                   launches=launches)
        legs[name] = out
        mirrors[name] = mirror
        print(f"failover {name} (B={kw.get('batch', 256)}): ttd {out['failover_ttd_s']} s, replication lag p99 "
              f"{out['replication_lag_p99_ms']} ms, {out['deltas_shipped']} deltas + {out['snapshots_shipped']} "
              f"snapshots, {out['delta_frame_bytes']} bytes a delta frame, dispatch-lock hold per snapshot "
              f"p50 {out['lock_hold_ms']['p50']:.4f} p99 {out['lock_hold_ms']['p99']:.4f} max "
              f"{out['lock_hold_ms']['max']:.4f} ms over {out['lock_hold_ms']['n']}; {out['spans_fed']} spans fed, "
              f"{launches} fused_update launches ({gpu_line()})")
    results["fused_update"].setdefault("launches_fleet", {}).update(
        {f"failover_{k}": v["launches"] for k, v in legs.items()})
    return legs, mirrors


def fleet_promotion(device, mirror, n=4, slow=5):
    """The B=2048 leg's promoted mirror hydrated onto the card into a
    fresh detector (``state_from_numpy`` and the replicated clock), and
    the primary's own detector beside it (the uninterrupted twin): four
    more batches with a ×10 latency fault on one service. The flags and
    the integer state must be equal bit for bit."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector
    from opentelemetry_demo_tpu_torch.models.detector import DetectorState, state_from_numpy, state_to_numpy
    from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanTensorizer

    twin = mirror["detector"]
    promoted = AnomalyDetector(twin.config, device=device)
    promoted.state = state_from_numpy(DetectorState(**mirror["arrays"]), device)
    promoted.clock._t_prev = mirror["meta"]["clock_t_prev"]
    check(promoted.clock._t_prev == twin.clock._t_prev, "the replicated clock is not the primary's")
    same_bits(state_to_numpy(promoted.state), state_to_numpy(twin.state), "promoted state before the fault")
    rng = np.random.default_rng(51)
    tz = SpanTensorizer(twin.config.num_services, 2048)
    flags = {"twin": [], "promoted": []}
    t = twin.clock._t_prev
    for k in range(n):
        t += 0.01
        svc = rng.integers(0, 20, 2048).astype(np.int32)
        lat = rng.gamma(4.0, 250.0, 2048).astype(np.float32)
        lat[svc == slow] *= 10.0
        batch = tz.pack_arrays(svc, lat, rng.integers(0, 2**63, 2048, dtype=np.uint64),
                               (rng.random(2048) < 0.02).astype(np.float32), rng.zipf(1.5, 2048).astype(np.uint64))
        for name, det in (("twin", twin), ("promoted", promoted)):
            flags[name].append(det.observe(batch, t).flags.cpu().numpy().copy())
    torch.cuda.synchronize()
    a, b = state_to_numpy(promoted.state), state_to_numpy(twin.state)
    for name in ("hll_bank", "cms_bank", "step_idx"):
        check(getattr(a, name).tobytes() == getattr(b, name).tobytes(), f"promoted {name} != the twin's")
    check(all(np.array_equal(x, y) for x, y in zip(flags["promoted"], flags["twin"])),
          "the promoted detector's flags differ from the twin's")
    floats_same = all(getattr(a, f).tobytes() == getattr(b, f).tobytes() for f in DetectorState._fields)
    flagged = [np.flatnonzero(f).tolist() for f in flags["twin"]]
    first = next((k + 1 for k, f in enumerate(flags["twin"]) if f[slow]), None)
    print(f"promotion: the B=2048 mirror hydrated onto the card, {n} batches with service {slow} x10: flags and "
          f"integer state == the uninterrupted twin's, every field bit-identical {floats_same}; flagged per "
          f"batch {flagged} (service {slow} from batch {first}) ({gpu_line()})")
    return dict(first_flag_batch=first, all_fields_identical=floats_same)


def fleet_link_cost(device, reps=6, width=2048, n_warm=40, n_fault=4):
    """The native B=2048 leg's bodies (``phase_native_e2e``'s path:
    ``decode_otlp_many`` → ``submit_columnar`` → spine (2) → async
    harvester), ``reps`` passes over them, with a replication primary
    shipping to a live standby in this process, against a twin without
    the link; in turns (off, 1.0 s, 0.05 s, 0.05 s, 1.0 s, off), each
    setting's second run kept. At 1.0 s (the reference's
    ``ANOMALY_REPLICATION_INTERVAL_S``) and 0.05 s (the drill's)."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
    from opentelemetry_demo_tpu_torch.runtime import native
    from opentelemetry_demo_tpu_torch.runtime.otlp import MONITORED_ATTR_KEYS
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline
    from opentelemetry_demo_tpu_torch.runtime.replbench import pipeline_snapshot_fn
    from opentelemetry_demo_tpu_torch.runtime.replication import EpochFence, ReplicationPrimary, ReplicationStandby

    clean, faulty, _spans = e2e_bodies(width, n_warm, n_fault, 1)
    n = n_warm + n_fault
    scratch = native.alloc_scratch(*native.scratch_dims(max(len(b) for b in clean + faulty), 1))
    threads = decode_threads()
    cfg = DetectorConfig()

    def run(interval):
        pipe = DetectorPipeline(AnomalyDetector(cfg, device=device), batch_size=width, spine_ring=2,
                                harvest_async=True)
        holds: list = []
        primary = standby = None
        if interval is not None:
            primary = ReplicationPrimary(pipeline_snapshot_fn(pipe, {0: 0}, holds), EpochFence(0),
                                         interval_s=interval)
            primary.start()
            standby = ReplicationStandby(f"127.0.0.1:{primary.port}", EpochFence(0),
                                         config_fingerprint=list(cfg._replace(sketch_impl=None)))
            standby.start()
            check(standby.wait_for_state(30.0), "the link's standby never bootstrapped")
            holds.clear()
        try:
            t0 = time.perf_counter()
            for r in range(reps):
                for k in range(n):
                    cols, _rows = native.decode_otlp_many(batch_bodies(clean, faulty, k, n_warm, 1),
                                                          MONITORED_ATTR_KEYS, scratch=scratch, threads=threads)
                    pipe.submit_columnar(cols, copy=True)
                    pipe.pump((r * n + k) * DT_S)
            pipe.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out = dict(spans_per_s=reps * n * width / wall, wall_s=wall, lag_p99_ms=pipe.stats.lag_p99_ms())
            if primary is not None:
                st = primary.stats()
                out.update(deltas=st["deltas_shipped"], snapshots=st["snapshots_shipped"],
                           lock_hold_ms=ms_pcts(holds), standby_applied=standby.deltas_applied)
        finally:
            if standby is not None:
                standby.stop()
            if primary is not None:
                primary.stop()
            pipe.close()
        return out

    order = (None, 1.0, 0.05, 0.05, 1.0, None)
    kept: dict = {}
    for interval in order:
        kept.setdefault(str(interval), []).append(run(interval))
    rec = {k: dict(first=v[0], second=v[1]) for k, v in kept.items()}
    off = rec["None"]["second"]["spans_per_s"]
    check(rec["0.05"]["second"]["deltas"] > 0, "the link shipped no delta at 0.05 s")
    print(f"link cost, native B={width} (spine + async), {reps} x {n} batches, in turns off/1.0/0.05/0.05/1.0/off: "
          + "; ".join(f"{k}: {v['first']['spans_per_s']:.0f} then {v['second']['spans_per_s']:.0f} spans/s"
                      + (f" ({v['second']['deltas']} deltas, lock hold p50 {v['second']['lock_hold_ms']['p50']} "
                         f"p99 {v['second']['lock_hold_ms']['p99']} ms)" if k != "None" else "")
                      for k, v in rec.items())
          + f"; second runs against off: " + ", ".join(
              f"{k} {rec[k]['second']['spans_per_s'] / off - 1:+.1%}" for k in ("1.0", "0.05"))
          + f" ({gpu_line()})")
    return rec


def docs_close(got, want, path="docs") -> None:
    """Integers, strings and flags exact; floats within RTOL / ATOL."""
    if isinstance(want, dict):
        check(sorted(got) == sorted(want), f"{path}: keys differ")
        for k in want:
            docs_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{path}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            docs_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        check(isinstance(got, float) and abs(got - want) <= ATOL + RTOL * abs(want), f"{path}: {got} vs {want}")
    else:
        check(got == want, f"{path}: {got} vs {want}")


def fleet_reshard(device, results):
    """``measure_reshard`` on the card at its own config and at
    ``DetectorConfig()``, and the same drills on the CPU: ``fleet_ok``,
    the partial answer labelled 200, and the victim's post-reshard
    documents on the card equal the CPU's."""
    from opentelemetry_demo_tpu_torch.models import DetectorConfig
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime.replbench import measure_reshard

    out = {}
    for name, kw in (("default", {}), ("daemon_config", dict(config=DetectorConfig()))):
        _kernels.reset_launches()
        card = measure_reshard(device=device, **kw)
        launches = _kernels.LAUNCHES["fused_update"]
        cpu = measure_reshard(device="cpu", **kw)
        for where, r in (("card", card), ("cpu", cpu)):
            check(r["fleet_ok"], f"reshard {name} on the {where}: {json.dumps(r, default=str)[:1500]}")
            check(r["partial_answer_ok"] and r["partial_shards_answered"] == 1,
                  f"reshard {name} on the {where}: the partial answer was not a labelled 200")
        check(card["victim_services"] == cpu["victim_services"], "the victim's keys differ")
        docs_close(json.loads(json.dumps(card["victim_docs"])), json.loads(json.dumps(cpu["victim_docs"])),
                   f"reshard {name} documents, card vs CPU")
        check(launches > 0, f"reshard {name}: the sketch kernel never launched")
        out[name] = dict(card=card, cpu=cpu, launches=launches)
        print(f"reshard {name}: fleet_ok on the card and the CPU; victim {card['victim']} "
              f"({', '.join(card['victim_services'])}) answered by the survivors, documents card == CPU; "
              f"ttd {card['shard_reshard_ttd_s']} s (CPU {cpu['shard_reshard_ttd_s']} s); partial answer 200 with "
              f"{card['partial_shards_answered']}/2 shards; tenant shed {card['tenant_shed_rows']}; "
              f"{launches} fused_update launches ({gpu_line()})")
    results["fused_update"].setdefault("launches_fleet", {}).update(
        {f"reshard_{k}": v["launches"] for k, v in out.items()})
    return out


def fleet_soaks(device, results):
    """The churn soak and the million-key soak at their defaults through
    the native front door into pipelines on the card (512 and 4096
    services; the second launches the sketch kernel past a warp's tile of
    services)."""
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime.frontdoorbench import measure_churn_soak, measure_million_key_soak

    _kernels.reset_launches()
    churn = measure_churn_soak(device=device)
    churn_launches = _kernels.LAUNCHES["fused_update"]
    check(churn["churn_ok"], f"churn soak: {json.dumps(churn, default=str)[:1500]}")
    print(f"churn soak on the card: {churn['distinct_streamed']} keys through {churn['capacity']} slots, "
          f"{churn['evictions']} evictions in {churn['sweeps']} sweeps (generation {churn['generation']}), live ids "
          f"stable, evicted keys answer from history, RSS slope {churn['rss_slope_mb']} MB, {churn['elapsed_s']:.2f} s, "
          f"{churn_launches} fused_update launches ({gpu_line()})")
    _kernels.reset_launches()
    soak = measure_million_key_soak(device=device)
    soak_launches = _kernels.LAUNCHES["fused_update"]
    check(soak["intern_exact"] and soak["readback_ok"] and soak["drift_refused"] and soak["soak_ok"],
          f"million-key soak: {json.dumps(soak, default=str)[:1500]}")
    check(soak_launches > 0, "the million-key soak never launched the sketch kernel")
    print(f"million-key soak on the card: {soak['distinct_keys']} keys, {soak['distinct_interned']} interned of "
          f"{soak['intern_capacity']}, {soak['overflow_keys']} refused into the overflow bucket, read-back exact, drift "
          f"refused; {soak['keys_per_sec']:.0f} keys/s in {soak['elapsed_s']:.2f} s; RSS "
          f"{soak['rss_per_million_keys_mb']} MB per million keys (gate {soak['soak_rss_ok']}); {soak['reports']} "
          f"reports, {soak_launches} fused_update launches at S={soak['sketch_num_services']} ({gpu_line()})")
    results["fused_update"].setdefault("launches_fleet", {}).update(churn_soak=churn_launches,
                                                                     million_key_soak=soak_launches)
    return dict(churn=churn, million=soak)


def phase_fleet(device, results):
    """The hot-standby and fleet tier on the card: failover at three
    configurations, promotion of the mirror onto the card against the
    uninterrupted twin, the link's cost to the native B=2048 leg, the
    reshard drill card against CPU, and the cardinality soaks."""
    t0 = time.perf_counter()
    failover, mirrors = fleet_failover(device, results)
    promotion = fleet_promotion(device, mirrors["b2048"])
    del mirrors
    link = fleet_link_cost(device)
    reshard = fleet_reshard(device, results)
    soaks = fleet_soaks(device, results)
    out = dict(failover=failover, promotion=promotion, link_cost=link, reshard=reshard, soaks=soaks,
               wall_s=time.perf_counter() - t0)
    print(f"fleet phase: {out['wall_s']:.1f} s")
    return out


# -- the daemon ---------------------------------------------------------------------

DAEMON_DIR = ROOT / "build" / "chip_smoke_daemon"
DAEMON_ENV = ("KAFKA_ADDR", "FLAGD_FILE", "OFREP_URL")


@contextlib.contextmanager
def daemon_env(name: str, **knobs):
    """The environment one daemon boots from: every ``ANOMALY_*`` knob
    unset, then ephemeral ports, the front door on (two decode workers),
    B = 2048, a checkpoint, a history directory and a flagd file of its
    own under ``DAEMON_DIR/name``, then ``knobs``. Restored on exit."""
    from opentelemetry_demo_tpu_torch.utils.flags import atomic_write_doc

    where = DAEMON_DIR / name
    where.mkdir(parents=True, exist_ok=True)
    flags = where / "flags.json"
    atomic_write_doc(str(flags), flag_doc())
    saved = dict(os.environ)
    for k in list(os.environ):
        if k.startswith("ANOMALY_") or k in DAEMON_ENV:
            del os.environ[k]
    env = dict(
        ANOMALY_OTLP_PORT=0, ANOMALY_OTLP_GRPC_PORT=-1, ANOMALY_METRICS_PORT=0, ANOMALY_QUERY_PORT=0,
        ANOMALY_FRONTDOOR_ENABLE=1, ANOMALY_FRONTDOOR_PORT=0, ANOMALY_INGEST_WORKERS=2, ANOMALY_BATCH=2048,
        ANOMALY_CHECKPOINT=where / "ckpt", ANOMALY_HISTORY_DIR=where / "history", FLAGD_FILE=flags,
    )
    env.update(knobs)
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield where
    finally:
        os.environ.clear()
        os.environ.update(saved)


def boot_daemon(device, config=None):
    """``DetectorDaemon`` booted and started, its width-ladder warm-up
    joined (boot time = constructor to ``start()`` returned, warm-up
    included); its reports tapped as ``(t, report, flagged names)``."""
    from opentelemetry_demo_tpu_torch.runtime.daemon import DetectorDaemon

    t0 = time.perf_counter()
    d = DetectorDaemon(config, device=device)
    check(d.wait_warm(300.0), "the width-ladder warm-up did not finish")
    d.start()
    boot_s = time.perf_counter() - t0
    check(d.warmup_error is None, f"the width-ladder warm-up failed: {d.warmup_error!r}")
    reports: list = []
    inner = d.pipeline.on_report

    def tap(t, rep, names):
        reports.append((t, rep, list(names)))
        inner(t, rep, names)

    d.pipeline.on_report = tap
    d.reports = reports
    return d, boot_s


def exposition(d) -> str:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", d.exporter.port, timeout=30.0)
    try:
        conn.request("GET", "/metrics")
        return conn.getresponse().read().decode()
    finally:
        conn.close()


def metric_value(text: str, series: str) -> float | None:
    """The value of one exposition line (name plus labels, exactly)."""
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    return None


def no_restarts(d, what: str) -> int:
    """Supervision stayed idle: no component restarted (``/metrics`` and
    the supervisor agree). Returns the count (0)."""
    from opentelemetry_demo_tpu_torch.telemetry import metrics as tele_metrics

    text = exposition(d)
    lines = [ln for ln in text.splitlines() if ln.startswith(tele_metrics.ANOMALY_COMPONENT_RESTARTS + "{")]
    total = sum(float(ln.rsplit(" ", 1)[1]) for ln in lines)
    total += sum(d._supervisor.restarts(c) for c in d._supervisor.states())
    check(total == 0, f"{what}: components restarted: {lines} {d._supervisor.states()}")
    return int(total)


def feed_daemon(d, clean, faulty, ks, n_warm, per, what):
    """POST each batch's bodies through ``d``'s native front door (one
    client), then ``d.step(t)`` on the e2e legs' virtual clock; drained
    at the end. Returns the wall seconds."""
    client = DoorClient(d.frontdoor.port)
    t0 = time.perf_counter()
    try:
        for k in ks:
            for body in batch_bodies(clean, faulty, k, n_warm, per):
                status, _ = client.post("/v1/traces", body)
                check(status == 200, f"{what}: batch {k} answered {status}")
            d.step(k * DT_S)
        d.pipeline.drain()
        torch.cuda.synchronize()
    finally:
        client.close()
    return time.perf_counter() - t0


def twin_pipeline(device, cfg, width):
    """The in-process ``submit_columnar`` twin (spine off, synchronous
    harvest) and its reports."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    reports: list = []
    pipe = DetectorPipeline(AnomalyDetector(cfg, device=device), batch_size=width,
                            on_report=lambda t, rep, names: reports.append((t, rep, list(names))))
    pipe.reports = reports
    return pipe


def feed_twin(pipe, clean, faulty, ks, n_warm, per):
    from opentelemetry_demo_tpu_torch.runtime import native
    from opentelemetry_demo_tpu_torch.runtime.otlp import MONITORED_ATTR_KEYS

    for k in ks:
        cols, _rows = native.decode_otlp_many(batch_bodies(clean, faulty, k, n_warm, per), MONITORED_ATTR_KEYS)
        pipe.submit_columnar(cols)
        pipe.pump(k * DT_S)
    pipe.drain()


def flags_by_t(reports) -> dict:
    return {t: names for t, _rep, names in reports}


def same_flags(got, want, ks, what) -> None:
    """The flags of every batch in ``ks`` that both runs read agree (at
    least half of them read by both)."""
    g, w = flags_by_t(got), flags_by_t(want)
    common = [k * DT_S for k in ks if k * DT_S in g and k * DT_S in w]
    check(len(common) >= len(ks) // 2, f"{what}: only {len(common)} of {len(ks)} batches read by both runs")
    for t in common:
        check(g[t] == w[t], f"{what}: flags at t={t}: {g[t]} vs {w[t]}")


def onset_flags(reports, n_warm, what) -> None:
    """``service-07`` flagged on the first faulty batch and never before."""
    target = f"service-{SLOW:02d}"
    onset = n_warm * DT_S
    before = [(t, names) for t, _r, names in reports if t < onset and names]
    check(not before, f"{what}: flags before onset: {before[:3]}")
    at = [names for t, _r, names in reports if t == onset]
    check(at == [[target]], f"{what}: the first faulty batch flags {at}, not [{target}]")


def states_close(got, want, what) -> None:
    """Integer fields exact, floats within RTOL / ATOL."""
    for name, x, y in zip(got._fields, got, want):
        check(x.dtype == y.dtype and x.shape == y.shape, f"{what}: {name} dtype/shape")
        if x.dtype.kind in "iu":
            check(x.tobytes() == y.tobytes(), f"{what}: {name} differs")
        else:
            check(np.allclose(x, y, rtol=RTOL, atol=ATOL), f"{what}: {name} beyond tolerance, max err "
                  f"{float(np.abs(x.astype(np.float64) - y).max())}")


def daemon_doors(device, results, n_warm=40, n_fault=4):
    """``DetectorDaemon(device=cuda)`` at its defaults with the front door
    on: the native B = 2048 corpus by one client through the front door,
    ``step(t)`` after each batch's body was answered; against a CPU twin
    daemon fed the same way and the in-process ``submit_columnar``
    pipeline twin on the card. Returns the record and (daemon, twin)
    for the resume leg."""
    from opentelemetry_demo_tpu_torch.models import DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.telemetry import metrics as tele_metrics

    width, per = 2048, 1
    clean, faulty, _spans = e2e_bodies(width, n_warm, n_fault, per)
    n = n_warm + n_fault
    ks = range(n)
    twin = twin_pipeline(device, DetectorConfig(), width)
    feed_twin(twin, clean, faulty, ks, n_warm, per)
    onset_flags(twin.reports, n_warm, "doors twin")
    with daemon_env("doors"):
        d, boot_s = boot_daemon(device)
    check(d.device.type == "cuda" and d.detector.state.hll_bank.is_cuda, "the daemon is not on the card")
    _kernels.reset_launches()
    wall = feed_daemon(d, clean, faulty, ks, n_warm, per, "daemon doors")
    launches = _kernels.LAUNCHES["fused_update"]
    check(launches == n == d.pipeline.stats.batches, f"daemon doors: {launches} launches, "
          f"{d.pipeline.stats.batches} batches, {n} fed")
    check(d.pipeline.stats.spans == n * width, f"daemon doors: {d.pipeline.stats.spans} spans dispatched")
    same_bits(state_to_numpy(d.detector.state), state_to_numpy(twin.detector.state), "daemon doors vs the twin")
    onset_flags(d.reports, n_warm, "daemon doors")
    same_flags(d.reports, twin.reports, ks, "daemon doors vs the twin")
    text = exposition(d)
    spans_metric = metric_value(text, tele_metrics.ANOMALY_SPANS_TOTAL)
    check(spans_metric == n * width, f"daemon doors: {tele_metrics.ANOMALY_SPANS_TOTAL} {spans_metric}, "
          f"{n * width} posted")
    target = f"service-{SLOW:02d}"
    check(metric_value(text, f'{tele_metrics.ANOMALY_FLAG_TOTAL}{{service="{target}"}}') is not None,
          f"daemon doors: no flag line for {target} on /metrics")
    status, doc = http_json(d.query_service.port, f"/query/zscore?service={target}")
    check(status == 200 and doc.get("data"), f"daemon doors: /query/zscore answered {status}")
    status, health = http_json(d.exporter.port, "/healthz")
    check(status == 200 and health.get("status") == "ok" and health.get("role") == "primary",
          f"daemon doors: /healthz {status} {health.get('status')} {health.get('role')}")
    restarts = no_restarts(d, "daemon doors")

    # The CPU twin daemon, fed the same way.
    with daemon_env("doors_cpu"):
        c, cpu_boot_s = boot_daemon("cpu")
    try:
        feed_daemon(c, clean, faulty, ks, n_warm, per, "CPU twin daemon")
        states_close(state_to_numpy(d.detector.state), state_to_numpy(c.detector.state), "daemon doors vs CPU")
        onset_flags(c.reports, n_warm, "CPU twin daemon")
        same_flags(d.reports, c.reports, ks, "daemon doors vs CPU")
    finally:
        c.shutdown()
    rec = dict(boot_s=boot_s, cpu_boot_s=cpu_boot_s, wall_s=wall, spans_per_s=n * width / wall,
               launches=launches, lag_p99_ms=d.pipeline.stats.lag_p99_ms(), restarts=restarts,
               reports_read=len(d.reports), reports_skipped=d.pipeline.stats.reports_skipped,
               ship_lock_hold_ms=None)
    print(f"daemon doors: DetectorDaemon on the card, boot {boot_s:.3f} s (warm-up included; CPU twin "
          f"{cpu_boot_s:.3f} s); {n} batches of {width} spans by one client through the front door: "
          f"{rec['spans_per_s']:.0f} spans/s answered and stepped, lag p99 {rec['lag_p99_ms']:.3f} ms; state == "
          f"the in-process twin bit for bit and the CPU twin daemon within tolerance, {target} flagged on the "
          f"first faulty batch and never before in all three, /metrics spans {spans_metric:.0f}, /query and "
          f"/healthz answer, restarts {restarts}; fused_update launches {launches} ({gpu_line()})")
    return rec, d, twin


def daemon_resume(device, d, twin, n_warm=40, n_fault=4, more=4):
    """``shutdown()`` writes the checkpoint on the steps' stream; a second
    daemon boots from it on the card with the first's final state,
    names, offsets and epoch; then ``more`` faulty batches go into both
    it and the uninterrupted twin: flags and state equal."""
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels

    width, per = 2048, 1
    clean, faulty, _spans = e2e_bodies(width, n_warm, n_fault, per)
    n = n_warm + n_fault
    final = state_to_numpy(d.detector.state)
    names = list(d.pipeline.tensorizer.service_names)
    offsets, epoch = dict(d._offsets), d._fence.epoch
    t0 = time.perf_counter()
    d.shutdown()
    save_s = time.perf_counter() - t0
    with daemon_env("doors"):
        r, boot_s = boot_daemon(device)
    try:
        same_bits(state_to_numpy(r.detector.state), final, "resumed daemon vs the first's final state")
        check(list(r.pipeline.tensorizer.service_names) == names, "resumed daemon: service names differ")
        check(dict(r._offsets) == offsets and r._fence.epoch == epoch, "resumed daemon: offsets or epoch differ")
        check(r.detector.clock._t_prev == twin.detector.clock._t_prev, "resumed daemon: window clock differs")
        ks = range(n, n + more)
        _kernels.reset_launches()
        feed_daemon(r, clean, faulty, ks, n_warm, per, "resumed daemon")
        launches = _kernels.LAUNCHES["fused_update"]
        feed_twin(twin, clean, faulty, ks, n_warm, per)
        same_bits(state_to_numpy(r.detector.state), state_to_numpy(twin.detector.state),
                  "resumed daemon vs the uninterrupted twin")
        same_flags(r.reports, twin.reports, ks, "resumed daemon vs the uninterrupted twin")
        check(launches == more, f"resumed daemon: {launches} launches for {more} batches")
        restarts = no_restarts(r, "resumed daemon")
    finally:
        r.shutdown()
        twin.close()
    print(f"daemon resume: shutdown save {save_s:.3f} s, boot from the checkpoint {boot_s:.3f} s; state, "
          f"{len(names)} names, offsets {offsets} and epoch {epoch} == the first daemon's; {more} faulty "
          f"batches: state and flags == the uninterrupted twin; fused_update launches {launches}, restarts "
          f"{restarts} ({gpu_line()})")
    return dict(save_s=save_s, boot_s=boot_s, launches=launches, restarts=restarts)


def daemon_orders(device, clean_s=40.0, flood_s=4.0):
    """``KAFKA_ADDR`` at the in-process broker (three partitions) with
    the orders leg's corpus and its ×4 flood, pumped by the daemon's
    ``_pump_orders`` every virtual 0.1 s: the flood flags
    ``checkout-orders`` on its first batch and never before, every order
    is counted, and the committed offsets are the produced ones."""
    from opentelemetry_demo_tpu_torch.ops import _kernels

    pumps = live_pumps(81, clean_s, flood_s)
    onset = int(round(clean_s / ORDER_DT))
    topic = OrderTopic()
    try:
        with daemon_env("orders", KAFKA_ADDR=topic.addr):
            d, boot_s = boot_daemon(device)
        try:
            _kernels.reset_launches()
            t0 = time.perf_counter()
            for k, payloads in enumerate(pumps):
                topic.publish(payloads)
                d.step(k * ORDER_DT)
                if k == onset:
                    d.pipeline.drain()  # the onset's report is read, never skipped
            d.pipeline.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _kernels.LAUNCHES["fused_update"]
            produced = {p: len(v) for p, v in enumerate(topic.by_partition)}
            check(d.pipeline.stats.spans == topic.n, f"daemon orders: {d.pipeline.stats.spans} of {topic.n} counted")
            check(dict(d._offsets) == produced, f"daemon orders: offsets {d._offsets} vs produced {produced}")
            check(launches == d.pipeline.stats.batches, f"daemon orders: {launches} launches for "
                  f"{d.pipeline.stats.batches} batches")
            t_onset = onset * ORDER_DT
            before = [(t, names) for t, _r, names in d.reports if t < t_onset and names]
            check(not before, f"daemon orders: flags before the flood: {before[:3]}")
            at = [names for t, _r, names in d.reports if t == t_onset]
            check(at == [[ORDERS]], f"daemon orders: the flood's first batch flags {at}, not [{ORDERS}]")
            restarts = no_restarts(d, "daemon orders")
            batches, lag = d.pipeline.stats.batches, d.pipeline.stats.lag_p99_ms()
        finally:
            d.shutdown()  # the shutdown checkpoint commits the offsets, epoch-tagged
        committed = {p: topic.broker.committed("anomaly-detector", "orders", p) for p in range(3)}
        check(committed == produced, f"daemon orders: committed {committed} vs produced {produced}")
    finally:
        topic.stop()
    rec = dict(boot_s=boot_s, orders=topic.n, pumps=len(pumps), batches=batches, wall_s=wall,
               orders_per_s=topic.n / wall, lag_p99_ms=lag, launches=launches, restarts=restarts,
               committed=committed)
    print(f"daemon orders: {topic.n} orders in {len(pumps)} pumps through the daemon's _pump_orders, "
          f"{wall:.3f} s = {rec['orders_per_s']:.0f} orders/s, lag p99 {lag:.3f} ms, {batches} batches; "
          f"{ORDERS} flagged on the flood's first batch and never before; committed offsets {committed} == "
          f"produced; fused_update launches {launches}, restarts {restarts} ({gpu_line()})")
    return rec


def daemon_roles(device, n_warm=40, n_fault=4, interval_s=0.1, failover_timeout_s=1.0):
    """A primary and a standby daemon on the card in this process: the
    primary takes the clean batches through its front door; once the
    standby's mirror equals its state it is stopped, the standby's
    watchdog promotes it at epoch 1 with the primary's final state on
    the card bit for bit, and the faulty batches then flag as in the
    uninterrupted twin."""
    from opentelemetry_demo_tpu_torch.models import DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime.replication import ROLE_PRIMARY

    width, per = 2048, 1
    clean, faulty, _spans = e2e_bodies(width, n_warm, n_fault, per)
    n = n_warm + n_fault
    twin = twin_pipeline(device, DetectorConfig(), width)
    feed_twin(twin, clean, faulty, range(n), n_warm, per)
    with daemon_env("primary", ANOMALY_REPLICATION_PORT=0, ANOMALY_REPLICATION_INTERVAL_S=interval_s):
        p, _boot = boot_daemon(device)
    p_up = True
    with daemon_env("standby", ANOMALY_ROLE="standby",
                    ANOMALY_REPLICATION_TARGET=f"127.0.0.1:{p.repl_primary.port}",
                    ANOMALY_REPLICATION_INTERVAL_S=interval_s, ANOMALY_FAILOVER_TIMEOUT_S=failover_timeout_s):
        s, _boot = boot_daemon(device)
    try:
        check(s.detector.state.hll_bank.is_cuda, "the standby's detector is not on the card")
        _kernels.reset_launches()
        feed_daemon(p, clean, faulty, range(n_warm), n_warm, per, "primary daemon")
        final = state_to_numpy(p.detector.state)
        deadline = time.monotonic() + 60.0
        while True:
            arrays, _meta = s.repl_standby.snapshot()
            if arrays and all(arrays[f].tobytes() == getattr(final, f).tobytes() for f in final._fields):
                break
            check(time.monotonic() < deadline, "the standby's mirror never reached the primary's state")
            s.step()
            time.sleep(interval_s / 2)
        stats = p.repl_primary.stats()
        holds = ms_pcts(list(p.ship_lock_holds))
        t_kill = time.monotonic()
        p.shutdown()
        p_up = False
        # The standby is stepped on this thread, so the primary's
        # shutdown (its drain and final checkpoint) passes unwatched.
        shutdown_s = time.monotonic() - t_kill
        while s.role != ROLE_PRIMARY:
            check(time.monotonic() - t_kill < 30.0, "the standby never promoted")
            s.step()
            time.sleep(0.01)
        ttd = time.monotonic() - t_kill
        check(s._fence.epoch == 1, f"promoted at epoch {s._fence.epoch}")
        same_bits(state_to_numpy(s.detector.state), final, "promoted standby vs the primary's final state")
        ks = range(n_warm, n)
        feed_daemon(s, clean, faulty, ks, n_warm, per, "promoted standby")
        launches = _kernels.LAUNCHES["fused_update"]
        same_bits(state_to_numpy(s.detector.state), state_to_numpy(twin.detector.state),
                  "promoted standby vs the uninterrupted twin")
        same_flags(s.reports, twin.reports, ks, "promoted standby vs the twin")
        at = [names for t, _r, names in s.reports if t == n_warm * DT_S]
        check(at == [[f"service-{SLOW:02d}"]], f"promoted standby: the first faulty batch flags {at}")
        restarts = no_restarts(s, "promoted standby")
    finally:
        s.shutdown()
        if p_up:
            p.shutdown()
        twin.close()
    rec = dict(ttd_s=ttd, shutdown_s=shutdown_s, failover_timeout_s=failover_timeout_s,
               replication_lag_p99_ms=stats["ack_lag_p99_ms"],
               deltas_shipped=stats["deltas_shipped"], snapshots_shipped=stats["snapshots_shipped"],
               ship_lock_hold_ms=holds, launches=launches, restarts=restarts)
    print(f"daemon roles: primary + standby daemons on the card, interval {interval_s} s; the standby's mirror "
          f"== the primary's state, promoted at epoch 1 {ttd:.4f} s after the primary's shutdown began (the "
          f"shutdown took {shutdown_s:.4f} s of it; watchdog {failover_timeout_s} s) with the "
          f"primary's final state bit for bit; {n_fault} faulty batches: state and flags == the uninterrupted "
          f"twin; replication lag p99 {stats['ack_lag_p99_ms']} ms over {stats['deltas_shipped']} deltas + "
          f"{stats['snapshots_shipped']} snapshots; dispatch-lock hold per ship p50 {holds['p50']} p99 "
          f"{holds['p99']} ms over {holds['n']}; fused_update launches {launches}, restarts {restarts} "
          f"({gpu_line()})")
    return rec


def daemon_wide(device, n_warm=24, n_fault=3, per=8):
    """``DetectorDaemon(DetectorConfig(sketch_impl="xla"))`` at
    ``ANOMALY_BATCH=65536`` (its row budget raised to four batches, so a
    batch's bodies are admitted before its step): the B = 65536 corpus
    through the front door; state == the in-process twin bit for bit,
    the same flags, one CMS-histogram launch a batch."""
    from opentelemetry_demo_tpu_torch.models import DetectorConfig
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels

    width = 65536
    clean, faulty, _spans = e2e_bodies(width, n_warm, n_fault, per)
    n = n_warm + n_fault
    cfg = DetectorConfig(sketch_impl="xla")
    twin = twin_pipeline(device, cfg, width)
    feed_twin(twin, clean, faulty, range(n), n_warm, per)
    with daemon_env("wide", ANOMALY_BATCH=width, ANOMALY_QUEUE_MAX_ROWS=4 * width):
        d, boot_s = boot_daemon(device, cfg)
    try:
        _kernels.reset_launches()
        wall = feed_daemon(d, clean, faulty, range(n), n_warm, per, "daemon wide")
        launches = _kernels.LAUNCHES["cms_hist"]
        check(launches == n == d.pipeline.stats.batches, f"daemon wide: {launches} cms_hist launches, "
              f"{d.pipeline.stats.batches} batches, {n} fed")
        same_bits(state_to_numpy(d.detector.state), state_to_numpy(twin.detector.state), "daemon wide vs the twin")
        onset_flags(d.reports, n_warm, "daemon wide")
        same_flags(d.reports, twin.reports, range(n), "daemon wide vs the twin")
        restarts = no_restarts(d, "daemon wide")
        lag = d.pipeline.stats.lag_p99_ms()
    finally:
        d.shutdown()
        twin.close()
    rec = dict(boot_s=boot_s, wall_s=wall, spans_per_s=n * width / wall, lag_p99_ms=lag, launches=launches,
               restarts=restarts)
    print(f"daemon wide: B={width} sketch_impl=xla, boot {boot_s:.3f} s; {n} batches of {per} bodies through "
          f"the front door: {rec['spans_per_s']:.0f} spans/s answered and stepped, lag p99 {lag:.3f} ms; state "
          f"== the in-process twin bit for bit, same flags; cms_hist launches {launches}, restarts {restarts} "
          f"({gpu_line()})")
    return rec


def daemon_many_services(device, n_warm=40, n_fault=4, per=2):
    """``DetectorDaemon`` on the card at ``ANOMALY_NUM_SERVICES=8192``,
    ``ANOMALY_HLL_P=8``, ``ANOMALY_CMS_WIDTH=1024`` (the million-key
    soak's sketch geometry at twice its slots) and ``ANOMALY_BATCH=4096``:
    the native B = 2048 corpus two bodies a batch through its front door,
    a ×10 latency step from batch 40, against a CPU twin daemon fed the
    same way. Flags identical, ``service-07`` flagged on the first faulty
    batch and never before, state within tolerance, one fused-update
    launch a batch."""
    from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
    from opentelemetry_demo_tpu_torch.ops import _kernels

    clean, faulty, _spans = e2e_bodies(2048, n_warm, n_fault, 1)
    n = n_warm + n_fault
    ks = range(n)
    knobs = dict(ANOMALY_NUM_SERVICES=8192, ANOMALY_HLL_P=8, ANOMALY_CMS_WIDTH=1024, ANOMALY_BATCH=4096)
    with daemon_env("many", **knobs):
        d, boot_s = boot_daemon(device)
    try:
        check(d.detector.config.num_services == 8192 and d.detector.state.hll_bank.is_cuda,
              "the many-services daemon is not at 8192 services on the card")
        _kernels.reset_launches()
        wall = feed_daemon(d, clean, faulty, ks, n_warm, per, "daemon at 8192 services")
        launches = _kernels.LAUNCHES["fused_update"]
        check(launches == n == d.pipeline.stats.batches, f"daemon at 8192 services: {launches} launches, "
              f"{d.pipeline.stats.batches} batches, {n} fed")
        onset_flags(d.reports, n_warm, "daemon at 8192 services")
        restarts = no_restarts(d, "daemon at 8192 services")
        with daemon_env("many_cpu", **knobs):
            c, cpu_boot_s = boot_daemon("cpu")
        try:
            t0 = time.perf_counter()
            feed_daemon(c, clean, faulty, ks, n_warm, per, "CPU twin daemon at 8192 services")
            cpu_wall = time.perf_counter() - t0
            states_close(state_to_numpy(d.detector.state), state_to_numpy(c.detector.state),
                         "daemon at 8192 services vs CPU")
            onset_flags(c.reports, n_warm, "CPU twin daemon at 8192 services")
            same_flags(d.reports, c.reports, ks, "daemon at 8192 services vs CPU")
        finally:
            c.shutdown()
        lag = d.pipeline.stats.lag_p99_ms()
    finally:
        d.shutdown()
    rec = dict(boot_s=boot_s, cpu_boot_s=cpu_boot_s, wall_s=wall, cpu_wall_s=cpu_wall,
               spans_per_s=n * 4096 / wall, lag_p99_ms=lag, launches=launches, restarts=restarts)
    print(f"daemon at 8192 services: ANOMALY_NUM_SERVICES=8192 HLL p=8 CMS 4x1024 B=4096 on the card, boot "
          f"{boot_s:.3f} s (CPU twin {cpu_boot_s:.3f} s); {n} batches of {per} bodies through the front door: "
          f"{rec['spans_per_s']:.0f} spans/s answered and stepped (CPU twin {cpu_wall:.2f} s), lag p99 {lag:.3f} ms; "
          f"state == the CPU twin daemon within tolerance, flags identical, service-{SLOW:02d} flagged on the first "
          f"faulty batch and never before; fused_update launches {launches}, restarts {restarts} ({gpu_line()})")
    return rec


def daemon_process(n_warm=40, fault_s=30.0):
    """``python -m opentelemetry_demo_tpu_torch`` with no ``--device``
    (the card) at the default knobs plus ephemeral ports and the front
    door: its announce line, a ×10 fault POSTed through the front door
    flagged on ``/metrics``, and on SIGTERM exit 0 with its checkpoint
    written."""
    import signal

    from opentelemetry_demo_tpu_torch.runtime import checkpoint
    from opentelemetry_demo_tpu_torch.runtime.replbench import _free_port
    from opentelemetry_demo_tpu_torch.telemetry import metrics as tele_metrics

    clean, faulty, _spans = e2e_bodies(2048, 40, 4, 1)
    fd_port = _free_port()
    with daemon_env("process", ANOMALY_FRONTDOOR_PORT=fd_port) as where:
        env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONUNBUFFERED"] = "1"
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "opentelemetry_demo_tpu_torch"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    tail: list = []
    try:
        line = None
        while line is None:
            out = proc.stdout.readline()
            check(out or proc.poll() is None, f"the daemon process exited rc={proc.returncode}: {tail[-20:]}")
            check(time.perf_counter() - t0 < 300.0, "the daemon process never announced")
            tail.append(out)
            if "anomaly-detector:" in out:
                line = out
        announce_s = time.perf_counter() - t0
        import re
        import threading

        threading.Thread(target=lambda: [tail.append(x) for x in proc.stdout], daemon=True).start()
        metrics_port = int(re.search(r"metrics :(\d+)", line).group(1))
        check("role primary" in line, f"announce: {line.strip()}")
        client = DoorClient(fd_port)
        target = f"service-{SLOW:02d}"
        series = f'{tele_metrics.ANOMALY_FLAG_TOTAL}{{service="{target}"}}'
        import http.client

        def scrape() -> str:
            conn = http.client.HTTPConnection("127.0.0.1", metrics_port, timeout=30.0)
            try:
                conn.request("GET", "/metrics")
                return conn.getresponse().read().decode()
            finally:
                conn.close()

        for k in range(n_warm):
            status, _ = client.post("/v1/traces", clean[k % len(clean)])
            check(status == 200, f"daemon process: clean body {k} answered {status}")
            time.sleep(0.06)
        # The daemon pumps on the wall clock here, so a rate-lane flag
        # before the fault is possible; the fault must add flags.
        before = metric_value(scrape(), series) or 0.0
        t_fault = time.perf_counter()
        k = 0
        while (metric_value(scrape(), series) or 0.0) <= before:
            check(time.perf_counter() - t_fault < fault_s, f"daemon process: {target} never flagged")
            status, _ = client.post("/v1/traces", faulty[k % len(faulty)])
            check(status == 200, f"daemon process: faulty body {k} answered {status}")
            k += 1
            time.sleep(0.06)
        ttd_s = time.perf_counter() - t_fault
        client.close()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"daemon process: SIGTERM exit {rc}: {tail[-20:]}")
        check(checkpoint.exists(str(where / "ckpt")), "daemon process: no checkpoint written at SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    rec = dict(announce_s=announce_s, fault_bodies=k, ttd_s=ttd_s, flags_before_fault=before,
               announce=line.strip())
    print(f"daemon process: python -m opentelemetry_demo_tpu_torch (no --device) announced in {announce_s:.3f} s: "
          f"{line.strip()}; {target} flagged on /metrics after {k} faulty bodies ({ttd_s:.3f} s); SIGTERM exit 0 "
          f"with its checkpoint ({gpu_line()})")
    return rec


def daemon_live_fleet():
    """``replbench.measure_reshard_live`` and ``measure_adoption`` with
    their daemon subprocesses on the card (no ``--device``)."""
    from opentelemetry_demo_tpu_torch.runtime.replbench import measure_adoption, measure_reshard_live

    t0 = time.perf_counter()
    live = measure_reshard_live()
    live_s = time.perf_counter() - t0
    adopt = measure_adoption()
    check(live["live_survivor_answers"] and live["live_adoption_exact"], f"reshard live: {live}")
    check(adopt["autoscale_ok"] and adopt["adoption_bitexact"],
          f"adoption: {json.dumps(adopt, default=str)[:1500]}")
    rec = dict(reshard_live=live, adoption=adopt, reshard_live_wall_s=live_s,
               adoption_wall_s=time.perf_counter() - t0 - live_s)
    print(f"daemon live fleet: reshard live ttd {live['live_sigkill_ttd_s']} s, survivor answers, adoption exact "
          f"({rec['reshard_live_wall_s']:.1f} s); adoption drill: autoscale_ok, bit-exact, tta "
          f"{adopt['autoscale_tta_s']} s (internal {adopt['adoption_tta_internal_s']} s), "
          f"{adopt['autoscale_proposals_split']} split proposals ({rec['adoption_wall_s']:.1f} s) ({gpu_line()})")
    return rec


def phase_daemon(device, results):
    """The detector daemon on the card: the front door into an
    in-process daemon against its CPU and pipeline twins, the resume from
    its shutdown checkpoint, the front door at 8192 services against a
    CPU twin, the orders leg through the daemon's pump, a primary/standby
    pair with promotion, the wide (K2) daemon, the module entry point as
    a process, and the live fleet drills."""
    t0 = time.perf_counter()
    out = {}
    out["doors"], d, twin = daemon_doors(device, results)
    out["resume"] = daemon_resume(device, d, twin)
    out["many_services"] = daemon_many_services(device)
    out["orders"] = daemon_orders(device)
    out["roles"] = daemon_roles(device)
    out["wide"] = daemon_wide(device)
    out["process"] = daemon_process()
    out["live_fleet"] = daemon_live_fleet()
    shutil.rmtree(DAEMON_DIR, ignore_errors=True)
    results["fused_update"]["launches_daemon"] = {
        leg: out[leg]["launches"] for leg in ("doors", "resume", "many_services", "orders", "roles")}
    results["cms_hist"]["launches_daemon"] = {"wide": out["wide"]["launches"]}
    out["wall_s"] = time.perf_counter() - t0
    print(f"daemon phase: {out['wall_s']:.1f} s ({gpu_line()})")
    return out



# -- the shop: the Locust-profile load through the shop's services -----------------

SHOP_QUIET_S = 300.0


def shop_config():
    """The daemon's default geometry (32 slots, HLL p=12, CMS 4×8192,
    windows 1/10/60 s) with the rig's warm-ups and z threshold."""
    from opentelemetry_demo_tpu_torch.models import DetectorConfig
    from opentelemetry_demo_tpu_torch.services.rig import RIG_CONFIG

    return DetectorConfig(warmup_batches=RIG_CONFIG.warmup_batches,
                          z_warmup_batches=RIG_CONFIG.z_warmup_batches, z_threshold=RIG_CONFIG.z_threshold)


def shop_rig(device, seed, kafka_bootstrap=None):
    from opentelemetry_demo_tpu_torch.services.rig import make_rig

    return make_rig(seed, config=shop_config(), device=device, kafka_bootstrap=kafka_bootstrap, record=True)


def shop_accepted(rig) -> int:
    counters, _ = rig.shop.collector.self_metrics.snapshot()
    return int(counters.get(("otelcol_receiver_accepted_spans", (("receiver", "otlp"),)), 0.0))


def shop_charged(rig) -> float:
    counters, _ = rig.shop.metrics.snapshot()
    return sum(v for (n, _k), v in counters.items() if n == "app_payment_transactions_total")


def shop_conserved(rig, what) -> None:
    """Every span the collector admitted reached the pipeline, once."""
    accepted, recorded = shop_accepted(rig), sum(len(s) for _, s in rig.calls)
    check(rig.pipeline.stats.spans == accepted == recorded,
          f"{what}: pipeline {rig.pipeline.stats.spans} spans, collector admitted {accepted}, flushed {recorded}")
    check(not rig.shop._span_buffer, f"{what}: {len(rig.shop._span_buffer)} spans left in the buffer")


def shop_twin(rig, what) -> None:
    """The card rig's flushes replayed into the port's pipeline on the
    CPU at the same config: every report's flags equal, the final state
    equal (integers exact, floats within RTOL / ATOL)."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    events = []
    pipe = DetectorPipeline(AnomalyDetector(rig.detector.config, device="cpu"), flags=rig.shop.flags,
                            on_report=lambda t, rep, flagged: events.append((t, sorted(flagged))),
                            batch_size=rig.pipeline.tensorizer.batch_size)
    for t, spans in rig.calls:
        pipe.submit(spans)
        pipe.pump(t)
    pipe.drain()
    got = [(t, sorted(flagged)) for t, flagged, _ in rig.events]
    check(len(got) == len(events) == rig.pipeline.stats.batches == pipe.stats.batches,
          f"{what}: {len(got)} reports on the card, {len(events)} on the CPU")
    for (t, a), (u, b) in zip(got, events):
        check(t == u and a == b, f"{what}: flags at t={t}: card {a}, CPU {b} (t={u})")
    snapshots_close(rig.pipeline.state_snapshot()[0], pipe.state_snapshot()[0], what)


def snapshots_close(card: dict, cpu: dict, what) -> None:
    """Two ``state_snapshot`` dicts: integer fields exact, floats within
    RTOL / ATOL."""
    for name, y in cpu.items():
        x = card[name]
        check(x.dtype == y.dtype and x.shape == y.shape, f"{what}: {name} dtype/shape")
        if x.dtype.kind in "iu":
            check(x.tobytes() == y.tobytes(), f"{what}: {name} differs from the CPU's")
        else:
            check(np.allclose(x, y, rtol=RTOL, atol=ATOL), f"{what}: {name} beyond tolerance of the CPU's")


def shop_leg(name, rigs, virtual_s, wall_s, launches, prof) -> dict:
    """One leg's line: virtual seconds, spans, wall, spans/s, steps (K1
    launches), the card's busy share of the traced wall, lag p99.
    ``launches`` is the launch counts read right after the leg."""
    spans = sum(r.pipeline.stats.spans for r in rigs)
    steps = sum(r.pipeline.stats.batches for r in rigs)
    lags = [x for r in rigs for x in r.pipeline.stats.lag_ms]
    busy = device_activity(prof)
    check(busy["ops"] > 0, f"{name}: the trace saw no device activity")
    check(launches["fused_update"] == steps and launches["cms_hist"] == launches["sketch_delta"] == 0,
          f"{name}: launches {launches} for {steps} steps")
    rec = dict(virtual_s=virtual_s, spans=spans, wall_s=wall_s, spans_per_s=spans / wall_s, steps=steps,
               launches=launches["fused_update"], all_launches=launches, steps_per_virtual_s=steps / virtual_s, busy_share=busy["union_ms"] / (wall_s * 1e3),
               device_ms=busy["union_ms"], device_ops=busy["ops"],
               lag_p99_ms=float(np.percentile(lags, 99)) if lags else None)
    print(f"{name}: {virtual_s:g} virtual s, {spans} spans, wall {wall_s:.3f} s (traced), "
          f"{rec['spans_per_s']:.1f} spans/s, {steps} steps ({launches['fused_update']} fused_update launches, "
          f"{rec['steps_per_virtual_s']:.3f} a virtual s), card busy {rec['busy_share']:.4%} "
          f"({busy['union_ms']:.3f} ms, {busy['ops']} device ops), lag p99 {rec['lag_p99_ms']} ms ({gpu_line()})")
    return rec


def traced():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


SHOP_FP_LIMIT = 0.02  # flagged reports after the warm-up, the reference's limit (tests/test_e2e_detection.py)


def shop_quiet(device):
    """Seed 0 for 300 virtual seconds with no fault flag: every admitted
    span is counted, the card = the CPU, and the share of reports after
    the z warm-up that flag anything within the reference's false-alarm
    limit. (The detector's z-scores are two-sided: at 1-38 spans a batch
    a fast batch can score past the threshold; the reference flags
    ``frontend`` at 270 s on this stream too, ``tests/test_torch_shop.py``.)
    Run once untraced for the host-clock rate, then traced for the leg."""
    from opentelemetry_demo_tpu_torch.ops import _kernels

    rig = shop_rig(device, 0)
    t0 = time.perf_counter()
    rig.run(SHOP_QUIET_S)
    rig.pipeline.drain()
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0
    untraced_spans = rig.pipeline.stats.spans
    rig = shop_rig(device, 0)
    with traced() as prof:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        rig.run(SHOP_QUIET_S)
        rig.pipeline.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    warm = int(rig.detector.config.z_warmup_batches)
    flagged = [(t, f) for t, f, _ in rig.events[warm:] if f]
    fp_rate = len(flagged) / max(len(rig.events) - warm, 1)
    check(not any(f for _, f, _ in rig.events[:warm]), "shop quiet: a flag inside the warm-up")
    check(fp_rate <= SHOP_FP_LIMIT, f"shop quiet: {len(flagged)} flagged reports after the warm-up: {flagged[:5]}")
    shop_conserved(rig, "shop quiet")
    shop_twin(rig, "shop quiet")
    print(f"shop quiet: flagged after the warm-up {flagged} = {fp_rate:.5f} of {len(rig.events) - warm} "
          f"reports (limit {SHOP_FP_LIMIT}); card = CPU")
    rec = shop_leg("shop_quiet", [rig], SHOP_QUIET_S, wall, launches, prof)
    rec.update(flagged=flagged, fp_rate=fp_rate)
    rec["untraced_wall_s"] = untraced_s
    rec["untraced_spans_per_s"] = untraced_spans / untraced_s
    print(f"shop_quiet untraced: wall {untraced_s:.3f} s, {rec['untraced_spans_per_s']:.1f} spans/s")
    return rec


def shop_faults(device):
    """The eight flagd scenarios of the reference's TestFaultScenarios at
    seed 7 (150 s warm, then the fault): no flag before onset, a flagged
    set holding the case's service, reports and state = the CPU's."""
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.services.rig import FAULT_SCENARIOS, FAULT_SEED, FAULT_WARM_S

    rigs, cases = [], {}
    virtual = 0.0
    with traced() as prof:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        for case, scenario in FAULT_SCENARIOS.items():
            rig = shop_rig(device, FAULT_SEED)
            rig.run(FAULT_WARM_S)
            charged = shop_charged(rig)  # payment_unreachable: no transaction after this
            onset = rig.run_fault(scenario, warm_s=0.0)
            rigs.append(rig)
            cases[case] = dict(rig=rig, onset=onset, charged=charged)
            virtual += FAULT_WARM_S + scenario.fault_s
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    out = {}
    for case, c in cases.items():
        rig, scenario = c["rig"], FAULT_SCENARIOS[case]
        before = [(t, f) for t, f, _ in rig.events[:c["onset"]] if f]
        check(not before, f"shop {case}: flags before onset {before[:3]}")
        flagged = rig.flagged_since(c["onset"])
        check(bool(flagged & scenario.any_of), f"shop {case}: flagged {sorted(flagged)}, none of {sorted(scenario.any_of)}")
        if case == "payment_unreachable":
            check(shop_charged(rig) == c["charged"], f"shop {case}: transactions during the fault")
        shop_conserved(rig, f"shop {case}")
        shop_twin(rig, f"shop {case}")
        out[case] = dict(flagged=sorted(flagged), reports=len(rig.events), onset=c["onset"],
                         spans=rig.pipeline.stats.spans, steps=rig.pipeline.stats.batches,
                         orders=(rig.shop.accounting.orders_seen, rig.shop.fraud.orders_checked))
        print(f"shop {case}: flagged {sorted(flagged)} after onset (report {c['onset']} of {len(rig.events)}), "
              f"none before; card = CPU")
    rec = shop_leg("shop_faults", rigs, virtual, wall, launches, prof)
    rec["cases"] = out
    return rec


def shop_kafka(device, bus_case):
    """``kafkaQueueProblems`` with the shop's async tier on ``KafkaBus``
    against the port's ``KafkaBroker`` on 127.0.0.1: a consumer flagged,
    no flag before onset, the consumer counts those of the in-process
    bus's run of the same case (``bus_case``), every order committed by
    both groups, reports and state = the CPU's."""
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime.kafka_broker import KafkaBroker
    from opentelemetry_demo_tpu_torch.services.rig import FAULT_SCENARIOS, FAULT_SEED, FAULT_WARM_S

    scenario = FAULT_SCENARIOS["kafka_queue_problems"]
    broker = KafkaBroker(host="127.0.0.1", port=0)
    broker.start()
    try:
        rig = shop_rig(device, FAULT_SEED, kafka_bootstrap=f"127.0.0.1:{broker.port}")
        bus = rig.shop.bus
        try:
            # Connect the producer and both groups before the first order,
            # so an order reaches the consumers on the pump after its
            # publish, as the in-process bus delivers it.
            deadline = time.monotonic() + 15.0
            while bus._ensure_producer() is None or any(sub.consumer is None for sub in bus._subs):
                check(time.monotonic() < deadline, "shop kafka: the bus did not connect to the broker")
                bus._send_wake.set()
                time.sleep(0.05)
            with traced() as prof:
                _kernels.reset_launches()
                t0 = time.perf_counter()
                onset = rig.run_fault(scenario, warm_s=FAULT_WARM_S)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = dict(_kernels.LAUNCHES)
            orders = (rig.shop.accounting.orders_seen, rig.shop.fraud.orders_checked)
            committed = (broker.committed("accounting", "orders"), broker.committed("fraud-detection", "orders"))
        finally:
            bus.close()
    finally:
        broker.stop()
    check(orders == tuple(bus_case["orders"]), f"shop kafka: consumers saw {orders}, the in-process bus "
          f"{bus_case['orders']}")
    check(committed == orders, f"shop kafka: committed {committed}, consumed {orders}")
    before = [(t, f) for t, f, _ in rig.events[:onset] if f]
    check(not before, f"shop kafka: flags before onset {before[:3]}")
    flagged = rig.flagged_since(onset)
    check(bool(flagged & scenario.any_of), f"shop kafka: flagged {sorted(flagged)}")
    shop_conserved(rig, "shop kafka")
    shop_twin(rig, "shop kafka")
    print(f"shop kafka: flagged {sorted(flagged)}; consumers {orders} = the in-process bus's, committed "
          f"{committed}; card = CPU")
    rec = shop_leg("shop_kafka", [rig], FAULT_WARM_S + scenario.fault_s, wall, launches, prof)
    rec.update(flagged=sorted(flagged), orders=orders, committed=committed)
    return rec


def phase_shop(device, results):
    """The shop at the reference's default load feeding the port's
    pipeline on the card: the quiet leg, the eight flagd faults, and the
    orders over a socket broker."""
    t0 = time.perf_counter()
    out = {"quiet": shop_quiet(device), "faults": shop_faults(device)}
    out["kafka"] = shop_kafka(device, out["faults"]["cases"]["kafka_queue_problems"])
    for name in ("fused_update", "cms_hist", "sketch_delta"):
        results[name]["launches_shop"] = {leg: rec["all_launches"][name] for leg, rec in out.items()}
    out["wall_s"] = time.perf_counter() - t0
    print(f"shop phase: {out['wall_s']:.1f} s ({gpu_line()})")
    return out


# -- the standalone stack: the shop's edges, its processes, spinebench ---------------

STACK_USERS = 5  # LoadControl's default swarm, the upstream demo's LOCUST_USERS
STACK_LOAD_S = 30.0  # wall seconds of load before the fault
STACK_FLAG_S = 60.0  # longest wait for a flag after the flip
STACK_CLIENTS = 4  # client threads running cart + checkout beside the load
STACK_THINK_S = 0.5  # a client's pause between checkouts
STACK_WARM_BATCHES = 40  # the compose daemon's batches before the fault (its CUSUM warm-up is 20)
STACK_ROUTES = ("/", "/product/TEL-DOB-10", "/api/products", "/feature/", "/jaeger", "/grafana", "/loadgen",
                "/metrics")
PAYMENT_FAILURE = {"flags": {"paymentFailure": {
    "state": "ENABLED", "variants": {"on": 1.0, "off": 0.0}, "defaultVariant": "on"}}}
KAFKA_QUEUE_PROBLEMS = {"flags": {"kafkaQueueProblems": {
    "state": "ENABLED", "variants": {"on": 80, "off": 0}, "defaultVariant": "on"}}}


def http_call(base: str, method: str, path: str, doc=None, timeout: float = 30.0) -> tuple[int, bytes, float]:
    """One request: (status, body, seconds). An HTTP error status is an
    answer, not an exception."""
    import urllib.error
    import urllib.request

    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"} if data is not None else {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def http_checkout(base: str, user: str) -> list[tuple[int, bytes, float]]:
    """Cart then checkout over ``/api``, as the reference's topology tests do."""
    return [
        http_call(base, "POST", "/api/cart", {"userId": user, "item": {"productId": "TEL-DOB-10", "quantity": 1}}),
        http_call(base, "POST", "/api/checkout", {"userId": user, "email": f"{user}@example.com",
                                                 "currencyCode": "USD"}),
    ]


def grpc_importable() -> bool:
    try:
        import grpc  # noqa: F401
    except ImportError:
        return False
    return True


class LanePeaks:
    """The largest |value| of each of a service's CUSUM and z-score lanes
    over the ``/metrics`` pages a leg reads before its fault, beside the
    threshold that lane alarms at (``DetectorConfig``'s defaults, which
    every leg's daemon runs) and the batches dispatched when it was read."""

    def __init__(self, service: str):
        import re

        from opentelemetry_demo_tpu_torch.models import DetectorConfig

        cfg = DetectorConfig()
        self.service = service
        self.peak: dict[str, float] = {}
        self.at: dict[str, float] = {}
        self.threshold = {"cusum/latency_up": cfg.cusum_h, "cusum/error_up": cfg.cusum_h,
                          "cusum/rate_down": cfg.cusum_h_rate}
        self._pat = re.compile(
            rf'^app_anomaly_(cusum|z_score)\{{service="{re.escape(service)}",signal="([a-z_]+)"\}} (\S+)$', re.M)
        self._z = cfg.z_threshold

    def lanes(self, text: str) -> dict[str, float]:
        return {f"{kind}/{signal}": abs(float(v)) for kind, signal, v in self._pat.findall(text)}

    def see(self, text: str) -> str:
        for name, v in self.lanes(text).items():
            if v > self.peak.get(name, -1.0):
                self.peak[name] = v
                self.at[name] = metric_value(text, "app_anomaly_batches_dispatched") or 0.0
        return text

    def shares(self) -> dict[str, float]:
        """Each lane's peak over its threshold."""
        return {k: v / self.threshold.get(k, self._z) for k, v in self.peak.items()}

    def __str__(self) -> str:
        return f"{self.service}'s lanes peaked at " + ", ".join(
            f"{k} {v:.3f} ({v / self.threshold.get(k, self._z):.2f} of {self.threshold.get(k, self._z):g}, "
            f"batch {self.at[k]:g})" for k, v in sorted(self.peak.items()))


def flag_count(text: str, service: str) -> float:
    from opentelemetry_demo_tpu_torch.telemetry import metrics as tele_metrics

    return metric_value(text, f'{tele_metrics.ANOMALY_FLAG_TOTAL}{{service="{service}"}}') or 0.0


class Background:
    """``fn`` on a thread of its own; ``result`` joins it and raises
    what it raised (a failed check fails the run where it is joined)."""

    def __init__(self, fn):
        import threading

        self._out: dict = {}

        def run():
            try:
                self._out["value"] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised by result()
                self._out["error"] = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def result(self, timeout_s: float = 600.0):
        self._thread.join(timeout_s)
        check(not self._thread.is_alive(), f"a background check did not finish in {timeout_s} s")
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def stack_twin(stack, calls, events, what) -> int:
    """The recorded ``on_spans`` flushes replayed into the port's
    pipeline on the CPU at the same config and width: every report's
    flags equal, the final state equal (integers exact, floats within
    RTOL / ATOL). Returns the replay's steps."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    pipe = stack.pipeline
    cpu_events = []
    twin = DetectorPipeline(AnomalyDetector(pipe.detector.config, device="cpu"), flags=stack.shop.flags,
                            on_report=lambda t, rep, flagged: cpu_events.append((t, sorted(flagged))),
                            batch_size=pipe.tensorizer.batch_size)
    for t, spans in calls:
        twin.submit(spans)
        twin.pump(t)
    twin.drain()
    check(len(events) == len(cpu_events) == pipe.stats.batches == twin.stats.batches,
          f"{what}: {len(events)} reports on the card ({pipe.stats.batches} steps), {len(cpu_events)} on the CPU")
    for (t, a), (u, b) in zip(events, cpu_events):
        check(t == u and a == b, f"{what}: flags at t={t}: card {a}, CPU {b} (t={u})")
    check(pipe.stats.spans == twin.stats.spans == sum(len(s) for _, s in calls),
          f"{what}: {pipe.stats.spans} spans on the card, {twin.stats.spans} on the CPU")
    snapshots_close(pipe.state_snapshot()[0], twin.state_snapshot()[0], what)
    return twin.stats.batches


def grpc_leg(stack, base: str) -> dict:
    """``GetProduct``, ``ListProducts`` and ``PlaceOrder`` over the gRPC
    edge beside the gateway, against the HTTP routes for the same
    product and the same cart. Requests are encoded and answers decoded
    by field number (proto/demo.proto) with the wire primitives."""
    import grpc

    from opentelemetry_demo_tpu_torch.runtime import wire

    def money(buf) -> tuple[str, int, int]:
        f = wire.scan_fields(buf)
        return (wire.first(f, 1, b"").decode(), wire.to_int64(int(wire.first(f, 2, 0) or 0)),
                wire.to_int64(int(wire.first(f, 3, 0) or 0)))

    def product(buf) -> dict:
        f = wire.scan_fields(buf)
        return dict(id=wire.first(f, 1, b"").decode(), name=wire.first(f, 2, b"").decode(),
                    price=money(wire.first(f, 5, b"")))

    def usd(doc) -> tuple[str, int, int]:
        return (doc["currencyCode"], int(doc["units"]), int(doc["nanos"]))

    channel = grpc.insecure_channel(f"127.0.0.1:{stack.grpc_edge.port}")
    t0 = time.perf_counter()
    try:
        def call(path: str, body: bytes) -> bytes:
            return channel.unary_unary(path)(body, timeout=30)

        listed = [product(p) for p in wire.scan_fields(call("/oteldemo.ProductCatalogService/ListProducts", b"")
                                                       ).get(1, [])]
        status, body, _ = http_call(base, "GET", "/api/products")
        check(status == 200, f"stack grpc: /api/products answered {status}")
        http_products = json.loads(body)["products"]
        check([p["id"] for p in listed] == [p["id"] for p in http_products]
              and [p["name"] for p in listed] == [p["name"] for p in http_products],
              f"stack grpc: ListProducts {[p['id'] for p in listed]} against /api/products")
        pid = "TEL-DOB-10"
        got = product(call("/oteldemo.ProductCatalogService/GetProduct", wire.encode_len(1, pid.encode())))
        status, body, _ = http_call(base, "GET", f"/api/products/{pid}")
        want = json.loads(body)
        check(status == 200 and got["id"] == want["id"] == pid and got["name"] == want["name"],
              f"stack grpc: GetProduct {got} against /api/products/{pid} {want}")
        check(abs(got["price"][1] + got["price"][2] / 1e9 - want["priceUsd"]) < 1e-6,
              f"stack grpc: GetProduct price {got['price']} against {want['priceUsd']}")
        # The same cart through each edge: two units of one product.
        item = wire.encode_len(1, pid.encode()) + wire.encode_int(2, 2)
        call("/oteldemo.CartService/AddItem", wire.encode_len(1, b"grpc-buyer") + wire.encode_len(2, item))
        placed = call("/oteldemo.CheckoutService/PlaceOrder",
                      wire.encode_len(1, b"grpc-buyer") + wire.encode_len(2, b"USD")
                      + wire.encode_len(3, b"grpc-buyer@example.com"))
        order = wire.scan_fields(wire.first(wire.scan_fields(placed), 1, b""))
        g_items = []
        for raw in order.get(5, []):
            f = wire.scan_fields(raw)
            ci = wire.scan_fields(wire.first(f, 1, b""))
            g_items.append((wire.first(ci, 1, b"").decode(), int(wire.first(ci, 2, 0)), money(wire.first(f, 2, b""))))
        g_ship = money(wire.first(order, 3, b""))
        check(http_call(base, "POST", "/api/cart", {"userId": "http-buyer",
                                                    "item": {"productId": pid, "quantity": 2}})[0] == 200,
              "stack grpc: /api/cart")
        status, body, _ = http_call(base, "POST", "/api/checkout", {"userId": "http-buyer",
                                                                   "email": "http-buyer@example.com",
                                                                   "currencyCode": "USD"})
        check(status == 200, f"stack grpc: /api/checkout answered {status}: {body[:200]!r}")
        h = json.loads(body)
        h_items = [(i["item"]["productId"], int(i["item"]["quantity"]), usd(i["cost"])) for i in h["items"]]
        h_ship = usd(h["shippingCost"])
        check(wire.first(order, 1, b"").decode() and g_items == h_items,
              f"stack grpc: PlaceOrder items {g_items}; /api/checkout {h_items}")
        # The shipping quote is drawn per order (8-12.50 USD an item, the
        # upstream quote's random per-item rate), through either edge.
        for ship in (g_ship, h_ship):
            check(ship[0] == "USD" and 8.0 * 2 <= ship[1] + ship[2] / 1e9 <= 12.5 * 2,
                  f"stack grpc: shipping {ship} for two items")
    finally:
        channel.close()
    rec = dict(products=len(listed), items=g_items, shipping=(g_ship, h_ship), wall_s=time.perf_counter() - t0)
    print(f"stack_grpc: ListProducts {len(listed)} = /api/products, GetProduct {pid} = /api/products/{pid}, "
          f"PlaceOrder items {g_items} = /api/checkout's (shipping {g_ship} and {h_ship}, drawn per order) "
          f"({rec['wall_s']:.3f} s)")
    return rec


def stack_http(device) -> dict:
    """The in-process stack through ``serve_shop.build`` on ``device``
    (B = 512, 32 services): ``LoadControl`` at 5 users for 30 s of wall
    beside 4 client threads running cart + checkout on ``/api``, every
    edge route fetched once, a JSON body to ``/otlp-http/v1/traces``,
    the gRPC leg where ``grpc`` imports, then ``paymentFailure`` through
    the flag editor and checkouts until ``payment`` is flagged. Every
    ``on_spans`` flush is recorded and replayed into a CPU pipeline."""
    import threading

    from torch.autograd import DeviceType

    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.serve_shop import build, parser

    grpc_on = grpc_importable()
    t_build = time.perf_counter()
    args = parser().parse_args(["--host", "127.0.0.1", "--port", "0", "--users", "0", "--seed", "0",
                                "--device", device.type, "--grpc-port", "0" if grpc_on else "-1"])
    stack = build(args)
    build_s = time.perf_counter() - t_build
    gw, pipe = stack.gateway, stack.pipeline
    base = f"http://127.0.0.1:{gw.port}"
    calls, events = [], []
    record_spans = gw.on_spans

    def on_spans(t, spans):
        calls.append((t, list(spans)))
        record_spans(t, spans)

    gw.on_spans = on_spans
    report = pipe.on_report

    def on_report(t, rep, flagged):
        events.append((t, sorted(flagged)))
        report(t, rep, flagged)

    pipe.on_report = on_report
    closed = False
    try:
        with traced() as prof:
            _kernels.reset_launches()
            t0 = time.perf_counter()
            stack.load.set_users(STACK_USERS)
            stop = threading.Event()
            answers: list = []

            def client(i: int) -> None:
                k = 0
                while not stop.is_set():
                    answers.extend((time.perf_counter(), *a) for a in http_checkout(base, f"client-{i}-{k}"))
                    k += 1
                    stop.wait(STACK_THINK_S)

            clients = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(STACK_CLIENTS)]
            for th in clients:
                th.start()
            time.sleep(STACK_LOAD_S)
            # The load goes on through the routes, the gRPC leg and the
            # fault: a pause would read as a rate drop on every service.
            load_status = stack.load.status()
            routes = {}
            for path in STACK_ROUTES:
                status, body, secs = http_call(base, "GET", path)
                routes[path] = dict(status=status, bytes=len(body), ms=secs * 1e3)
            browser = {"resourceSpans": [{
                "resource": {"attributes": [{"key": "service.name", "value": {"stringValue": "browser"}}]},
                "scopeSpans": [{"spans": [{"traceId": "cd" * 16, "name": "documentFetch",
                                           "startTimeUnixNano": 0, "endTimeUnixNano": 5_000_000}]}]}]}
            status, body, secs = http_call(base, "POST", "/otlp-http/v1/traces", browser)
            routes["/otlp-http/v1/traces"] = dict(status=status, bytes=len(body), ms=secs * 1e3)
            bad = {p: r["status"] for p, r in routes.items() if r["status"] != 200}
            check(not bad, f"stack http: routes answered {bad}")
            grpc_rec = grpc_leg(stack, base) if grpc_on else "not run: grpc does not import here"
            status, body, _ = http_call(base, "GET", "/metrics")
            check(status == 200 and flag_count(body.decode(), "payment") == 0.0,
                  "stack http: payment flagged before the fault")
            t_flip = time.perf_counter()
            flip_t = time.monotonic() - gw._t0  # the clock the gateway pumps on
            status, _, _ = http_call(base, "POST", "/feature/api/write-to-file", {"data": PAYMENT_FAILURE})
            check(status == 200, f"stack http: the flag editor answered {status}")
            flagged = False
            while not flagged:
                check(time.perf_counter() - t_flip < STACK_FLAG_S, f"stack http: payment not flagged in {STACK_FLAG_S} s")
                time.sleep(0.1)
                status, body, _ = http_call(base, "GET", "/metrics")
                flagged = flag_count(body.decode(), "payment") >= 1.0
            ttd_s = time.perf_counter() - t_flip
            stop.set()
            for th in clients:
                th.join(timeout=60)
            stack.close()
            closed = True
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        trace_exit_s = time.perf_counter() - t0 - wall
    finally:
        if not closed:
            stack.close()
    t_events = time.perf_counter()
    steps = pipe.stats.batches
    k1_events = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and "sketch_kernel" in e.name)
    check(launches["fused_update"] == steps == k1_events and launches["cms_hist"] == launches["sketch_delta"] == 0,
          f"stack http: launches {launches}, {k1_events} sketch kernels in the trace, for {steps} steps")
    busy = device_activity(prof)
    events_s = time.perf_counter() - t_events
    check(busy["ops"] > 0, "stack http: the trace saw no device activity")
    # No batch dispatched before the flip flags payment (a report's time
    # is its batch's, on the gateway's clock).
    before = [(t, f) for t, f in events if "payment" in f and t < flip_t]
    check(not before, f"stack http: payment flagged before the flip: {before[:3]}")
    # The CPU replay runs beside the process legs; phase_stack joins it.
    t_replay = time.perf_counter()
    replay = Background(lambda: (stack_twin(stack, calls, events, "stack http"), time.perf_counter() - t_replay))
    # The clients' answers before the flip: requests/s answered 200 and
    # the request latency under the load.
    quiet = [(status, x) for t, status, _, x in answers if t < t_flip]
    ok = [status for status, _ in quiet if status == 200]
    secs = sorted(x for _, x in quiet)
    fault_checkouts = sum(1 for t, _, _, _ in answers if t >= t_flip) // 2
    rec = dict(
        load_s=t_flip - t0, requests=len(quiet), answered_200=len(ok), requests_per_s_200=len(ok) / (t_flip - t0),
        request_p50_ms=float(np.percentile(secs, 50)) * 1e3, request_p99_ms=float(np.percentile(secs, 99)) * 1e3,
        loadgen=load_status, routes=routes, grpc=grpc_rec, fault_checkouts=fault_checkouts, ttd_s=ttd_s, wall_s=wall,
        spans=pipe.stats.spans, spans_per_s=pipe.stats.spans / wall, steps=steps, replay=replay,
        build_s=build_s, trace_exit_s=trace_exit_s, events_s=events_s,
        launches=launches["fused_update"], all_launches=launches, trace_sketch_kernels=k1_events,
        lag_p99_ms=float(np.percentile(pipe.stats.lag_ms, 99)) if pipe.stats.lag_ms else None,
        busy_share=busy["union_ms"] / (wall * 1e3), device_ms=busy["union_ms"], device_ops=busy["ops"],
        flagged=sorted({s for _, f in events for s in f}),
    )
    print(f"stack_http: {len(ok)} of {len(quiet)} client requests answered 200 in {rec['load_s']:.3f} s "
          f"({rec['requests_per_s_200']:.1f}/s, p50 {rec['request_p50_ms']:.2f} ms, p99 {rec['request_p99_ms']:.2f} ms) "
          f"beside {STACK_USERS} load users ({load_status}); routes {{{', '.join(f'{p}: {r['status']}' for p, r in routes.items())}}}; "
          f"payment flagged {ttd_s:.3f} s after the flip ({fault_checkouts} client checkouts); {rec['spans']} spans in {wall:.3f} s "
          f"(traced, {rec['spans_per_s']:.1f} spans/s), {steps} steps = {launches['fused_update']} fused_update launches "
          f"= {k1_events} sketch kernels in the trace, card busy {rec['busy_share']:.4%} ({busy['ops']} device ops), "
          f"lag p99 {rec['lag_p99_ms']} ms; build {build_s:.3f} s, trace stop {trace_exit_s:.3f} s, trace read "
          f"{events_s:.3f} s ({gpu_line()})")
    return rec


STACK_ENV = ("KAFKA_PORT", "SHOP_PORT", "SHOP_USERS", "SHOP_MINIMAL", "SHOP_GRPC_PORT",
             "OTEL_EXPORTER_OTLP_ENDPOINT", "LOCUST_BROWSER_TRAFFIC_ENABLED")


def child_env(daemon: str | None = None, **knobs) -> dict:
    """A child's environment, with this checkout on ``PYTHONPATH`` and
    none of the knobs ``serve_shop`` and ``serve_kafka`` read. A daemon's
    is ``daemon_env(daemon)``'s (every ``ANOMALY_*`` knob unset,
    ephemeral ports, its own checkpoint, history and flagd file) without
    the front door and the gRPC receiver; then ``knobs``."""
    with daemon_env(daemon or "stack", ANOMALY_FRONTDOOR_ENABLE=0, ANOMALY_OTLP_GRPC_PORT=-1, **knobs):
        env = {k: v for k, v in os.environ.items() if k not in STACK_ENV}
    if daemon is None:
        env = {k: v for k, v in env.items() if not k.startswith("ANOMALY_") and k not in DAEMON_ENV}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONUNBUFFERED"] = "1"
    return env


class Child:
    """A process of the stack: its output read on a thread, its first
    line matching a pattern awaited, killed on ``stop``."""

    def __init__(self, name: str, argv: list[str], env: dict, cwd: Path = ROOT):
        import threading

        self.name = name
        self.lines: list[str] = []
        self.proc = subprocess.Popen([sys.executable, *argv], cwd=cwd, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=lambda: self.lines.extend(self.proc.stdout), daemon=True)
        self._reader.start()

    def wait_line(self, pattern: str, timeout_s: float = 120.0) -> str:
        import re

        deadline = time.perf_counter() + timeout_s
        while True:
            for line in list(self.lines):
                if re.search(pattern, line):
                    return line
            check(self.proc.poll() is None, f"{self.name} exited rc={self.proc.returncode}: {self.lines[-20:]}")
            check(time.perf_counter() < deadline, f"{self.name}: no line matching {pattern!r}: {self.lines[-20:]}")
            time.sleep(0.05)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self._reader.join(timeout=10)


def device_args(device) -> list[str]:
    """The card is every entry point's default; only another device is named."""
    return [] if device.type == "cuda" else ["--device", device.type]


def scrape(url: str) -> str:
    status, body, _ = http_call(url, "GET", "/metrics")
    check(status == 200, f"{url}/metrics answered {status}")
    return body.decode()


def stack_compose(device) -> dict:
    """The compose topology: the port's daemon as a process on ``device``
    at its default geometry and warm-ups (the deployed ones) with the
    reference's topology test's batch and cadence, ``serve_shop
    --otlp-endpoint`` as a process exporting the three signals to it;
    ``payment`` must not flag before the fault, ``paymentFailure``
    through the shop's flag editor must flag it on the daemon's
    ``/metrics``, and the shop's error logs must be stored there.

    An 8-batch CUSUM warm-up (the reference's topology test's, which
    never reads the flags before the fault) left the latency lane of
    ``payment`` at 2.4-4.0 of its threshold 5 on healthy traffic and
    crossed it on one run; the default warm-up of 20 kept it under 2.0
    at every checkout pace tried (``scripts/warm_margin.py``)."""
    import re

    children: list[Child] = []
    t0 = time.perf_counter()
    try:
        daemon = Child("compose daemon", ["-m", "opentelemetry_demo_tpu_torch", *device_args(device)],
                       child_env("compose", ANOMALY_BATCH=128, ANOMALY_PUMP_INTERVAL_S=0.05))
        children.append(daemon)
        line = daemon.wait_line(r"anomaly-detector: otlp-http :\d+")
        otlp = int(re.search(r"otlp-http :(\d+)", line).group(1))
        metrics = f"http://127.0.0.1:{re.search(r'metrics :(\d+)', line).group(1)}"
        shop = Child("compose shop", ["-m", "opentelemetry_demo_tpu_torch.serve_shop", "--host", "127.0.0.1",
                                      "--port", "0", "--users", "0", "--otlp-endpoint", f"http://127.0.0.1:{otlp}"],
                     child_env())
        children.append(shop)
        base = f"http://127.0.0.1:{re.search(r'http://[^:]+:(\d+)', shop.wait_line(r'shop gateway on http://')).group(1)}"
        boot_s = time.perf_counter() - t0
        # Warm past the CUSUM warm-up several times over: a fault that
        # lands inside it is learned as the baseline and never flags.
        i, peak = 0, LanePeaks("payment")
        while True:
            text = peak.see(scrape(metrics))
            if ((metric_value(text, "app_anomaly_spans_processed_total") or 0.0) >= 100
                    and (metric_value(text, "app_anomaly_batches_dispatched") or 0.0) >= STACK_WARM_BATCHES):
                break
            check(time.perf_counter() - t0 < 120.0, f"stack compose: the daemon did not warm: {i} checkouts")
            http_checkout(base, f"warm-{i}")
            i += 1
            time.sleep(0.07)
        text = peak.see(scrape(metrics))
        print(f"stack_compose: before the flip, {peak}")
        check(flag_count(text, "payment") == 0.0,
              f"stack compose: payment flagged before the fault (its lanes now {peak.lanes(text)}; {peak})")
        status, _, _ = http_call(base, "POST", "/feature/api/write-to-file", {"data": PAYMENT_FAILURE})
        check(status == 200, f"stack compose: the flag editor answered {status}")
        t_flip = time.perf_counter()
        j = 0
        while True:
            text = scrape(metrics)
            if flag_count(text, "payment") >= 1.0 and (metric_value(text, "app_anomaly_log_docs_stored") or 0.0) >= 1:
                break
            check(time.perf_counter() - t_flip < STACK_FLAG_S,
                  f"stack compose: payment {flag_count(text, 'payment')}, logs stored "
                  f"{metric_value(text, 'app_anomaly_log_docs_stored')} after {STACK_FLAG_S} s")
            for _ in range(4):
                http_checkout(base, f"fault-{j}")
                j += 1
            time.sleep(0.07)
        ttd_s = time.perf_counter() - t_flip
        logs = metric_value(text, "app_anomaly_log_docs_stored")
        check(not any("warm-up failed" in ln for ln in daemon.lines), "stack compose: the daemon's warm-up failed")
    finally:
        for child in children:
            child.stop()
    rec = dict(boot_s=boot_s, warm_checkouts=i, fault_checkouts=j, ttd_s=ttd_s, logs_stored=logs,
               warm_peak_lanes=peak.peak, warm_peak_shares=peak.shares(), announce=line.strip(), wall_s=time.perf_counter() - t0)
    print(f"stack_compose: daemon ({line.strip()}) and serve_shop --otlp-endpoint up in {boot_s:.3f} s; payment "
          f"unflagged over {i} warm checkouts, flagged on the daemon's /metrics {ttd_s:.3f} s "
          f"after the flip ({j} checkouts), {logs:g} log docs stored ({gpu_line()})")
    return rec


def kafka_topology(device) -> dict:
    """Start the three-process topology: ``serve_kafka`` (awaited: the
    others need its address), then the daemon with ``KAFKA_ADDR`` (the
    reference's topology test's batch, cadence and warm-ups) and
    ``serve_shop --kafka``, not awaited, so they boot beside the compose
    leg."""
    import re

    topo = dict(t0=time.perf_counter(), children=[])
    broker = Child("broker", ["-m", "opentelemetry_demo_tpu_torch.serve_kafka", "--host", "127.0.0.1",
                              "--port", "0"], child_env())
    topo["children"].append(broker)
    topo["bootstrap"] = re.search(r"kafka broker on (\S+)", broker.wait_line(r"kafka broker on \S+:\d+")).group(1)
    topo["daemon"] = Child("kafka daemon", ["-m", "opentelemetry_demo_tpu_torch", *device_args(device)],
                           child_env("kafka", KAFKA_ADDR=topo["bootstrap"], ANOMALY_BATCH=128,
                                     ANOMALY_PUMP_INTERVAL_S=0.05, ANOMALY_WARMUP_BATCHES=6,
                                     ANOMALY_Z_WARMUP_BATCHES=40))
    topo["children"].append(topo["daemon"])
    topo["shop"] = Child("kafka shop", ["-m", "opentelemetry_demo_tpu_torch.serve_shop", "--host", "127.0.0.1",
                                        "--port", "0", "--users", "0", "--kafka", topo["bootstrap"],
                                        *device_args(device)], child_env())
    topo["children"].append(topo["shop"])
    return topo


def stack_kafka(topo) -> dict:
    """The three-process topology of ``kafka_topology``:
    ``kafkaQueueProblems`` through the shop's flag editor must flag
    ``checkout-orders`` on the daemon's ``/metrics``, and all three
    consumer groups must have committed."""
    import re

    from opentelemetry_demo_tpu_torch.runtime.kafka_client import KafkaConsumer

    t0 = time.perf_counter()
    bootstrap, daemon = topo["bootstrap"], topo["daemon"]
    line = daemon.wait_line(r"anomaly-detector: otlp-http :\d+")
    metrics = f"http://127.0.0.1:{re.search(r'metrics :(\d+)', line).group(1)}"
    base = f"http://127.0.0.1:{re.search(r'http://[^:]+:(\d+)', topo['shop'].wait_line(r'shop gateway on http://')).group(1)}"
    boot_s = time.perf_counter() - topo["t0"]
    i, peak = 0, LanePeaks(ORDERS)
    while (metric_value(peak.see(scrape(metrics)), "app_anomaly_spans_processed_total") or 0.0) < 55:
        check(time.perf_counter() - t0 < 150.0, "stack kafka: the daemon never ingested orders off the broker")
        http_checkout(base, f"warm-{i}")
        i += 1
        time.sleep(0.15)
    text = peak.see(scrape(metrics))
    print(f"stack_kafka: before the flip, {peak}")
    check(flag_count(text, ORDERS) == 0.0,
          f"stack kafka: checkout-orders flagged before the flood (its lanes now {peak.lanes(text)}; {peak})")
    status, _, _ = http_call(base, "POST", "/feature/api/write-to-file", {"data": KAFKA_QUEUE_PROBLEMS})
    check(status == 200, f"stack kafka: the flag editor answered {status}")
    t_flip = time.perf_counter()
    j = 0
    while flag_count(scrape(metrics), "checkout-orders") < 1.0:
        check(time.perf_counter() - t_flip < STACK_FLAG_S, f"stack kafka: checkout-orders not flagged in {STACK_FLAG_S} s")
        http_checkout(base, f"flood-{j}")
        j += 1
        time.sleep(0.3)
    ttd_s = time.perf_counter() - t_flip
    committed = {}
    for group in ("accounting", "fraud-detection", "anomaly-detector"):
        consumer = KafkaConsumer(bootstrap, group, "orders")
        try:
            committed[group] = sum(v for v in consumer.committed().values() if v > 0)
        finally:
            consumer.close()
    check(all(v > 0 for v in committed.values()), f"stack kafka: committed offsets {committed}")
    check(not any("warm-up failed" in ln for ln in daemon.lines), "stack kafka: the daemon's warm-up failed")
    rec = dict(boot_s=boot_s, warm_checkouts=i, flood_checkouts=j, ttd_s=ttd_s, committed=committed,
               warm_peak_lanes=peak.peak, warm_peak_shares=peak.shares(), announce=line.strip(), wall_s=time.perf_counter() - t0)
    print(f"stack_kafka: serve_kafka, serve_shop --kafka and the daemon up {boot_s:.3f} s after their start (booted "
          f"beside the compose leg); checkout-orders flagged {ttd_s:.3f} s after the flip ({j} checkouts); "
          f"committed {committed} ({gpu_line()})")
    return rec


def stack_spine(device) -> dict:
    """spinebench on the card as ``bench.py`` calls it: ``measure_e2e``
    at its own geometry (S=16, p=8, CMS 1024, B=2048; 1 s of payloads
    offered to the decode pool, spine and harvester, then drained) with
    its ``measure_kernel_ref`` at the same width. Measurements, no gate."""
    from opentelemetry_demo_tpu_torch.ops import _kernels
    from opentelemetry_demo_tpu_torch.runtime import spinebench

    _kernels.reset_launches()
    t0 = time.perf_counter()
    rec = spinebench.measure_e2e(seconds=1.0, device=str(device))
    check(rec is not None, "stack spine: spinebench found no native decoder")
    rec["wall_s"] = time.perf_counter() - t0
    rec["all_launches"] = dict(_kernels.LAUNCHES)
    print(f"stack_spine: e2e {rec['spans_per_sec']:.1f} spans/s ({rec['spans']} spans, {rec['batches']} batches, "
          f"overlap {rec['overlap_ratio']}, phase share {rec['phase_share']}), kernel ref "
          f"{rec['kernel_spans_per_sec']} spans/s at B=2048; {rec['all_launches']['fused_update']} fused_update "
          f"launches ({rec['wall_s']:.1f} s) ({gpu_line()})")
    return rec


def phase_stack(device, results):
    """The standalone stack as its users start it: the in-process stack
    of ``serve_shop`` with its HTTP and gRPC edges on the card, the
    compose and Kafka topologies as processes, and spinebench."""
    t0 = time.perf_counter()
    out = {"http": stack_http(device)}
    out["grpc"] = out["http"]["grpc"]
    if isinstance(out["grpc"], str):
        print(f"stack_grpc: {out['grpc']}")
    topo = kafka_topology(device)
    try:
        out["compose"] = stack_compose(device)
        out["kafka"] = stack_kafka(topo)
    finally:
        for child in reversed(topo["children"]):
            child.stop()
    t_join = time.perf_counter()
    http = out["http"]
    http["replayed_steps"], http["replay_s"] = http.pop("replay").result()
    print(f"stack_http replay: card = CPU over {http['replayed_steps']} steps, reports and state "
          f"({http['replay_s']:.3f} s beside the process legs, {time.perf_counter() - t_join:.3f} s waited)")
    out["spine"] = stack_spine(device)
    shutil.rmtree(DAEMON_DIR, ignore_errors=True)
    for name in ("fused_update", "cms_hist", "sketch_delta"):
        results[name]["launches_stack"] = {leg: out[leg]["all_launches"][name] for leg in ("http", "spine")}
    out["wall_s"] = time.perf_counter() - t0
    print(f"stack phase: {out['wall_s']:.1f} s ({gpu_line()})")
    return out


# -- the deployment surface ---------------------------------------------------------

DEPLOY_DIR = ROOT / "deploy" / "torch"
DEPLOY_WORK = ROOT / "build" / "chip_smoke_deploy"  # the images' copies and the services' mounts
# The system's knobs: a process of the images' copies gets none of this
# one's, only what its compose file sets.
DEPLOY_KNOB_PREFIXES = ("ANOMALY_", "SHOP_", "KAFKA_", "BENCH_", "FAULTWIRE_", "OTEL_", "LOCUST_", "SANITYCHECK_")
DEPLOY_KNOBS = ("FLAGD_FILE", "OFREP_URL", "CUDA_VISIBLE_DEVICES", "PYTHONUNBUFFERED")


def deploy_env(home: Path) -> dict:
    """What a process of the images' copies keeps of this one's
    environment: where the interpreter, its packages and the toolkit
    are, and no knob of the system; ``HOME`` its own."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(DEPLOY_KNOB_PREFIXES) and k not in DEPLOY_KNOBS}
    env["HOME"] = str(home)
    return env
DEPLOY_KERNELS = ("fused_update", "cms_hist", "sketch_delta")
DEPLOY_HOST_LIBS = ("ingest", "frontdoor", "crc32c", "currency", "shipping")
# The self topology's batches before the flip: twice the default CUSUM
# warm-up of 20, as the compose leg warms. At 80 the 60 batches after the
# warm-up took payment's latency lane to 0.35-0.66 of its threshold on
# healthy traffic, its peak as late as batch 77 (phase_deploy's lane peaks).
DEPLOY_WARM_BATCHES = 40
DEPLOY_FLAG_S = 30.0  # longest wait for the flag after the flip


def read_dockerfile(path: Path) -> dict:
    """What ``phase_deploy`` takes from a Dockerfile: its WORKDIR, the
    COPY of the package, the RUN line that builds the port (continuation
    lines joined) and the ENTRYPOINT."""
    import shlex

    text = path.read_text().replace("\\\n", " ")
    out: dict = {"build": None}
    for line in text.splitlines():
        word, _, rest = line.strip().partition(" ")
        if word == "WORKDIR":
            out["workdir"] = rest.strip()
        elif word == "COPY" and "opentelemetry_demo_tpu_torch" in rest:
            out["copy"] = rest.split()
        elif word == "RUN" and "opentelemetry_demo_tpu_torch.build" in rest:
            out["build"] = shlex.split(rest)
        elif word == "ENTRYPOINT":
            out["entrypoint"] = json.loads(rest)
    check(out["build"] is not None, f"{path.name} runs no build of the port")
    return out


def mem_bytes(limit: str) -> int:
    """A compose memory limit (``1500M``, ``6g``): binary units, as
    Docker reads them."""
    units = {"b": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30}
    return int(float(limit[:-1]) * units[limit[-1].lower()])


def rss_now(pid: int) -> tuple[int, int]:
    """A live process's (resident set, peak resident set) in bytes, from
    ``/proc/<pid>/status``; the peak is 0 where the kernel keeps no
    ``VmHWM``. (A child's ``ru_maxrss`` will not do: exec keeps the
    high-water mark of the forked parent's memory.)"""
    fields = {}
    for line in Path(f"/proc/{pid}/status").read_text().splitlines():
        key, _, value = line.partition(":")
        if key in ("VmRSS", "VmHWM"):
            fields[key] = int(value.split()[0]) * 1024
    return fields["VmRSS"], fields.get("VmHWM", 0)


class PeakRss:
    """The peak resident set of each of some processes: ``VmHWM`` where
    the kernel keeps it, else the largest ``VmRSS`` seen by a thread
    that samples every ``period_s``."""

    def __init__(self, period_s: float = 0.2):
        import threading

        self.peaks: dict[int, int] = {}
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._pids: list[int] = []
        self._thread = threading.Thread(target=self._run, args=(period_s,), daemon=True)
        self._thread.start()

    def watch(self, pid: int) -> None:
        with self._lock:
            self._pids.append(pid)

    def sample(self, pid: int) -> None:
        try:
            rss, hwm = rss_now(pid)
        except (OSError, KeyError):
            return  # gone, or not started
        with self._lock:
            self.peaks[pid] = max(self.peaks.get(pid, 0), rss, hwm)

    def _run(self, period_s: float) -> None:
        while not self._stop.wait(period_s):
            with self._lock:
                pids = list(self._pids)
            for pid in pids:
                self.sample(pid)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_listing(build_dir: Path) -> dict:
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in sorted(build_dir.iterdir())}


def deploy_image(name: str, spec: dict, work: Path) -> dict:
    """Start the image's build in a copy of the package under ``work``:
    ``/app`` becomes ``work/<name>``, so ``BUILD_DIR`` is the copy's own
    and empty. The card is hidden from the build."""
    src, dst = spec["copy"]
    app = work / name
    target = Path(dst) if Path(dst).is_absolute() else Path(spec["workdir"]) / dst
    copy = app / target.relative_to(spec["workdir"])
    shutil.copytree(ROOT / src, copy, ignore=shutil.ignore_patterns("__pycache__"))
    argv = [sys.executable if a == "python" else a for a in spec["build"]]
    env = deploy_env(work / "home")
    env["CUDA_VISIBLE_DEVICES"] = ""
    print(f"deploy: image {name}: {' '.join(spec['build'])} in {app} (the image's {spec['workdir']}), "
          f"CUDA_VISIBLE_DEVICES=''")
    proc = subprocess.Popen(argv, cwd=app, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return dict(app=app, proc=proc, t0=time.perf_counter(), build_dir=app / "build" / "torch_kernels")


def finish_image(name: str, image: dict, want: tuple) -> None:
    out, _ = image["proc"].communicate(timeout=600)
    image["build_s"] = time.perf_counter() - image["t0"]
    check(image["proc"].returncode == 0, f"deploy: image {name}'s build failed:\n{out[-4000:]}")
    built = json.loads(out.strip().splitlines()[-1])
    check(sorted(built) == sorted(want), f"deploy: image {name} built {sorted(built)}, want {sorted(want)}")
    for lib, path in built.items():
        check(Path(path).parent == image["build_dir"] and Path(path).exists(),
              f"deploy: image {name}: {lib} is not in the copy's BUILD_DIR: {path}")
    image["listing"] = build_listing(image["build_dir"])
    image.pop("proc")
    print(f"deploy: image {name} built without the card in {image['build_s']:.2f} s: "
          f"{sorted(image['listing'])}")


class DeployService:
    """One compose service as a process on this machine: its argv, env
    and healthcheck from the file, with only what a container network
    provides rewritten (host names, ports, mounted paths, the image's
    interpreter). Each rewrite is kept and printed."""

    def __init__(self, file: str, name: str, spec: dict, image: dict, dockerfile: dict, work: Path, ports: dict,
                 device):
        import re

        self.file, self.name, self.spec, self.image = file, name, spec, image
        self.ports = ports  # (file, service) → {container port: host port}
        self.rewrites: list[str] = []
        self.mounts = {}
        for vol in spec.get("volumes") or []:
            src, dst = vol.split(":")[:2]
            where = work / file / (src.strip("./") or "root")
            where.mkdir(parents=True, exist_ok=True)
            self.mounts[dst] = where
        self.mounts.setdefault(dockerfile["workdir"], image["app"])
        self._host_port = re.compile(r"(?<![\w.-])(\w[\w.-]*):(\d+)\b")
        entry = spec.get("entrypoint") or dockerfile["entrypoint"]
        argv = [*entry, *(spec.get("command") or [])]
        self.argv = [sys.executable if a == "python" and i == 0 else self.value(a, ports_too=True)
                     for i, a in enumerate(argv)]
        if argv[0] == "python":
            self.rewrites.append(f"python → {sys.executable}")
        if "opentelemetry_demo_tpu_torch" in argv and device.type != "cuda":
            self.argv += ["--device", device.type]
            self.rewrites.append(f"+ --device {device.type}")
        self.env = deploy_env(work / "home")
        self.env["PYTHONUNBUFFERED"] = "1"
        self.rewrites.append("+ PYTHONUNBUFFERED=1 (output read line by line)")
        for entry in spec.get("environment") or []:
            key, eq, value = entry.partition("=")
            if not eq:
                self.rewrites.append(f"{key}: passed through from the host's environment, unset here")
                continue
            new = self.port_value(key, value) if key.endswith("_PORT") else self.value(value)
            self.env[key] = new
        test = (spec.get("healthcheck") or {}).get("test")
        self.health = None
        if test:
            kind, *rest = test
            if kind == "CMD-SHELL":
                shell = self.value(rest[0], ports_too=True)
                if shell.startswith("python "):
                    shell = sys.executable + shell[len("python"):]
                self.health = ["sh", "-c", shell]
            else:
                check(kind == "CMD", f"{file}/{name}: healthcheck {test}")
                self.health = [sys.executable if a == "python" and i == 0 else self.value(a, ports_too=True)
                               for i, a in enumerate(rest)]
        self.proc = None

    def own(self, port: int) -> int | None:
        return self.ports[(self.file, self.name)].get(port)

    def note(self, old: str, new: str) -> str:
        if new != old:
            self.rewrites.append(f"{old} → {new}")
        return new

    def port_value(self, key: str, value: str) -> str:
        mapped = self.own(int(value)) if value.lstrip("-").isdigit() and int(value) > 0 else None
        return self.note(f"{key}={value}", f"{key}={mapped}")[len(key) + 1:] if mapped else value

    def value(self, value: str, ports_too: bool = False) -> str:
        import re

        old = value

        def host_port(m):
            host, port = m.group(1), int(m.group(2))
            if host in ("127.0.0.1", "localhost", "0.0.0.0"):
                mapped = self.own(port)
            elif (self.file, host) in self.ports:
                mapped = self.ports[(self.file, host)].get(port)
            else:
                # A host this file does not define: nothing listens there.
                mapped = self.ports.setdefault(("absent", host), {}).setdefault(port, free_port())
            return f"127.0.0.1:{mapped}" if mapped else m.group(0)

        value = self._host_port.sub(host_port, value)
        if ports_too:
            value = re.sub(r"(['\"])(127\.0\.0\.1|localhost)\1,\s*(\d+)",
                           lambda m: f"{m.group(1)}127.0.0.1{m.group(1)}, {self.own(int(m.group(3)))}", value)
            if old.isdigit() and self.own(int(old)):
                value = str(self.own(int(old)))
        for dst in sorted(self.mounts, key=len, reverse=True):
            if value == dst or value.startswith(dst + "/"):
                value = str(self.mounts[dst]) + value[len(dst):]
                break
        return self.note(old, value)

    def start(self, rss: PeakRss) -> None:
        self.child = Child(f"{self.file}/{self.name}", self.argv[1:], self.env, cwd=self.image["app"])
        self.proc = self.child.proc
        rss.watch(self.proc.pid)

    def healthy(self) -> dict:
        """The compose healthcheck: the test run up to ``retries`` times,
        ``interval`` apart, each within ``timeout``; must exit 0."""
        hc = self.spec["healthcheck"]
        seconds = {k: float(str(hc[k]).rstrip("s")) for k in ("interval", "timeout")}
        tries = []
        for _ in range(int(hc["retries"])):
            t = time.perf_counter()
            try:
                out = subprocess.run(self.health, env=self.env, cwd=self.image["app"], capture_output=True,
                                     text=True, timeout=seconds["timeout"])
                tries.append((out.returncode, round(time.perf_counter() - t, 3)))
                if out.returncode == 0:
                    return dict(tries=tries, stdout=out.stdout.strip())
            except subprocess.TimeoutExpired:
                tries.append(("timeout", round(time.perf_counter() - t, 3)))
            check(self.proc.poll() is None, f"{self.child.name} exited rc={self.proc.returncode}: "
                                            f"{self.child.lines[-20:]}")
            time.sleep(max(0.0, seconds["interval"] - (time.perf_counter() - t)))
        check(False, f"{self.child.name}: healthcheck {self.health} never exited 0: {tries}")

    def limit(self) -> int:
        return mem_bytes(str(self.spec["deploy"]["resources"]["limits"]["memory"]))


def deploy_topology(device, work: Path, images: dict, dockerfiles: dict) -> dict:
    """The services of ``docker-compose.self.yml`` and the overlay's
    primary, standby and aggregator as processes from the images' copies:
    every healthcheck exits 0, the standby reports STANDBY, the shop's
    spans reach the detector, whose ``/metrics`` shows its steps, the
    three consumer groups commit, and ``paymentFailure`` flags ``payment``
    after the flip and never before."""
    import re

    from opentelemetry_demo_tpu_torch.runtime.kafka_client import KafkaConsumer

    import yaml

    files = {f: yaml.safe_load((DEPLOY_DIR / f"docker-compose.{f}.yml").read_text()) for f in ("self", "anomaly")}
    chosen = [("self", "kafka"), ("self", "shop"), ("self", "anomaly-detector"), ("anomaly", "anomaly-detector"),
              ("anomaly", "anomaly-detector-standby"), ("anomaly", "anomaly-aggregator")]
    ports: dict = {}
    for file, name in chosen:
        spec = files[file]["services"][name]
        listen = {int(str(p).split(":")[-1]) for p in spec.get("ports") or []}
        for entry in spec.get("environment") or []:
            key, _, value = entry.partition("=")
            if key.endswith("_PORT") and value.isdigit() and int(value) > 0:
                listen.add(int(value))
        cmd = spec.get("command") or []
        listen |= {int(cmd[i + 1]) for i, a in enumerate(cmd[:-1]) if a == "--port"}
        ports[(file, name)] = {p: free_port() for p in sorted(listen)}
    flagd = work / "anomaly" / "flagd"
    flagd.mkdir(parents=True)
    shutil.copy(ROOT / "deploy" / "demo.flagd.anomaly.json", flagd / "demo.flagd.json")
    image_of = {}
    svcs = {}
    for file, name in chosen:
        spec = files[file]["services"][name]
        img = spec["build"]["dockerfile"].rsplit(".", 1)[1]
        image_of[(file, name)] = img
        svcs[(file, name)] = DeployService(file, name, spec, images[img], dockerfiles[img], work, ports, device)
    for s in svcs.values():
        print(f"deploy: {s.file}/{s.name} ({image_of[(s.file, s.name)]} image): {' '.join(s.argv[1:])}; "
              f"rewrites: {'; '.join(s.rewrites)}")
    rec: dict = {"services": {}}
    t0 = time.perf_counter()
    kafka, shop, det = svcs[("self", "kafka")], svcs[("self", "shop")], svcs[("self", "anomaly-detector")]
    primary, standby = svcs[("anomaly", "anomaly-detector")], svcs[("anomaly", "anomaly-detector-standby")]
    aggregator = svcs[("anomaly", "anomaly-aggregator")]
    started = []
    rss = PeakRss()
    try:
        for s in (kafka, det, primary, aggregator):
            s.start(rss)
            started.append(s)
        kafka.child.wait_line(r"kafka broker on \S+:\d+")
        rec["services"]["self/kafka"] = {"health": kafka.healthy()}  # shop and detector depend on it
        shop.start(rss)
        started.append(shop)
        primary.child.wait_line(r"anomaly-detector: otlp-http :\d+", 300.0)
        standby.start(rss)  # depends_on: anomaly-detector (service_started)
        started.append(standby)
        rec["services"]["anomaly/anomaly-detector"] = {"health": primary.healthy()}
        standby.child.wait_line(r"anomaly-detector: otlp-http", 300.0)
        role = standby.healthy()
        check("STANDBY" in role["stdout"], f"deploy: the standby's --role probe printed {role['stdout']!r}")
        rec["services"]["anomaly/anomaly-detector-standby"] = {"health": role}
        aggregator.child.wait_line(r"anomaly-aggregator: query :\d+", 120.0)
        det.child.wait_line(r"anomaly-detector: otlp-http :\d+", 300.0)
        base = f"http://127.0.0.1:{re.search(r'http://[^:]+:(\d+)', shop.child.wait_line(r'shop gateway on http://', 300.0)).group(1)}"
        metrics = f"http://127.0.0.1:{det.own(9464)}"
        rec["boot_s"] = time.perf_counter() - t0
        i, peak = 0, LanePeaks("payment")
        # What this process (the checkouts' client) takes of the cores the
        # topology shares while it warms: the lanes are host-bound.
        cpu0, wall0 = time.process_time(), time.perf_counter()

        def own_cpu() -> str:
            return f"this process {time.process_time() - cpu0:.2f} CPU s in {time.perf_counter() - wall0:.2f} s"

        while True:
            text = peak.see(scrape(metrics))
            check(flag_count(text, "payment") == 0.0,
                  f"deploy: payment flagged before the flip (its lanes now {peak.lanes(text)}; {peak}; "
                  f"warm-up: {own_cpu()})")
            batches = metric_value(text, "app_anomaly_batches_dispatched") or 0.0
            if batches >= DEPLOY_WARM_BATCHES and (metric_value(text, "app_anomaly_spans_processed_total") or 0) > 0:
                break
            check(time.perf_counter() - t0 < 90.0, f"deploy: the detector did not warm: {batches} batches")
            http_checkout(base, f"deploy-warm-{i}")
            i += 1
            time.sleep(0.05)
        bootstrap = f"127.0.0.1:{kafka.own(9092)}"

        def committed() -> dict:
            out = {}
            for group in ("accounting", "fraud-detection", "anomaly-detector"):
                consumer = KafkaConsumer(bootstrap, group, "orders")
                try:
                    out[group] = sum(v for v in consumer.committed().values() if v > 0)
                finally:
                    consumer.close()
            return out

        rec["warm_own_cpu"] = own_cpu()
        print(f"deploy: before the flip, {peak}; warm-up: {rec['warm_own_cpu']}")
        rec.update(warm_peak_lanes=peak.peak, warm_peak_shares=peak.shares())
        rec["committed_warm"] = committed()
        status, _, _ = http_call(base, "POST", "/feature/api/write-to-file", {"data": PAYMENT_FAILURE})
        check(status == 200, f"deploy: the flag editor answered {status}")
        t_flip = time.perf_counter()
        j = 0
        while flag_count(text := scrape(metrics), "payment") < 1.0:
            check(time.perf_counter() - t_flip < DEPLOY_FLAG_S, f"deploy: payment not flagged in {DEPLOY_FLAG_S} s")
            for _ in range(4):
                http_checkout(base, f"deploy-fault-{j}")
                j += 1
            time.sleep(0.05)
        rec["ttd_s"] = time.perf_counter() - t_flip
        rec["committed"] = committed()
        check(all(rec["committed"][g] > 0 and rec["committed"][g] >= rec["committed_warm"][g]
                  for g in rec["committed"]),
              f"deploy: committed offsets {rec['committed_warm']} then {rec['committed']}")
        rec["spans"] = metric_value(text, "app_anomaly_spans_processed_total")
        rec["batches"] = metric_value(text, "app_anomaly_batches_dispatched")
        build_info = [ln for ln in text.splitlines() if ln.startswith("anomaly_build_info{")]
        check(rec["spans"] > 0 and rec["batches"] > 0, f"deploy: the detector's /metrics: {rec}")
        rec.update(warm_checkouts=i, fault_checkouts=j, build_info=build_info)
        for s in started:
            check(s.proc.poll() is None, f"{s.child.name} exited rc={s.proc.returncode}: {s.child.lines[-20:]}")
            rss.sample(s.proc.pid)
    finally:
        rss.close()
        for s in reversed(started):
            s.child.stop()
    for s in started:
        rec["services"].setdefault(f"{s.file}/{s.name}", {}).update(
            peak_rss_mib=rss.peaks[s.proc.pid] / (1 << 20), limit_mib=s.limit() / (1 << 20), rewrites=s.rewrites)
    for key, svc in rec["services"].items():
        print(f"deploy: {key}: peak RSS {svc['peak_rss_mib']:.1f} MiB of its compose limit "
              f"{svc['limit_mib']:.0f} MiB" + (f"; health {svc['health']['tries']}" if "health" in svc else ""))
    print(f"deploy: every healthcheck exited 0; the standby printed {role['stdout']!r}; the shop's spans reached "
          f"the detector ({rec['spans']:g} spans, {rec['batches']:g} batches on its /metrics, {build_info}); "
          f"payment flagged {rec['ttd_s']:.3f} s after the flip, never before; committed {rec['committed']} "
          f"(at the flip {rec['committed_warm']}) ({gpu_line()})")
    return rec


def phase_deploy(device):
    """The deployment surface of ``deploy/torch`` on this machine: each
    image's build step without the card into an empty ``BUILD_DIR``, the
    compose files' services as processes from those builds, and nothing
    compiled at run time."""
    t0 = time.perf_counter()
    work = DEPLOY_WORK
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        dockerfiles = {name: read_dockerfile(DEPLOY_DIR / f"Dockerfile.{name}")
                       for name in ("anomaly-detector", "gateway")}
        images = {name: deploy_image(name, spec, work) for name, spec in dockerfiles.items()}
        finish_image("anomaly-detector", images["anomaly-detector"], DEPLOY_KERNELS + DEPLOY_HOST_LIBS)
        finish_image("gateway", images["gateway"], DEPLOY_HOST_LIBS)
        out = {"images": {k: dict(build_s=v["build_s"], libraries=sorted(v["listing"])) for k, v in images.items()}}
        out.update(deploy_topology(device, work, images, dockerfiles))
        for name, image in images.items():
            after = build_listing(image["build_dir"])
            check(after == image["listing"], f"deploy: image {name}'s BUILD_DIR changed at run time: "
                                             f"{sorted(set(after) ^ set(image['listing']))}")
        print(f"deploy: nothing compiled at run time: both BUILD_DIRs hold the files the builds left "
              f"({sum(len(i['listing']) for i in images.values())} libraries, sizes and times unchanged)")
        for key, svc in out["services"].items():
            check(svc["peak_rss_mib"] <= svc["limit_mib"],
                  f"deploy: {key} peaked at {svc['peak_rss_mib']:.1f} MiB, over its compose limit "
                  f"{svc['limit_mib']:.0f} MiB")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    print(f"deploy phase: {out['wall_s']:.1f} s ({gpu_line()})")
    return out


# -- the bench line -----------------------------------------------------------------

# phase_bench's knobs: the full width (BENCH_BATCH at its default), the
# matrix, the spine and lag legs shortened; the legs that other phases
# already drive on the card at 0 (quality, mitigation, the fleet drills,
# the front door and its soaks in phase_quality, phase_mitigation,
# phase_fleet and phase_daemon; spinebench's tracer and provenance A/B
# beside stack_spine and tracer_cost: each A/B's four spinebench runs
# take 70-95 s on an H100, past the phase's 150 s).
BENCH_PHASE_KNOBS = {
    "BENCH_MATRIX": "1", "BENCH_SPINE_SECONDS": "1", "BENCH_LAG_SECONDS": "6",
    "BENCH_QUALITY": "0", "BENCH_MITIG": "0", "BENCH_REPL": "0", "BENCH_FLEET": "0",
    "BENCH_AUTOSCALE": "0", "BENCH_FRONTDOOR": "0", "BENCH_SELFTRACE": "0", "BENCH_EXPLAIN": "0",
}


def seeded_state(rng, cfg, device):
    """A full detector state from ``rng``: banks with history in both
    halves, heads past their warm-ups, step 7."""
    from opentelemetry_demo_tpu_torch.models import detector_init
    from opentelemetry_demo_tpu_torch.models.detector import DetectorState

    hll_bank, cms_bank, heads = random_state(rng, cfg, device)
    state = detector_init(cfg, device)._asdict()
    state.update(hll_bank=hll_bank, cms_bank=cms_bank, **heads, step_idx=torch.tensor(7, dtype=torch.int32,
                                                                                    device=device))
    for name in ("span_total", "card_mean", "card_var", "obs_windows"):
        shape = tuple(state[name].shape)
        state[name] = torch.from_numpy(rng.gamma(4.0, 50.0, shape).astype(np.float32)).to(device)
    return DetectorState(**state)


def bench_k1(cfg, device, pool) -> float:
    """Two detector steps from one seeded state on the bench's batches,
    the fused-update kernel (``sketch_impl="pallas"``) against its plain
    version (``"interpret"``): integer state exact, float state and
    reports within RTOL/ATOL, flags identical, after each step."""
    from opentelemetry_demo_tpu_torch.models import detector_step
    from opentelemetry_demo_tpu_torch.models.detector import DetectorState

    base = seeded_state(np.random.default_rng(12), cfg, device)
    runs = {}
    for impl in ("pallas", "interpret"):
        c = cfg._replace(sketch_impl=impl)
        st = DetectorState(*(t.clone() for t in base))
        reports = []
        for batch, rotate in zip(pool, ((False, False, False), (True, False, False))):
            st, rep = detector_step(c, st, *batch, torch.tensor(DT_S, device=device),
                                    torch.tensor(rotate, device=device))
            reports.append([t.clone() for t in rep])
            runs.setdefault(impl, []).append((DetectorState(*(t.clone() for t in st)), reports[-1]))
        torch.cuda.synchronize()
    worst = 0.0
    b = pool[0][0].shape[0]
    for i, ((sk, rk), (sp, rp)) in enumerate(zip(runs["pallas"], runs["interpret"])):
        for name, a, w in zip(DetectorState._fields, sk, sp):
            if a.dtype in (torch.int32, torch.int64):
                check(torch.equal(a, w), f"B={b} step {i}: {name} differs from the plain path")
            else:
                check(close(a, w), f"B={b} step {i}: {name} differs from the plain path: {max_err(a, w)}")
                worst = max(worst, max_err(a, w))
        for j, (a, w) in enumerate(zip(rk, rp)):
            if a.dtype == torch.bool:
                check(torch.equal(a, w), f"B={b} step {i}: report field {j} (flags) differs")
            else:
                check(close(a, w), f"B={b} step {i}: report field {j} differs: {max_err(a, w)}")
                worst = max(worst, max_err(a, w))
    print(f"fused_update at the bench's width B={b}: two detector steps from one seeded state, integer state "
          f"exact, floats max abs err {worst:.3g}, flags identical")
    return worst


def bench_kernel_times(cfg, device, pool_k1, pool_k2) -> dict:
    """K1 at the bench's width and K2 at the matrix's widest composed call,
    each in turns with its plain version, on the bench's own batches."""
    from opentelemetry_demo_tpu_torch.ops import cms, fused

    svc, lat, err, t_hi, t_lo, a_hi, a_lo, valid = pool_k1[0]
    lanes = dict(svc=svc, log_lat=torch.log1p(lat), is_error=err, trace_hi=t_hi, trace_lo=t_lo,
                 cidx=cms.cms_indices(a_hi, a_lo, cfg.cms_depth, cfg.cms_width), valid=valid)
    hll_bank, cms_bank, heads = random_state(np.random.default_rng(13), cfg, device)
    kw = dict(num_services=cfg.num_services, hll_p=cfg.hll_p, heads=fused.HeadState(**heads),
              dt=torch.tensor(DT_S, device=device), step_pos=torch.tensor(7, dtype=torch.int32, device=device),
              statics=head_kw(cfg))
    args = (hll_bank[:, 0], cms_bank[:, 0], *k1_args(lanes))
    b = svc.shape[0]
    out = {"fused_update": dict(
        time_kernel(lambda: fused.fused_update_plain(*args, **kw), lambda: fused.fused_update(*args, **kw), 4, 50),
        bound_ms=fused_bound_bytes(lanes, cfg) / HBM_BYTES_PER_S * 1e3, shape=f"B={b}",
    )}

    _svc, _lat, _err, _hi, _lo, a_hi, a_lo, valid = pool_k2[0]
    idx, width = cms.cms_indices(a_hi, a_lo, cfg.cms_depth, cfg.cms_width), cfg.cms_width
    for _ in range(2):
        check(torch.equal(cms.cms_count(idx, valid, width), cms.cms_count_plain(idx, valid, width)),
              f"cms_count differs from its plain version at {idx.shape[0]} x {idx.shape[1]}")
    print(f"cms_hist at the matrix's widest composed call: cms_count {idx.shape[0]} x {idx.shape[1]} keys into "
          f"{idx.shape[0] * width} bins exact, twice")
    n_bins = idx.shape[0] * width
    keys = flat_keys(idx, valid, width)
    library = lambda: torch.bincount(keys, minlength=n_bins + 1)[:n_bins]  # noqa: E731
    k2 = dict(
        time_kernel(lambda: cms.cms_count_plain(idx, valid, width), lambda: cms.cms_count(idx, valid, width), 10, 50),
        bound_ms=(idx.shape[1] * (4 * idx.shape[0] + 1) + n_bins * 4) / HBM_BYTES_PER_S * 1e3,
        shape=f"cms_count B={idx.shape[1]} D={idx.shape[0]}",
        library_breakdown=profile_ops(library),
    )
    k2["library_ms"] = sum(
        v["ms"] for k, v in k2["library_breakdown"].items() if not k.startswith(("Memcpy", "Memset"))
    ) or None
    out["cms_hist"] = k2
    for name, t in out.items():
        (p1, _), (k1_, kw_), (k2_, _), (p2, _) = t["turns"]
        print(f"time {name} {t['shape']} (bench): device kernel {k1_:.5f} / {k2_:.5f} ms, plain {p1:.5f} / "
              f"{p2:.5f} ms; wall kernel {kw_:.5f} ms; bound {t['bound_ms']:.6f} ms; library "
              f"{t.get('library_ms')} ms")
        print(f"  device operations per call ({name} {t['shape']}): {show_breakdown(t['breakdown'])}")
    return out


def phase_bench(device, results):
    """The port's bench line as its users run it, ``bench.main`` on the
    card at its full width (``BENCH_BATCH`` = 2,097,152) with the
    sketch-impl matrix, at ``BENCH_PHASE_KNOBS``. Before it, the two
    kernels at the bench's widths against their plain versions: K1 in two
    detector steps at B = 2,097,152, K2 at 4 × 524,288 keys (the matrix's
    ``xla@524288``); both timed. Gates: exactly one JSON line with the
    reference's first keys and this card in ``device``; a finite
    throughput; eight finite matrix entries; ``legs_skipped`` = the knobs
    at 0; both kernels launched on the bench's path."""
    import io

    from opentelemetry_demo_tpu_torch import bench
    from opentelemetry_demo_tpu_torch.models import DetectorConfig
    from opentelemetry_demo_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    cfg = DetectorConfig()
    width = bench.BENCH_KNOBS["BENCH_BATCH"][1]
    rng = np.random.default_rng(11)
    pool_k1 = bench.make_batch_pool(cfg, width, 2, rng, device)
    pool_k2 = bench.make_batch_pool(cfg, bench.MATRIX_BATCHES[-1], 1, rng, device)
    worst = bench_k1(cfg, device, pool_k1)
    results["fused_update"]["max_abs_err"] = max(results["fused_update"]["max_abs_err"], worst)
    times = bench_kernel_times(cfg, device, pool_k1, pool_k2)
    del pool_k1, pool_k2
    torch.cuda.empty_cache()
    t_checks = time.perf_counter() - t0

    saved = {k: os.environ.get(k) for k in bench.BENCH_KNOBS}
    for k in bench.BENCH_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(BENCH_PHASE_KNOBS)
    out = io.StringIO()
    try:
        _kernels.reset_launches()
        t_main = time.perf_counter()
        with contextlib.redirect_stdout(out):
            line = bench.main(["--device", "cuda"])
        t_main = time.perf_counter() - t_main
        launches = dict(_kernels.LAUNCHES)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    printed = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    check(len(printed) == 1, f"the bench printed {len(printed)} lines, not one JSON line")
    check(json.loads(printed[0]) == json.loads(json.dumps(line)), "the bench's line is not what main returned")
    check(list(line)[:4] == ["metric", "value", "unit", "vs_baseline"], f"bench line starts {list(line)[:4]}")
    card_name, card_limit = gpu_line().rsplit(",", 1)
    check(line["device"] == {"name": card_name.strip(), "power_limit_w": float(card_limit.split()[0])},
          f"bench device {line['device']} is not this card")
    check(np.isfinite(line["value"]) and line["value"] > 0, f"bench throughput {line['value']}")
    matrix = line["sketch_impl_matrix"]
    check(len(matrix) == 8 and all(np.isfinite(v) and v > 0 for v in matrix.values()), f"matrix {matrix}")
    want_skipped = [k for k in bench.LEG_KNOBS if BENCH_PHASE_KNOBS.get(k) == "0"]
    check(line["legs_skipped"] == want_skipped, f"legs_skipped {line['legs_skipped']}, knobs at 0 {want_skipped}")
    for name in ("fused_update", "cms_hist"):
        check(launches[name] > 0, f"{name} was not launched on the bench's path")
    for name in ("fused_update", "cms_hist", "sketch_delta"):
        results[name]["launches_bench"] = launches[name]
    rec = dict(line=line, kernel_times=times, launches=launches, checks_s=t_checks, main_s=t_main,
               wall_s=time.perf_counter() - t0)
    best = max(matrix, key=matrix.get)
    print(f"bench: {line['value']:.1f} spans/s at B={width} ({line['vs_baseline']}x the 200,000 target), matrix "
          + ", ".join(f"{k} {v:.0f}" for k, v in matrix.items()) + f" (best {best}); lag p99 "
          f"{line['lag_p99_ms']} ms (net {line['lag_p99_net_ms']}), fetch RTT {line['fetch_rtt_ms']} ms; "
          f"launches {launches}; checks {t_checks:.1f} s, main {t_main:.1f} s ({gpu_line()})")
    print(f"bench phase: {rec['wall_s']:.1f} s")
    return rec


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
                    generation=b.tensorizer.generation, dispatch_lock=lock, stream=b.step_stream)
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
        checkpoint.save(path, c.detector, service_names=c.tensorizer.service_names, dispatch_lock=lock,
                        stream=c.step_stream)
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
        checkpoint.save(path, c.detector, service_names=c.tensorizer.service_names, dispatch_lock=lock,
                        stream=c.step_stream)
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
                    dispatch_lock=card._dispatch_lock, stream=card.step_stream)
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
    without its head epilogue, to show the launch's fixed cost. Both at
    B = 4096 with 2048-16384 services (the million-key soak's geometry),
    with the composed path (``sketch_impl="xla"``, which the reference
    selects at such counts) timed beside them, and a second bound that
    counts the partials each block writes whole and the reduction reads."""
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
    for s in TILED_SERVICES:
        c = soak_config(cfg, s)
        lanes = batch_lanes(rng, c, 4096, device, n_active=s)
        hll_bank, cms_bank, heads = random_state(rng, c, device)
        kw = dict(num_services=s, hll_p=c.hll_p, heads=fused.HeadState(**heads),
                  dt=torch.tensor(DT_S, device=device),
                  step_pos=torch.tensor(7, dtype=torch.int32, device=device), statics=head_kw(c))
        args = (hll_bank[:, 0], cms_bank[:, 0], *k1_args(lanes))
        composed = dict(num_services=s, hll_p=c.hll_p, cms_width=c.cms_width, impl="xla", heads=kw["heads"],
                        dt=kw["dt"], step_pos=kw["step_pos"], **head_kw(c))
        plan = fused.launch_plan(4096, s)
        k1["shapes"][f"B=4096 S={s}"] = dict(
            time_kernel(lambda: fused.fused_update_plain(*args, **kw), lambda: fused.fused_update(*args, **kw), 4),
            composed_ms=time_ms(lambda: fused.sketch_batch_update(*args, **composed), 4)[0],
            bound_ms=fused_bound_bytes(lanes, c) / HBM_BYTES_PER_S * 1e3,
            bound_with_partials_ms=(fused_bound_bytes(lanes, c) + partials_bytes(plan, s)) / HBM_BYTES_PER_S * 1e3,
            plan=plan._asdict(),
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
    for s in TILED_SERVICES:
        c = soak_config(cfg, s)
        lanes = batch_lanes(rng, c, 4096, device, n_active=s)
        args = delta_args(lanes)
        kw = dict(num_services=s, hll_p=c.hll_p, cms_width=c.cms_width)
        k3["shapes"][f"B=4096 S={s} D={c.cms_depth}"] = dict(
            time_kernel(lambda: fused.sketch_delta_plain(*args, **kw), lambda: fused.sketch_delta(*args, **kw), 4),
            composed_ms=time_ms(lambda: fused.sketch_batch_delta(*args, **kw, impl="xla"), 4)[0],
            bound_ms=delta_bound_bytes(lanes, s, c) / HBM_BYTES_PER_S * 1e3,
            bound_with_partials_ms=(delta_bound_bytes(lanes, s, c) + partials_bytes(fused.launch_plan(4096, s), s))
            / HBM_BYTES_PER_S * 1e3,
        )
    k3.update(k3["shapes"]["B=32768 S=16 D=2"], library_ms=None)

    for name, r in results.items():
        for label, t in r["shapes"].items():
            (p1, pw), (k1_, kw_), (k2_, _), (p2, _) = t["turns"]
            extra = ""
            if "composed_ms" in t:
                extra = (f"; composed path {t['composed_ms']} ms; bound with the partials "
                         f"{t['bound_with_partials_ms']:.6f} ms")
            print(f"time {name} {label}: device kernel {k1_:.5f} / {k2_:.5f} ms, plain {p1:.5f} / "
                  f"{p2:.5f} ms; wall kernel {kw_:.5f} ms, plain {pw:.5f} ms; bound {t['bound_ms']:.6f} ms{extra}")
            print(f"  device operations per call ({name} {label}): {show_breakdown(t['breakdown'])}")
    print(f"time torch.bincount (yardstick of cms_hist): device {k2['library_ms']} ms "
          f"({show_breakdown(k2['library_breakdown'])}), wall {k2['library_wall_ms']:.5f} ms")


def mesh_on_cards(n_cards: int, phases: Phases) -> int:
    """The four-rank mesh leg with NCCL between ``n_cards`` cards, held
    against the single-device step on card 0; no other phase."""
    from opentelemetry_demo_tpu_torch.models import DetectorConfig

    check(n_cards == 4, "the mesh leg is a (2 × 2) layout of four ranks")
    check(torch.cuda.device_count() >= n_cards, f"{torch.cuda.device_count()} cards, not {n_cards}")
    card = gpu_line()
    print(f"card: {card} (x{torch.cuda.device_count()}); torch {torch.__version__} cuda {torch.version.cuda}")
    phases("phase_build", phase_build)
    results = {"sketch_delta": {}}
    mesh = phases("phase_mesh_four_ranks", phase_mesh_four_ranks, DetectorConfig(), torch.device("cuda"), results,
                  backend="nccl")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_nccl.json").write_text(json.dumps(
        {"card": card, "count": torch.cuda.device_count(), "mesh": mesh,
         "wall_s": time.perf_counter() - phases.t_start}, indent=1, default=str))
    print(f"total {time.perf_counter() - phases.t_start:.1f} s")
    print(phases.walls_line())
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def run(args, phases: Phases) -> int:
    """Every phase, each through ``phases``; the result lines."""
    # The composed path's segment stats are a float32 matmul: keep it in
    # full float32 (PyTorch's default, stated here).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    from opentelemetry_demo_tpu_torch.models import DetectorConfig

    cfg = DetectorConfig()
    if args.times_only:
        phases("phase_build", phase_build)
        results = {name: {} for name in ("fused_update", "cms_hist", "sketch_delta")}
        phases("phase_times", phase_times, cfg, device, results)
        Path(args.times_only).write_text(json.dumps({"card": card, "root": str(ROOT), "times": results},
                                                    indent=1, default=str))
        print(card)
        return 0
    results: dict[str, dict] = {}
    phases("phase_build", phase_build)
    phases("phase_fused_update", phase_fused_update, cfg, device, results)
    phases("phase_cms_hist", phase_cms_hist, cfg, device, results)
    phases("phase_sketch_delta", phase_sketch_delta, cfg, device, results)
    phases("phase_detector_vs_cpu", phase_detector_vs_cpu, device)
    e2e = [
        phases("phase_end_to_end[2048]", phase_end_to_end, device, None, 2048, n_warm=40, n_fault=4,
               bodies_per_batch=1, results=results),
        phases("phase_end_to_end[65536,xla]", phase_end_to_end, device, "xla", 65536, n_warm=24, n_fault=3,
               bodies_per_batch=8, results=results),
    ]
    for leg in e2e:
        leg["step_device_ms"], leg["step_wall_ms"], leg["step_ops"] = phases(
            f"phase_step_time[{leg['width']}]", phase_step_time, device, leg["impl"], leg["width"])
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
    native_rec = dict(decode=phases("phase_native_decode", phase_native_decode))
    native_rec["e2e"] = [
        phases("phase_native_e2e[2048]", phase_native_e2e, device, None, 2048, n_warm=40, n_fault=4,
               bodies_per_batch=1, results=results),
        phases("phase_native_e2e[65536,xla]", phase_native_e2e, device, "xla", 65536, n_warm=24, n_fault=3,
               bodies_per_batch=8, results=results),
    ]
    native_rec["spine_guard"] = phases("phase_spine_guard", phase_spine_guard, device)
    native_rec["overload"] = phases("phase_overload", phase_overload, device,
                                    native_rec["e2e"][0]["spans_per_s"])
    native_rec["lag"] = phases("phase_lag", phase_lag, device)
    doors = phases("phase_doors", phase_doors, device, results)
    orders = phases("phase_orders", phase_orders, device, results)
    read_side = phases("phase_read_side", phase_read_side, device, results)
    time_travel = dict(history=phases("phase_history", phase_history, device, results),
                       quality=phases("phase_quality", phase_quality, device, results),
                       mitigation=phases("phase_mitigation", phase_mitigation, device, results))
    fleet = phases("phase_fleet", phase_fleet, device, results)
    daemon = phases("phase_daemon", phase_daemon, device, results)
    shop = phases("phase_shop", phase_shop, device, results)
    stack = phases("phase_stack", phase_stack, device, results)
    deploy = phases("phase_deploy", phase_deploy, device)
    bench_rec = phases("phase_bench", phase_bench, device, results)
    state = dict(
        checkpoint=[phases("phase_checkpoint[fused]", phase_checkpoint, device, None, cfg.cms_width, results),
                    phases("phase_checkpoint[xla]", phase_checkpoint, device, "xla", 16384, results)],
        metrics_head=phases("phase_metrics_head", phase_metrics_head, device),
        keyspace=phases("phase_keyspace", phase_keyspace, device, results),
    )
    mesh = phases("phase_mesh_one_rank", phase_mesh_one_rank, cfg, device)
    mesh.update(phases("phase_mesh_four_ranks", phase_mesh_four_ranks, cfg, device, results))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    phases("phase_times", phase_times, cfg, device, results)

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
            launches_orders=r.get("launches_orders"), launches_read=r.get("launches_read"),
            launches_history=r.get("launches_history"), launches_quality=r.get("launches_quality"),
            launches_fleet=r.get("launches_fleet"), launches_daemon=r.get("launches_daemon"),
            launches_shop=r.get("launches_shop"), launches_stack=r.get("launches_stack"),
            launches_bench=r.get("launches_bench"),
        ))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "repeat": results, "e2e": e2e, "native": native_rec,
         "doors": doors, "orders": orders, "read_side": read_side, "time_travel": time_travel,
         "fleet": fleet, "daemon": daemon, "shop": shop, "stack": stack, "deploy": deploy, "bench": bench_rec,
         "state": state, "mesh": mesh, "phase_walls_s": phases.walls,
         "wall_s": time.perf_counter() - phases.t_start}, indent=1, default=str))
    print(f"total {time.perf_counter() - phases.t_start:.1f} s")
    print(phases.walls_line())
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
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
    phases = Phases()
    try:
        if args.nccl_cards:
            return mesh_on_cards(args.nccl_cards, phases)
        return run(args, phases)
    except Exception as exc:
        phases.failed(exc)
        return 1


if __name__ == "__main__":
    sys.exit(main())
