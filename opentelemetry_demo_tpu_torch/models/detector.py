"""The streaming anomaly detector: multi-window sketch bank + z-score heads.

Per service it flags latency, error-rate and throughput anomalies (EWMA
z-scores at several timescales plus CUSUM accumulators), cardinality
anomalies (HLL distinct trace ids per tumbling window) and heavy-hitter
attributes (CMS count share per window).

All memory lives in one :class:`DetectorState` of device tensors and
advances by :func:`detector_step`, which — unlike the reference's
functional, donated jit step — **updates the state in place** and
returns it. Its layout, the packed report and the config are the
reference's, so state carries over both ways (:func:`state_from_numpy`,
:func:`state_to_numpy`) and the reference's ``report_unpack`` reads the
packed report unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import cms, fused, hll
from ..ops.collectives import NO_COMM, Comm
from ..runtime.tensorize import TensorBatch
from .windows import WindowClock

# Heavy-hitter candidate cap: spans queried against the CMS per step.
# Past it, candidates come from an evenly spread subsample; counts stay
# exact (the full table absorbed every span).
HH_QUERY_CAP = 16384


def hh_sample_indices(b_total: int, bq: int) -> np.ndarray:
    """Evenly-distributed candidate indices ``(i·B)//BQ`` for i<BQ, in
    host int64 (an int32 product overflows from i=4096 at B=512k).
    :func:`detector_step` forms the same indices on the device in int64."""
    return (np.arange(bq, dtype=np.int64) * b_total // bq).astype(np.int32)


class DetectorConfig(NamedTuple):
    """Static shape/threshold configuration, field for field the
    reference's (checkpoints persist ``list(config)`` positionally, so
    new fields append at the end)."""

    num_services: int = 32
    hll_p: int = 12
    cms_depth: int = 4
    cms_width: int = 8192
    windows_s: tuple[float, ...] = (1.0, 10.0, 60.0)  # tumbling (HLL/CMS)
    taus_s: tuple[float, ...] = (1.0, 10.0, 60.0)  # EWMA timescales
    z_threshold: float = 6.0
    card_alpha: float = 0.3  # EWMA weight per completed window
    warmup_batches: float = 20.0  # CUSUM suppressed until this many obs
    z_warmup_batches: float = 60.0  # single-batch z suppressed until then
    warmup_windows: float = 5.0
    eps: float = 1e-6
    cusum_k: float = 0.5  # per-batch drift toward zero
    cusum_h: float = 5.0  # alarm threshold (latency↑ / error↑ lanes)
    cusum_cap: float = 50.0  # bound accumulation (bounded recovery time)
    err_slack: float = 0.01  # tolerated error-rate above baseline
    # None: the fused kernel on CUDA, the composed path elsewhere;
    # "xla" / "pallas" / "interpret" force a path (see ops.fused).
    sketch_impl: str | None = None
    cusum_h_rate: float = 8.0  # rate↓ lane threshold (higher: count noise)

    @property
    def num_windows(self) -> int:
        return len(self.windows_s)

    @property
    def cusum_thresholds(self) -> tuple[float, float, float]:
        """Per-lane alarm thresholds in cusum column order
        {lat↑, err↑, rate↓}."""
        return (self.cusum_h, self.cusum_h, self.cusum_h_rate)

    @property
    def num_taus(self) -> int:
        return len(self.taus_s)


class DetectorState(NamedTuple):
    """All detector memory, as device tensors.

    Axis glossary: W#=tumbling windows, S=services, R=HLL registers,
    D×C=CMS rows×counters, T=EWMA timescales. ``[W#, 2, ...]`` banks hold
    {0: current, 1: previous} per window.
    """

    hll_bank: torch.Tensor  # int32[W#, 2, S, R]
    cms_bank: torch.Tensor  # int32[W#, 2, D, C]
    span_total: torch.Tensor  # float32[W#, 2] — spans per window bank
    lat_mean: torch.Tensor  # float32[S, T]
    lat_var: torch.Tensor  # float32[S, T]
    err_mean: torch.Tensor  # float32[S, T]
    rate_mean: torch.Tensor  # float32[S, T]
    rate_var: torch.Tensor  # float32[S, T]
    card_mean: torch.Tensor  # float32[S, W#]
    card_var: torch.Tensor  # float32[S, W#]
    obs_batches: torch.Tensor  # float32[S] — batches seen per service
    obs_windows: torch.Tensor  # float32[S, W#] — completed windows seen
    cusum: torch.Tensor  # float32[S, 3] — {lat↑, err↑, rate↓} accumulators
    step_idx: torch.Tensor  # int32[] — steps taken


class DetectorReport(NamedTuple):
    """Per-step detection output (tensors from :func:`detector_step`,
    numpy arrays from :func:`report_unpack`)."""

    lat_z: torch.Tensor  # float32[S, T]
    err_z: torch.Tensor  # float32[S, T]
    rate_z: torch.Tensor  # float32[S, T]
    card_z: torch.Tensor  # float32[S, W#]
    card_est: torch.Tensor  # float32[S, W#] — completed-window distinct count
    hh_ratio: torch.Tensor  # float32[S, W#] — max attr share of window traffic
    svc_count: torch.Tensor  # float32[S] — valid spans this batch
    cusum: torch.Tensor  # float32[S, 3]
    flags: torch.Tensor  # bool[S] — any signal over threshold


_BOOL_REPORT_FIELDS = {"flags"}  # carried as f32 on the packed wire

_REPORT_FIELD_SHAPES = {
    "lat_z": lambda c: (c.num_services, c.num_taus),
    "err_z": lambda c: (c.num_services, c.num_taus),
    "rate_z": lambda c: (c.num_services, c.num_taus),
    "card_z": lambda c: (c.num_services, c.num_windows),
    "card_est": lambda c: (c.num_services, c.num_windows),
    "hh_ratio": lambda c: (c.num_services, c.num_windows),
    "svc_count": lambda c: (c.num_services,),
    "cusum": lambda c: (c.num_services, 3),
    "flags": lambda c: (c.num_services,),
}


def _report_shapes(config: DetectorConfig) -> list[tuple[int, ...]]:
    return [_REPORT_FIELD_SHAPES[name](config) for name in DetectorReport._fields]


def report_pack(report: DetectorReport) -> torch.Tensor:
    """Flatten the report to ONE float32 device vector (one copy to the
    host at harvest), in the reference's layout."""
    return torch.cat(
        [getattr(report, name).to(torch.float32).reshape(-1) for name in DetectorReport._fields]
    )


def report_unpack(flat, config: DetectorConfig) -> DetectorReport:
    """Host-side inverse of :func:`report_pack` (numpy fields)."""
    flat = np.asarray(flat)
    fields = []
    pos = 0
    for name, shape in zip(DetectorReport._fields, _report_shapes(config)):
        n = int(np.prod(shape))
        leaf = flat[pos:pos + n].reshape(shape)
        if name in _BOOL_REPORT_FIELDS:
            leaf = leaf > 0.5
        fields.append(leaf)
        pos += n
    if pos != flat.size:
        raise ValueError(
            f"packed report length {flat.size} != expected {pos} "
            "(DetectorReport layout drifted from _REPORT_FIELD_SHAPES?)"
        )
    return DetectorReport(*fields)


def detector_init(
    config: DetectorConfig, device: "torch.device | str | None" = None
) -> DetectorState:
    """A zeroed detector state on ``device`` (the card unless the caller
    names another)."""
    device = resolve_device(device)
    nw, s, t = config.num_windows, config.num_services, config.num_taus

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return DetectorState(
        hll_bank=hll.hll_init(s, p=config.hll_p, leading=(nw, 2), device=device),
        cms_bank=cms.cms_init(
            config.cms_depth, config.cms_width, leading=(nw, 2), device=device
        ),
        span_total=zeros(nw, 2),
        lat_mean=zeros(s, t),
        lat_var=zeros(s, t),
        err_mean=zeros(s, t),
        rate_mean=zeros(s, t),
        rate_var=zeros(s, t),
        card_mean=zeros(s, nw),
        card_var=zeros(s, nw),
        obs_batches=zeros(s),
        obs_windows=zeros(s, nw),
        cusum=zeros(s, 3),
        step_idx=zeros(dtype=torch.int32),
    )


def state_from_numpy(
    state_np, device: "torch.device | str | None" = None
) -> DetectorState:
    """A detector state pulled to numpy (by field name, e.g. the
    reference's ``DetectorState`` after ``jax.device_get``) → this
    package's state on ``device`` (the card unless the caller names
    another), bit for bit."""
    device = resolve_device(device)
    return DetectorState(
        **{
            name: torch.from_numpy(np.array(getattr(state_np, name), copy=True)).to(device)
            for name in DetectorState._fields
        }
    )


def state_to_numpy(state: DetectorState) -> DetectorState:
    """This package's state → numpy arrays with the same fields, dtypes
    and bits (for the reference's ``DetectorState(**...)``). The arrays
    are copies: the step updates the state in place, and a snapshot must
    not move with it."""
    return DetectorState(*(t.detach().to("cpu", copy=True).numpy() for t in state))


def _rotate(bank: torch.Tensor, mask: torch.Tensor) -> None:
    """In place, where ``mask``: prev ← cur, cur ← 0."""
    m = mask.view(-1, *([1] * (bank.dim() - 2)))
    bank[:, 1].copy_(torch.where(m, bank[:, 0], bank[:, 1]))
    bank[:, 0].masked_fill_(m, 0)


def detector_step(
    config: DetectorConfig,
    state: DetectorState,
    svc: torch.Tensor,  # int32[B]
    lat_us: torch.Tensor,  # float32[B]
    is_error: torch.Tensor,  # float32[B]
    trace_hi: torch.Tensor,  # int32[B] — uint32 bits
    trace_lo: torch.Tensor,  # int32[B]
    attr_hi: torch.Tensor,  # int32[B]
    attr_lo: torch.Tensor,  # int32[B]
    valid: torch.Tensor,  # bool[B]
    dt: torch.Tensor,  # float32[] — seconds since previous batch
    rotate: torch.Tensor,  # bool[W#] — window boundary crossed
    comm: Comm = NO_COMM,
) -> tuple[DetectorState, DetectorReport]:
    """One detector update, **in place** on ``state`` (which is also
    returned), plus the step's report.

    Order is fixed, as in the reference: (1) harvest the cardinality of
    windows that just completed into the card EWMA, (2) rotate banks
    where ``rotate`` is set, (3) absorb the batch into every current
    bank and the EWMA/CUSUM heads, then heavy hitters and flags. Nothing
    here reads a device value on the host, so the step runs
    asynchronously on the card.

    Sharded (``parallel.make_sharded_step``): the same function runs on
    every rank with a real ``comm``. The state then holds this rank's
    slice (service axis of HLL and heads, depth axis of CMS) and the
    batch arrays this rank's batch shard; service and row ids are global
    on the wire and localised here through ``comm.sketch_index()``. Any
    comm but :data:`NO_COMM` — even on a 1 × 1 mesh — takes the delta
    path: the batch's standalone delta crosses the batch-axis reductions
    before it is merged into the banks and advances the heads.
    """
    # Local shard geometry, from the state itself.
    s_axis = state.lat_mean.shape[0]
    d_local = state.cms_bank.shape[-2]
    shard = comm.sketch_index()
    # Global → local service ids; out-of-slice ids become s_axis, which
    # every scatter drops and every one-hot misses.
    svc = svc.to(torch.int64) - shard * s_axis
    svc = torch.where((svc >= 0) & (svc < s_axis), svc, s_axis)
    valid_f = valid.to(torch.float32)

    # ---- 1. harvest cardinality of windows that just completed -------
    card_x = hll.hll_estimate(state.hll_bank[:, 0]).T  # [S, W#]
    card_obs = rotate[None, :] & (card_x > 0.5)
    card_warm = state.obs_windows < config.warmup_windows
    cm, cv = state.card_mean, state.card_var
    card_delta = card_x - cm
    floor = 0.05 * cm
    card_z = card_delta / torch.sqrt(cv + floor * floor + 10.0)
    card_z = torch.where(card_obs & ~card_warm, card_z, 0.0)
    a_card = torch.clamp(1.0 / (state.obs_windows + 1.0), min=config.card_alpha)
    card_mean = torch.where(card_obs, cm + a_card * card_delta, cm)
    card_var = torch.where(
        card_obs, (1.0 - a_card) * (cv + a_card * card_delta * card_delta), cv
    )
    state.card_mean.copy_(card_mean)
    state.card_var.copy_(card_var)
    state.obs_windows.add_(card_obs.to(torch.float32))

    # ---- 2. rotate tumbling banks ------------------------------------
    _rotate(state.hll_bank, rotate)
    _rotate(state.cms_bank, rotate)
    _rotate(state.span_total, rotate)

    # ---- 3. absorb the batch into the banks and the heads ------------
    # The latency head works in log space: a k× degradation is a clean
    # +ln(k) shift at every timescale.
    log_lat = torch.log1p(torch.clamp(lat_us, min=0.0))
    # CMS rows are hash-independent, so the sketch axis shards the depth:
    # this rank updates its own rows with the matching global row hashes.
    cidx = cms.cms_indices(attr_hi, attr_lo, config.cms_depth, config.cms_width)
    cidx = cidx[shard * d_local:(shard + 1) * d_local]
    impl = fused.resolve_impl(config.sketch_impl, svc.device)
    heads = fused.HeadState(
        lat_mean=state.lat_mean,
        lat_var=state.lat_var,
        err_mean=state.err_mean,
        rate_mean=state.rate_mean,
        rate_var=state.rate_var,
        cusum=state.cusum,
        obs_batches=state.obs_batches,
    )
    head_kw = dict(
        taus_s=tuple(config.taus_s),
        warmup_batches=config.warmup_batches,
        z_warmup_batches=config.z_warmup_batches,
        cusum_k=config.cusum_k,
        cusum_cap=config.cusum_cap,
        err_slack=config.err_slack,
    )
    lanes = (svc.to(torch.int32), log_lat, is_error, trace_hi, trace_lo, cidx, valid)
    if comm is NO_COMM:
        # One device: the batch folds into every current bank and the
        # heads in one pass. The step counter is the rate gate (step 0
        # carries a meaningless dt); it stays on the device.
        _, _, stats, _, (lat_z, err_z, rate_z) = fused.sketch_batch_update(
            state.hll_bank[:, 0],
            state.cms_bank[:, 0],
            *lanes,
            num_services=s_axis,
            hll_p=config.hll_p,
            cms_width=config.cms_width,
            impl=impl,
            heads=heads,
            dt=dt,
            step_pos=state.step_idx,
            **head_kw,
        )
        n_valid = valid_f.sum()
    else:
        # Sharded: deltas, not banks, cross the batch axis; then each rank
        # merges the same reduced delta into its banks and heads.
        delta = fused.sketch_batch_delta(
            *lanes,
            num_services=s_axis,
            hll_p=config.hll_p,
            cms_width=config.cms_width,
            impl=impl,
        )
        hll_delta = comm.pmax_batch(delta.hll)
        cms_delta = comm.psum_batch(delta.cms)
        # Float merge: always direct (see Comm.psum_batch_f32).
        stats = comm.psum_batch_f32(delta.stats)
        hll_cur, cms_cur = state.hll_bank[:, 0], state.cms_bank[:, 0]
        hll_cur.copy_(torch.maximum(hll_cur, hll_delta[None]))
        cms_cur.add_(cms_delta[None])
        n_valid = comm.psum_batch_f32(valid_f.sum().reshape(1))
        new_heads, (lat_z, err_z, rate_z) = fused.head_update(
            stats, heads, dt, state.step_idx, **head_kw
        )
        for dst, src in zip(heads, new_heads):
            dst.copy_(src)
    state.span_total[:, 0].add_(n_valid)
    cnt = stats[0]

    # ---- 3c. heavy hitters: max attr share of each current window ----
    b_total = svc.shape[0]
    bq = min(b_total, HH_QUERY_CAP)
    if bq < b_total:
        # hh_sample_indices, formed on the device in int64.
        q_idx = torch.arange(bq, dtype=torch.int64, device=svc.device) * b_total // bq
        q_svc, q_valid, q_cidx = svc[q_idx], valid_f[q_idx], cidx[:, q_idx]
    else:
        q_svc, q_valid, q_cidx = svc, valid_f, cidx
    # Row-sharded CMS query: min over local rows, then across the sketch
    # axis; batch shards each score their own spans, max-merged.
    counts = comm.pmin_sketch(cms.cms_query(state.cms_bank[:, 0], q_cidx))
    masked = counts.to(torch.float32) * q_valid[None, :]  # [W#, BQ]
    nw = counts.shape[0]
    per_svc_max = torch.zeros((nw, s_axis + 1), dtype=torch.float32, device=svc.device)
    per_svc_max.scatter_reduce_(
        1, q_svc.expand(nw, -1), masked, reduce="amax", include_self=True
    )
    # Column S holds out-of-range lanes.
    per_svc_max = comm.pmax_batch(per_svc_max[:, :s_axis])
    hh_ratio = (
        per_svc_max / torch.clamp(state.span_total[:, 0], min=1.0)[:, None]
    ).T

    # ---- flags -------------------------------------------------------
    thr = config.z_threshold
    cusum = state.cusum.clone()
    h_lat, h_err, h_rate = config.cusum_thresholds
    flags = (
        (lat_z.abs() > thr).any(dim=1)
        | (err_z.abs() > thr).any(dim=1)
        | (rate_z.abs() > thr).any(dim=1)
        | (card_z.abs() > thr).any(dim=1)
        | (cusum[:, 0] > h_lat)
        | (cusum[:, 1] > h_err)
        | (cusum[:, 2] > h_rate)
    )
    state.step_idx.add_(1)
    report = DetectorReport(
        lat_z=lat_z,
        err_z=err_z,
        rate_z=rate_z,
        card_z=card_z,
        card_est=card_x,
        hh_ratio=hh_ratio,
        svc_count=cnt,
        cusum=cusum,
        flags=flags,
    )
    return state, report


def step_args(lanes: torch.Tensor, tail: torch.Tensor) -> tuple:
    """:func:`detector_step`'s batch arguments from one int32 tensor of
    8 × B lanes (svc, lat_us, is_error, trace hi/lo, attr hi/lo, valid;
    the floats as their bits, ``valid`` as 0/1) and a tail of ``dt``'s
    bits and the rotate mask."""
    b = lanes.shape[0] // 8
    lane = [lanes[i * b:(i + 1) * b] for i in range(8)]
    f32 = torch.float32
    return (
        lane[0],
        lane[1].view(f32),
        lane[2].view(f32),
        lane[3],
        lane[4],
        lane[5],
        lane[6],
        lane[7] != 0,
        tail[0:1].view(f32).reshape(()),
        tail[1:] != 0,
    )


class AnomalyDetector:
    """Host-side driver: owns the state, the window clock and the device.

    Usage::

        det = AnomalyDetector(DetectorConfig())          # on the card
        report = det.observe(tensor_batch, t_now)        # t in seconds

    The state is updated in place each step. A batch goes to the device
    in one copy (its lanes, ``dt`` and the rotate mask packed into one
    pinned int32 buffer), so a step never waits on the card.
    """

    def __init__(
        self,
        config: DetectorConfig | None = None,
        device: "torch.device | str | None" = None,
    ):
        self.config = config or DetectorConfig()
        self.device = resolve_device(device)
        self.state = detector_init(self.config, self.device)
        self.clock = WindowClock(self.config.windows_s)

    def _args(self, batch: TensorBatch, t_now: float) -> tuple:
        dt, rotate = self.clock.tick(t_now)
        return self.pack_args(batch, dt, rotate)

    def pack_args(self, batch: TensorBatch, dt: float, rotate: np.ndarray) -> tuple:
        """Step arguments for ``batch`` with the given ``dt`` and rotate
        mask (no clock tick): one pinned buffer, one copy."""
        b = batch.batch_size
        n = 8 * b + 1 + rotate.shape[0]
        cuda = self.device.type == "cuda"
        buf = torch.empty(n, dtype=torch.int32, pin_memory=cuda)
        host = buf.numpy()
        for i, lane in enumerate(batch):
            host[i * b:(i + 1) * b] = (
                lane if lane.dtype == np.bool_ else lane.view(np.int32)
            )
        host[8 * b] = np.float32(dt).view(np.int32)
        host[8 * b + 1:] = rotate
        dev = buf.to(self.device, non_blocking=True) if cuda else buf
        return step_args(dev[:8 * b], dev[8 * b:])

    def staged_args(self, lanes: torch.Tensor, t_now: float) -> tuple:
        """Step arguments from a batch already on the device: ``lanes`` is
        one int32 tensor of 8 × B laid out as :meth:`_args` lays out a
        batch (a spine ring slot). The window clock ticks here, at
        dispatch, and only ``dt`` and the rotate mask are copied, so the
        state advances exactly as on the inline path."""
        dt, rotate = self.clock.tick(t_now)
        cuda = self.device.type == "cuda"
        buf = torch.empty(1 + rotate.shape[0], dtype=torch.int32, pin_memory=cuda)
        host = buf.numpy()
        host[0] = np.float32(dt).view(np.int32)
        host[1:] = rotate
        tail = buf.to(self.device, non_blocking=True) if cuda else buf
        return step_args(lanes, tail)

    def observe(self, batch: TensorBatch, t_now: float) -> DetectorReport:
        self.state, report = detector_step(
            self.config, self.state, *self._args(batch, t_now)
        )
        return report

    def observe_packed(self, batch: TensorBatch, t_now: float) -> torch.Tensor:
        """Like :meth:`observe`, with the report as one flat device
        vector (:func:`report_unpack` restores it on the host)."""
        return report_pack(self.observe(batch, t_now))

    def observe_staged_packed(self, lanes: torch.Tensor, t_now: float) -> torch.Tensor:
        """:meth:`observe_packed` for a batch staged on the device
        (:meth:`staged_args`). The caller orders the step after the
        lanes' copy on the stream it dispatches on."""
        self.state, report = detector_step(
            self.config, self.state, *self.staged_args(lanes, t_now)
        )
        return report_pack(report)

    def flagged_services(self, report: DetectorReport, names: list[str]) -> list[str]:
        mask = np.asarray(
            report.flags.cpu() if isinstance(report.flags, torch.Tensor) else report.flags
        )
        return [n for i, n in enumerate(names) if i < mask.shape[0] and mask[i]]
