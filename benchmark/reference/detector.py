"""The detector step in plain NumPy: the yardstick a served run is held to.

Per service it keeps HyperLogLog registers and the Count-Min table in a
{current, previous} bank per tumbling window, and EWMA means and
variances of log-latency, error rate and span rate at several
timescales, CUSUM accumulators and a cardinality EWMA per window. One
:meth:`ReferenceDetector.step` takes one dispatched batch and returns
the step's per-service score (the largest of each signal's statistic
over its threshold) and its flags (score above 1).

The order of a step: the distinct count of every window that just
completed feeds the cardinality EWMA; those windows' banks rotate; the
batch folds into every current bank and advances the heads; the flags
read the heads' z-scores and the CUSUM. All float state is float32;
per-service sums over a batch are taken exactly and rounded once.

``precision="bf16"`` rounds every float result of the heads and the
cardinality EWMA to bfloat16 instead: the control that a comparison has
to fail.
"""

from __future__ import annotations

import numpy as np

from .hashing import cms_cells, hll_cells

F32 = np.float32
# The latency z's sigma floor, 0.15 squared, rounded to float32.
LAT_FLOOR2 = F32(0.15 * 0.15)


def bf16(x) -> np.ndarray:
    """Round float32 values to the nearest bfloat16 (ties to even),
    kept in float32 storage."""
    a = np.ascontiguousarray(x, F32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + np.uint64(0x7FFF) + ((u >> np.uint64(16)) & np.uint64(1))) & np.uint64(0xFFFF0000)
    out = u.astype(np.uint32).view(F32)
    return np.where(np.isfinite(a), out, a).reshape(np.shape(x))


class WindowClock:
    """(dt, rotate) per dispatch: ``rotate[w]`` is set when window ``w``
    has a boundary in ``(t_prev, t_now]``; the first tick gives
    dt = 1 ms and no rotation."""

    def __init__(self, windows_s):
        self.windows_s = np.asarray(windows_s, np.float64)
        self.t_prev = None

    def tick(self, t_now: float) -> tuple[np.float32, np.ndarray]:
        if self.t_prev is None:
            self.t_prev = float(t_now)
            return F32(1e-3), np.zeros(len(self.windows_s), bool)
        dt = max(float(t_now) - self.t_prev, 1e-3)
        rotate = np.floor(t_now / self.windows_s) > np.floor(self.t_prev / self.windows_s)
        self.t_prev = float(t_now)
        return F32(dt), rotate


def hll_estimate(regs: np.ndarray) -> np.ndarray:
    """Bias-corrected HyperLogLog estimate over the last axis, with the
    small-range linear-counting correction, in float32."""
    m = F32(regs.shape[-1])
    alpha = F32(0.7213) / (F32(1.0) + F32(1.079) / m)
    inv_sum = np.sum(np.exp2(-regs.astype(F32)), axis=-1, dtype=np.float64).astype(F32)
    raw = alpha * m * m / inv_sum
    zeros = np.sum(regs == 0, axis=-1).astype(F32)
    lc = m * np.log(m / np.maximum(zeros, F32(1.0)), dtype=F32)
    return np.where((raw <= F32(2.5) * m) & (zeros > 0), lc, raw).astype(F32)


class ReferenceDetector:
    """The detector's state and step. ``geometry`` holds the
    configuration's ``detector`` block (services, HLL precision, CMS
    shape, windows, timescales and thresholds)."""

    HEADS = ("lat_mean", "lat_var", "err_mean", "rate_mean", "rate_var",
             "card_mean", "card_var", "cusum")
    COUNTS = ("hll_bank", "cms_bank", "span_total", "obs_batches", "obs_windows", "step_idx")

    def __init__(self, geometry: dict, precision: str = "fp32"):
        g = geometry
        self.s = int(g["num_services"])
        self.p = int(g["hll_p"])
        self.d = int(g["cms_depth"])
        self.w = int(g["cms_width"])
        self.taus = [float(t) for t in g["taus_s"]]
        self.nw = len(g["windows_s"])
        self.thr = F32(g["z_threshold"])
        self.card_alpha = F32(g["card_alpha"])
        self.warmup = F32(g["warmup_batches"])
        self.z_warmup = F32(g["z_warmup_batches"])
        self.warmup_windows = F32(g["warmup_windows"])
        self.cusum_k = F32(g["cusum_k"])
        self.cusum_h = F32(g["cusum_h"])
        self.cusum_h_rate = F32(g["cusum_h_rate"])
        self.cusum_cap = F32(g["cusum_cap"])
        self.err_slack = F32(g["err_slack"])
        self.q = bf16 if precision == "bf16" else (lambda x: np.asarray(x, F32))
        self.clock = WindowClock(g["windows_s"])
        s, t, nw = self.s, len(self.taus), self.nw
        z = lambda *shape: np.zeros(shape, F32)  # noqa: E731
        self.hll_bank = np.zeros((nw, 2, s, 1 << self.p), np.int32)
        self.cms_bank = np.zeros((nw, 2, self.d, self.w), np.int32)
        self.span_total = z(nw, 2)
        self.lat_mean, self.lat_var, self.err_mean = z(s, t), z(s, t), z(s, t)
        self.rate_mean, self.rate_var = z(s, t), z(s, t)
        self.card_mean, self.card_var = z(s, nw), z(s, nw)
        self.obs_batches, self.obs_windows = z(s), z(s, nw)
        self.cusum = z(s, 3)
        self.step_idx = 0

    def state(self) -> dict:
        out = {k: getattr(self, k) for k in self.HEADS + self.COUNTS}
        out["step_idx"] = np.int32(self.step_idx)
        return out

    # -- one step -----------------------------------------------------

    def step(self, t_now: float, slot, lat_us, is_error, trace_key, attr_crc):
        """Fold one batch (its valid rows) in; return (score[S], flags[S])."""
        q = self.q
        dt, rotate = self.clock.tick(t_now)
        card_z = self._harvest_cardinality(rotate)
        for bank in (self.hll_bank, self.cms_bank, self.span_total):
            bank[rotate, 1] = bank[rotate, 0]
            bank[rotate, 0] = 0
        slot = np.asarray(slot, np.int64)
        self._absorb_sketches(slot, trace_key, attr_crc)
        log_lat = np.log1p(np.maximum(np.asarray(lat_us, F32), F32(0.0))).astype(F32)
        err = np.asarray(is_error, F32)
        ll = log_lat.astype(np.float64)
        stats = [np.bincount(slot, weights=w, minlength=self.s)[: self.s].astype(F32)
                 for w in (None, ll, ll * ll, err.astype(np.float64))]
        lat_z, err_z, rate_z = self._heads(stats, dt, q)
        self.span_total[:, 0] = self.span_total[:, 0] + F32(slot.shape[0])
        self.step_idx += 1
        thr = self.thr
        score = np.maximum.reduce([
            np.abs(lat_z).max(1) / thr, np.abs(err_z).max(1) / thr,
            np.abs(rate_z).max(1) / thr, np.abs(card_z).max(1) / thr,
            self.cusum[:, 0] / self.cusum_h, self.cusum[:, 1] / self.cusum_h,
            self.cusum[:, 2] / self.cusum_h_rate,
        ]).astype(F32)
        flags = ((np.abs(lat_z) > thr).any(1) | (np.abs(err_z) > thr).any(1)
                 | (np.abs(rate_z) > thr).any(1) | (np.abs(card_z) > thr).any(1)
                 | (self.cusum[:, 0] > self.cusum_h) | (self.cusum[:, 1] > self.cusum_h)
                 | (self.cusum[:, 2] > self.cusum_h_rate))
        return score, flags

    def _harvest_cardinality(self, rotate: np.ndarray) -> np.ndarray:
        """Windows that completed feed their distinct count into the
        cardinality EWMA; returns card_z[S, W#]."""
        q = self.q
        card_z = np.zeros((self.s, self.nw), F32)
        for w in np.nonzero(rotate)[0]:
            x = hll_estimate(self.hll_bank[w, 0])
            obs = x > F32(0.5)
            cm, cv, ow = self.card_mean[:, w], self.card_var[:, w], self.obs_windows[:, w]
            delta = q(x - cm)
            floor = q(F32(0.05) * cm)
            z = q(delta / q(np.sqrt(q(q(cv + q(floor * floor)) + F32(10.0)))))
            card_z[:, w] = np.where(obs & ~(ow < self.warmup_windows), z, F32(0.0))
            a = np.maximum(q(F32(1.0) / (ow + F32(1.0))), self.card_alpha)
            new_m = q(cm + q(a * delta))
            new_v = q(q(F32(1.0) - a) * q(cv + q(q(a * delta) * delta)))
            self.card_mean[:, w] = np.where(obs, new_m, cm)
            self.card_var[:, w] = np.where(obs, new_v, cv)
            self.obs_windows[:, w] = ow + obs.astype(F32)
        return card_z

    def _absorb_sketches(self, slot, trace_key, attr_crc) -> None:
        r = 1 << self.p
        bucket, rank = hll_cells(np.asarray(trace_key, np.uint64), self.p)
        cell = slot * r + bucket
        order = np.lexsort((rank, cell))
        cell, rank = cell[order], rank[order]
        last = np.r_[cell[1:] != cell[:-1], True]
        cell, rank = cell[last], rank[last]
        for w in range(self.nw):
            cur = self.hll_bank[w, 0].reshape(-1)
            cur[cell] = np.maximum(cur[cell], rank)
        idx = cms_cells(np.asarray(attr_crc, np.uint64), slot, self.d, self.w)
        flat = (idx + (np.arange(self.d, dtype=np.int64) * self.w)[:, None]).reshape(-1)
        counts = np.bincount(flat, minlength=self.d * self.w).astype(np.int32).reshape(self.d, self.w)
        self.cms_bank[:, 0] += counts[None]

    def _heads(self, stats, dt, q):
        """The EWMA/CUSUM advance of one batch; returns (lat_z, err_z, rate_z)."""
        cnt, lat_sum, lat_sumsq, err_sum = stats
        one, zero = F32(1.0), F32(0.0)
        alphas = np.array([q(one - q(np.exp(q(-dt / F32(t))))) for t in self.taus], F32)
        obs = self.obs_batches
        seen = cnt > 0
        obs2d = seen[:, None]
        warm = (obs < self.warmup)[:, None]
        z_warm = (obs < self.z_warmup)[:, None]
        cnt1 = np.maximum(cnt, one)
        n = cnt1[:, None]
        debias = q(one / q(obs[:, None] + one))
        alphas = np.maximum(alphas[None, :], debias)
        alpha_var = np.maximum(q(one - q(np.exp(q(-dt / F32(max(self.taus)))))), debias)

        mu, sigma2 = self.lat_mean, self.lat_var
        xbar = q(lat_sum / cnt1)[:, None]
        lat_z = q(q(xbar - mu) / q(np.sqrt(q(q(sigma2 / n) + LAT_FLOOR2))))
        lat_z_cusum = np.where(obs2d & ~warm, lat_z, zero)
        lat_z = np.where(obs2d & ~z_warm, lat_z, zero)
        lat_mean = np.where(obs2d, q(mu + q(alphas * q(xbar - mu))), mu)
        v_obs = q(q(q(lat_sumsq / cnt1)[:, None] - q(q(F32(2.0) * lat_mean) * xbar))
                  + q(lat_mean * lat_mean))
        lat_var = np.where(obs2d, q(sigma2 + q(alpha_var * q(np.maximum(v_obs, zero) - sigma2))), sigma2)

        p = self.err_mean
        err_cnt = err_sum[:, None]
        err_z = q(q(err_cnt - q(n * p)) / q(np.sqrt(q(q(q(n * p) * q(one - p)) + one))))
        err_z = np.where(obs2d & ~z_warm, err_z, zero)
        phat = q(err_cnt / n)
        err_mean = np.where(obs2d, q(p + q(alphas * q(phat - p))), p)

        lam = self.rate_mean
        dt_c = np.maximum(dt, F32(1e-3))
        expected = q(lam * dt_c)
        emp_var = q(q(self.rate_var * dt_c) * dt_c)
        rate_obs = (seen | (obs > 0))[:, None] & (self.step_idx > 0)
        rate_z = q(q(cnt[:, None] - expected) / q(np.sqrt(q(np.maximum(expected, emp_var) + one))))
        rate_z_cusum = np.where(rate_obs & ~warm, rate_z, zero)
        rate_z = np.where(rate_obs & ~z_warm, rate_z, zero)
        rate_x = q(cnt / dt_c)[:, None]
        dx = q(rate_x - lam)
        rate_mean = np.where(rate_obs, q(lam + q(alphas * dx)), lam)
        rate_var = np.where(rate_obs, q(self.rate_var + q(alpha_var * q(q(dx * dx) - self.rate_var))),
                            self.rate_var)

        active = seen & ~warm[:, 0]
        s_lat = np.where(active, q(lat_z_cusum[:, -1] - self.cusum_k), zero)
        p_ref = err_mean[:, -1]
        err_sigma = q(np.sqrt(q(q(q(n[:, 0] * p_ref) * q(one - p_ref)) + one)))
        s_err = np.where(
            active,
            q(q(q(err_cnt[:, 0] - q(n[:, 0] * q(p_ref + self.err_slack))) / err_sigma) - self.cusum_k),
            zero,
        )
        s_rate = np.where(rate_obs[:, 0] & ~warm[:, 0], q(-rate_z_cusum[:, -1] - self.cusum_k), zero)
        scores = np.stack([s_lat, s_err, s_rate], axis=1)
        self.cusum = np.clip(q(self.cusum + scores), zero, self.cusum_cap).astype(F32)
        self.lat_mean, self.lat_var = lat_mean.astype(F32), lat_var.astype(F32)
        self.err_mean, self.rate_mean, self.rate_var = (
            err_mean.astype(F32), rate_mean.astype(F32), rate_var.astype(F32))
        self.obs_batches = obs + seen.astype(F32)
        return lat_z.astype(F32), err_z.astype(F32), rate_z.astype(F32)
