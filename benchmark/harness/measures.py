"""The run's record, from which every metric is read.

End to end (taken here, from the host clock):

- ``spans_per_s``: spans whose batches a report harvested inside the
  window covers, over the window's seconds. A report covers its own
  batch and every earlier one (the state it was read from holds them);
  a batch whose own report was skipped is covered by the next one read.
- ``lag_p50_ms`` / ``lag_p99_ms``: over every body offered in the
  window, from its due time to the harvest of the first report that
  covers its last span (a body that lost its last span to shedding
  counts as infinitely late).
- ``setup_s``: process start to the first timed body.
"""

from __future__ import annotations

import math

import numpy as np


def record(run: dict) -> dict:
    """Everything the metric readers read."""
    w = run["window"]
    t0, t1, seconds = w["t_start"], w["t_close"], w["seconds"]
    all_batches = w["batch_cols"]
    t_now = np.array([b[1] for b in all_batches], np.float64)
    from .judge import map_rows, match_reports

    rep = w["reports"]
    matched = match_reports(t_now, [r[1] for r in rep])
    # A batch is covered by the first report read at or after it.
    read_at = np.full(t_now.shape[0], np.inf)
    read_at[matched] = [r[0] for r in rep]
    cover = np.minimum.accumulate(read_at[::-1])[::-1]
    rows = np.array([len(b[2]) for b in all_batches], np.int64)
    in_window = (cover >= t0) & (cover <= t1)
    spans_done = int(rows[in_window].sum())

    # Lag: each timed body's last span → its batch → the covering report.
    bounds, stream, corpus = w["bounds"], w["stream"], w["corpus"]
    row_of = map_rows(corpus, stream)
    # Occurrences of each corpus row in dispatch order.
    order = np.argsort(row_of, kind="stable")
    sorted_rows = row_of[order]
    offered = [lg for lg in w["logs"] if lg.due <= t1]
    seen_count: dict[int, int] = {}
    lags, admits = [], []
    for lg in sorted(offered, key=lambda lg: lg.admitted if not math.isnan(lg.admitted) else math.inf):
        last = int(w["timed"][lg.body].rows[-1])
        k = seen_count.get(last, 0)
        seen_count[last] = k + 1
        lo = np.searchsorted(sorted_rows, last, "left")
        hi = np.searchsorted(sorted_rows, last, "right")
        if lo + k < hi:
            pos = order[lo + k]
            batch = int(np.searchsorted(bounds, pos, "right") - 1)
            lags.append((cover[batch] - lg.due) * 1e3)
        else:
            lags.append(math.inf)
        admits.append((lg.resolved - lg.due) * 1e3)
    lags_a = np.array(lags, np.float64)
    attempted = int(sum(len(w["timed"][lg.body].rows) for lg in offered))
    return dict(
        seconds=seconds, t_start=t0, t_close=t1, setup_s=w["setup_s"],
        spans_done=spans_done, spans_per_s=spans_done / seconds,
        lag_ms=lags_a, admit_ms=np.array(admits, np.float64),
        attempted=attempted, failed=int(w["shed"]),
        bodies=len(offered), refusals=int(sum(lg.refusals for lg in offered)),
        batch_times=np.array([b[0] for b in all_batches]),
        batch_width=np.array([b[7] for b in all_batches], np.int64),
        batch_cols=all_batches,
        pool_phase_s=w["pool_phase_s"], pool_spans=w["pool_spans"],
        phase_events=w["phase_events"], device=w["device"], cfg=w["cfg"],
        stats=w["stats"], backlog=w["backlog"], pump_spans=w["pump_spans"],
    )


def phase_mean(rec: dict, phase: str) -> float | None:
    """Mean ms of one ``phase_observe`` phase over the window (count too)."""
    dts = [dt for name, _t, dt in rec["phase_events"] if name == phase]
    return [len(dts), float(np.mean(dts)) * 1e3] if dts else None


def percentile(x: np.ndarray, q: float) -> float:
    """The q-th percentile; a body that never got its verdict counts as
    the largest float (it misses any limit)."""
    if x.size == 0:
        return math.nan
    return float(np.percentile(np.where(np.isfinite(x), x, np.finfo(np.float64).max), q))


def end_to_end(rec: dict) -> dict:
    return {
        "spans_per_s": rec["spans_per_s"],
        "lag_p50_ms": percentile(rec["lag_ms"], 50),
        "lag_p99_ms": percentile(rec["lag_ms"], 99),
        "setup_s": rec["setup_s"],
    }
