"""Decides ``correct``: the served run's outputs against the plain reference.

What the run hands over: every batch the pipeline dispatched (its rows
as the program decoded and tensorized them, and its timebase), every
harvested report's per-service score and flags, the program's final
detector state and its service-name table. The reference starts from the
generator's spans and works out the rest itself:

1. ``decode_rows_wrong``: each dispatched row is named by (trace key,
   duration) and must be a span the generator made, with its service,
   duration, error bit, trace key and attribute CRC as the reference
   derives them from that span; each span must appear as often as its
   body was accepted, less the rows admission shed, which may come from
   the OK lane only (an error-lane span missing is wrong). Exact: limit 0.
2. The reference detector steps over the same batches in the same order
   and at the same timebase, with its own columns for every row.
   ``sketch_cells_wrong``: HLL registers, CMS counters, span totals,
   observation counts and the step count at the end. Exact: limit 0.
3. ``flags_wrong``: (report, service) pairs whose flag differs from the
   reference's, leaving out pairs whose reference score lies within
   ``FLAG_BAND`` of the threshold (there float32 summation order decides).
   Exact: limit 0.
4. ``score_gap``: the largest gap between a report's per-service score
   (each signal's statistic over its threshold, the largest) and the
   reference's, over every harvested report.
5. ``head_gap``: the largest gap between the final EWMA, CUSUM and
   cardinality heads and the reference's, in each leaf as a share of
   the reference leaf's largest magnitude.

The batch partition and the slot numbering are the program's: the pump
cuts batches by timing and the interner numbers services as they come.
The reference takes both from the run (the partition as the dispatched
rows, the numbering from the name table, itself checked in 1).
"""

from __future__ import annotations

import numpy as np

from ..reference.detector import ReferenceDetector
from ..reference.hashing import crc32_of
from .traffic import span_key

FLAG_BAND = 1e-3


def map_rows(corpus, stream: dict) -> np.ndarray:
    """Corpus row of each dispatched row (-1 where none is named)."""
    keys = corpus.span_keys()
    order = np.argsort(keys)
    sk = keys[order]
    lat_bits = np.asarray(stream["lat_us"], np.float32).view(np.uint32).astype(np.uint64)
    q = span_key(stream["trace_key"], lat_bits)
    pos = np.minimum(np.searchsorted(sk, q), sk.shape[0] - 1)
    hit = sk[pos] == q
    return np.where(hit, order[pos], -1)


def reference_columns(corpus, names_by_slot: list[str]) -> dict:
    """The detector's five columns of every corpus span, as the reference
    derives them (slots from the run's name table)."""
    c = corpus.cols
    t = corpus.table
    slot_of = {n: i for i, n in enumerate(names_by_slot)}
    svc_slot = np.array([slot_of.get(n, -1) for n in t.names], np.int64)
    values = [None] + list(corpus.attr_values)
    crc_table = crc32_of(values)
    return dict(
        slot=svc_slot[c["svc"]],
        lat_us=np.asarray(c["dur_us"], np.float32),
        is_error=c["err"].astype(np.float32),
        trace_key=np.asarray(c["trace_lo"], np.uint64),
        attr_crc=crc_table[np.asarray(c["attr"], np.int64) + 1],
    )


def decode_check(corpus, stream: dict, ref: dict, row: np.ndarray, expected_rows: np.ndarray,
                 shed_rows: int) -> tuple[int, dict]:
    """Rows wrong, and what went wrong. Admission may shed OK-lane rows
    only (the configuration's guarantee): every error-lane span that is
    missing counts, and the OK-lane spans missing must be as many as the
    program says it shed."""
    ok = row >= 0
    r = np.where(ok, row, 0)
    wrong = ~ok
    for name in ("slot", "lat_us", "is_error", "trace_key", "attr_crc"):
        prog = stream["svc" if name == "slot" else name]
        wrong |= ok & (np.asarray(prog).astype(np.float64) != ref[name][r].astype(np.float64))
    seen = np.bincount(r[ok], minlength=expected_rows.shape[0])
    extra = int(np.maximum(seen - expected_rows, 0).sum())
    short = np.maximum(expected_rows - seen, 0)
    err_lane = ref["is_error"] > 0
    missing_error = int(short[err_lane].sum())
    missing_ok = int(short[~err_lane].sum())
    detail = dict(unnamed=int((~ok).sum()), fields=int(wrong.sum() - (~ok).sum()),
                  extra=extra, missing_ok=missing_ok, missing_error=missing_error, shed=int(shed_rows))
    return int(wrong.sum()) + extra + missing_error + abs(missing_ok - int(shed_rows)), detail


def replay(geometry: dict, ref_cols: dict, row: np.ndarray, stream: dict, bounds: np.ndarray,
           t_now: np.ndarray, want: np.ndarray, precision: str = "fp32"):
    """Step the reference over every dispatched batch; returns the
    detector and the (score, flags) of the batches in ``want``."""
    det = ReferenceDetector(geometry, precision=precision)
    r = np.where(row >= 0, row, 0)
    cols = {}
    for name in ("slot", "lat_us", "is_error", "trace_key", "attr_crc"):
        prog = stream["svc" if name == "slot" else name]
        cols[name] = np.where(row >= 0, ref_cols[name][r], prog).astype(ref_cols[name].dtype)
    out = {}
    for j in range(t_now.shape[0]):
        a, b = bounds[j], bounds[j + 1]
        score, flags = det.step(t_now[j], cols["slot"][a:b], cols["lat_us"][a:b],
                                cols["is_error"][a:b], cols["trace_key"][a:b], cols["attr_crc"][a:b])
        if want[j]:
            out[j] = (score, flags)
    return det, out


def compare_reports(reports: list, matched: np.ndarray, ref_out: dict) -> tuple[int, float]:
    """(flags_wrong, score_gap) over every harvested report."""
    flags_wrong, gap = 0, 0.0
    for (_t, score, flags), j in zip(reports, matched):
        r_score, r_flags = ref_out[j]
        gap = max(gap, float(np.max(np.abs(score.astype(np.float64) - r_score))))
        differ = (flags != r_flags) & (np.abs(r_score.astype(np.float64) - 1.0) > FLAG_BAND)
        flags_wrong += int(differ.sum())
    return flags_wrong, gap


def compare_state(state: dict, det: ReferenceDetector) -> tuple[int, float]:
    """(sketch_cells_wrong, head_gap) of a final state against the reference."""
    ref = det.state()
    cells = 0
    for name in ReferenceDetector.COUNTS:
        cells += int(np.sum(np.asarray(state[name]) != np.asarray(ref[name])))
    gap = 0.0
    for name in ReferenceDetector.HEADS:
        rv = np.asarray(ref[name], np.float64)
        pv = np.asarray(state[name], np.float64)
        scale = max(float(np.max(np.abs(rv))), 1e-3)
        gap = max(gap, float(np.max(np.abs(pv - rv))) / scale)
    return cells, gap


def match_reports(batch_t: np.ndarray, report_t: list[float]) -> np.ndarray:
    """Index of each report's batch: reports come in dispatch order (a
    skipped report leaves a batch out), so the next batch with the
    report's timebase is its batch."""
    out = np.empty(len(report_t), np.int64)
    j = 0
    for i, t in enumerate(report_t):
        while j < batch_t.shape[0] and batch_t[j] != t:
            j += 1
        if j == batch_t.shape[0]:
            raise RuntimeError(f"report {i} (t={t}) matches no dispatched batch")
        out[i] = j
        j += 1
    return out


def judge(cfg: dict, corpus, run: dict, limits: dict, control: bool = False) -> dict:
    """Every number compared, with its limit, and the verdict."""
    stream, bounds, t_now = run["stream"], run["bounds"], run["t_now"]
    row = map_rows(corpus, stream)
    ref_cols = reference_columns(corpus, run["names"])
    expected = np.zeros(corpus.cols["svc"].shape[0], np.int64)
    for rows in run["accepted_rows"]:
        expected[rows] += 1
    decode_wrong, decode_detail = decode_check(corpus, stream, ref_cols, row, expected, run["shed_rows"])
    matched = match_reports(t_now, [r[0] for r in run["reports"]])
    want = np.zeros(t_now.shape[0], bool)
    want[matched] = True
    det, ref_out = replay(cfg["detector"], ref_cols, row, stream, bounds, t_now, want)
    flags_wrong, score_gap = compare_reports(run["reports"], matched, ref_out)
    cells_wrong, head_gap = compare_state(run["state"], det)
    numbers = {
        "decode_rows_wrong": (decode_wrong, 0),
        "sketch_cells_wrong": (cells_wrong, 0),
        "flags_wrong": (flags_wrong, 0),
        "score_gap": (score_gap, float(limits["score_gap"])),
        "head_gap": (head_gap, float(limits["head_gap"])),
    }
    out = dict(numbers=numbers, decode=decode_detail, rows=int(row.shape[0]),
               reports=len(run["reports"]), batches=int(t_now.shape[0]),
               correct=all(v <= lim for v, lim in numbers.values()))
    if control:
        # The reference in bfloat16 put in the program's place.
        cdet, c_out = replay(cfg["detector"], ref_cols, row, stream, bounds, t_now, want, precision="bf16")
        c_reports = [(t, c_out[j][0], c_out[j][1]) for (t, _s, _f), j in zip(run["reports"], matched)]
        c_state = cdet.state()
        c_flags, c_score = compare_reports(c_reports, matched, ref_out)
        c_cells, c_head = compare_state(c_state, det)
        out["control"] = {"flags_wrong": c_flags, "score_gap": c_score, "head_gap": c_head,
                          "sketch_cells_wrong": c_cells}
    return out
