"""Verdict provenance: an evidence bundle for every flag.

A flag becomes a bundle an operator can interrogate: which head fired,
the head trajectories over the last K harvested reports, the CMS
heavy-hitter keys behind the window, the HLL estimate against its
learned baseline, and the trace ids (the detector's own batch trace and
the flag-time exemplar shop traces).

- **The trajectory costs no device round trip.** Every harvested report
  is host numpy already; ``observe_report`` rings its head columns and
  ``build`` slices them per service.
- **The flag-time state comes from one snapshot.** The EWMA baselines
  and the CMS/HLL banks live on the card, where the step updates them
  in place. The pipeline enqueues one stream-ordered copy of them under
  its dispatch lock per flagging batch and hands the numpy arrays here;
  this module never touches the detector or a lock.
- **Bundles are JSON-able dicts with deterministic ids**: the id hashes
  (epoch, seq, service) through the scalar splitmix64 the self-trace ids
  use, so a primary, a replica and a replay mint the same id, and the
  reference package mints it too.

The ``HEAD_*`` / ``REASON_*`` constants are the closed evidence
vocabulary.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable

import numpy as np

from ..ops.cms import cms_indices_np, cms_query_np
from ..ops.hashing import split_hi_lo_np, splitmix64_np
from ..ops.hll import hll_estimate_np
from ..telemetry.logstore import LogDoc
from .selftrace import splitmix64

# -- the closed evidence vocabulary -----------------------------------
# Head kinds: which detector head produced the verdict.
HEAD_EWMA_Z = "ewma-z"
HEAD_CUSUM = "cusum"
HEAD_CARDINALITY = "cardinality"

# Reasons: the per-signal vocabulary ``_capture_exemplars`` emits into
# anomaly events (and now into bundles) — one reason per flagged
# signal lane.
REASON_LATENCY = "latency"
REASON_ERROR_RATE = "error_rate"
REASON_THROUGHPUT = "throughput"
REASON_CARDINALITY = "cardinality"
REASON_CUSUM = "cusum"

# Reason → head: the three EWMA z lanes share one head; cardinality
# and CUSUM are their own. Closed mapping — an unknown reason maps to
# no head rather than a guessed one.
HEAD_FOR_REASON: dict[str, str] = {
    REASON_LATENCY: HEAD_EWMA_Z,
    REASON_ERROR_RATE: HEAD_EWMA_Z,
    REASON_THROUGHPUT: HEAD_EWMA_Z,
    REASON_CARDINALITY: HEAD_CARDINALITY,
    REASON_CUSUM: HEAD_CUSUM,
}

# Bundle schema version: bumped on any field-meaning change so history
# readers (and the collector pipeline downstream of the OTLP log
# export) can branch on it.
SCHEMA_VERSION = 1


def bundle_id(epoch: int, seq: int, service: int) -> str:
    """Deterministic 64-bit bundle id as 16 hex chars.

    Double-mixed so nearby (epoch, seq, service) triples don't share
    prefixes; pure function of the replicated coordinates, so every
    surface that sees the same verdict mints the same id."""
    return format(
        splitmix64(splitmix64((int(epoch) << 32) ^ int(seq)) ^ int(service)),
        "016x",
    )


def _row(arr, svc: int) -> list[float]:
    return [float(x) for x in np.asarray(arr)[svc]]


class ProvenanceEngine:
    """Builds evidence bundles at flag time.

    Owned by the caller, fed by the pipeline: ``observe_report`` on
    every harvested report (any thread; internally locked), ``build``
    per flagged service (harvester thread, under the pipeline's query
    lock — cheap numpy only). The bundle RING lives in the pipeline
    beside the anomaly ring so it rides ``query_meta`` replication;
    this engine is stateless apart from the trajectory deque and the
    build-latency samples a caller drains for the histogram.
    """

    def __init__(
        self,
        config,
        topk: int = 5,
        trajectory_windows: int = 16,
        epoch_fn: Callable[[], int] | None = None,
    ):
        self.config = config
        self.topk = max(int(topk), 1)
        self.trajectory_windows = max(int(trajectory_windows), 1)
        self._epoch_fn = epoch_fn
        self._traj: deque[dict] = deque(maxlen=self.trajectory_windows)
        self._lock = threading.Lock()
        # Build-latency samples (seconds), drained by the caller into
        # anomaly_explain_latency_seconds; bounded so an unexported
        # burst can't grow without limit.
        self._build_s: deque[float] = deque(maxlen=1024)

    # -- trajectory ring ----------------------------------------------

    def observe_report(self, t_batch: float, report) -> None:
        """Ring one harvested report's head columns (all services).

        Fields are read defensively (``getattr`` with None) so a
        partial report — unit-test fakes carry only the lanes they
        exercise — rings what it has."""
        row = {"t": float(t_batch)}
        for name in ("lat_z", "err_z", "rate_z", "card_z", "card_est", "cusum"):
            val = getattr(report, name, None)
            if val is not None:
                row[name] = np.asarray(val)
        with self._lock:
            self._traj.append(row)

    def trajectory_for(self, svc: int) -> list[dict]:
        """The per-service slice of the ring, oldest first, JSON-able."""
        with self._lock:
            rows = list(self._traj)
        out = []
        for row in rows:
            ent: dict = {"t": row["t"]}
            for name in ("lat_z", "err_z", "rate_z", "card_z", "card_est", "cusum"):
                arr = row.get(name)
                if arr is None or svc >= arr.shape[0]:
                    continue
                ent[name] = [float(x) for x in np.atleast_1d(arr[svc])]
            out.append(ent)
        return out

    # -- flag-time assembly -------------------------------------------

    def build(
        self,
        *,
        t_batch: float,
        seq: int,
        service: int,
        label: str,
        signals: list[str],
        exemplars: list[str],
        state: dict | None,
        hh_candidates: list[int],
        trace_id: str | None,
    ) -> dict:
        """One flagged service → one evidence bundle (JSON-able dict).

        ``state`` is the dispatch-lock snapshot (host numpy arrays) or
        None when the fetch was skipped/failed — the bundle degrades to
        trajectory + signals rather than refusing to exist."""
        t0 = time.perf_counter()
        epoch = int(self._epoch_fn()) if self._epoch_fn is not None else 0
        cfg = self.config
        heads = sorted({
            HEAD_FOR_REASON[s] for s in signals if s in HEAD_FOR_REASON
        })
        bundle: dict = {
            "id": bundle_id(epoch, seq, service),
            "schema": SCHEMA_VERSION,
            "t": float(t_batch),
            "seq": int(seq),
            "epoch": epoch,
            "service": label,
            "service_id": int(service),
            "heads": heads,
            "signals": list(signals),
            "windows_s": [float(w) for w in cfg.windows_s],
            "taus_s": [float(x) for x in cfg.taus_s],
            "z_threshold": float(cfg.z_threshold),
            "trajectory": self.trajectory_for(int(service)),
            "exemplars": list(exemplars),
            "selftrace": trace_id,
        }
        if state is not None:
            try:
                self._attach_state(bundle, state, int(service), hh_candidates)
            except (KeyError, IndexError, ValueError):
                # A mismatched snapshot (mid-resize shapes) costs the
                # state block, not the bundle.
                pass
        with self._lock:
            self._build_s.append(time.perf_counter() - t0)
        return bundle

    def _attach_state(
        self, bundle: dict, state: dict, svc: int, cands: list[int]
    ) -> None:
        bundle["ewma"] = {
            "latency": {
                "mean": _row(state["lat_mean"], svc),
                "var": _row(state["lat_var"], svc),
            },
            "error_rate": {"mean": _row(state["err_mean"], svc)},
            "throughput": {
                "mean": _row(state["rate_mean"], svc),
                "var": _row(state["rate_var"], svc),
            },
        }
        cus = np.asarray(state["cusum"])[svc]
        thr = self.config.cusum_thresholds
        bundle["cusum"] = {
            "latency_up": float(cus[0]),
            "error_up": float(cus[1]),
            "rate_down": float(cus[2]),
            "thresholds": [float(x) for x in thr],
        }
        # Cardinality head evidence: live estimate per window vs the
        # learned EWMA baseline — the delta is the head's own signal.
        est = hll_estimate_np(np.asarray(state["hll_bank"])[:, 0])  # [W#, S]
        base = np.asarray(state["card_mean"])[svc]  # [W#]
        nw = min(est.shape[0], base.shape[0])
        if svc < est.shape[1]:
            bundle["cardinality"] = {
                "estimate": [float(est[w, svc]) for w in range(nw)],
                "baseline_mean": [float(base[w]) for w in range(nw)],
                "delta": [
                    float(est[w, svc]) - float(base[w]) for w in range(nw)
                ],
            }
        bundle["top_keys"] = self._topk_contributors(state, svc, cands)

    def _topk_contributors(
        self, state: dict, svc: int, cands: list[int]
    ) -> list[dict]:
        """Exact CMS point queries for the candidate keys — the SAME
        fold ``query.topk_heavy_hitters`` runs (key | svc<<32 →
        splitmix → rows), snapshotted into evidence at flag time so
        the bundle stays truthful after the window rolls."""
        if not cands:
            return []
        cur = np.asarray(state["cms_bank"])[:, 0]  # [W#, D, C]
        depth, width = cur.shape[-2], cur.shape[-1]
        span_total = np.asarray(state["span_total"])[:, 0]  # [W#]
        crc = np.asarray(cands, dtype=np.uint64)
        key = crc | (np.uint64(svc) << np.uint64(32))
        hi, lo = split_hi_lo_np(splitmix64_np(key))
        idx = cms_indices_np(hi, lo, depth, width)
        counts = cms_query_np(cur, idx)  # [W#, B]
        sel = counts[-1]  # longest window: the attribution horizon
        order = sorted(
            range(len(cands)), key=lambda i: (-int(sel[i]), int(crc[i]))
        )[: self.topk]
        denom = max(float(span_total[-1]), 1.0)
        return [
            {
                "attr_crc": f"0x{int(crc[i]):08x}",
                "count": int(sel[i]),
                "counts": [int(c) for c in counts[:, i]],
                "share": float(np.float32(int(sel[i]) / denom)),
            }
            for i in order
        ]

    # -- export helpers -----------------------------------------------

    def take_build_samples(self) -> list[float]:
        """Drain build-latency samples (seconds) for the histogram."""
        with self._lock:
            out = list(self._build_s)
            self._build_s.clear()
        return out


def log_doc(bundle: dict):
    """Bundle → LogDoc for ``otlp_export.encode_logs_request``.

    The body is the human sentence ("why was this flagged"); the
    machine-readable coordinates ride attributes so the collector
    pipeline can index/route without parsing the body. The selftrace
    batch trace id rides the record's trace_id field — the standard
    log↔trace correlation hop."""
    heads = ",".join(bundle.get("heads") or [])
    signals = ",".join(bundle.get("signals") or [])
    attrs = {
        "anomaly.bundle_id": str(bundle.get("id")),
        "anomaly.heads": heads,
        "anomaly.signals": signals,
        "anomaly.seq": str(bundle.get("seq")),
        "anomaly.epoch": str(bundle.get("epoch")),
    }
    exemplars = bundle.get("exemplars") or []
    if exemplars:
        attrs["anomaly.exemplars"] = ",".join(str(x) for x in exemplars[:5])
    trace_id = bundle.get("selftrace")
    return LogDoc(
        ts=float(bundle.get("t") or 0.0),
        service=str(bundle.get("service")),
        severity="WARN",
        body=(
            f"anomaly flagged: service={bundle.get('service')} "
            f"heads={heads or 'none'} signals={signals or 'none'} "
            f"bundle={bundle.get('id')}"
        ),
        attrs=attrs,
        trace_id=bytes.fromhex(trace_id) if trace_id else None,
    )
