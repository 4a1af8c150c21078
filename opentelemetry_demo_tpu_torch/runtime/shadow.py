"""Counterfactual pre-flight: prove a mitigation on replayed history.

Before :class:`~.remediation.RemediationController` lets an actuator
write, a :class:`ShadowVerifier` replays the last N minutes of recorded
span frames (the ``HistoryStore`` span capture, read through
``HistoryReader.span_records``) through a FRESH ``DetectorPipeline`` on
the card at replay speed (virtual-time clock injection, the replaybench
machinery) **with the proposed mitigation applied as a transform on the
replayed stream**, and releases the act only if the shadow's own
EWMA/CUSUM and cardinality heads clear in the verification tail. A
mitigation that would not have helped is refused, with flight-recorder
evidence, the episode parked back in PENDING and the budget token
refunded.

Contracts:

- **One pipeline constructor.** :func:`build_shadow_pipeline` is the single
  constructor both this verifier and ``runtime.replaybench`` use, so a
  shadow replay of a recorded window gives replaybench's verdicts by
  construction (same admission, same tensorize/pack, same step, same
  ``round(t_batch, 6)``-keyed flag tuples).
- **Live-state isolation.** The shadow pipeline runs beside the live
  one on the same card and never touches live detector state: it reads
  only a disk-backed ``HistoryReader`` plus a static ``DetectorConfig``,
  and owns its own detector, state and harvest.
- **First use off the clock.** A throwaway pipeline at the same geometry
  runs one batch before the timed loop (the kernel library's load, the
  first launch, the allocator's growth), and is closed synchronously so
  no thread outlives it; the measured speedup and the deadline measure
  replay only.
- **Fail closed.** Too few recorded frames, a wall-deadline miss, or any
  replay error refuse the act (reason-coded).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np

from ..models.detector import AnomalyDetector, DetectorConfig
from .history import SPAN_CAPTURE_COLUMNS, HistoryReader
from .pipeline import DetectorPipeline
from .tensorize import SpanColumns

# Refusal reason vocabulary (the flight evidence's ``reason=`` label).
REASON_CLEARED = "cleared"
REASON_STILL_FLAGGED = "still_flagged"
REASON_DEADLINE = "deadline"
REASON_INSUFFICIENT = "insufficient_records"
REASON_ERROR = "error"

# Pre-flight act→verdict histogram ladder (seconds): a warm shadow
# replay of a few-minute window costs tens of milliseconds to a few
# seconds; the deadline knob caps the far end.
PREFLIGHT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0)


class PreflightVerdict(NamedTuple):
    """One shadow replay's answer: would this mitigation have helped?

    ``verdicts`` carries the replayed per-batch flag tuples keyed by
    ``round(t_batch, 6)`` — the bit-identity pinning surface (stripped
    from flight evidence; the scalars tell the postmortem story)."""

    would_help: bool
    reason: str
    batches: int
    records: int
    corrupt: int
    virtual_s: float
    wall_s: float
    speedup: float
    flagged_tail: int
    clear_tail: int
    verdicts: dict


def refused(reason: str, **kw) -> PreflightVerdict:
    """A fail-closed verdict (no replay numbers beyond what's known)."""
    base = dict(
        would_help=False, reason=reason, batches=0, records=0,
        corrupt=0, virtual_s=0.0, wall_s=0.0, speedup=0.0,
        flagged_tail=0, clear_tail=0, verdicts={},
    )
    base.update(kw)
    return PreflightVerdict(**base)


def build_shadow_pipeline(
    config: DetectorConfig, batch_size: int, collect: dict, device=None,
) -> tuple[AnomalyDetector, DetectorPipeline]:
    """THE pipeline constructor for replayed frames — shared with
    ``runtime.replaybench`` so shadow and replaybench verdicts can
    never drift: a fresh detector + pipeline (on the card unless
    ``device="cpu"``) whose ``on_report`` stores
    ``round(t_batch, 6) → tuple(bool flags)``; the harvested report is
    already on the host."""
    det = AnomalyDetector(config, device=device)

    def on_report(t_batch, report, flagged):
        collect[round(float(t_batch), 6)] = tuple(
            bool(f) for f in np.asarray(report.flags)
        )

    pipe = DetectorPipeline(det, on_report=on_report, batch_size=batch_size)
    return det, pipe


def suppress_transform(
    service_idx: int,
) -> Callable[[SpanColumns], SpanColumns]:
    """The mitigation-as-transform for a fault-flag disable: suppress
    the target service's fault columns on the replayed stream — errors
    zeroed, latency pulled to the batch's cross-service baseline (the
    other services' median) — modeling what the stream would have
    looked like had the faulty code path been off. Rows of every other
    service pass through untouched (a transform that edited healthy
    services could fake a clear)."""

    idx = int(service_idx)

    def transform(cols: SpanColumns) -> SpanColumns:
        svc = np.asarray(cols.svc)
        hit = svc == idx
        if not hit.any():
            return cols
        lat = np.asarray(cols.lat_us, dtype=np.float32).copy()
        err = np.asarray(cols.is_error, dtype=np.float32).copy()
        others = lat[~hit]
        baseline = float(np.median(others)) if others.size else float(
            np.median(lat)
        )
        lat[hit] = baseline
        err[hit] = 0.0
        return SpanColumns(
            svc=svc, lat_us=lat, is_error=err,
            trace_key=np.asarray(cols.trace_key),
            attr_crc=np.asarray(cols.attr_crc),
        )

    return transform


class ShadowVerifier:
    """Replays the recorded recent window through a fresh shadow
    pipeline with a proposed mitigation applied, and answers
    :class:`PreflightVerdict` — the controller's pre-flight gate.

    Disk-only by construction: reads frames through a
    :class:`~.history.HistoryReader` (corrupt records counted +
    skipped per the store's hop contract) and builds its own detector
    from the passed static config, on ``device`` (the card unless
    ``"cpu"``). Never names live state.
    """

    def __init__(
        self,
        reader: HistoryReader,
        config: DetectorConfig,
        batch_size: int = 256,
        window_s: float = 120.0,
        deadline_s: float = 5.0,
        rate_target: float = 10.0,
        min_records: int = 20,
        clear_tail: int = 4,
        flight=None,
        bundle_fn: Callable[[int], str | None] | None = None,
        now_fn: Callable[[], float] = time.time,
        device=None,
    ):
        self.reader = reader
        self.device = device
        self.config = config
        self.batch_size = int(batch_size)
        self.window_s = float(window_s)
        self.deadline_s = float(deadline_s)
        self.rate_target = float(rate_target)
        self.min_records = max(int(min_records), 1)
        self.clear_tail = max(int(clear_tail), 1)
        self._flight = flight
        # Provenance citation hook (service index → newest evidence-
        # bundle id via the daemon): every refusal/verdict record names
        # the verdict it judged. Single-call discipline: verify() runs
        # on the controller's one worker thread, so the per-call stamp
        # below needs no lock.
        self._bundle_fn = bundle_fn
        self._bundle: str | None = None
        self._now_fn = now_fn
        self._warmed = False
        # Verifier-side tallies (the daemon exports the controller's;
        # these feed /healthz + tests).
        self.runs = 0
        self.refusals = 0

    # -- internals -----------------------------------------------------

    def _record(self, **detail) -> None:
        if self._flight is not None:
            self._flight.record("preflight", bundle=self._bundle, **detail)

    def _cols_of(self, arrays: dict) -> SpanColumns:
        return SpanColumns(**{
            name: np.asarray(arrays[name]) for name in SPAN_CAPTURE_COLUMNS
        })

    def _warm(self, sample: SpanColumns) -> None:
        """Take first use off the clock with a throwaway pipeline at the
        same geometry: the kernel library's load, the first launch and
        the allocator's growth. The shadow detector proper starts cold
        and untouched; ``close`` joins everything the throwaway
        started."""
        if self._warmed:
            return
        _det, pipe = build_shadow_pipeline(
            self.config, self.batch_size, {}, device=self.device
        )
        pipe.submit_columns(sample)
        pipe.pump(0.0)
        pipe.close()
        self._warmed = True

    # -- the gate ------------------------------------------------------

    def verify(
        self,
        service_idx: int,
        transform: Callable[[SpanColumns], SpanColumns] | None,
        now: float | None = None,
    ) -> PreflightVerdict:
        """Replay the last ``window_s`` of recorded frames with the
        mitigation transform applied; the act is releasable iff the
        flagged service's heads clear for the final ``clear_tail``
        replayed batches within the wall deadline."""
        self.runs += 1
        self._bundle = self._cite(int(service_idx))
        try:
            verdict = self._verify(int(service_idx), transform, now)
        except Exception as e:  # noqa: BLE001 — ANY replay fault
            # refuses the act (fail closed): a verifier that crashed
            # mid-replay has proven nothing about the mitigation.
            verdict = refused(REASON_ERROR)
            self._record(
                op="error", service_idx=int(service_idx),
                error=f"{type(e).__name__}: {e}",
            )
        if not verdict.would_help:
            self.refusals += 1
        return verdict

    def _cite(self, service_idx: int) -> str | None:
        if self._bundle_fn is None:
            return None
        try:
            return self._bundle_fn(service_idx)
        except Exception:  # noqa: BLE001 — citation is best-effort
            return None

    def _verify(
        self,
        service_idx: int,
        transform: Callable[[SpanColumns], SpanColumns] | None,
        now: float | None,
    ) -> PreflightVerdict:
        t_now = self._now_fn() if now is None else float(now)
        corrupt0 = self.reader.store.frames_corrupt
        recs = self.reader.span_records(t_now - self.window_s, t_now)
        if len(recs) < self.min_records:
            self._record(
                op="refused", reason=REASON_INSUFFICIENT,
                service_idx=service_idx, records=len(recs),
                min_records=self.min_records,
            )
            return refused(REASON_INSUFFICIENT, records=len(recs))

        # First decodable record warms the compile cache off-clock.
        sample = None
        for rec in recs:
            arrays, _t = self.reader.read_span_record(rec)
            if arrays is not None:
                sample = self._cols_of(arrays)
                break
        if sample is None:
            return refused(
                REASON_INSUFFICIENT, records=len(recs),
                corrupt=self.reader.store.frames_corrupt - corrupt0,
            )
        self._warm(sample)

        verdicts: dict = {}
        _det, pipe = build_shadow_pipeline(
            self.config, self.batch_size, verdicts, device=self.device
        )
        batches = 0
        t_first = t_last = None
        pending_t: float | None = None
        deadline_missed = False
        wall0 = time.perf_counter()
        try:
            # One-batch lookahead (the replaybench overlap regime):
            # batch k pumps while batch k+1 already sits in the queue.
            for rec in recs:
                if time.perf_counter() - wall0 > self.deadline_s:
                    deadline_missed = True
                    break
                arrays, t_batch = self.reader.read_span_record(rec)
                if arrays is None:
                    continue  # corrupt: counted by the store, skipped
                cols = self._cols_of(arrays)
                if transform is not None:
                    cols = transform(cols)
                pipe.submit_columns(cols)
                if pending_t is not None:
                    pipe.pump(pending_t)
                    batches += 1
                pending_t = t_batch
                t_first = t_batch if t_first is None else t_first
                t_last = t_batch
            if not deadline_missed and pending_t is not None:
                pipe.pump(pending_t)
                batches += 1
            pipe.drain()
        finally:
            pipe.close()
        wall = time.perf_counter() - wall0
        virtual = (
            (t_last - t_first) if t_first is not None and batches > 1
            else 0.0
        )
        speedup = virtual / max(wall, 1e-9)
        corrupt = self.reader.store.frames_corrupt - corrupt0

        if deadline_missed:
            self._record(
                op="refused", reason=REASON_DEADLINE,
                service_idx=service_idx, batches=batches,
                wall_s=round(wall, 4), deadline_s=self.deadline_s,
            )
            return refused(
                REASON_DEADLINE, batches=batches, records=len(recs),
                corrupt=corrupt, virtual_s=round(virtual, 3),
                wall_s=round(wall, 4), speedup=round(speedup, 2),
            )

        tail = sorted(verdicts)[-self.clear_tail:]
        flagged_tail = sum(
            1 for t in tail
            if service_idx < len(verdicts[t]) and verdicts[t][service_idx]
        )
        would_help = bool(tail) and flagged_tail == 0
        reason = REASON_CLEARED if would_help else REASON_STILL_FLAGGED
        self._record(
            op="verdict", reason=reason, service_idx=service_idx,
            batches=batches, flagged_tail=flagged_tail,
            speedup=round(speedup, 2), wall_s=round(wall, 4),
        )
        return PreflightVerdict(
            would_help=would_help, reason=reason, batches=batches,
            records=len(recs), corrupt=corrupt,
            virtual_s=round(virtual, 3), wall_s=round(wall, 4),
            speedup=round(speedup, 2), flagged_tail=flagged_tail,
            clear_tail=len(tail), verdicts=verdicts,
        )
