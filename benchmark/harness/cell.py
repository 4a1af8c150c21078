"""One run of one cell: set up, drive the window, judge, report.

The window starts with the first timed body. A closed mix runs
``in_flight`` client threads, each sending its next body once the pool
accepted the last; a paced mix runs one sender that offers each body at
its due time whatever the backlog, and one thread that waits on the
pool's tickets. A client honours the admission signal the receivers
answer 429 with (``admission_retry_after``, a full pool queue): it
waits the Retry-After and sends the same body again, keeping its due
time. When the window closes no new body is offered; the bodies in
flight are sent to the end, and the run waits until every accepted span
was dispatched and its report harvested (a minute at most).
"""

from __future__ import annotations

import heapq
import math
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from . import spec as specs
from .judge import judge
from .system import System
from .traffic import build, service_table

DRAIN_S = 60.0


@dataclass
class SendLog:
    """One offer of a body: which, when due, when accepted, when its
    ticket resolved (perf_counter seconds)."""

    body: int
    due: float
    admitted: float = float("nan")
    resolved: float = float("nan")
    refusals: int = 0


REPORT_FIELDS = ("lat_z", "err_z", "rate_z", "card_z", "cusum", "flags")


@dataclass
class Recorder:
    """What the pipeline hands out while it runs, copied: the columns of
    each dispatched batch (``history_capture``) and each harvested
    report's z-scores, CUSUM and flags."""

    batches: list = field(default_factory=list)
    reports: list = field(default_factory=list)
    width: object = None

    def capture(self, cols, t_now) -> None:
        self.batches.append((time.perf_counter(), float(t_now), cols.svc.copy(), cols.lat_us.copy(),
                             cols.is_error.copy(), cols.trace_key.copy(), cols.attr_crc.copy(),
                             self.width() if self.width else 0))

    def record(self, t_batch, report) -> None:
        self.reports.append((time.perf_counter(), float(t_batch),
                             tuple(np.array(getattr(report, f)) for f in REPORT_FIELDS)))


def report_score(fields, thr: float, cusum_h: tuple) -> np.ndarray:
    """Each service's score: every signal's statistic over its threshold,
    the largest (a flag is a score above 1)."""
    lat_z, err_z, rate_z, card_z, cusum, _flags = fields
    return np.maximum.reduce([
        np.abs(lat_z).max(1) / thr, np.abs(err_z).max(1) / thr,
        np.abs(rate_z).max(1) / thr, np.abs(card_z).max(1) / thr,
        cusum[:, 0] / cusum_h[0], cusum[:, 1] / cusum_h[1], cusum[:, 2] / cusum_h[2],
    ]).astype(np.float32)


def _offer(sys_, body: bytes, log: SendLog, retry_s: float, stop_retries: threading.Event):
    """Offer ``body`` until the door takes it; returns its ticket."""
    from opentelemetry_demo_tpu_torch.runtime.ingest_pool import IngestPoolSaturated

    pipe, pool = sys_.pipe, sys_.pool
    while True:
        wait = pipe.admission_retry_after()
        if wait is None:
            try:
                ticket = pool.submit(body)
                log.admitted = time.perf_counter()
                return ticket
            except IngestPoolSaturated:
                wait = retry_s
        log.refusals += 1
        if stop_retries.wait(wait):
            raise RuntimeError("the run ended with a body still refused")


def drive_closed(sys_, sends, mix, t_close, logs, retry_s, abort):
    in_flight = int(mix["in_flight"])
    lock = threading.Lock()
    nxt = [0]
    errors = []

    def client():
        try:
            while time.perf_counter() < t_close:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                log = SendLog(i % len(sends), time.perf_counter())
                logs.append(log)
                ticket = _offer(sys_, sends[log.body].body, log, retry_s, abort)
                ticket.result(timeout=DRAIN_S)
                log.resolved = time.perf_counter()
        except BaseException as e:  # noqa: BLE001 — surfaced after the join
            errors.append(e)

    threads = [threading.Thread(target=client, name=f"bench-client-{i}", daemon=True) for i in range(in_flight)]
    for t in threads:
        t.start()
    return threads, errors


def drive_paced(sys_, sends, t_start, logs, retry_s, abort):
    errors = []
    tickets: list = []
    cv = threading.Condition()
    done = [False]

    def sender():
        try:
            heap = [(t_start + s.due, i, i) for i, s in enumerate(sends)]
            heapq.heapify(heap)
            while heap:
                when, _, i = heapq.heappop(heap)
                delay = when - time.perf_counter()
                if delay > 0 and abort.wait(delay):
                    return
                log = SendLog(i, t_start + sends[i].due)
                logs.append(log)
                ticket = _offer(sys_, sends[i].body, log, retry_s, abort)
                with cv:
                    tickets.append((ticket, log))
                    cv.notify()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
        finally:
            with cv:
                done[0] = True
                cv.notify()

    def waiter():
        k = 0
        try:
            while True:
                with cv:
                    while k >= len(tickets) and not done[0]:
                        cv.wait()
                    if k >= len(tickets):
                        return
                    ticket, log = tickets[k]
                ticket.result(timeout=DRAIN_S)
                log.resolved = time.perf_counter()
                k += 1
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=sender, name="bench-sender", daemon=True),
               threading.Thread(target=waiter, name="bench-waiter", daemon=True)]
    for t in threads:
        t.start()
    return threads, errors


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
        process_start: float, control: bool = False) -> dict:
    """One run; returns the result's parts (see ``benchmark/run.py``)."""
    import torch

    table = service_table(cfg)
    corpus, warm, timed = build(table, mix, seed, seconds)
    rec = Recorder()
    sys_ = System(cfg, device, rec.record, rec.capture)
    rec.width = lambda: sys_.pipe.batch_width
    cuda = torch.device(device).type == "cuda"
    retry_s = float(sys_.knobs["ANOMALY_RETRY_AFTER_S"])
    abort = threading.Event()
    try:
        sys_.pipe.warm_widths()
        sys_.start()
        # Warm-up through the served path: every flush shape the window sends.
        for group in mix["warmup_groups"]:
            tickets = [sys_.pool.submit(warm[i].body) for i in group]
            for t in tickets:
                t.result(timeout=DRAIN_S)
            _wait_idle(sys_)
        dev = None
        if trace:
            from .devtrace import DeviceTrace

            dev = DeviceTrace()
            dev.warm()
        if cuda:
            torch.cuda.synchronize()
        warm_accepted = [w.rows for w in warm]
        n_warm_reports = len(rec.reports)
        stats0 = _pipe_counts(sys_)
        pool0 = sys_.pool.stats()
        phase0 = len(sys_.phases.events)
        pump0 = len(sys_.pump.spans)
        t_start = time.perf_counter()
        setup_s = t_start - process_start
        t_close = t_start + seconds
        logs: list[SendLog] = []
        if mix["loop"] == "closed":
            threads, errors = drive_closed(sys_, timed, mix, t_close, logs, retry_s, abort)
        else:
            threads, errors = drive_paced(sys_, timed, t_start, logs, retry_s, abort)
        if dev is not None:
            trace_slices(dev, t_start + 0.2 * seconds, t_close, min(0.6 * seconds, 10.0))
        _sleep_until(t_close)
        backlog = sys_.pipe.pending_rows() + sys_.pool.depth()
        pool1 = sys_.pool.stats()
        phase1 = len(sys_.phases.events)
        t_joined = time.perf_counter() + DRAIN_S
        for t in threads:
            t.join(timeout=max(t_joined - time.perf_counter(), 0.1))
            if t.is_alive():
                abort.set()
                raise RuntimeError(f"{t.name} did not finish within {DRAIN_S} s of the close")
        if errors:
            raise errors[0]
        _wait_idle(sys_)
        if sys_.pump.error is not None:
            raise sys_.pump.error
        sys_.pump.stop()
        if cuda:
            torch.cuda.synchronize()
            peak = int(torch.cuda.max_memory_allocated())
        else:
            peak = 0
        from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy

        state = state_to_numpy(sys_.detector.state)._asdict()
        names = list(sys_.pipe.tensorizer.service_names)
        stats1 = _pipe_counts(sys_)
        dev_read = dev.read(sys_.phases.events[phase0:], sys_.pump.spans[pump0:]) if dev else None
        phase_events = list(sys_.phases.events[phase0:phase1])
        pump_spans = list(sys_.pump.spans[pump0:])
    finally:
        abort.set()
        sys_.close()
    del sys_
    if cuda:
        torch.cuda.empty_cache()

    batches = rec.batches
    rows = np.array([len(b[2]) for b in batches], np.int64)
    bounds = np.r_[0, np.cumsum(rows)]
    stream = {k: np.concatenate([b[i] for b in batches]) if batches else np.zeros(0)
              for k, i in (("svc", 2), ("lat_us", 3), ("is_error", 4), ("trace_key", 5), ("attr_crc", 6))}
    t_now = np.array([b[1] for b in batches], np.float64)
    accepted = warm_accepted + [timed[log.body].rows for log in logs if not math.isnan(log.admitted)]
    shed = sum(stats1[k] - stats0[k] for k in ("shed_ok", "shed_error", "brownout"))
    g = cfg["detector"]
    thr, cusum_h = float(g["z_threshold"]), (float(g["cusum_h"]), float(g["cusum_h"]), float(g["cusum_h_rate"]))
    reports = [(r[1], report_score(r[2], thr, cusum_h), r[2][-1]) for r in rec.reports]
    run_out = dict(stream=stream, bounds=bounds, t_now=t_now, names=names, state=state,
                   reports=reports, accepted_rows=accepted, shed_rows=shed)
    verdict = judge(cfg, corpus, run_out, cfg["limits"], control=control)
    window = dict(
        seconds=seconds, t_start=t_start, t_close=t_close, setup_s=setup_s, peak=peak,
        batch_cols=batches,
        reports=[(r[0], r[1]) for r in rec.reports], report_flags=reports[n_warm_reports:],
        logs=logs, timed=timed, corpus=corpus, bounds=bounds, stream=stream,
        pool_phase_s={k: pool1["phase_s"][k] - pool0["phase_s"].get(k, 0.0) for k in pool1["phase_s"]},
        pool_spans=pool1["flushed_spans"] - pool0["flushed_spans"],
        phase_events=phase_events, pump_spans=pump_spans, device=dev_read,
        stats=(stats0, stats1), shed=shed, cfg=cfg, backlog=backlog,
    )
    return dict(verdict=verdict, window=window)


def trace_slices(dev, t_from: float, t_close: float, slice_s: float) -> None:
    """Profile ``slice_s`` seconds of the window from ``t_from``; a slice
    in which the profiler lost every kernel is traced again while the
    window has room for another."""
    _sleep_until(t_from)
    while True:
        dev.start()
        # The slice runs from when the profiler is up, not from when it was asked.
        _sleep_until(min(dev.t0 + slice_s, t_close))
        dev.stop()
        if dev.kernels_seen() or t_close - time.perf_counter() < slice_s:
            return


def _pipe_counts(sys_) -> dict:
    st = sys_.pipe.stats
    return dict(batches=st.batches, spans=st.spans, skipped=st.reports_skipped,
                shed_ok=st.shed_rows.get("ok", 0), shed_error=st.shed_rows.get("error", 0),
                brownout=st.brownout_rows, saturation=st.saturation_events)


def _wait_idle(sys_) -> None:
    deadline = time.perf_counter() + DRAIN_S
    if not sys_.pool.drain(timeout=DRAIN_S):
        raise RuntimeError(f"the decode pool did not drain within {DRAIN_S} s")
    while not sys_.idle():
        if sys_.pump.error is not None:
            raise sys_.pump.error
        if time.perf_counter() > deadline:
            raise RuntimeError(f"the pipeline did not drain within {DRAIN_S} s: {_state(sys_)}")
        time.sleep(0.01)


def _state(sys_) -> str:
    pipe, spans = sys_.pipe, sys_.pump.spans
    dur = np.array([b - a for a, b in spans[-200:]]) if spans else np.zeros(1)
    return (f"pending rows {pipe.pending_rows()}, pool queue {sys_.pool.depth()}, "
            f"batches {pipe.stats.batches}, flag events {pipe.stats.flag_events}, "
            f"pumps {len(spans)}, last pumps mean {dur.mean():.4f} s max {dur.max():.4f} s")


def _sleep_until(t: float) -> None:
    while True:
        d = t - time.perf_counter()
        if d <= 0:
            return
        time.sleep(min(d, 0.5))


def load(root, workload: str):
    """(cell, config, mix, bench) for a workload name."""
    bench = specs.load_benchmark(root)
    cell = specs.find(bench["workloads"], workload, "workload")
    cfg = specs.load_config(root, bench, cell["config"])
    mix = specs.load_traffic(cell["traffic"])
    return cell, cfg, mix, bench
