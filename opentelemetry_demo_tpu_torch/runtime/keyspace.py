"""Key lifecycle plane: bounded memory through a cardinality bomb.

Without it the intern table is append-only: once its slots are taken,
every new service folds into the overflow bucket for the life of the
process. This module keeps the keyspace on a budget:

- **Watchdog** (:meth:`KeyspaceManager.tick`): samples the process RSS
  and the intern table's fill fraction and clocks the pipeline's
  keyspace ladder (``DetectorPipeline.keyspace_update``).
- **Evictor** (:meth:`KeyspaceManager.evict_idle`): under pressure it
  zeroes the idle keys' rows of the detector state **in place on the
  device** (their HLL registers in every bank and their head rows),
  then retires their ids into the tensorizer's free list behind a
  generation bump, so a recycled id starts from the monoid identities.
  Both happen under the pipeline's dispatch lock, on the stream the
  steps run on. With a ``history_writer`` it first hands over a fold
  record of the rows (the reference's record: the current shortest
  window's HLL bank, the head arrays, and the add-identity for the CMS
  and span total), copying only those arrays to the host.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Iterable

import numpy as np
import torch

from .pipeline import KEYSPACE_LEVEL_EVICT

log = logging.getLogger(__name__)

# Per-service head rows of DetectorState (leading service axis): what an
# eviction zeroes beside the HLL rows, and what its fold record carries.
MERGE_HEAD_ROWS = (
    "lat_mean", "lat_var", "err_mean", "rate_mean", "rate_var",
    "card_mean", "card_var", "obs_batches", "obs_windows", "cusum",
)


def process_rss_bytes() -> int:
    """Resident set size of this process in bytes (0 where
    /proc/self/status is unavailable)."""
    try:
        with open("/proc/self/status", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class KeyspaceManager:
    """The keyspace watchdog and idle-key evictor.

    ``tick()`` is the whole behaviour (the background thread calls it on
    a cadence; a replay calls it with a virtual clock): sample pressure
    → clock the ladder → evict idle keys while the ladder is engaged.
    ``protected`` names are never evicted.
    """

    def __init__(
        self,
        pipeline,
        *,
        idle_s: float = 300.0,
        evict_batch: int = 64,
        rss_budget_mb: float = 0.0,
        interval_s: float = 1.0,
        protected: Iterable[str] = (),
        history_writer=None,
        now_fn: Callable[[], float] = time.monotonic,
        wall_fn: Callable[[], float] = time.time,
        rss_fn: Callable[[], int] = process_rss_bytes,
    ):
        self.pipeline = pipeline
        self.idle_s = float(idle_s)
        self.evict_batch = max(int(evict_batch), 1)
        self.rss_budget_mb = float(rss_budget_mb)
        self.interval_s = float(interval_s)
        self.protected = set(protected)
        self.history_writer = history_writer
        self.now_fn = now_fn
        self.wall_fn = wall_fn
        self.rss_fn = rss_fn
        # Keys interned before this manager existed (a restore) have no
        # last-seen sample: they idle from here, not from the epoch.
        self._t0 = now_fn()
        self.last_rss = 0
        self.last_fill = 0.0
        self.evictions = 0  # keys evicted by this manager
        self.sweeps = 0  # sweeps that evicted at least one key
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        """Start the watchdog thread (idempotent while it lives)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="keyspace-watchdog", daemon=True)
        self._thread.start()

    def alive(self) -> bool:
        return self._thread is None or self._thread.is_alive()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — one bad tick is a skipped sweep, never a dead watchdog
                log.exception("keyspace watchdog tick failed")

    # -- the watchdog --------------------------------------------------

    def fill_fraction(self) -> float:
        tz = self.pipeline.tensorizer
        return tz.live_keys / max(tz.capacity, 1)

    def rss_over_budget(self, rss_bytes: int) -> bool:
        if self.rss_budget_mb <= 0:
            return False
        return rss_bytes > self.rss_budget_mb * 1024 * 1024

    def tick(self, now: float | None = None) -> dict:
        """One watchdog step: pressure sample → ladder clock → evict while
        engaged. Returns the sample."""
        now = self.now_fn() if now is None else now
        self.last_rss = rss = self.rss_fn()
        self.last_fill = fill = self.fill_fraction()
        level = self.pipeline.keyspace_update(fill, self.rss_over_budget(rss), now=now)
        evicted: list[str] = []
        if self.pipeline.keyspace_enable and level >= KEYSPACE_LEVEL_EVICT:
            evicted = self.evict_idle(now)
        return {"level": level, "fill": fill, "rss_bytes": rss, "evicted": evicted}

    # -- the evictor ---------------------------------------------------

    def idle_candidates(self, now: float) -> list[tuple[float, str, int]]:
        """(last_seen, name, id) of eviction-eligible keys, oldest first:
        idle past the budget, not protected, not the overflow bucket."""
        tz = self.pipeline.tensorizer
        last_seen = self.pipeline._last_seen
        out: list[tuple[float, str, int]] = []
        for name, sid in tz._svc_snapshot.items():
            if name in self.protected or sid >= tz.num_services - 1:
                continue
            seen = last_seen[sid] if last_seen[sid] > 0.0 else self._t0
            if now - seen >= self.idle_s:
                out.append((seen, name, sid))
        out.sort()
        return out[: self.evict_batch]

    def evict_idle(self, now: float | None = None) -> list[str]:
        """One eviction sweep: hand the fold record to the history writer
        (when there is one), zero the idle keys' rows on the device and
        retire their ids, all under the dispatch lock. Returns the
        evicted names."""
        now = self.now_fn() if now is None else now
        candidates = self.idle_candidates(now)
        if not candidates:
            return []
        names = [name for _, name, _ in candidates]
        pipeline = self.pipeline
        tz = pipeline.tensorizer
        state = pipeline.detector.state
        device = state.hll_bank.device
        cuda = device.type == "cuda"
        # The row ids go to the device through pinned memory without a
        # host wait, so the lock is held only while the work is enqueued.
        sids = torch.tensor([sid for _, _, sid in candidates], dtype=torch.int64)
        if cuda:
            sids = sids.pin_memory()
        fold = None
        with pipeline._dispatch_lock:
            if self.history_writer is not None:
                # The rows still hold the keys' state: snapshot what the
                # record needs on the device, in stream order.
                fold = {
                    "hll_bank": state.hll_bank[0, 0].clone(),
                    "step_idx": state.step_idx.clone(),
                    **{h: getattr(state, h).clone() for h in MERGE_HEAD_ROWS},
                }
                rec_meta = {
                    "service_names": tz.service_names,  # pre-retirement
                    "config": list(pipeline.detector.config._replace(sketch_impl=None)),
                    "generation": tz.generation,  # pre-bump: the old ids
                    "evicted": list(names),
                    "query": {},
                }
            idx = sids.to(device, non_blocking=True)
            # A recycled id starts from the monoid identities.
            state.hll_bank.index_fill_(2, idx, 0)
            for head in MERGE_HEAD_ROWS:
                getattr(state, head).index_fill_(0, idx, 0)
            # Retire inside the lock: the next flush may hand a freed id
            # to a new key, and its rows must already be zero.
            freed = tz.retire_services(names)
        evicted = [n for n in names if tz._svc_snapshot.get(n) is None]
        self.evictions += len(freed)
        self.sweeps += 1
        if fold is not None and freed:
            host = {k: v.cpu().numpy() for k, v in fold.items()}
            record = {
                "hll_bank": host["hll_bank"],
                "cms_bank": np.zeros(tuple(state.cms_bank.shape[2:]), np.int32),
                "span_total": np.zeros((), np.float32),
                **{h: host[h] for h in MERGE_HEAD_ROWS},
            }
            rec_meta = {"seq": int(host["step_idx"]), **rec_meta}
            self.history_writer.record_eviction(record, rec_meta, now=self.wall_fn())
        return evicted

    def stats(self) -> dict:
        tz = self.pipeline.tensorizer
        return {
            "level": self.pipeline.keyspace_level,
            "rows": tz.live_keys,
            "capacity": tz.capacity,
            "fill": round(self.fill_fraction(), 4),
            "free_ids": tz.free_ids,
            "generation": tz.generation,
            "evicted_total": tz.evicted_total,
            "overflow_assigns_total": tz.overflow_assigns_total,
            "rss_bytes": self.last_rss,
            "rss_budget_mb": self.rss_budget_mb,
            "sweeps": self.sweeps,
        }
