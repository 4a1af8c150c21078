"""Device-put spine: a ring of pinned host slots and async copies to the card.

Between the pipeline's batch assembly and the detector step sit a pack
(pad + hash) and a host→device copy. Without the spine both run on the
pump thread inside the dispatch tick. The spine moves them onto a
**stager thread** working through a ring of ``depth`` slots:

- ``stage(cols, width, ...)`` (pump thread) queues the assembled columns
  and returns at once. The stager packs them into slot ``seq % depth``
  and copies the slot to the card on a side CUDA stream, recording one
  event behind the copy.
- ``take(wait=...)`` (pump thread) pops the oldest staged batch. With a
  step in flight the pump takes only a batch whose copy is done
  (``event.query()``: an overlap hit); with the card idle, under
  ``drain()``, or with ``overlap`` off, it waits for the stager (a
  miss). A miss never blocks the host on the copy: the dispatch stream
  waits for the copy's event.
- ``release(staged)`` (pump thread, after the step is enqueued) records
  an event on the dispatch stream and frees the slot.

With a ``phase_observe`` hook the stager observes each batch's
``stage`` phase itself, when its pack and copy issue end.

A slot is one pinned int32 host buffer of 8 × B laid out as
``AnomalyDetector._args`` lays out a batch, packed in place through
numpy views (``SpanTensorizer.pack_columns_into``), and one device
buffer of the same layout; both are allocated once per slot and width.
Two guards keep a slot's bytes stable while they are read:

- before a slot's host buffer is repacked, its last copy must be done
  (the stager waits on the copy's event on the host);
- before a slot's device buffer is overwritten, the step that read it
  must be done: the side stream waits on the event ``release`` recorded
  on the dispatch stream. The stager does not start on a slot until the
  batch that held it has been released or discarded.

The device buffers are allocated on the side stream, never from the
dispatch stream's pool, whose freed blocks queued steps may still read.

The spine owns no detector state: dispatch, ``checkpoint.save`` and the
keyspace evictor stay on the one dispatch stream under the pipeline's
``_dispatch_lock``. On the CPU (``device="cpu"``) the thread and the ring
work the same, with plain copies and no streams or events.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

import numpy as np
import torch

from .selftrace import PHASE_STAGE
from .tensorize import SpanColumns, SpanTensorizer, TensorBatch


class SpineError(RuntimeError):
    """A staging job failed (pack or copy), or the spine closed under
    it: raised to the dispatcher that takes the batch."""


class StagedBatch:
    """One assembled batch riding the spine: host columns in, the slot's
    device lanes out once the stager has issued the copy.

    ``stage_dur`` and ``wait_s`` are this batch's own pack+copy-issue
    seconds and the seconds a waiting ``take`` spent on it; ``t_staged``
    is the ``perf_counter`` of its ``stage`` call. ``trace`` is
    the batch's sampled self-trace (``runtime.selftrace.BatchTrace``) or
    None: carried to dispatch, never read on the stager thread."""

    __slots__ = (
        "cols", "width", "t_now", "t_oldest", "lanes", "copied", "slot",
        "error", "ready", "stage_dur", "wait_s", "trace", "t_staged",
    )

    def __init__(self, cols: SpanColumns, width: int, t_now, t_oldest, trace=None):
        self.cols = cols
        self.trace = trace
        self.width = width
        self.t_now = t_now
        self.t_oldest = t_oldest
        self.lanes: torch.Tensor | None = None  # int32 [8 × width] on the device
        self.copied: "torch.cuda.Event | None" = None
        self.slot: int | None = None
        self.error: BaseException | None = None
        self.ready = threading.Event()
        self.stage_dur = 0.0
        self.wait_s = 0.0
        self.t_staged = time.perf_counter()

    def copy_done(self) -> bool:
        return self.copied is None or self.copied.query()


class _Slot:
    __slots__ = ("host", "dev", "copied", "consumed", "owner")

    def __init__(self):
        self.host: dict[int, tuple[torch.Tensor, TensorBatch]] = {}
        self.dev: dict[int, torch.Tensor] = {}
        self.copied: "torch.cuda.Event | None" = None  # the last copy out of a host buffer
        self.consumed: "torch.cuda.Event | None" = None  # after the last step that read dev
        self.owner: StagedBatch | None = None  # staged, not yet released


def slot_views(buf: torch.Tensor, width: int) -> TensorBatch:
    """The eight lanes of one int32 slot buffer as numpy views of their
    dtypes (``valid`` stays int32 and takes 0/1)."""
    a = buf.numpy()
    lane = [a[i * width:(i + 1) * width] for i in range(8)]
    return TensorBatch(
        lane[0],
        lane[1].view(np.float32),
        lane[2].view(np.float32),
        lane[3].view(np.uint32),
        lane[4].view(np.uint32),
        lane[5].view(np.uint32),
        lane[6].view(np.uint32),
        lane[7],
    )


def pinned_device(device: "torch.device | str") -> torch.device:
    """``device`` with its CUDA index filled in from the calling thread,
    so a worker thread can ``torch.cuda.set_device`` it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class DevicePutSpine:
    """Staging ring + stager thread (see the module doc)."""

    def __init__(
        self,
        tensorizer: SpanTensorizer,
        device: "torch.device | str",
        depth: int = 2,
        overlap: bool = True,
        chunk_rows: int = 0,
        phase_observe=None,
    ):
        if depth < 1:
            raise ValueError(f"spine ring depth must be >= 1 (got {depth})")
        self.tensorizer = tensorizer
        self.device = pinned_device(device)
        self._cuda = self.device.type == "cuda"
        self.depth = int(depth)
        self.overlap = bool(overlap)
        self.chunk_rows = int(chunk_rows)
        self.phase_observe = phase_observe
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._slots = [_Slot() for _ in range(self.depth)]
        self._seq = 0
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._jobs: deque[StagedBatch] = deque()
        self._staged: deque[StagedBatch] = deque()
        self._stop = False
        self.puts_total = 0
        self.overlap_hits = 0  # take() found the copy already done
        self.overlap_misses = 0  # take() had to wait for the stager or the copy
        self.step_waits = 0  # copies queued behind a step still reading their slot
        self.stage_s = 0.0  # stager: slot wait + pack + copy issue
        self.take_wait_s = 0.0  # pump: time blocked in waiting takes
        self._thread = threading.Thread(target=self._run, name="spine-stager", daemon=True)
        self._thread.start()

    # -- pump-thread API ----------------------------------------------

    def stage(self, cols: SpanColumns, width: int, t_now, t_oldest, trace=None) -> None:
        """Queue one assembled batch for pack + copy. Never blocks: the
        pump bounds the ring by dispatching the head before staging past
        ``depth``. ``trace`` rides the staged batch to dispatch."""
        staged = StagedBatch(cols, int(width), t_now, t_oldest, trace)
        with self._work:
            if self._stop:
                raise SpineError("spine is closed")
            self._jobs.append(staged)
            self._staged.append(staged)
            self._work.notify_all()

    def take(self, wait: bool, timeout: float = 30.0) -> StagedBatch | None:
        """The oldest staged batch, its copy issued — or None when nothing
        is staged, or when ``wait`` is False and its copy is not done."""
        with self._lock:
            staged = self._staged[0] if self._staged else None
        if staged is None:
            return None
        if staged.ready.is_set() and staged.copy_done():
            hit = True
        elif not wait:
            return None
        else:
            hit = False
            t0 = time.perf_counter()
            while not staged.ready.wait(0.05):
                if not self._thread.is_alive():
                    raise SpineError("the stager thread is dead")
                if time.perf_counter() - t0 > timeout:
                    raise SpineError(f"staged batch not ready after {timeout}s (a slot never released)")
            staged.wait_s = time.perf_counter() - t0
        with self._work:
            if self._staged and self._staged[0] is staged:
                self._staged.popleft()
            if hit:
                self.overlap_hits += 1
            else:
                self.overlap_misses += 1
                self.take_wait_s += staged.wait_s
            self._work.notify_all()
        if staged.error is not None:
            self._free(staged)
            raise SpineError(
                f"staging failed: {type(staged.error).__name__}: {staged.error}"
            ) from staged.error
        return staged

    def release(self, staged: StagedBatch) -> None:
        """The step that reads ``staged.lanes`` is enqueued: record an
        event on the current stream behind it and free the slot."""
        consumed = None
        if self._cuda:
            stream = torch.cuda.current_stream(self.device)
            consumed = torch.cuda.Event()
            consumed.record(stream)
            # The slot's device buffer is read here, off the stream it
            # was allocated on: were it ever freed, its block must wait
            # for this stream too.
            staged.lanes.record_stream(stream)
        with self._work:
            if staged.slot is not None and consumed is not None:
                self._slots[staged.slot].consumed = consumed
            self._free_locked(staged)

    def _free(self, staged: StagedBatch) -> None:
        with self._work:
            self._free_locked(staged)

    def _free_locked(self, staged: StagedBatch) -> None:
        if staged.slot is not None and self._slots[staged.slot].owner is staged:
            self._slots[staged.slot].owner = None
            self._work.notify_all()

    def pending(self) -> int:
        with self._lock:
            return len(self._staged)

    def discard_pending(self) -> int:
        """Drop every staged batch not yet taken; returns their rows.
        Unstarted jobs are cancelled; a batch the stager is packing now
        completes into an orphan and frees its slot."""
        with self._work:
            dropped = list(self._staged)
            self._staged.clear()
            gone = {id(s) for s in dropped}
            self._jobs = deque(j for j in self._jobs if id(j) not in gone)
            for s in dropped:
                self._free_locked(s)
            self._work.notify_all()
        return sum(s.cols.rows for s in dropped)

    def alive(self) -> bool:
        return self._thread.is_alive() and not self._stop

    def close(self) -> None:
        with self._work:
            self._stop = True
            self._work.notify_all()
        self._thread.join(timeout=5.0)

    def stats(self) -> dict:
        with self._lock:
            hits, misses = self.overlap_hits, self.overlap_misses
            taken = hits + misses
            return {
                "ring_depth": self.depth,
                "staged": len(self._staged),
                "puts_total": self.puts_total,
                "overlap_hits": hits,
                "overlap_misses": misses,
                # Of the batches taken, the share whose copy was done
                # behind the step in flight.
                "overlap_ratio": (hits / taken) if taken else 0.0,
                "step_waits": self.step_waits,
                "stage_s": self.stage_s,
                "take_wait_s": self.take_wait_s,
            }

    # -- stager thread -------------------------------------------------

    def _buffers(self, slot: _Slot, width: int) -> tuple[torch.Tensor, TensorBatch, torch.Tensor]:
        host = slot.host.get(width)
        if host is None:
            buf = torch.empty(8 * width, dtype=torch.int32, pin_memory=self._cuda)
            host = slot.host[width] = (buf, slot_views(buf, width))
        dev = slot.dev.get(width)
        if dev is None:
            # Allocated on the side stream that writes it. From the
            # dispatch stream's pool the allocator could hand out a block
            # just freed there (a state the last step replaced) that a
            # queued step has yet to read, and the side stream's copy
            # would land in it first.
            with torch.cuda.stream(self._side) if self._cuda else contextlib.nullcontext():
                dev = slot.dev[width] = (
                    torch.empty(8 * width, dtype=torch.int32, device=self.device)
                )
        return host[0], host[1], dev

    def _fail_all_locked(self, first: StagedBatch | None = None) -> None:
        jobs = ([first] if first is not None else []) + list(self._jobs)
        self._jobs.clear()
        for staged in jobs:
            staged.error = SpineError("spine closed mid-stage")
            staged.ready.set()

    def _run(self) -> None:
        if self._cuda:
            torch.cuda.set_device(self.device)
        while True:
            with self._work:
                while not self._jobs and not self._stop:
                    self._work.wait(0.05)
                if self._stop:
                    self._fail_all_locked()
                    return
                staged = self._jobs.popleft()
                t0 = time.perf_counter()
                idx = self._seq % self.depth
                self._seq += 1
                slot = self._slots[idx]
                # The slot's last batch must be released (its step
                # enqueued) or discarded before its buffers are reused.
                while slot.owner is not None and not self._stop:
                    self._work.wait(0.05)
                if self._stop:
                    self._fail_all_locked(staged)
                    return
                if staged not in self._staged:
                    # Discarded while it waited: it must not hold a slot
                    # that no take or release would ever free.
                    staged.ready.set()
                    continue
                slot.owner = staged
                staged.slot = idx
                consumed = slot.consumed
            try:
                if slot.copied is not None:
                    slot.copied.synchronize()  # guard 1: the host buffer's last copy is done
                buf, views, dev = self._buffers(slot, staged.width)
                self.tensorizer.pack_columns_into(views, staged.cols, chunk_rows=self.chunk_rows)
                step_wait = False
                if self._cuda:
                    with torch.cuda.stream(self._side):
                        if consumed is not None:
                            step_wait = not consumed.query()
                            self._side.wait_event(consumed)  # guard 2: the step that read dev is done
                        dev.copy_(buf, non_blocking=True)
                        copied = torch.cuda.Event()
                        copied.record(self._side)
                    slot.copied = staged.copied = copied
                else:
                    dev.copy_(buf)
                staged.lanes = dev
                staged.stage_dur = time.perf_counter() - t0
                if self.phase_observe is not None:
                    self.phase_observe(PHASE_STAGE, staged.stage_dur)
                with self._lock:
                    self.puts_total += 1
                    self.step_waits += step_wait
                    self.stage_s += staged.stage_dur
            except Exception as e:  # noqa: BLE001 — raised to the taker;
                # the stager itself must survive (close() joins it).
                staged.error = e
            finally:
                staged.ready.set()
            # Hold no batch between jobs: its columns may view a decode
            # scratch that the pool recycles once nothing holds it.
            staged = None
