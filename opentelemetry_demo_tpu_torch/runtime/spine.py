"""Device-put spine: a ring of pinned host slots and async copies to the card.

Between the pipeline's batch assembly and the detector step sit a pack
(pad + hash) and a host→device copy. The spine does both on the pump
thread through a ring of ``depth`` slots, and the copy runs on a side
CUDA stream, so the host never waits for it:

- ``put(cols, width)`` packs the columns into slot ``seq % depth`` and
  issues the slot's copy to the card on the side stream, recording one
  event behind the copy. It returns at once (with ``overlap`` off, once
  the copy is done); the dispatch stream waits for the copy's event.
- ``release(put)`` (after the step is enqueued) records an event on the
  dispatch stream behind the step that reads the slot.

Nothing stays on the ring between two pump calls: the pump puts,
dispatches and releases each batch in the same call.

A slot is one pinned int32 host buffer of 8 × B laid out as
``AnomalyDetector._args`` lays out a batch, packed in place through
numpy views (``SpanTensorizer.pack_columns_into``), and one device
buffer of the same layout; both are allocated once per slot and width.
Two guards keep a slot's bytes stable while they are read:

- before a slot's host buffer is repacked, its last copy must be done
  (the put waits on the copy's event on the host);
- before a slot's device buffer is overwritten, the step that read it
  must be done: the side stream waits on the event ``release`` recorded
  on the dispatch stream.

The device buffers are allocated on the side stream, never from the
dispatch stream's pool, whose freed blocks queued steps may still read.

The spine owns no detector state: dispatch, ``checkpoint.save`` and the
keyspace evictor stay on the one dispatch stream under the pipeline's
``_dispatch_lock``. On the CPU (``device="cpu"``) the ring works the
same, with plain copies and no streams or events.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .tensorize import SpanColumns, SpanTensorizer, TensorBatch


class SlotPut:
    """One batch put on the card: the slot's device lanes, the event
    behind their copy (None off the card, or once the copy is done), and
    the put's own seconds: ``stage_s`` packing and issuing the copy,
    ``wait_s`` blocked on the slot's last copy (and, with ``overlap``
    off, on this one). ``hit``: the copy was issued while the last step
    still ran on the card."""

    __slots__ = ("lanes", "copied", "slot", "stage_s", "wait_s", "hit")

    def __init__(self, lanes: torch.Tensor, copied, slot: int, stage_s: float, wait_s: float, hit: bool):
        self.lanes = lanes  # int32 [8 × width] on the device
        self.copied: "torch.cuda.Event | None" = copied
        self.slot = slot
        self.stage_s = stage_s
        self.wait_s = wait_s
        self.hit = hit


class _Slot:
    __slots__ = ("host", "dev", "copied", "consumed")

    def __init__(self):
        self.host: dict[int, tuple[torch.Tensor, TensorBatch]] = {}
        self.dev: dict[int, torch.Tensor] = {}
        self.copied: "torch.cuda.Event | None" = None  # the last copy out of a host buffer
        self.consumed: "torch.cuda.Event | None" = None  # after the last step that read dev


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
    """The ring of staging slots (see the module doc)."""

    def __init__(
        self,
        tensorizer: SpanTensorizer,
        device: "torch.device | str",
        depth: int = 2,
        overlap: bool = True,
        chunk_rows: int = 0,
    ):
        if depth < 1:
            raise ValueError(f"spine ring depth must be >= 1 (got {depth})")
        self.tensorizer = tensorizer
        self.device = pinned_device(device)
        self._cuda = self.device.type == "cuda"
        self.depth = int(depth)
        self.overlap = bool(overlap)
        self.chunk_rows = int(chunk_rows)
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._slots = [_Slot() for _ in range(self.depth)]
        self._seq = 0
        # After the last step released, whichever slot it read.
        self._last_consumed: "torch.cuda.Event | None" = None
        self.puts_total = 0
        self.overlap_hits = 0  # copies issued while the last step still ran on the card
        self.overlap_misses = 0  # copies issued with the card idle (always, off the card)
        self.step_waits = 0  # copies queued behind a step still reading their slot
        self.stage_s = 0.0  # pack + copy issue
        self.take_wait_s = 0.0  # blocked in puts (``SlotPut.wait_s``)

    def put(self, cols: SpanColumns, width: int) -> SlotPut:
        """Pack ``cols`` into the next slot at ``width`` lanes and issue
        its copy to the card. A failed pack or copy raises here and
        leaves the slot to the next put."""
        idx = self._seq % self.depth
        slot = self._slots[idx]
        t0 = time.perf_counter()
        if slot.copied is not None:
            slot.copied.synchronize()  # guard 1: the host buffer's last copy is done
        t1 = time.perf_counter()
        buf, views, dev = self._buffers(slot, width)
        self.tensorizer.pack_columns_into(views, cols, chunk_rows=self.chunk_rows)
        copied = None
        hit = step_wait = False
        if self._cuda:
            hit = self._last_consumed is not None and not self._last_consumed.query()
            with torch.cuda.stream(self._side):
                if slot.consumed is not None:
                    step_wait = not slot.consumed.query()
                    self._side.wait_event(slot.consumed)  # guard 2: the step that read dev is done
                dev.copy_(buf, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self._side)
        else:
            dev.copy_(buf)
        slot.copied = copied
        self._seq += 1
        t2 = time.perf_counter()
        wait_s = t1 - t0
        if copied is not None and not self.overlap:
            copied.synchronize()
            copied = None
            wait_s += time.perf_counter() - t2
        self.puts_total += 1
        self.overlap_hits += hit
        self.overlap_misses += not hit
        self.step_waits += step_wait
        self.stage_s += t2 - t1
        self.take_wait_s += wait_s
        return SlotPut(dev, copied, idx, t2 - t1, wait_s, hit)

    def release(self, put: SlotPut) -> None:
        """The step that reads ``put.lanes`` is enqueued: record an event
        on the current stream behind it, which the slot's next copy waits
        for."""
        if not self._cuda:
            return
        stream = torch.cuda.current_stream(self.device)
        consumed = torch.cuda.Event()
        consumed.record(stream)
        # The slot's device buffer is read here, off the stream it was
        # allocated on: were it ever freed, its block must wait for this
        # stream too.
        put.lanes.record_stream(stream)
        self._slots[put.slot].consumed = self._last_consumed = consumed

    def pending(self) -> int:
        """Batches put and not yet dispatched between pump calls: none."""
        return 0

    def stats(self) -> dict:
        hits, misses = self.overlap_hits, self.overlap_misses
        puts = hits + misses
        return {
            "ring_depth": self.depth,
            "staged": 0,
            "puts_total": self.puts_total,
            "overlap_hits": hits,
            "overlap_misses": misses,
            # Of the batches put, the share whose copy was issued behind
            # a step still running on the card.
            "overlap_ratio": (hits / puts) if puts else 0.0,
            "step_waits": self.step_waits,
            "stage_s": self.stage_s,
            "take_wait_s": self.take_wait_s,
        }

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
