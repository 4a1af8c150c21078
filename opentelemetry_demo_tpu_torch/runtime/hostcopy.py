"""Stream-ordered copies of device tensors to the host.

The detector's step updates its state in place on one CUDA stream. A
reader that wants a consistent copy (a checkpoint, a query snapshot, the
flag-time state of an evidence bundle) must neither wait for the
in-flight steps while it holds the dispatch lock (``t.cpu()`` would)
nor read host memory the copy has not yet written
(``t.to("cpu", non_blocking=True)`` without an event would).

:class:`HostCopy` splits the copy in two. :meth:`HostCopy.start`, run
under the dispatch lock, only enqueues work on the steps' stream: one
gather of every tensor's bytes into one device buffer, one
non-blocking copy of it into pinned host memory, and one event. The copy
therefore holds exactly the steps dispatched before it. :meth:`HostCopy.numpy`,
run after the lock is released, waits for the event and returns the
arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


class HostCopy:
    """A stream-ordered copy of a tuple of tensors to the host.

    The constructor takes the layout and allocates the host buffer
    (pinned for a card); :meth:`start` enqueues the copy on ``stream``
    (the stream the writers of the tensors run on; the calling thread's
    current stream when None); :meth:`numpy` waits for it and returns the
    arrays with the tensors' dtypes and shapes. On the CPU the copy is
    made in :meth:`start`."""

    def __init__(self, like):
        self._layout = [(np_dtype(t.dtype), tuple(t.shape)) for t in like]
        n = sum(int(np.prod(shape, dtype=np.int64)) * dtype.itemsize for dtype, shape in self._layout)
        self._cuda = like[0].is_cuda
        self._host = torch.empty(n, dtype=torch.uint8, pin_memory=self._cuda)
        self._ready = None

    def start(self, tensors, stream: "torch.cuda.Stream | None" = None) -> None:
        if not self._cuda:
            self._host.copy_(torch.cat([t.detach().reshape(-1).view(torch.uint8) for t in tensors]))
            return
        if stream is None:
            stream = torch.cuda.current_stream(tensors[0].device)
        with torch.cuda.stream(stream):
            flat = torch.cat([t.detach().reshape(-1).view(torch.uint8) for t in tensors])
            self._host.copy_(flat, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record(stream)

    def numpy(self) -> list[np.ndarray]:
        if self._ready is not None:
            self._ready.synchronize()
        raw = self._host.numpy()
        out, pos = [], 0
        for dtype, shape in self._layout:
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            out.append(raw[pos:pos + n].view(dtype).reshape(shape))
            pos += n
        return out
