"""Epoch fencing: the process-local authority over guarded writes.

Every checkpoint, Kafka offset commit, history append and remediation
write carries a monotonically increasing **epoch**. A standby promotes
by bumping it; a resurrected stale primary learns of the newer epoch on
any channel (the checkpoint volume at boot, the history log when its
store opens, broker commit metadata) and :meth:`EpochFence.check` then
refuses every guarded write with :class:`checkpoint.StaleEpochError`.

Only the fence is here. The replication link itself (primary, standby,
envelopes, anti-entropy) is not ported yet.
"""

from __future__ import annotations

import threading

from .checkpoint import StaleEpochError


class EpochFence:
    """Process-local fencing authority.

    ``epoch`` is this process's own epoch; ``observed`` is the largest
    epoch seen on any channel. Once ``observed > epoch`` the process is
    stale and :meth:`check` raises until an explicit :meth:`bump`
    (promotion) or a restart."""

    def __init__(self, epoch: int = 0):
        self._lock = threading.Lock()
        self.epoch = int(epoch)
        self.observed = int(epoch)
        self.fenced_writes = 0
        # Per-path rejection counts (checkpoint / offsets / history /
        # remediation): the audit trail of a stale process's refused
        # writes.
        self.fenced_by_path: dict[str, int] = {}

    def observe(self, epoch: int) -> None:
        """Record fencing evidence from any channel."""
        with self._lock:
            if epoch > self.observed:
                self.observed = int(epoch)

    def stale(self) -> bool:
        with self._lock:
            return self.observed > self.epoch

    def check(self, path: str = "write") -> None:
        """Raise :class:`checkpoint.StaleEpochError` when stale."""
        with self._lock:
            if self.observed > self.epoch:
                self.fenced_writes += 1
                self.fenced_by_path[path] = self.fenced_by_path.get(path, 0) + 1
                raise StaleEpochError(
                    f"{path} fenced: epoch {self.epoch} superseded by "
                    f"{self.observed}"
                )

    def bump(self) -> int:
        """Promotion: claim an epoch above everything ever observed."""
        with self._lock:
            self.epoch = max(self.epoch, self.observed) + 1
            self.observed = self.epoch
            return self.epoch
