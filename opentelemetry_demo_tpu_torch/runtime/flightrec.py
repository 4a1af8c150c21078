"""Flight recorder: a bounded ring of structured runtime events.

The detector's state transitions (role flips, brownout ladder steps,
fence hits, shed bursts, frame quarantines, component crash loops) and
a 1 Hz trend snapshot (phase shares, spine overlap, lag p99) land in a
fixed-size ring at the cost of one locked append each. The ring is
served live at ``/query/flight`` on the query plane and dumped to a
self-contained JSON evidence file, ``flight-<reason>-<ms>.json``, on
every health or role transition, with a per-reason cooldown so a
flapping transition cannot storm the disk. An empty ``dump_dir`` keeps
the ring in memory only. Event kinds are free-form strings.

The ring, snapshot and dump files are the reference package's.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable


class FlightRecorder:
    """Fixed-size event ring + transition-evidence dumps (module doc).

    One lock guards the ring and the counters: every operation under
    it is a bounded append or a copy, never I/O — ``dump`` snapshots
    under the lock and writes the file outside it, so a slow disk
    can't stall the pump thread behind a recording.
    """

    def __init__(
        self,
        size: int = 512,
        dump_dir: str = "",
        clock: Callable[[], float] = time.time,
        dump_cooldown_s: float = 2.0,
    ):
        self._ring: deque = deque(maxlen=max(int(size), 1))
        self.dump_dir = dump_dir or ""
        self._clock = clock
        self._cooldown = float(dump_cooldown_s)
        self._lock = threading.Lock()
        self._last_dump: dict[str, float] = {}
        self._seq = 0
        self.events_total: dict[str, int] = {}
        self.dumps_total: dict[str, int] = {}
        self.dump_errors = 0

    @property
    def size(self) -> int:
        return self._ring.maxlen or 0

    def record(self, kind: str, **detail) -> None:
        """Append one event (any thread). ``detail`` must be
        JSON-able — it rides the evidence files and /query/flight."""
        with self._lock:
            self._seq += 1
            self._ring.append({
                "seq": self._seq,
                "t": self._clock(),
                "kind": kind,
                **detail,
            })
            self.events_total[kind] = self.events_total.get(kind, 0) + 1

    def snapshot(self) -> list[dict]:
        """Copy of the ring, oldest first (the /query/flight body)."""
        with self._lock:
            return [dict(ev) for ev in self._ring]

    def counts(self) -> tuple[dict[str, int], dict[str, int]]:
        """(events_total, dumps_total) copies for the metrics export."""
        with self._lock:
            return dict(self.events_total), dict(self.dumps_total)

    def dump(self, reason: str, force: bool = False, **context) -> str | None:
        """Write the ring as a postmortem evidence file; returns the
        path, or None (no directory configured / inside the per-reason
        cooldown / write failed — recording evidence must never
        compound the fault it records, the quarantine() rule)."""
        if not self.dump_dir:
            return None
        now = time.monotonic()
        with self._lock:
            if (
                not force
                and now - self._last_dump.get(reason, -self._cooldown)
                < self._cooldown
            ):
                return None
            self._last_dump[reason] = now
            events = [dict(ev) for ev in self._ring]
            self.dumps_total[reason] = self.dumps_total.get(reason, 0) + 1
        doc = {
            "reason": reason,
            "t": self._clock(),
            "events": events,
            **context,
        }
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir,
                f"flight-{reason}-{int(self._clock() * 1000)}.json",
            )
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, default=str)
                f.write("\n")
            os.replace(tmp, path)
            return path
        except OSError:
            with self._lock:
                self.dump_errors += 1
            return None
