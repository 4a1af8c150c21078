"""The time-travel tier wired onto a live pipeline.

The reference package wires its history tier inside its daemon. This
module does the same wiring once, as a function of its own:

- a :class:`~.history.HistoryStore` over a directory, a
  :class:`~.history.HistoryReader` and a
  :class:`~.history.HistoryWriter` whose snapshot is the pipeline's
  stream-ordered state copy (:func:`snapshot_fn`);
- ``pipeline.history_capture = writer.capture`` when spans are captured;
- a :class:`~.keyspace.KeyspaceManager` whose eviction folds land in the
  writer;
- the harvester's evidence bundles (``take_explain_exports``) into
  ``writer.capture_explain`` on every :meth:`TimeTravel.tick`;
- a :class:`~.query.QueryEngine` with ``history=`` the reader, over the
  same snapshot.
"""

from __future__ import annotations

from typing import Callable

from .history import HistoryReader, HistoryStore, HistoryWriter
from .keyspace import KeyspaceManager
from .query import QueryEngine
from .querybench import state_snapshot_fn


def snapshot_fn(pipe) -> Callable[[], tuple[dict, dict]]:
    """The pipeline's state snapshot (``querybench.state_snapshot_fn``:
    the whole state copied off the device in stream order) with the
    keyspace generation in its meta: range reads merge records of one
    generation only, and a stitch refuses live state of another."""
    base = state_snapshot_fn(pipe)

    def snapshot():
        arrays, meta = base()
        meta["generation"] = pipe.tensorizer.generation
        return arrays, meta

    return snapshot


class TimeTravel:
    """History store, writer, reader, keyspace manager and query engine
    over one pipeline. ``keyspace`` (keyword arguments of
    :class:`KeyspaceManager`, or None for none) and ``query`` (keyword
    arguments of :class:`QueryEngine`) tune the two consumers; the rest
    are the writer's. The store keeps its defaults: a caller that needs
    retention or an epoch fence builds :class:`HistoryStore` itself."""

    def __init__(
        self,
        pipe,
        directory: str,
        *,
        rungs: tuple[float, ...] = (1.0, 60.0, 3600.0),
        capture_spans: bool = False,
        span_queue_max: int = 64,
        keyspace: dict | None = None,
        query: dict | None = None,
    ):
        self.pipe = pipe
        self.store = HistoryStore(directory)
        self.reader = HistoryReader(self.store, rungs=rungs)
        self.snapshot = snapshot_fn(pipe)
        self.writer = HistoryWriter(
            self.store,
            self.snapshot,
            rungs=rungs,
            capture_spans=capture_spans,
            span_queue_max=span_queue_max,
            service_names_fn=lambda: pipe.tensorizer.service_names,
        )
        if capture_spans:
            pipe.history_capture = self.writer.capture
        self.keyspace = (
            None if keyspace is None
            else KeyspaceManager(pipe, history_writer=self.writer, **keyspace)
        )
        self.engine = QueryEngine(self.snapshot, history=self.reader, **(query or {}))

    def export_explains(self) -> list[dict]:
        """Hand the harvester's new evidence bundles to the writer;
        returns them (a caller may also post them as OTLP logs: the
        pipeline's export queue is drained here)."""
        bundles = self.pipe.take_explain_exports()
        for b in bundles:
            self.writer.capture_explain(b)
        return bundles

    def tick(self, now: float | None = None) -> None:
        """One compaction step (the caller's cadence; ``now`` defaults to
        the wall clock): the new bundles, then the writer's tick (span
        drain, explain drain, ladder)."""
        self.export_explains()
        self.writer.tick(now)

    def close(self) -> None:
        """Stop the keyspace manager's thread, drain and seal; the
        pipeline stops capturing."""
        if self.keyspace is not None:
            self.keyspace.close()
        if self.pipe.history_capture == self.writer.capture:
            self.pipe.history_capture = None
        self.export_explains()
        self.writer.close()
