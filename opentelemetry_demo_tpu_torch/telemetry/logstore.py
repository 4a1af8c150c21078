"""Log store: named indices of structured log documents.

The OTLP logs leg (``runtime.otlp.decode_logs_request``) lands here: a
bounded ring per index, and the search verbs of an OpenSearch
datasource — filter by service, severity, body substring or trace id,
most recent first.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

SEVERITIES = ("DEBUG", "INFO", "WARN", "ERROR", "FATAL")


def normalize_severity(text: str | None) -> str:
    """Free-form OTLP severityText → the store's five levels.

    SDKs disagree on severity text ("Information", "warning", "ERROR2",
    "Critical"…); every decoder that makes LogDocs runs this, so the
    store only ever holds the five canonical levels.
    """
    sev = (text or "INFO").upper()
    if sev in SEVERITIES:
        return sev
    if sev.startswith("WARN"):
        return "WARN"
    if sev.startswith("ERR"):
        return "ERROR"
    if sev.startswith(("FATAL", "CRIT")):
        return "FATAL"
    if sev.startswith(("DEBUG", "TRACE")):
        return "DEBUG"
    return "INFO"


@dataclass
class LogDoc:
    ts: float
    service: str
    severity: str
    body: str
    attrs: dict = field(default_factory=dict)
    trace_id: bytes | None = None


class LogStore:
    """Bounded per-index document store with OpenSearch-shaped search."""

    def __init__(self, max_docs_per_index: int = 100_000):
        self.max_docs_per_index = max_docs_per_index
        self._indices: dict[str, deque[LogDoc]] = {}

    def add(self, doc: LogDoc, index: str = "otel") -> None:
        if doc.severity not in SEVERITIES:
            raise ValueError(f"severity {doc.severity!r} not one of {SEVERITIES}")
        # setdefault is one GIL-atomic dict operation: receiver threads
        # racing on a new index must not each create a ring and drop a
        # document. Appends to the shared deque are atomic too.
        ring = self._indices.setdefault(index, deque(maxlen=self.max_docs_per_index))
        ring.append(doc)

    def indices(self) -> list[str]:
        return sorted(self._indices)

    def count(self, index: str = "otel") -> int:
        return len(self._indices.get(index, ()))

    def search(
        self,
        index: str = "otel",
        service: str | None = None,
        severity: str | None = None,
        query: str | None = None,
        trace_id: bytes | None = None,
        limit: int = 100,
    ) -> list[LogDoc]:
        out: list[LogDoc] = []
        for doc in reversed(self._indices.get(index, ())):
            if service is not None and doc.service != service:
                continue
            if severity is not None and doc.severity != severity:
                continue
            if query is not None and query not in doc.body:
                continue
            if trace_id is not None and doc.trace_id != trace_id:
                continue
            out.append(doc)
            if len(out) >= limit:
                break
        return out
