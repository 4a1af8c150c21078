"""The one traffic generator: a configuration's service table and a mix's
parameters in, OTLP bodies and their schedule out, all from the seed.

A mix is one of two loops (``"loop"`` in its file):

- ``closed``: ``in_flight`` collector exporters, each sending its next
  body once the last was accepted. Bodies hold ``spans_per_body`` spans
  and are drawn in turn from a pool of ``pool_bodies`` distinct bodies
  (a long window sends the pool again, as a collector's retry would).
- ``paced``: ``agents`` collector agents, each flushing every
  ``flush_s`` seconds the spans its share of ``rate_spans_s`` gave it
  (Poisson), capped at ``cap`` spans a body: an open loop whose due
  times do not move when the system slows.

Every span carries its service (drawn by the table's shares), a duration
(log-normal per service, whole microseconds), an error status (the
service's error rate), an operation and, with the service's attribute
share, one monitored attribute. Spans come in traces of up to 8 spans
that stay inside one body; within a trace the durations differ modulo 8
microseconds, so (trace key, duration) names a span.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..reference.hashing import splitmix64
from .wire import Encoder

MAX_TRACE = 8


@dataclass
class ServiceTable:
    names: list[str]
    share: np.ndarray
    lat_median_us: np.ndarray
    log_sigma: np.ndarray
    error_rate: np.ndarray
    attr_share: np.ndarray
    attr_class: np.ndarray  # index into classes, per service
    ops: list[list[str]]
    classes: list[tuple[str, list[str], np.ndarray]]  # (key, values, weights)
    spans_per_trace: float


def service_table(cfg: dict) -> ServiceTable:
    """The configuration's services, as its table lists them."""
    spec = cfg["services"]
    classes = []
    class_ids = {}
    for name, c in spec["attr_classes"].items():
        if "values" in c:
            values = list(c["values"])
        else:
            values = [c["format"].format(i) for i in range(int(c["count"]))]
        weights = np.asarray(c.get("weights", np.ones(len(values))), np.float64)
        class_ids[name] = len(classes)
        classes.append((c["key"], values, weights / weights.sum()))
    rows = spec["table"]
    names = [r["name"] for r in rows]
    share = np.array([r["share"] for r in rows], np.float64)
    lat = np.array([r["lat_median_us"] for r in rows], np.float64)
    sigma = np.array([r["log_sigma"] for r in rows], np.float64)
    err = np.array([r["error_rate"] for r in rows], np.float64)
    attr_share = np.array([r["attr_share"] for r in rows], np.float64)
    attr_class = np.array([class_ids.get(r.get("attr_class"), 0) for r in rows])
    ops = [list(r["ops"]) for r in rows]
    return ServiceTable(names, share / share.sum(), lat, sigma, err, attr_share, attr_class,
                        ops, classes, float(spec["spans_per_trace"]))


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, stream]))


class Corpus:
    """The spans of a run as columns, and the bodies that carry them."""

    def __init__(self, table: ServiceTable, seed: int):
        self.table = table
        self.seed = seed
        self.cols: dict[str, np.ndarray] = {}
        # Flat (class, value) vocabulary for the attribute column.
        self.attr_base = np.cumsum([0] + [len(c[1]) for c in table.classes])[:-1]
        vocab = [(c[0], v) for c in table.classes for v in c[1]]
        self.attr_values = [v for _, v in vocab]
        self.encoder = Encoder(table.names, table.ops, vocab)

    def draw(self, sizes: list[int], stream: int) -> list[np.ndarray]:
        """Append one body of each size to the corpus; returns each
        body's corpus rows in document order (grouped by service)."""
        t = self.table
        rng = _rng(self.seed, stream)
        n = int(sum(sizes))
        base = self.cols["svc"].shape[0] if self.cols else 0
        svc = rng.choice(len(t.names), size=n, p=t.share).astype(np.int32)
        # Traces: runs of 1..8 spans that never cross a body boundary.
        body_of = np.repeat(np.arange(len(sizes)), sizes)
        k = np.minimum(1 + rng.poisson(max(t.spans_per_trace - 1.0, 0.0), n), MAX_TRACE)
        starts = np.zeros(n, bool)
        pos = np.cumsum(np.r_[0, k])  # candidate trace starts
        starts[pos[pos < n]] = True
        starts |= np.r_[True, body_of[1:] != body_of[:-1]]
        trace = np.cumsum(starts) - 1
        first = np.nonzero(starts)[0]
        pos_in_trace = np.arange(n) - first[trace]
        pos_in_trace = np.minimum(pos_in_trace, MAX_TRACE - 1)
        n_traces = first.shape[0]
        lo = rng.integers(0, 2**64, n_traces, dtype=np.uint64)
        hi = rng.integers(0, 2**64, n_traces, dtype=np.uint64)
        lat = np.exp(np.log(t.lat_median_us[svc]) + t.log_sigma[svc] * rng.standard_normal(n))
        dur = np.maximum(np.round(lat).astype(np.int64) // MAX_TRACE, 1) * MAX_TRACE + pos_in_trace
        err = rng.random(n) < t.error_rate[svc]
        n_ops = np.array([len(o) for o in t.ops])
        op = (rng.random(n) * n_ops[svc]).astype(np.int32)
        has_attr = rng.random(n) < t.attr_share[svc]
        cls = t.attr_class[svc]
        attr = np.full(n, -1, np.int32)
        for ci, (_key, values, weights) in enumerate(t.classes):
            m = has_attr & (cls == ci)
            attr[m] = self.attr_base[ci] + rng.choice(len(values), size=int(m.sum()), p=weights)
        new = dict(
            svc=svc, trace_lo=lo[trace], trace_hi=hi[trace],
            span_id=rng.integers(0, 2**64, n, dtype=np.uint64),
            start_ns=np.uint64(1_700_000_000_000_000_000) + (np.arange(n, dtype=np.uint64) + np.uint64(base)) * np.uint64(1000),
            dur_us=dur, err=err, op=op, attr=attr,
        )
        for key, v in new.items():
            self.cols[key] = np.concatenate([self.cols[key], v]) if key in self.cols else v
        bodies = []
        off = base
        for size in sizes:
            rows = np.arange(off, off + size)
            bodies.append(rows[np.argsort(svc[rows - base], kind="stable")])
            off += size
        return bodies

    def encode(self, bodies: list[np.ndarray]) -> list[bytes]:
        return self.encoder.encode(self.cols, bodies)

    def span_keys(self) -> np.ndarray:
        """Each span's name, from the columns the detector sees: its
        trace key and its duration as float32 bits."""
        lat_bits = np.asarray(self.cols["dur_us"], np.float32).view(np.uint32).astype(np.uint64)
        return span_key(self.cols["trace_lo"], lat_bits)


def span_key(trace_key: np.ndarray, lat_bits: np.ndarray) -> np.ndarray:
    return np.asarray(trace_key, np.uint64) ^ splitmix64(np.asarray(lat_bits, np.uint64))


@dataclass
class Send:
    """One body to send: corpus rows, wire bytes, and its due offset
    from the start of the window (paced), or None (closed)."""

    rows: np.ndarray
    body: bytes
    due: float | None


def build(table: ServiceTable, mix: dict, seed: int, seconds: float) -> tuple[Corpus, list[Send], list[Send]]:
    """(corpus, warm-up sends, timed sends) of one run."""
    corpus = Corpus(table, seed)
    warm_sizes = [int(s) for s in mix["warmup_bodies"]]
    warm_rows = corpus.draw(warm_sizes, stream=1)
    warm = [Send(r, b, None) for r, b in zip(warm_rows, corpus.encode(warm_rows))]
    if mix["loop"] == "closed":
        sizes = [int(mix["spans_per_body"])] * int(mix["pool_bodies"])
        rows = corpus.draw(sizes, stream=2)
        timed = [Send(r, b, None) for r, b in zip(rows, corpus.encode(rows))]
    elif mix["loop"] == "paced":
        rng = _rng(seed, 3)
        agents, flush = int(mix["agents"]), float(mix["flush_s"])
        lam = float(mix["rate_spans_s"]) * flush / agents
        n_flush = int(round(seconds / flush))
        dues, sizes = [], []
        for a in range(agents):
            phase = flush * a / agents
            counts = np.minimum(rng.poisson(lam, n_flush), int(mix["cap"]))
            for j, c in enumerate(counts):
                if c:
                    dues.append(phase + j * flush)
                    sizes.append(int(c))
        order = np.argsort(dues, kind="stable")
        dues = [dues[i] for i in order]
        sizes = [sizes[i] for i in order]
        rows = corpus.draw(sizes, stream=2)
        timed = [Send(r, b, d) for r, b, d in zip(rows, corpus.encode(rows), dues)]
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    return corpus, warm, timed
