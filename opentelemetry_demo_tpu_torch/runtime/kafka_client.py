"""Minimal Kafka client: a simple consumer and a producer over the wire subset.

The consumer is the classic "simple consumer with group offset storage":
partitions assigned by hand from Metadata, positions restored through
OffsetFetch (else the earliest), Fetch v4 polls under ``max_bytes``,
and OffsetCommit with generation -1 and an empty member id. That is the
Kafka protocol without the group-membership state machine
(JoinGroup/SyncGroup/Heartbeat), which only matters for rebalancing
several instances; the detector scales by partition assignment.

It keeps the contract of the shop's consumers: a poll loop, and the
committed offsets as the resume point. The bytes it sends are the JAX
package's client's.
"""

from __future__ import annotations

import itertools
import socket
import threading
import time
from typing import NamedTuple

from . import kafka_wire as kw


class FetchedMessage(NamedTuple):
    partition: int
    offset: int
    key: bytes | None
    value: bytes | None
    headers: tuple = ()  # ((str, bytes|None), ...) — v2 record headers


class KafkaConnection:
    """One broker connection: framed request/response with correlation."""

    def __init__(self, host: str, port: int, client_id: str = "otel-demo-tpu",
                 timeout_s: float = 5.0):
        self.client_id = client_id
        self._corr = itertools.count(1)
        self._lock = threading.Lock()
        self._sock = socket.create_connection((host, port), timeout=timeout_s)

    def request(self, api_key: int, api_version: int, body: bytes) -> kw.Reader:
        corr = next(self._corr)
        frame = kw.encode_request(api_key, api_version, corr, self.client_id, body)
        with self._lock:
            self._sock.sendall(frame)
            resp = kw.read_frame(self._sock)
        if resp is None:
            raise kw.KafkaWireError("broker closed connection")
        r = kw.Reader(resp)
        got = r.int32()
        if got != corr:
            raise kw.KafkaWireError(f"correlation mismatch {got} != {corr}")
        return r

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _parse_bootstrap(bootstrap: str) -> tuple[str, int]:
    host, _, port = bootstrap.partition(":")
    return host or "127.0.0.1", int(port or 9092)


class KafkaProducer:
    """Produce v3 (v2 RecordBatch + headers) with broker-assigned
    offsets (acks=1 semantics) — the modern protocol minimum, so the
    same client speaks to the in-repo broker and a real Kafka ≥3.0."""

    def __init__(self, bootstrap: str):
        self._conn = KafkaConnection(*_parse_bootstrap(bootstrap))

    def send(self, topic: str, value: bytes, key: bytes | None = None,
             partition: int = 0, headers=()) -> int:
        """Returns the broker-assigned base offset. ``headers``:
        iterable of (str, bytes|None) pairs or a {str: bytes} mapping:
        trace context crosses the async boundary here."""
        batch = kw.encode_record_batch(
            [(key, value, headers)],
            base_timestamp_ms=int(time.time() * 1000),
        )
        body = (
            kw.enc_string(None)  # transactional_id
            + kw.enc_int16(1)  # required_acks
            + kw.enc_int32(1000)  # timeout
            + kw.enc_array(
                [(topic, [(partition, batch)])],
                lambda t: kw.enc_string(t[0])
                + kw.enc_array(
                    t[1],
                    lambda p: kw.enc_int32(p[0]) + kw.enc_int32(len(p[1])) + p[1],
                ),
            )
        )
        r = self._conn.request(kw.PRODUCE, 3, body)

        def read_partition():
            partition_ = r.int32()
            error = r.int16()
            base_offset = r.int64()
            r.int64()  # log_append_time
            return partition_, error, base_offset

        topics = r.array(lambda: (r.string(), r.array(read_partition)))
        _name, parts = topics[0]
        partition_, error, base_offset = parts[0]
        if error != kw.NO_ERROR:
            raise kw.KafkaProduceError(error, partition_)
        return base_offset

    def close(self) -> None:
        self._conn.close()


class KafkaConsumer:
    """Simple consumer with consumer-group offset storage."""

    def __init__(
        self,
        bootstrap: str,
        group_id: str,
        topic: str,
        max_bytes: int = 1 << 20,
        auto_commit: bool = True,
    ):
        self.group_id = group_id
        self.topic = topic
        self.max_bytes = max_bytes
        self.auto_commit = auto_commit
        self._conn = KafkaConnection(*_parse_bootstrap(bootstrap))
        self._partitions = self._fetch_partitions()
        # Restore committed positions; fall back to earliest.
        committed = self.committed()
        self._positions = {
            p: committed.get(p, -1) if committed.get(p, -1) >= 0 else 0
            for p in self._partitions
        }

    # -- metadata / offsets --------------------------------------------

    def _fetch_partitions(self) -> list[int]:
        body = kw.enc_array([self.topic], kw.enc_string)
        r = self._conn.request(kw.METADATA, 0, body)
        r.array(lambda: (r.int32(), r.string(), r.int32()))  # brokers

        def read_partition():
            r.int16()  # error
            partition = r.int32()
            r.int32()  # leader
            r.array(r.int32)
            r.array(r.int32)
            return partition

        topics = r.array(lambda: (r.int16(), r.string(), r.array(read_partition)))
        for _err, name, parts in topics:
            if name == self.topic:
                return sorted(parts)
        return [0]

    def committed(self) -> dict[int, int]:
        """Consumer-group committed offsets (next-to-read), -1 = none."""
        return {p: off for p, (off, _meta) in self.committed_meta().items()}

    def committed_meta(self) -> dict[int, tuple[int, str]]:
        """Committed offsets WITH their metadata strings.

        The metadata slot is where epoch-tagged commits
        (``kafka_orders.OrdersSource.commit``) park the writer's
        fencing epoch — a resurrected stale primary reads it at boot
        and learns it has been promoted past before its first write."""
        body = kw.enc_string(self.group_id) + kw.enc_array(
            [(self.topic, self._partitions if hasattr(self, "_partitions") else [0])],
            lambda t: kw.enc_string(t[0]) + kw.enc_array(t[1], kw.enc_int32),
        )
        r = self._conn.request(kw.OFFSET_FETCH, 1, body)

        def read_partition():
            partition = r.int32()
            offset = r.int64()
            metadata = r.string()
            r.int16()  # error
            return partition, (offset, metadata or "")

        topics = r.array(lambda: (r.string(), r.array(read_partition)))
        out: dict[int, tuple[int, str]] = {}
        for _name, parts in topics:
            out.update(dict(parts))
        return out

    def commit(
        self,
        offsets: dict[int, int] | None = None,
        metadata: str = "",
    ) -> None:
        """Commit next-to-read offsets (defaults to current positions).

        ``metadata`` rides in the protocol's per-partition metadata
        string (stored by the broker, returned by OFFSET_FETCH) — the
        epoch-tag channel for fenced commits."""
        offsets = offsets if offsets is not None else dict(self._positions)
        body = (
            kw.enc_string(self.group_id)
            + kw.enc_int32(-1)  # generation: simple consumer
            + kw.enc_string("")  # member id
            + kw.enc_int64(-1)  # retention: broker default
            + kw.enc_array(
                [(self.topic, sorted(offsets.items()))],
                lambda t: kw.enc_string(t[0])
                + kw.enc_array(
                    t[1],
                    lambda p: kw.enc_int32(p[0])
                    + kw.enc_int64(p[1])
                    + kw.enc_string(metadata),
                ),
            )
        )
        r = self._conn.request(kw.OFFSET_COMMIT, 2, body)
        topics = r.array(
            lambda: (r.string(), r.array(lambda: (r.int32(), r.int16())))
        )
        for _name, parts in topics:
            for partition, error in parts:
                if error != kw.NO_ERROR:
                    raise kw.KafkaWireError(
                        f"offset commit error {error} on partition {partition}"
                    )

    @property
    def positions(self) -> dict[int, int]:
        return dict(self._positions)

    def seek(self, partition: int, offset: int) -> None:
        """Set the next-to-read position; a partition the boot-time
        metadata didn't list is added to the fetch set rather than
        silently dropped (stale metadata must not cause replay)."""
        if partition not in self._positions:
            self._partitions = sorted(set(self._partitions) | {partition})
        self._positions[partition] = offset

    def _reset_offset(self, partition: int) -> None:
        """OFFSET_OUT_OF_RANGE recovery: reset to earliest (the
        ``auto.offset.reset=earliest`` rule the shop's consumers
        configure) via ListOffsets."""
        body = (
            kw.enc_int32(-1)
            + kw.enc_array(
                [(self.topic, [(partition, -2, 1)])],  # ts -2 = earliest
                lambda t: kw.enc_string(t[0])
                + kw.enc_array(
                    t[1],
                    lambda p: kw.enc_int32(p[0])
                    + kw.enc_int64(p[1])
                    + kw.enc_int32(p[2]),
                ),
            )
        )
        r = self._conn.request(kw.LIST_OFFSETS, 0, body)

        def read_partition():
            part = r.int32()
            err = r.int16()
            offsets = r.array(r.int64)
            return part, err, offsets

        topics = r.array(lambda: (r.string(), r.array(read_partition)))
        for _name, parts in topics:
            for part, err, offsets in parts:
                if part == partition and err == kw.NO_ERROR and offsets:
                    self._positions[partition] = offsets[0]

    # -- poll -----------------------------------------------------------

    def poll(self, max_wait_ms: int = 100) -> list[FetchedMessage]:
        """Fetch v4 (v2 RecordBatch + headers) — the modern protocol
        minimum, same rationale as the producer's v3."""
        body = (
            kw.enc_int32(-1)  # replica_id
            + kw.enc_int32(max_wait_ms)
            + kw.enc_int32(1)  # min_bytes
            + kw.enc_int32(self.max_bytes)  # whole-response cap
            + kw.enc_int8(0)  # isolation_level: read_uncommitted
            + kw.enc_array(
                [(self.topic, [(p, self._positions[p], self.max_bytes)
                               for p in self._partitions])],
                lambda t: kw.enc_string(t[0])
                + kw.enc_array(
                    t[1],
                    lambda p: kw.enc_int32(p[0])
                    + kw.enc_int64(p[1])
                    + kw.enc_int32(p[2]),
                ),
            )
        )
        r = self._conn.request(kw.FETCH, 4, body)
        r.int32()  # throttle_time_ms

        def read_partition():
            partition = r.int32()
            error = r.int16()
            hw = r.int64()
            r.int64()  # last_stable_offset
            r.array(lambda: (r.int64(), r.int64()))  # aborted_transactions
            size = r.int32()
            batches = r.buf[r.pos : r.pos + size]
            r.pos += size
            return partition, error, hw, batches

        topics = r.array(lambda: (r.string(), r.array(read_partition)))
        out: list[FetchedMessage] = []
        for _name, parts in topics:
            for partition, error, _hw, batches in parts:
                if error == kw.OFFSET_OUT_OF_RANGE:
                    # Retention deleted our position (or a checkpoint
                    # predates the log start): reset to earliest rather
                    # than wedging on retries forever.
                    self._reset_offset(partition)
                    continue
                if error != kw.NO_ERROR:
                    continue  # transient: position holds, retry later
                for rec in kw.decode_record_batches(batches):
                    if rec.offset < self._positions[partition]:
                        continue  # batch starts below our position
                    out.append(
                        FetchedMessage(
                            partition, rec.offset, rec.key, rec.value,
                            rec.headers,
                        )
                    )
                    self._positions[partition] = rec.offset + 1
        if out and self.auto_commit:
            self.commit()
        return out

    def close(self) -> None:
        self._conn.close()
