"""In-repo Kafka broker: the shop's broker as a test double.

A TCP server speaking the wire subset in ``kafka_wire`` — Metadata v0,
Produce v0 and v3, Fetch v0 and v4, ListOffsets v0, FindCoordinator v0,
OffsetCommit v2 and OffsetFetch v1 (with commit metadata, the channel
for epoch-tagged commits) — with append-only partition logs and
consumer-group offsets held for the life of the process. It exists so
the orders leg runs as a deployment runs it: bytes over a socket,
committed offsets, resume. A deployment points the consumer at its real
Kafka 3.x broker; the client speaks the same protocol either way.

Thread model: one acceptor thread and one thread per connection; all
state behind one lock.

The bytes it answers are the JAX package's broker's, byte for byte.
A fetch builds its record set as a list of batches joined once, not by
repeated concatenation, so a 1 MiB fetch costs one copy.
"""

from __future__ import annotations

import socket
import threading
from typing import NamedTuple

from . import kafka_wire as kw


class StoredMessage(NamedTuple):
    key: bytes | None
    value: bytes | None
    headers: tuple  # ((str, bytes|None), ...) — v2 record headers
    timestamp_ms: int


class _PartitionLog:
    def __init__(self):
        self.messages: list[StoredMessage] = []

    @property
    def high_watermark(self) -> int:
        return len(self.messages)


class KafkaBroker:
    """Single-node broker; node id 0, coordinator for every group."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, num_partitions: int = 1):
        self.host = host
        self.num_partitions = num_partitions
        self._lock = threading.Lock()
        self._topics: dict[str, list[_PartitionLog]] = {}
        self._group_offsets: dict[tuple[str, str, int], int] = {}
        # Commit metadata strings beside the offsets (real Kafka stores
        # them together): the epoch-tag channel for fenced commits.
        self._group_meta: dict[tuple[str, str, int], str] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._stop = False
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._acceptor = threading.Thread(
            target=self._accept_loop, name="kafka-broker-accept", daemon=True
        )

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self._acceptor.start()

    def stop(self) -> None:
        self._stop = True
        # close() alone does NOT wake a thread blocked in accept() — the
        # kernel socket survives the fd close while the syscall holds it
        # and keeps accepting (the port then never frees). shutdown()
        # interrupts the accept deterministically.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._acceptor.join(timeout=2.0)
        # Close accepted connections too: a conn thread blocked in recv
        # would otherwise hold the port against a broker restart.
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)

    # -- test/sim conveniences -----------------------------------------

    def ensure_topic(self, name: str) -> None:
        with self._lock:
            self._topics.setdefault(
                name, [_PartitionLog() for _ in range(self.num_partitions)]
            )

    def append(self, topic: str, value: bytes, key: bytes | None = None,
               partition: int = 0, headers=()) -> int:
        """Direct append (producer-side shortcut for sims); returns offset."""
        self.ensure_topic(topic)
        with self._lock:
            log = self._topics[topic][partition]
            log.messages.append(StoredMessage(key, value, tuple(headers), 0))
            return log.high_watermark - 1

    def committed(self, group: str, topic: str, partition: int = 0) -> int:
        with self._lock:
            return self._group_offsets.get((group, topic, partition), -1)

    # -- server loops ---------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # socket closed
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="kafka-broker-conn", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop:
                frame = kw.read_frame(conn)
                if frame is None:
                    return
                reader = kw.Reader(frame)
                header = kw.decode_request_header(reader)
                body = self._dispatch(header, reader)
                conn.sendall(kw.encode_response(header.correlation_id, body))
        except (kw.KafkaWireError, OSError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    # -- request handlers ----------------------------------------------

    def _dispatch(self, header: kw.RequestHeader, r: kw.Reader) -> bytes:
        handlers = {
            (kw.PRODUCE, 0): self._produce_v0,
            (kw.PRODUCE, 3): self._produce_v3,
            (kw.FETCH, 0): self._fetch_v0,
            (kw.FETCH, 4): self._fetch_v4,
            (kw.LIST_OFFSETS, 0): self._list_offsets_v0,
            (kw.METADATA, 0): self._metadata_v0,
            (kw.FIND_COORDINATOR, 0): self._find_coordinator_v0,
            (kw.OFFSET_COMMIT, 2): self._offset_commit_v2,
            (kw.OFFSET_FETCH, 1): self._offset_fetch_v1,
        }
        handler = handlers.get((header.api_key, header.api_version))
        if handler is None:
            # Protocol-correct refusal (error body shapes vary per API,
            # so close after a header-only error frame).
            raise kw.KafkaWireError(
                f"unsupported api {header.api_key} v{header.api_version}"
            )
        return handler(r)

    def _metadata_v0(self, r: kw.Reader) -> bytes:
        topics = r.array(r.string)
        with self._lock:
            if not topics:
                topics = list(self._topics)
            for t in topics:
                self._topics.setdefault(
                    t, [_PartitionLog() for _ in range(self.num_partitions)]
                )  # auto-create, the dev-broker default
            out = kw.enc_array(
                [(0, self.host, self.port)],
                lambda b: kw.enc_int32(b[0]) + kw.enc_string(b[1]) + kw.enc_int32(b[2]),
            )

            def enc_partition(p):
                return (
                    kw.enc_int16(kw.NO_ERROR)
                    + kw.enc_int32(p)
                    + kw.enc_int32(0)  # leader = node 0
                    + kw.enc_array([0], kw.enc_int32)  # replicas
                    + kw.enc_array([0], kw.enc_int32)  # isr
                )

            def enc_topic(t):
                parts = range(len(self._topics[t]))
                return (
                    kw.enc_int16(kw.NO_ERROR)
                    + kw.enc_string(t)
                    + kw.enc_array(list(parts), enc_partition)
                )

            out += kw.enc_array(topics, enc_topic)
        return out

    def _produce_v0(self, r: kw.Reader) -> bytes:
        r.int16()  # required_acks (always ack here)
        r.int32()  # timeout

        def read_partition():
            partition = r.int32()
            size = r.int32()
            mset = r.buf[r.pos : r.pos + size]
            r.pos += size
            return partition, mset

        def read_topic():
            name = r.string()
            return name, r.array(read_partition)

        topics = r.array(read_topic)
        resp_topics = []
        with self._lock:
            for name, parts in topics:
                self._topics.setdefault(
                    name, [_PartitionLog() for _ in range(self.num_partitions)]
                )
                resp_parts = []
                for partition, mset in parts:
                    if partition >= len(self._topics[name]):
                        resp_parts.append(
                            (partition, kw.UNKNOWN_TOPIC_OR_PARTITION, -1)
                        )
                        continue
                    log = self._topics[name][partition]
                    base = log.high_watermark
                    for msg in kw.decode_message_set(mset):
                        log.messages.append(
                            StoredMessage(msg.key, msg.value, (), 0)
                        )
                    resp_parts.append((partition, kw.NO_ERROR, base))
                resp_topics.append((name, resp_parts))
        return kw.enc_array(
            resp_topics,
            lambda t: kw.enc_string(t[0])
            + kw.enc_array(
                t[1],
                lambda p: kw.enc_int32(p[0]) + kw.enc_int16(p[1]) + kw.enc_int64(p[2]),
            ),
        )

    def _produce_v3(self, r: kw.Reader) -> bytes:
        """Produce v3: transactional_id + v2 RecordBatch payloads (the
        modern minimum — Kafka ≥3.0 accepts nothing older). Headers
        survive into the log."""
        r.string()  # transactional_id (nullable; transactions unsupported)
        r.int16()  # required_acks
        r.int32()  # timeout

        def read_partition():
            partition = r.int32()
            size = r.int32()
            batches = r.buf[r.pos : r.pos + size]
            r.pos += size
            return partition, batches

        topics = r.array(lambda: (r.string(), r.array(read_partition)))
        resp_topics = []
        with self._lock:
            for name, parts in topics:
                self._topics.setdefault(
                    name, [_PartitionLog() for _ in range(self.num_partitions)]
                )
                resp_parts = []
                for partition, batches in parts:
                    if partition >= len(self._topics[name]):
                        resp_parts.append(
                            (partition, kw.UNKNOWN_TOPIC_OR_PARTITION, -1)
                        )
                        continue
                    log = self._topics[name][partition]
                    base = log.high_watermark
                    for rec in kw.decode_record_batches(batches):
                        log.messages.append(
                            StoredMessage(
                                rec.key, rec.value, rec.headers,
                                rec.timestamp_ms,
                            )
                        )
                    resp_parts.append((partition, kw.NO_ERROR, base))
                resp_topics.append((name, resp_parts))
        # v3 partition response carries log_append_time (-1: CREATE_TIME
        # logs); throttle_time_ms trails the response.
        return kw.enc_array(
            resp_topics,
            lambda t: kw.enc_string(t[0])
            + kw.enc_array(
                t[1],
                lambda p: kw.enc_int32(p[0]) + kw.enc_int16(p[1])
                + kw.enc_int64(p[2]) + kw.enc_int64(-1),
            ),
        ) + kw.enc_int32(0)

    def _fetch_v0(self, r: kw.Reader) -> bytes:
        r.int32()  # replica_id
        r.int32()  # max_wait_ms (no long-poll in the test double)
        r.int32()  # min_bytes

        def read_partition():
            return r.int32(), r.int64(), r.int32()  # partition, offset, max_bytes

        def read_topic():
            return r.string(), r.array(read_partition)

        topics = r.array(read_topic)
        resp_topics = []
        with self._lock:
            for name, parts in topics:
                logs = self._topics.get(name)
                resp_parts = []
                for partition, offset, max_bytes in parts:
                    if logs is None or partition >= len(logs):
                        resp_parts.append(
                            (partition, kw.UNKNOWN_TOPIC_OR_PARTITION, -1, b"")
                        )
                        continue
                    log = logs[partition]
                    hw = log.high_watermark
                    if offset > hw or offset < 0:
                        resp_parts.append(
                            (partition, kw.OFFSET_OUT_OF_RANGE, hw, b"")
                        )
                        continue
                    chunks = []
                    size = 0
                    pos = offset
                    while pos < hw and size < max_bytes:
                        msg = log.messages[pos]
                        # v0 fetch serves magic-0 messages: headers have
                        # no slot in that format and are dropped.
                        chunk = kw.encode_message_set(
                            [(msg.key, msg.value)], base_offset=pos
                        )
                        chunks.append(chunk)
                        size += len(chunk)
                        pos += 1
                    resp_parts.append((partition, kw.NO_ERROR, hw, b"".join(chunks)))
                resp_topics.append((name, resp_parts))
        return kw.enc_array(
            resp_topics,
            lambda t: kw.enc_string(t[0])
            + kw.enc_array(
                t[1],
                lambda p: kw.enc_int32(p[0])
                + kw.enc_int16(p[1])
                + kw.enc_int64(p[2])
                + kw.enc_int32(len(p[3]))
                + p[3],
            ),
        )

    def _fetch_v4(self, r: kw.Reader) -> bytes:
        """Fetch v4: isolation level + v2 RecordBatch record sets (the
        modern minimum), headers intact."""
        r.int32()  # replica_id
        r.int32()  # max_wait_ms (no long-poll in the test double)
        r.int32()  # min_bytes
        r.int32()  # max_bytes (whole response; per-partition cap below)
        r.int8()  # isolation_level (no transactions: read_uncommitted)

        def read_partition():
            return r.int32(), r.int64(), r.int32()

        topics = r.array(lambda: (r.string(), r.array(read_partition)))
        resp_topics = []
        with self._lock:
            for name, parts in topics:
                logs = self._topics.get(name)
                resp_parts = []
                for partition, offset, max_bytes in parts:
                    if logs is None or partition >= len(logs):
                        resp_parts.append(
                            (partition, kw.UNKNOWN_TOPIC_OR_PARTITION, -1, b"")
                        )
                        continue
                    log = logs[partition]
                    hw = log.high_watermark
                    if offset > hw or offset < 0:
                        resp_parts.append(
                            (partition, kw.OFFSET_OUT_OF_RANGE, hw, b"")
                        )
                        continue
                    # One batch per stored message keeps the cut-at-
                    # byte-limit semantics identical to the v0 path.
                    chunks = []
                    size = 0
                    pos = offset
                    while pos < hw and size < max_bytes:
                        msg = log.messages[pos]
                        chunk = kw.encode_record_batch(
                            [(msg.key, msg.value, msg.headers)],
                            base_offset=pos,
                            base_timestamp_ms=msg.timestamp_ms,
                        )
                        chunks.append(chunk)
                        size += len(chunk)
                        pos += 1
                    resp_parts.append((partition, kw.NO_ERROR, hw, b"".join(chunks)))
                resp_topics.append((name, resp_parts))

        def enc_partition(p):
            partition, error, hw, batches = p
            return (
                kw.enc_int32(partition)
                + kw.enc_int16(error)
                + kw.enc_int64(hw)
                + kw.enc_int64(hw)  # last_stable_offset (no txns)
                + kw.enc_int32(0)  # aborted_transactions: none
                + kw.enc_int32(len(batches))
                + batches
            )

        return kw.enc_int32(0) + kw.enc_array(  # throttle_time_ms first
            resp_topics,
            lambda t: kw.enc_string(t[0]) + kw.enc_array(t[1], enc_partition),
        )

    def _list_offsets_v0(self, r: kw.Reader) -> bytes:
        r.int32()  # replica_id

        def read_partition():
            return r.int32(), r.int64(), r.int32()  # partition, ts, max_offsets

        def read_topic():
            return r.string(), r.array(read_partition)

        topics = r.array(read_topic)
        resp_topics = []
        with self._lock:
            for name, parts in topics:
                logs = self._topics.get(name)
                resp_parts = []
                for partition, ts, _max_offsets in parts:
                    if logs is None or partition >= len(logs):
                        resp_parts.append(
                            (partition, kw.UNKNOWN_TOPIC_OR_PARTITION, [])
                        )
                        continue
                    hw = logs[partition].high_watermark
                    # -1 = latest, -2 = earliest (log start is always 0
                    # here; the double never truncates).
                    offsets = [hw] if ts == -1 else [0]
                    resp_parts.append((partition, kw.NO_ERROR, offsets))
                resp_topics.append((name, resp_parts))
        return kw.enc_array(
            resp_topics,
            lambda t: kw.enc_string(t[0])
            + kw.enc_array(
                t[1],
                lambda p: kw.enc_int32(p[0])
                + kw.enc_int16(p[1])
                + kw.enc_array(p[2], kw.enc_int64),
            ),
        )

    def _find_coordinator_v0(self, r: kw.Reader) -> bytes:
        r.string()  # group id — this node coordinates every group
        return (
            kw.enc_int16(kw.NO_ERROR)
            + kw.enc_int32(0)
            + kw.enc_string(self.host)
            + kw.enc_int32(self.port)
        )

    def _offset_commit_v2(self, r: kw.Reader) -> bytes:
        group = r.string()
        r.int32()  # generation (-1: simple consumer)
        r.string()  # member id
        r.int64()  # retention

        def read_partition():
            partition = r.int32()
            offset = r.int64()
            metadata = r.string()  # stored + served back (epoch tags)
            return partition, offset, metadata

        def read_topic():
            return r.string(), r.array(read_partition)

        topics = r.array(read_topic)
        resp_topics = []
        with self._lock:
            for name, parts in topics:
                resp_parts = []
                for partition, offset, metadata in parts:
                    self._group_offsets[(group, name, partition)] = offset
                    self._group_meta[(group, name, partition)] = metadata or ""
                    resp_parts.append((partition, kw.NO_ERROR))
                resp_topics.append((name, resp_parts))
        return kw.enc_array(
            resp_topics,
            lambda t: kw.enc_string(t[0])
            + kw.enc_array(
                t[1], lambda p: kw.enc_int32(p[0]) + kw.enc_int16(p[1])
            ),
        )

    def _offset_fetch_v1(self, r: kw.Reader) -> bytes:
        group = r.string()

        def read_topic():
            return r.string(), r.array(r.int32)

        topics = r.array(read_topic)
        resp_topics = []
        with self._lock:
            for name, parts in topics:
                resp_parts = []
                for partition in parts:
                    offset = self._group_offsets.get((group, name, partition), -1)
                    meta = self._group_meta.get((group, name, partition), "")
                    resp_parts.append((partition, offset, meta))
                resp_topics.append((name, resp_parts))
        return kw.enc_array(
            resp_topics,
            lambda t: kw.enc_string(t[0])
            + kw.enc_array(
                t[1],
                lambda p: kw.enc_int32(p[0])
                + kw.enc_int64(p[1])
                + kw.enc_string(p[2])
                + kw.enc_int16(kw.NO_ERROR),
            ),
        )
