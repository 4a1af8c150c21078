"""Kafka ``orders`` topic ingestion: OrderResult wire decode and consumer.

Wire contract (the shop's ``demo.proto``): ``OrderResult{order_id=1,
shipping_tracking_id=2, shipping_cost=3, shipping_address=4, items=5}``,
``OrderItem{item=1 CartItem{product_id=1, quantity=2}, cost=2
Money{currency_code=1, units=2, nanos=3}}``. Any producer that feeds the
shop's fraud-detection consumer feeds this one unchanged.

An order becomes one row of the ``checkout-orders`` lane of the
detector: the order id is the distinct-count (HLL) key, the first
product id the heavy-hitter (CMS) attribute, and the order value in USD
rides in the latency lane, so the EWMA head tracks order value.

Two decode paths, as the JAX package has them. :class:`OrdersSource`
decodes each message in Python (:func:`decode_order` →
:func:`order_to_record`), which is what the consumer runs; the native
decoder (:func:`decode_orders_columnar`, ``csrc/host/ingest.cc``) turns a
batch of payloads into columns in one call and has no fallback: it
raises with the build's error where the library cannot build.

The consumer transport is ``confluent_kafka`` when installed, else the
package's own wire client (``runtime.kafka_client``, the Kafka protocol
over a socket; ``runtime.kafka_broker`` is the in-repo broker). Every
poll yields next-to-read offsets, which a checkpoint stores so a resume
seeks past what the sketches already hold.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, NamedTuple, Sequence

import numpy as np

from . import native, wire
from ..currency_data import to_usd_factor
from .tensorize import SpanColumns, SpanRecord, SpanTensorizer

ORDERS_SERVICE = "checkout-orders"


class Order(NamedTuple):
    order_id: str
    tracking_id: str
    shipping_cost_units: float
    item_count: int
    product_ids: tuple[str, ...]
    total_quantity: int
    currency: str = "USD"  # shipping_cost Money currency on the wire


def _money_units(buf: bytes | None) -> tuple[float, str]:
    if not buf:
        return 0.0, "USD"
    f = wire.scan_fields(buf)
    code = wire.first(f, 1, b"USD")
    units = wire.first(f, 2, 0)
    nanos = wire.first(f, 3, 0)
    # zigzag not used (int64/int32 plain varints in the schema)
    return (
        float(units) + float(nanos) * 1e-9,
        code.decode("utf-8", "replace") if isinstance(code, bytes) else "USD",
    )


def decode_order(payload: bytes) -> Order:
    """Decode an OrderResult protobuf payload (see module docstring)."""
    f = wire.scan_fields(payload)
    order_id = (wire.first(f, 1, b"") or b"").decode("utf-8", "replace")
    tracking = (wire.first(f, 2, b"") or b"").decode("utf-8", "replace")
    shipping, currency = _money_units(wire.first(f, 3))
    products: list[str] = []
    qty = 0
    for item_buf in f.get(5, []):
        item_f = wire.scan_fields(item_buf)
        cart_buf = wire.first(item_f, 1)
        if cart_buf:
            cart_f = wire.scan_fields(cart_buf)
            pid = wire.first(cart_f, 1, b"")
            if pid:
                products.append(pid.decode("utf-8", "replace"))
            qty += int(wire.first(cart_f, 2, 0) or 0)
    return Order(
        order_id, tracking, shipping, len(products), tuple(products), qty,
        currency,
    )


def order_to_record(order: Order, duration_us: float = 0.0) -> SpanRecord:
    """Project an order onto the detector's span shape.

    Trace-id analogue = order id (distinct-order cardinality); monitored
    attribute = the order's first product id (heavy-hitter per service
    'checkout-orders'); latency lane carries order value so the EWMA head
    doubles as an order-value anomaly tracker. The value is normalized
    to USD (the wire carries the user's currency: the shop's checkout
    localises the shipping cost) so a burst of JPY checkouts is
    not a ~150x false value anomaly.
    """
    value = order.shipping_cost_units * to_usd_factor(order.currency)
    return SpanRecord(
        service="checkout-orders",
        duration_us=duration_us if duration_us else value,
        trace_id=order.order_id.encode() or b"\0",
        is_error=False,
        attr=order.product_ids[0] if order.product_ids else "",
    )


def decode_orders_columnar(
    payloads: Sequence[bytes], tensorizer: SpanTensorizer
) -> SpanColumns:
    """Batch-decode OrderResult payloads straight to pipeline columns
    with the native decoder (one call for the whole poll batch); the
    columns equal the per-message path's. Feed them to
    ``DetectorPipeline.submit_columns``. Raises ``RuntimeError`` with
    the build's error where the decoder cannot build, and ``ValueError``
    on a malformed payload.
    """
    sid = tensorizer.service_id(ORDERS_SERVICE)
    n = len(payloads)
    cols = native.decode_orders(payloads)
    return SpanColumns(
        svc=np.full(n, sid, np.int32),
        lat_us=cols.value_units,
        is_error=np.zeros(n, np.float32),
        trace_key=cols.order_key,
        attr_crc=cols.attr_crc.astype(np.uint64),
    )


class DeferredOffsets:
    """Bounded deferred-confirmation offset list (an orders pump's):
    flushes whose pool ticket hasn't resolved park here until the flush
    confirms cleanly, and only THEN do their offsets join the
    checkpointable map (at-least-once).

    Unbounded, a permanently-failing flush path would grow this list
    forever (one entry per pump). Bounded: over ``cap`` entries the
    OLDEST is shed — its records simply replay from the broker on
    restart (at-least-once preserved, never silent loss), the shed is
    counted (``anomaly_offset_defer_dropped_total``) and
    ``barrier_needed`` flips so the pump's owner forces an immediate
    checkpoint, persisting what IS confirmed and bounding the replay
    window the sheds opened.
    """

    def __init__(self, cap: int = 64):
        self.cap = max(int(cap), 1)
        self._items: deque = deque()
        self.dropped_total = 0
        self.barrier_needed = False

    def __len__(self) -> int:
        return len(self._items)

    def add(self, ticket, offsets: dict) -> None:
        self._items.append((ticket, offsets))
        while len(self._items) > self.cap:
            self._items.popleft()
            self.dropped_total += 1
            self.barrier_needed = True

    def resolve(self) -> dict:
        """Merged offsets of every flush that has since confirmed
        CLEANLY; failed/unresolved flushes stay out (failed ones are
        dropped — their records replay on restart)."""
        merged: dict = {}
        unresolved: deque = deque()
        for ticket, offsets in self._items:
            if not ticket._done:
                unresolved.append((ticket, offsets))
            elif ticket._error is None:
                merged.update(offsets)
        self._items = unresolved
        return merged

    def take_barrier(self) -> bool:
        """True once per cap-hit episode: the caller owes a checkpoint."""
        if self.barrier_needed:
            self.barrier_needed = False
            return True
        return False


MoneyTuple = tuple  # (currency: str, units: int, nanos: int)


def encode_money(currency: str, units: int, nanos: int) -> bytes:
    """Money submessage; zero units/nanos omitted (proto3 defaults)."""
    out = wire.encode_len(1, currency.encode())
    if units:
        out += wire.encode_int(2, units)
    if nanos:
        out += wire.encode_int(3, nanos)
    return out


def encode_order_result(
    order_id: str,
    tracking_id: str,
    shipping: MoneyTuple,
    lines: Sequence[tuple[str, int, MoneyTuple | None]],
) -> bytes:
    """The ONE wire-compatible OrderResult encoder.

    Both transports that emit OrderResult — checkout's Kafka publish and
    the gRPC edge's PlaceOrder response — go through here, so they can
    never disagree about quantities or costs on the same proto message.
    ``lines`` = (product_id, quantity, (currency, units, nanos) | None).
    """
    out = (
        wire.encode_len(1, order_id.encode())
        + wire.encode_len(2, tracking_id.encode())
        + wire.encode_len(3, encode_money(*shipping))
    )
    for pid, qty, cost in lines:
        cart = wire.encode_len(1, pid.encode()) + wire.encode_int(2, qty)
        item = wire.encode_len(1, cart)
        if cost is not None:
            item += wire.encode_len(2, encode_money(*cost))
        out += wire.encode_len(5, item)
    return out


def encode_placed_order(placed) -> bytes:
    """OrderResult bytes from a checkout's ``PlacedOrder``.

    Duck-typed (``.shipping``/``.items`` with Money-shaped members) so
    the runtime layer imports no shop code. This is the ONE
    marshalling of PlacedOrder onto the wire — checkout's Kafka publish
    and the gRPC edge's PlaceOrder response both call it, so neither
    call site can drift back to e.g. encoding the grand total as
    shipping_cost.
    """
    return encode_order_result(
        placed.order_id,
        placed.tracking_id,
        (placed.shipping.currency, placed.shipping.units,
         placed.shipping.nanos),
        [
            (line.product_id, line.quantity,
             (line.cost.currency, line.cost.units, line.cost.nanos))
            for line in placed.items
        ],
    )


def encode_order(order: Order) -> bytes:
    """OrderResult from the compact :class:`Order` shape (simulator +
    tests — real producers carry exact lines via
    :func:`encode_order_result`; this synthesizes uniform quantities)."""
    units = int(order.shipping_cost_units)
    nanos = int((order.shipping_cost_units - units) * 1e9)
    qty = max(order.total_quantity // max(order.item_count, 1), 1)
    return encode_order_result(
        order.order_id,
        order.tracking_id,
        (order.currency, units, nanos),
        [(pid, qty, None) for pid in order.product_ids],
    )


class OrdersSource:
    """Kafka consumer for topic ``orders``.

    Keeps the shop's consumer contract: its own group id, auto-commit
    offsets, value = OrderResult bytes. Yields
    ``(offset_by_partition, SpanRecord)``.

    Transport: ``confluent_kafka`` when installed (production images
    that ship it), else the built-in wire client
    (:class:`~.kafka_client.KafkaConsumer`) — real Kafka protocol over a
    real socket either way, so the leg never silently degrades to
    in-proc simulation.
    """

    TOPIC = "orders"
    RECONNECT_BACKOFF_S = 1.0

    QUARANTINE_KEEP = 32  # most-recent poison records retained for triage

    def __init__(self, bootstrap: str, group_id: str = "anomaly-detector"):
        self._bootstrap = bootstrap
        self._group_id = group_id
        self._pending_seek: dict[int, int] = {}
        # Epoch fencing: any object with ``check(path=)`` that raises
        # ``checkpoint.StaleEpochError``. Every explicit commit is
        # fence-checked and
        # epoch-tagged in the commit metadata string, so a resurrected
        # stale primary can neither commit past its successor nor boot
        # without discovering the successor's epoch
        # (:meth:`last_committed_epoch`).
        self.fence = None
        self.decode_failures = 0  # poison pills skipped (not crashed on)
        # Consumer-side quarantine: the poison record's coordinates,
        # error and payload head are kept (bounded) so an operator can
        # triage the bad producer; last_error feeds a last-error metric.
        self.quarantine: deque = deque(maxlen=self.QUARANTINE_KEEP)
        self.last_error: str | None = None
        self.last_error_ts: float = 0.0
        self._wire = None
        self._next_connect = 0.0  # wire-transport reconnect backoff
        try:
            from confluent_kafka import Consumer  # type: ignore

            self._consumer = Consumer(
                {
                    "bootstrap.servers": bootstrap,
                    "group.id": group_id,
                    "auto.offset.reset": "earliest",
                    "enable.auto.commit": True,
                }
            )
            self._consumer.subscribe([self.TOPIC])
        except ImportError:
            # Built-in wire transport, connected lazily on first poll:
            # a deployment starts its services in parallel, so a broker
            # that isn't up yet must mean "retry", not a boot crash
            # (confluent buffers the same way internally). A malformed
            # address is NOT transient — validate it now, so a config
            # error refuses to boot instead of retrying silently forever.
            from .kafka_client import _parse_bootstrap

            _parse_bootstrap(bootstrap)
            self._consumer = None
            self._ensure_wire(raise_on_fail=False)

    def _ensure_wire(self, raise_on_fail: bool = False):
        import time as _time

        if self._wire is not None:
            return self._wire
        now = _time.monotonic()
        if now < self._next_connect:
            return None
        self._next_connect = now + self.RECONNECT_BACKOFF_S
        try:
            from .kafka_client import KafkaConsumer

            self._wire = KafkaConsumer(self._bootstrap, self._group_id, self.TOPIC)
            self._last_connect_error = None
        except Exception as e:  # noqa: BLE001 — any connect/handshake
            # fault (DNS, RST, wire-version mismatch) means "no broker
            # yet": back off and retry on the next poll.
            if raise_on_fail:
                raise
            # Log once per distinct failure — a silent forever-retry
            # would hide a permanently unreachable broker.
            msg = f"{type(e).__name__}: {e}"
            if msg != getattr(self, "_last_connect_error", None):
                import logging

                logging.getLogger(__name__).warning(
                    "Kafka connect to %s failed (%s); retrying every %.0fs",
                    self._bootstrap, msg, self.RECONNECT_BACKOFF_S,
                )
                self._last_connect_error = msg
            return None
        if self._pending_seek:
            for partition, offset in self._pending_seek.items():
                self._wire.seek(partition, offset)
        return self._wire

    def _drop_wire(self) -> None:
        if self._wire is not None:
            # Remember positions so a reconnect resumes where we were
            # even if the last auto-commit didn't land.
            self._pending_seek.update(self._wire.positions)
            try:
                self._wire.close()
            finally:
                self._wire = None

    def seek(self, offsets: dict[int, int]) -> None:
        """Seek to checkpointed next-to-read offsets (resume): sketch
        state corresponds to the checkpoint's offsets, which win over
        broker-committed ones. Applied now if connected, and re-applied
        on every (re)connect."""
        offsets = {int(p): int(o) for p, o in offsets.items()}
        self._pending_seek.update(offsets)
        if self._wire is not None:
            for partition, offset in offsets.items():
                self._wire.seek(partition, offset)
        elif self._consumer is not None:  # pragma: no cover - confluent
            from confluent_kafka import TopicPartition  # type: ignore

            self._consumer.assign(
                [
                    TopicPartition(self.TOPIC, p, o)
                    for p, o in offsets.items()
                ]
            )

    def poll(
        self, timeout_s: float = 0.1
    ) -> Iterator[tuple[dict, SpanRecord | None]]:
        """Yield ``(offsets, record)``; ``record`` is None for a skipped
        message (tombstone or undecodable poison pill) whose offset must
        STILL advance — otherwise a pill at a partition tail is never
        committed past and replays (and re-logs) on every restart.

        Next-offset semantics (Kafka committed-offset convention): a
        checkpoint taken after a message seeks *past* it on resume, so
        nothing is double-counted into the CMS.
        """
        if self._consumer is None:
            wire = self._ensure_wire()
            if wire is None:
                return  # broker unreachable: retry next poll
            try:
                msgs = wire.poll(max_wait_ms=int(timeout_s * 1000))
            except Exception:
                # Transient transport failure (broker restart, half-open
                # socket): drop the connection and reconnect with
                # backoff instead of killing the caller's loop.
                self._drop_wire()
                return
            for msg in msgs:
                record = (
                    None if msg.value is None
                    else self._decode(msg.value, msg.partition, msg.offset)
                )
                yield {msg.partition: msg.offset + 1}, record
            return
        msg = self._consumer.poll(timeout_s)  # pragma: no cover - confluent
        if msg is None or msg.error():
            return
        record = (
            None if msg.value() is None
            else self._decode(msg.value(), msg.partition(), msg.offset())
        )
        yield {msg.partition(): msg.offset() + 1}, record

    def poll_batch(
        self, timeout_s: float = 0.1
    ) -> tuple[dict, list[SpanRecord]]:
        """One poll → (merged next-offsets, decoded records).

        The batch shape the ingest pool wants: a pump hands the whole
        poll to ``IngestPool.submit_records`` so
        the Kafka leg shares the pool's one-tensorize-per-flush
        amortization instead of a per-record pipeline submit (which
        took the pipeline lock once per message). Tombstones and
        quarantined poison pills still advance their offsets.
        """
        offsets: dict = {}
        records: list[SpanRecord] = []
        for off, rec in self.poll(timeout_s):
            offsets.update(off)
            if rec is not None:
                records.append(rec)
        return offsets, records

    def _decode(self, value: bytes, partition: int, offset: int):
        """Decode one message, treating a malformed payload as a skip.

        A bad producer payload must not be a poison pill: the transport
        try in :meth:`poll` guards the socket, not the decode, and
        auto-commit means a crash here would skip the message *silently*
        after restart — crash plus data loss. Instead: log, count,
        continue (the shop's consumers do the same: a deserialisation
        error logs and polls on).
        """
        try:
            return order_to_record(decode_order(value))
        except Exception as e:
            # Deliberately broad: a wrong-schema payload that parses as
            # valid wire format surfaces as TypeError/AttributeError
            # (scan_fields returns an int where bytes were expected),
            # not WireError — and ANY decode failure is the same poison
            # pill from the consumer's point of view.
            import time as _time

            self.decode_failures += 1
            self.last_error = f"{type(e).__name__}: {e}"
            self.last_error_ts = _time.time()
            self.quarantine.append(
                (partition, offset, type(e).__name__, bytes(value[:64]))
            )
            import logging

            logging.getLogger(__name__).warning(
                "orders[%s@%s]: undecodable payload quarantined (%s); "
                "%d total", partition, offset, self.last_error,
                self.decode_failures,
            )
            return None

    def commit(self, offsets: dict[int, int], epoch: int = 0) -> None:
        """Epoch-tagged offset commit (fence-guarded).

        The commit metadata string carries ``{"epoch": N}`` — durable
        fencing evidence beside the offsets themselves, readable by any
        later consumer via OFFSET_FETCH. The fence check runs FIRST: a
        process that has observed a newer epoch must not write, however
        briefly (``checkpoint.StaleEpochError``). Raises on transport
        failure too — the caller (a supervised step) owns the retry.
        """
        if self.fence is not None:
            self.fence.check(path="kafka-offset-commit")
        offsets = {int(p): int(o) for p, o in offsets.items()}
        if not offsets:
            return
        import json as _json

        tag = _json.dumps({"epoch": int(epoch)})
        if self._consumer is not None:  # pragma: no cover - confluent
            from confluent_kafka import TopicPartition  # type: ignore

            try:
                # metadata kwarg exists on confluent-kafka >= 1.9 —
                # the epoch tag must ride on REAL Kafka too, or the
                # broker-witness fencing leg only exists against the
                # in-repo broker.
                tps = [
                    TopicPartition(self.TOPIC, p, o, metadata=tag)
                    for p, o in offsets.items()
                ]
            except TypeError:  # ancient client: commit untagged
                tps = [
                    TopicPartition(self.TOPIC, p, o)
                    for p, o in offsets.items()
                ]
            self._consumer.commit(offsets=tps, asynchronous=False)
            return
        wire_c = self._ensure_wire(raise_on_fail=True)
        if wire_c is None:
            raise ConnectionError("Kafka broker unreachable for commit")
        wire_c.commit(offsets, metadata=tag)

    def last_committed_epoch(self) -> int:
        """Largest epoch tag on the group's committed offsets (0 when
        untagged/unreachable): the boot-time fencing probe a
        resurrected primary runs before its first write."""
        import json as _json

        def parse(meta: str | None) -> int:
            if not meta:
                return 0
            try:
                return int(_json.loads(meta).get("epoch", 0))
            except (ValueError, TypeError):
                return 0

        try:
            if self._consumer is not None:  # pragma: no cover - confluent
                from confluent_kafka import TopicPartition  # type: ignore

                tps = self._consumer.committed(
                    [TopicPartition(self.TOPIC, p) for p in range(8)],
                    timeout=5.0,
                )
                return max(
                    (parse(getattr(tp, "metadata", None)) for tp in tps),
                    default=0,
                )
            wire_c = self._ensure_wire(raise_on_fail=False)
            if wire_c is None:
                return 0
            return max(
                (
                    parse(meta)
                    for _p, (_off, meta) in wire_c.committed_meta().items()
                ),
                default=0,
            )
        except Exception:  # noqa: BLE001 — fencing evidence is
            # best-effort here; the checkpoint + frame paths still fence
            return 0

    def close(self) -> None:
        if self._wire is not None:
            self._wire.close()
            self._wire = None
        elif self._consumer is not None:  # pragma: no cover
            self._consumer.close()
