"""The port's Kafka leg against the reference: wire, broker, client, orders source.

The same inputs give the same bytes from both packages: the primitive
codecs, request and response framing, v0 message sets and v2 record
batches at a fixed timestamp, and every broker answer. The port's
CRC-32C (native, through ``frame.crc32c``) equals its Python table and
the reference's. Over TCP the two packages interoperate both ways, and
the reference's socket cases (``tests/test_kafka_socket.py``,
``tests/test_kafka_interop.py``) run against the port: partitions,
groups, reconnects, the orders source, checkpoint offsets, poison pills,
tombstones and a broker restart. Then ``DeferredOffsets`` (the cases of
``tests/test_replication.py``) and the epoch-tagged, fence-checked commit.

Not ported here: ``test_daemon_kafka_leg_end_to_end`` needs the daemon,
and ``test_rejected_record_dead_letters_instead_of_blocking`` needs the
shop's ``services/kafka_bus``; neither module is in the port yet.
"""

from __future__ import annotations

import json
import random
import socket
import time

import numpy as np
import pytest

from opentelemetry_demo_tpu.runtime import kafka_broker as jbroker
from opentelemetry_demo_tpu.runtime import kafka_client as jclient
from opentelemetry_demo_tpu.runtime import kafka_orders as jorders
from opentelemetry_demo_tpu.runtime import kafka_wire as jkw
from opentelemetry_demo_tpu_torch.runtime import checkpoint, frame
from opentelemetry_demo_tpu_torch.runtime import kafka_broker, kafka_client, kafka_orders
from opentelemetry_demo_tpu_torch.runtime import kafka_wire as kw
from opentelemetry_demo_tpu_torch.runtime.kafka_orders import DeferredOffsets, Order, OrdersSource, encode_order

HEADERS = (
    ("traceparent", b"00-" + b"ab" * 16 + b"-" + b"0" * 16 + b"-01"),
    ("baggage", b"session.id=s1"),
    ("empty", None),
)


@pytest.fixture
def broker():
    b = kafka_broker.KafkaBroker()
    b.start()
    yield b
    b.stop()


def _addr(b) -> str:
    return f"127.0.0.1:{b.port}"


# -- wire bytes -----------------------------------------------------------------------

PRIMITIVES = [
    ("enc_int8", -3), ("enc_int16", -2), ("enc_int32", 123456), ("enc_int64", -(2**40)),
    ("enc_string", "orders"), ("enc_string", None), ("enc_string", "ünï"),
    ("enc_bytes", b"\x00\xff"), ("enc_bytes", None),
    ("enc_varint", 0), ("enc_varint", -1), ("enc_varint", 300), ("enc_varint", -(2**62)),
]


@pytest.mark.parametrize("fn,value", PRIMITIVES)
def test_primitive_codecs_equal_the_reference(fn, value):
    got = getattr(kw, fn)(value)
    assert got == getattr(jkw, fn)(value)
    if fn == "enc_varint":
        assert kw.dec_varint(got, 0) == jkw.dec_varint(got, 0) == (value, len(got))


def test_arrays_requests_and_responses_equal_the_reference():
    arr = kw.enc_array([1, 2, 3], kw.enc_int32)
    assert arr == jkw.enc_array([1, 2, 3], jkw.enc_int32)
    req = kw.encode_request(kw.FETCH, 4, 77, "client-x", b"body")
    assert req == jkw.encode_request(jkw.FETCH, 4, 77, "client-x", b"body")
    r = kw.Reader(req[4:])
    assert kw.decode_request_header(r) == tuple(jkw.decode_request_header(jkw.Reader(req[4:])))
    assert r.remaining() == b"body"
    assert kw.encode_response(9, b"xyz") == jkw.encode_response(9, b"xyz")
    with pytest.raises(kw.KafkaWireError, match="truncated"):
        kw.Reader(b"\x00").int32()


@pytest.mark.parametrize("n", [0, 1, 9, 4096, 65537])
def test_crc32c_is_the_table_and_the_reference(n):
    data = np.random.default_rng(n).bytes(n)
    want = jkw.crc32c(data)
    assert kw.crc32c(data) == kw.crc32c_plain(data) == want
    assert kw.crc32c(data[n // 2:], kw.crc32c(data[: n // 2])) == want
    assert frame.crc_backend() == "native"


def _records(rng, n):
    out = []
    for i in range(n):
        key = None if i % 5 == 0 else rng.bytes(int(rng.integers(1, 20)))
        value = None if i % 7 == 3 else rng.bytes(int(rng.integers(0, 300)))
        out.append((key, value, HEADERS[: i % 4]))
    return out


@pytest.mark.parametrize("n", [0, 1, 3, 40])
def test_record_batches_equal_the_reference(n):
    recs = _records(np.random.default_rng(n), n)
    got = kw.encode_record_batch(recs, base_offset=11, base_timestamp_ms=1_700_000_000_123)
    assert got == jkw.encode_record_batch(recs, base_offset=11, base_timestamp_ms=1_700_000_000_123)
    two = got + kw.encode_record_batch(recs[:2], base_offset=11 + n, base_timestamp_ms=5)
    dec = kw.decode_record_batches(two)
    assert [tuple(r) for r in dec] == [tuple(r) for r in jkw.decode_record_batches(two)]
    assert [(r.offset, r.key, r.value, r.headers) for r in dec[:n]] == [
        (11 + i, k, v, tuple(h)) for i, (k, v, h) in enumerate(recs)]
    # A trailing partial batch is dropped; a flipped bit is refused.
    assert len(kw.decode_record_batches(two[:-3])) == n
    if n:
        bad = bytearray(got)
        bad[-1] ^= 0x40
        with pytest.raises(kw.KafkaWireError, match="CRC"):
            kw.decode_record_batches(bytes(bad))
        with pytest.raises(jkw.KafkaWireError, match="CRC"):
            jkw.decode_record_batches(bytes(bad))


def test_message_sets_equal_the_reference():
    msgs = [(b"k1", b"v1"), (None, b"v2"), (b"k3", None)]
    got = kw.encode_message_set(msgs, base_offset=7)
    assert got == jkw.encode_message_set(msgs, base_offset=7)
    assert [(m.offset, m.key, m.value) for m in kw.decode_message_set(got)] == [
        (7, b"k1", b"v1"), (8, None, b"v2"), (9, b"k3", None)]
    assert [m.value for m in kw.decode_message_set(got[:-3])] == [b"v1", b"v2"]
    bad = bytearray(got)
    bad[-1] ^= 0xFF
    with pytest.raises(kw.KafkaWireError, match="CRC"):
        kw.decode_message_set(bytes(bad))


# -- the broker's answers, byte for byte ------------------------------------------------


def _requests():
    """(api, version, body) in the order a session sends them."""
    batch = lambda recs: kw.encode_record_batch(recs, base_timestamp_ms=1234)  # noqa: E731
    parts = lambda items: kw.enc_array(  # noqa: E731
        items, lambda p: kw.enc_int32(p[0]) + kw.enc_int32(len(p[1])) + p[1])
    fetch = lambda offs, mb=1 << 20: kw.enc_array(  # noqa: E731
        [("orders", [(p, o, mb) for p, o in offs])],
        lambda t: kw.enc_string(t[0]) + kw.enc_array(
            t[1], lambda p: kw.enc_int32(p[0]) + kw.enc_int64(p[1]) + kw.enc_int32(p[2])))
    return [
        (kw.METADATA, 0, kw.enc_array(["orders"], kw.enc_string)),
        (kw.METADATA, 0, kw.enc_array([], kw.enc_string)),
        (kw.PRODUCE, 3, kw.enc_string(None) + kw.enc_int16(1) + kw.enc_int32(1000) + kw.enc_array(
            [("orders", [(0, batch([(b"k", b"a", HEADERS), (None, b"b", ())])),
                         (1, batch([(None, b"c", ())])), (9, batch([(None, b"x", ())]))])],
            lambda t: kw.enc_string(t[0]) + parts(t[1]))),
        (kw.PRODUCE, 0, kw.enc_int16(1) + kw.enc_int32(1000) + kw.enc_array(
            [("orders", [(2, kw.encode_message_set([(b"m", b"v0")]))])],
            lambda t: kw.enc_string(t[0]) + parts(t[1]))),
        (kw.FETCH, 4, kw.enc_int32(-1) + kw.enc_int32(0) + kw.enc_int32(1) + kw.enc_int32(1 << 20)
         + kw.enc_int8(0) + fetch([(0, 0), (1, 0), (2, 0), (0, 9), (7, 0)])),
        (kw.FETCH, 4, kw.enc_int32(-1) + kw.enc_int32(0) + kw.enc_int32(1) + kw.enc_int32(1)
         + kw.enc_int8(0) + fetch([(0, 1)], mb=1)),
        (kw.FETCH, 0, kw.enc_int32(-1) + kw.enc_int32(0) + kw.enc_int32(1) + fetch([(0, 0), (2, 0), (2, 5)])),
        (kw.LIST_OFFSETS, 0, kw.enc_int32(-1) + kw.enc_array(
            [("orders", [(0, -1, 1), (0, -2, 1), (8, -1, 1)]), ("nope", [(0, -1, 1)])],
            lambda t: kw.enc_string(t[0]) + kw.enc_array(
                t[1], lambda p: kw.enc_int32(p[0]) + kw.enc_int64(p[1]) + kw.enc_int32(p[2])))),
        (kw.FIND_COORDINATOR, 0, kw.enc_string("g1")),
        (kw.OFFSET_COMMIT, 2, kw.enc_string("g1") + kw.enc_int32(-1) + kw.enc_string("") + kw.enc_int64(-1)
         + kw.enc_array([("orders", [(0, 2, '{"epoch": 3}'), (1, 1, None)])],
                        lambda t: kw.enc_string(t[0]) + kw.enc_array(
                            t[1], lambda p: kw.enc_int32(p[0]) + kw.enc_int64(p[1]) + kw.enc_string(p[2])))),
        (kw.OFFSET_FETCH, 1, kw.enc_string("g1") + kw.enc_array(
            [("orders", [0, 1, 2])], lambda t: kw.enc_string(t[0]) + kw.enc_array(t[1], kw.enc_int32))),
    ]


def test_broker_answers_equal_the_reference_byte_for_byte():
    port_b = kafka_broker.KafkaBroker(num_partitions=3)
    ref_b = jbroker.KafkaBroker(num_partitions=3)
    port_b.start()
    ref_b.start()
    try:
        port_b.port = ref_b.port = 9092  # the answers name the broker's address
        for corr, (api, ver, body) in enumerate(_requests()):
            frame_ = kw.encode_request(api, ver, corr, "c", body)
            got = port_b._dispatch(kw.decode_request_header(r := kw.Reader(frame_[4:])), r)
            want = ref_b._dispatch(jkw.decode_request_header(rr := jkw.Reader(frame_[4:])), rr)
            assert got == want, (api, ver)
        assert port_b.committed("g1", "orders", 0) == 2
        with pytest.raises(kw.KafkaWireError, match="unsupported api"):
            port_b._dispatch(kw.RequestHeader(kw.FETCH, 11, 1, "c"), kw.Reader(b""))
    finally:
        port_b.stop()
        ref_b.stop()


# -- over TCP, across the packages ---------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_package_produce_and_consume_over_tcp(writer):
    """The port's consumer reads what the JAX producer wrote into the JAX
    broker, and the JAX consumer reads what the port wrote into the
    port's broker."""
    bmod, pmod, cmod = ((jbroker, jclient, kafka_client) if writer == "reference"
                        else (kafka_broker, kafka_client, jclient))
    b = bmod.KafkaBroker(num_partitions=2)
    b.start()
    try:
        prod = pmod.KafkaProducer(_addr(b))
        sent = [(f"m{i}".encode(), None if i == 3 else encode_order(Order(f"o{i}", "t", 2.5, 1, ("P",), 1)),
                 HEADERS[: i % 4]) for i in range(6)]
        for i, (k, v, h) in enumerate(sent):
            assert prod.send("orders", v, key=k, partition=i % 2, headers=h) == i // 2
        prod.close()
        cons = cmod.KafkaConsumer(_addr(b), "g", "orders")
        got = cons.poll(max_wait_ms=100)
        assert sorted((m.partition, m.offset, m.key, m.value, tuple(m.headers)) for m in got) == sorted(
            (i % 2, i // 2, k, v, tuple(h)) for i, (k, v, h) in enumerate(sent))
        assert cons.committed() == {0: 3, 1: 3}
        cons.close()
        # The port's orders source over either broker.
        src = OrdersSource(_addr(b), group_id="orders-g")
        offsets, records = src.poll_batch(0.05)
        assert offsets == {0: 3, 1: 3}  # the tombstone advances its offset too
        assert sorted(r.trace_id for r in records) == [f"o{i}".encode() for i in (0, 1, 2, 4, 5)]
        src.close()
    finally:
        b.stop()


# -- the reference's socket cases, on the port ------------------------------------------


def test_produce_fetch_round_trip(broker):
    producer = kafka_client.KafkaProducer(_addr(broker))
    assert producer.send("orders", b"first") == 0
    assert producer.send("orders", b"second", key=b"k", headers=HEADERS) == 1
    consumer = kafka_client.KafkaConsumer(_addr(broker), "g1", "orders")
    msgs = consumer.poll()
    assert [(m.offset, m.key, m.value, m.headers) for m in msgs] == [
        (0, None, b"first", ()), (1, b"k", b"second", HEADERS)]
    assert consumer.poll() == []
    producer.close()
    consumer.close()


def test_consumer_group_offsets_survive_reconnect(broker):
    producer = kafka_client.KafkaProducer(_addr(broker))
    for i in range(5):
        producer.send("orders", f"m{i}".encode())
    c1 = kafka_client.KafkaConsumer(_addr(broker), "g1", "orders")
    assert len(c1.poll()) == 5
    c1.close()
    producer.send("orders", b"m5")
    c2 = kafka_client.KafkaConsumer(_addr(broker), "g1", "orders")
    assert [(m.offset, m.value) for m in c2.poll()] == [(5, b"m5")]
    c2.close()
    c3 = kafka_client.KafkaConsumer(_addr(broker), "g2", "orders")
    assert len(c3.poll()) == 6
    c3.close()
    producer.close()


def test_multi_partition_produce_fetch_and_offsets():
    b = kafka_broker.KafkaBroker(num_partitions=3)
    b.start()
    try:
        producer = kafka_client.KafkaProducer(_addr(b))
        for p in range(3):
            for i in range(2):
                producer.send("orders", f"p{p}m{i}".encode(), partition=p)
        consumer = kafka_client.KafkaConsumer(_addr(b), "g1", "orders")
        by_part: dict = {}
        for m in consumer.poll():
            by_part.setdefault(m.partition, []).append(m.value)
        assert by_part == {p: [f"p{p}m0".encode(), f"p{p}m1".encode()] for p in range(3)}
        assert [b.committed("g1", "orders", p) for p in range(3)] == [2, 2, 2]
        consumer.seek(1, 0)
        assert [(m.partition, m.value) for m in consumer.poll()] == [(1, b"p1m0"), (1, b"p1m1")]
        # A partition the boot-time metadata did not list joins the fetch set.
        consumer.seek(5, 0)
        assert 5 in consumer.positions and consumer.poll() == []
        producer.close()
        consumer.close()
    finally:
        b.stop()


def test_two_groups_are_independent(broker):
    producer = kafka_client.KafkaProducer(_addr(broker))
    producer.send("orders", b"x")
    a = kafka_client.KafkaConsumer(_addr(broker), "fraud-detection", "orders")
    c = kafka_client.KafkaConsumer(_addr(broker), "accounting", "orders")
    assert [m.value for m in a.poll()] == [b"x"]
    assert [m.value for m in c.poll()] == [b"x"]
    assert broker.committed("fraud-detection", "orders") == broker.committed("accounting", "orders") == 1
    for x in (a, c, producer):
        x.close()


def test_fetch_stops_at_max_bytes_and_resumes(broker):
    for i in range(50):
        broker.append("orders", bytes(100) + bytes([i]))
    consumer = kafka_client.KafkaConsumer(_addr(broker), "g", "orders", max_bytes=1000)
    seen = []
    for _ in range(20):
        got = consumer.poll()
        assert len(got) <= 10  # one batch past the cap at most
        seen += [m.offset for m in got]
        if not got:
            break
    assert seen == list(range(50))
    consumer.close()


def test_out_of_range_position_resets_to_earliest(broker):
    for i in range(3):
        broker.append("orders", f"v{i}".encode())
    consumer = kafka_client.KafkaConsumer(_addr(broker), "g", "orders")
    consumer.seek(0, 99)
    assert consumer.poll() == []
    assert consumer.positions == {0: 0}
    assert [m.value for m in consumer.poll()] == [b"v0", b"v1", b"v2"]
    consumer.close()


def _publish_orders(b, n, start=0, partition=0):
    producer = kafka_client.KafkaProducer(_addr(b))
    for i in range(start, start + n):
        order = Order(f"ord-{i}", f"trk-{i}", 10.0 + i, 1, (f"PROD-{i % 3}",), 2)
        producer.send("orders", encode_order(order), key=order.order_id.encode(), partition=partition)
    producer.close()


def test_orders_source_consumes_over_tcp(broker):
    _publish_orders(broker, 4)
    source = OrdersSource(_addr(broker))
    got = list(source.poll(0.05))
    assert len(got) == 4
    offsets, record = got[-1]
    assert offsets == {0: 4}
    assert (record.service, record.trace_id, record.attr) == ("checkout-orders", b"ord-3", "PROD-0")
    assert record.duration_us == pytest.approx(13.0)
    source.close()


def test_orders_source_resumes_from_checkpoint_offsets(broker):
    _publish_orders(broker, 6)
    s1 = OrdersSource(_addr(broker))
    assert [off for off, _ in s1.poll(0.05)][-1] == {0: 6}
    s1.close()
    s2 = OrdersSource(_addr(broker))
    # Offsets come back from a checkpoint's JSON with string keys.
    s2.seek(json.loads(json.dumps({0: 4})))
    assert [(off[0], rec.trace_id) for off, rec in s2.poll(0.05)] == [(5, b"ord-4"), (6, b"ord-5")]
    s2.close()


def test_resume_through_a_checkpoint_file(broker, tmp_path):
    """The offsets ride in the snapshot's meta and seek a new source."""
    from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig

    _publish_orders(broker, 5)
    s1 = OrdersSource(_addr(broker))
    offsets, _ = s1.poll_batch(0.05)
    s1.close()
    det = AnomalyDetector(DetectorConfig(num_services=8, hll_p=8, cms_width=512), device="cpu")
    path = str(tmp_path / "ck")
    checkpoint.save(path, det, offsets=offsets, dispatch_lock=None)
    _, meta, _ = checkpoint.load_resilient(path, det.config, device="cpu")
    assert meta["offsets"] == {"0": 5}
    _publish_orders(broker, 2, start=5)
    s2 = OrdersSource(_addr(broker))
    s2.seek(meta["offsets"])
    assert [r.trace_id for r in s2.poll_batch(0.05)[1]] == [b"ord-5", b"ord-6"]
    s2.close()


def test_orders_source_quarantines_a_poison_pill_and_passes_a_tombstone(broker):
    producer = kafka_client.KafkaProducer(_addr(broker))
    producer.send("orders", encode_order(Order("ord-ok-1", "t", 1.0, 1, ("P",), 1)))
    producer.send("orders", b"\xff\xff\xff\xff")  # a truncated varint
    producer.send("orders", None)  # a tombstone
    producer.send("orders", encode_order(Order("ord-ok-2", "t", 1.0, 1, ("P",), 1)))
    producer.close()
    source = OrdersSource(_addr(broker))
    got = list(source.poll(0.05))
    assert [rec.trace_id if rec else None for _, rec in got] == [b"ord-ok-1", None, None, b"ord-ok-2"]
    assert [off for off, _ in got] == [{0: 1}, {0: 2}, {0: 3}, {0: 4}]
    assert source.decode_failures == 1 and len(source.quarantine) == 1
    part, off, err, head = source.quarantine[0]
    assert (part, off, head) == (0, 1, b"\xff\xff\xff\xff") and err
    assert source.last_error and source.last_error_ts > 0
    source.close()


def test_quarantine_is_bounded(broker):
    for _ in range(OrdersSource.QUARANTINE_KEEP + 5):
        broker.append("orders", b"\xff\xff")
    source = OrdersSource(_addr(broker))
    offsets, records = source.poll_batch(0.05)
    assert records == [] and offsets == {0: OrdersSource.QUARANTINE_KEEP + 5}
    assert source.decode_failures == OrdersSource.QUARANTINE_KEEP + 5
    assert len(source.quarantine) == OrdersSource.QUARANTINE_KEEP
    source.close()


def _low_port_broker(mod, port=None):
    for _ in range(20):
        try:
            return mod.KafkaBroker(port=port or random.randint(20000, 30000))
        except OSError:
            time.sleep(0.25 if port else 0)
    pytest.fail("no port to bind")


def test_orders_source_survives_broker_restart():
    """A lost broker means retry with backoff; the remembered position
    is past the new broker's log end, so the source resets to earliest."""
    b1 = _low_port_broker(kafka_broker)
    b1.start()
    _publish_orders(b1, 2)
    source = OrdersSource(_addr(b1))
    assert len(list(source.poll(0.05))) == 2
    port = b1.port
    b1.stop()
    assert list(source.poll(0.05)) == []
    assert list(source.poll(0.05)) == []
    b2 = _low_port_broker(kafka_broker, port)
    b2.start()
    try:
        _publish_orders(b2, 1, start=100)
        deadline = time.monotonic() + 5.0
        got = []
        while not got and time.monotonic() < deadline:
            got = list(source.poll(0.05))
            if not got:
                time.sleep(0.2)
        assert [rec.trace_id for _, rec in got] == [b"ord-100"]
    finally:
        source.close()
        b2.stop()


def test_seek_before_connect_applies_on_connect():
    """A source built while its broker is down connects later and seeks
    to the offsets it was given."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    source = OrdersSource(f"127.0.0.1:{port}")
    source.seek({"0": 2})
    assert source.poll_batch(0.05) == ({}, [])
    b = _low_port_broker(kafka_broker, port)
    b.start()
    try:
        _publish_orders(b, 4)
        source._next_connect = 0.0  # skip the reconnect backoff
        assert [r.trace_id for r in source.poll_batch(0.05)[1]] == [b"ord-2", b"ord-3"]
    finally:
        source.close()
        b.stop()


def test_a_malformed_address_refuses_at_once():
    with pytest.raises(ValueError):
        OrdersSource("127.0.0.1:notaport")


# -- deferred offsets and the fenced commit -------------------------------------------


class _FakeTicket:
    def __init__(self, done=False, error=None):
        self._done = done
        self._error = error


@pytest.mark.parametrize("mod", [kafka_orders, jorders], ids=["port", "reference"])
def test_deferred_offsets_merge_only_clean_confirmations(mod):
    d = mod.DeferredOffsets(cap=8)
    d.add(_FakeTicket(done=True), {0: 5})
    d.add(_FakeTicket(done=True, error=RuntimeError("flush died")), {0: 9})
    d.add(_FakeTicket(done=False), {1: 3})
    assert d.resolve() == {0: 5}
    assert len(d) == 1


@pytest.mark.parametrize("mod", [kafka_orders, jorders], ids=["port", "reference"])
def test_deferred_offsets_cap_sheds_oldest_and_forces_a_barrier(mod):
    d = mod.DeferredOffsets(cap=3)
    for i in range(5):
        d.add(_FakeTicket(), {0: i})
    assert len(d) == 3 and d.dropped_total == 2
    assert d.take_barrier() is True and d.take_barrier() is False
    for t, _ in d._items:
        t._done = True
    assert d.resolve() == {0: 4}


def test_deferred_offsets_resolve_a_real_pool_ticket():
    from opentelemetry_demo_tpu_torch.runtime.ingest_pool import DecodeTicket

    d = DeferredOffsets()
    t = DecodeTicket()
    d.add(t, {2: 7})
    assert d.resolve() == {} and len(d) == 1
    t._resolve()
    assert d.resolve() == {2: 7} and len(d) == 0


class _Fence:
    def __init__(self, stale=False):
        self.stale = stale
        self.paths = []

    def check(self, path=""):
        self.paths.append(path)
        if self.stale:
            raise checkpoint.StaleEpochError(f"fenced at {path}")


def test_epoch_tagged_commit_reads_back_through_the_broker(broker):
    _publish_orders(broker, 6)
    source = OrdersSource(_addr(broker), group_id="det")
    source.fence = _Fence()
    assert source.last_committed_epoch() == 0
    source.commit({0: 4}, epoch=3)
    assert source.fence.paths == ["kafka-offset-commit"]
    assert broker.committed("det", "orders") == 4
    assert source.last_committed_epoch() == 3
    # Any later consumer of the group reads the tag; the JAX package's too.
    other = OrdersSource(_addr(broker), group_id="det")
    assert other.last_committed_epoch() == 3
    assert jorders.OrdersSource(_addr(broker), group_id="det").last_committed_epoch() == 3
    assert other._ensure_wire().committed_meta() == {0: (4, '{"epoch": 3}')}
    source.commit({}, epoch=5)  # nothing to commit: no write
    assert source.last_committed_epoch() == 3
    other.close()
    source.close()


def test_a_stale_fence_blocks_the_commit(broker):
    _publish_orders(broker, 3)
    source = OrdersSource(_addr(broker), group_id="det")
    source.commit({0: 1}, epoch=2)
    source.fence = _Fence(stale=True)
    with pytest.raises(checkpoint.StaleEpochError):
        source.commit({0: 3}, epoch=1)
    assert broker.committed("det", "orders") == 1
    assert source.last_committed_epoch() == 2
    source.close()


def test_commit_without_a_broker_raises():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    source = OrdersSource(f"127.0.0.1:{port}")
    with pytest.raises(Exception):
        source.commit({0: 1}, epoch=1)
    assert source.last_committed_epoch() == 0
