"""The port's orders leg against the reference: decode, native columns, end to end.

``decode_order``, ``order_to_record`` and the encoders equal the JAX
package's on the same orders (the cases of ``tests/test_runtime.py``).
The port's native ``decode_orders_columnar`` (its own ``ingest.cc``,
built with the host ``g++``) gives the reference decoder's columns byte
for byte, on the cases of ``tests/test_native_ingest.py`` (JPY
normalisation, the empty batch, a malformed payload, the first
non-empty product id) and on a seeded corpus, and raises with the
build's error where the library cannot build: no fallback.

Then the leg end to end on the CPU: one seeded order stream with a
producer flood (each order published four times, the shop's
``kafkaQueueProblems``) through the port's broker, ``OrdersSource`` and
pipeline, and through the JAX package's. Integer state bit-exact, floats
within rtol 1e-4 / atol 1e-5, the same flags on the same batches, and
``checkout-orders`` flagged on the first batch of the flood. A
checkpoint with the per-partition offsets, resumed in either package,
continues as the uninterrupted run.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest

from opentelemetry_demo_tpu.currency_data import EUR_RATES as J_EUR_RATES
from opentelemetry_demo_tpu.currency_data import to_usd_factor as j_to_usd_factor
from opentelemetry_demo_tpu.models import AnomalyDetector as JAnomalyDetector
from opentelemetry_demo_tpu.models import DetectorConfig as JDetectorConfig
from opentelemetry_demo_tpu.runtime import checkpoint as jckpt
from opentelemetry_demo_tpu.runtime import kafka_broker as jbroker
from opentelemetry_demo_tpu.runtime import kafka_orders as jorders
from opentelemetry_demo_tpu.runtime import native as jnative
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu.runtime.pipeline import DetectorPipeline as JDetectorPipeline
import torch

from opentelemetry_demo_tpu_torch import currency_data
from opentelemetry_demo_tpu_torch.models import AnomalyDetector, DetectorConfig
from opentelemetry_demo_tpu_torch.models.detector import state_to_numpy
from opentelemetry_demo_tpu_torch.runtime import checkpoint, kafka_broker, kafka_orders, native, tensorize, wire
from opentelemetry_demo_tpu_torch.runtime.kafka_orders import Order
from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    """Both decoders must build here (g++ is on the test machines)."""
    assert native.available(), native.load_error()
    assert jnative.available(), jnative.load_error()


ORDERS = [
    Order("ord-1", "trk", 3.5, 2, ("P-A", "P-B"), 3),
    Order("", "", 0.0, 0, (), 0),
    Order("ord-with-long-id-123456", "t", 19.99, 1, ("P-Z",), 1),
    Order("ord-jpy", "t", 1500.0, 1, ("P-J",), 1, currency="JPY"),
    Order("ord-eur", "t", 9.5, 1, ("P-E",), 1, currency="EUR"),
    Order("ord-xxx", "t", 7.0, 1, ("P-X",), 1, currency="XXX"),
    Order("ord-multi", "trk-2", 0.125, 3, ("TEL-DOB-10", "RED-DOT-F", "CHA-ATLAS"), 7, currency="GBP"),
]


def test_currency_table_is_the_reference():
    assert currency_data.EUR_RATES == J_EUR_RATES
    for code in list(J_EUR_RATES) + ["XXX", ""]:
        assert currency_data.to_usd_factor(code) == j_to_usd_factor(code)


@pytest.mark.parametrize("i", range(len(ORDERS)))
def test_decode_and_records_equal_the_reference(i):
    order = ORDERS[i]
    payload = kafka_orders.encode_order(order)
    assert payload == jorders.encode_order(jorders.Order(*order))
    got, want = kafka_orders.decode_order(payload), jorders.decode_order(payload)
    assert tuple(got) == tuple(want)
    rec, ref = kafka_orders.order_to_record(got), jorders.order_to_record(want)
    assert tuple(rec) == tuple(ref)
    assert kafka_orders.order_to_record(got, duration_us=5.0).duration_us == 5.0


def test_encoders_equal_the_reference():
    for args in (("EUR", 3, 0), ("USD", 0, 500_000_000), ("JPY", 0, 0)):
        assert kafka_orders.encode_money(*args) == jorders.encode_money(*args)
    lines = [("P-A", 2, ("USD", 12, 990_000_000)), ("P-B", 1, None)]
    want = jorders.encode_order_result("o-1", "t-1", ("USD", 8, 250_000_000), lines)
    assert kafka_orders.encode_order_result("o-1", "t-1", ("USD", 8, 250_000_000), lines) == want

    class Money:
        def __init__(self, currency, units, nanos):
            self.currency, self.units, self.nanos = currency, units, nanos

    class Line:
        def __init__(self, pid, qty, cost):
            self.product_id, self.quantity, self.cost = pid, qty, cost

    class Placed:
        order_id, tracking_id = "o-2", "t-2"
        shipping = Money("EUR", 5, 0)
        items = [Line("P-C", 3, Money("EUR", 1, 10)), Line("P-D", 1, Money("EUR", 0, 5))]

    assert kafka_orders.encode_placed_order(Placed) == jorders.encode_placed_order(Placed)
    dec = kafka_orders.decode_order(kafka_orders.encode_placed_order(Placed))
    assert dec.product_ids == ("P-C", "P-D") and dec.total_quantity == 4 and dec.currency == "EUR"


# -- the native decoder ----------------------------------------------------------------


def _assert_same_columns(got, want):
    assert got.rows == want.rows
    for name in got._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def _both_columnar(payloads):
    tz, jt = tensorize.SpanTensorizer(num_services=8), jtz.SpanTensorizer(num_services=8)
    got = kafka_orders.decode_orders_columnar(payloads, tz)
    want = jorders.decode_orders_columnar(payloads, jt)
    assert tz.service_names == jt.service_names == [kafka_orders.ORDERS_SERVICE]
    return got, want, tz


def test_columnar_equals_the_reference_and_the_record_path():
    payloads = [kafka_orders.encode_order(o) for o in ORDERS]
    got, want, tz = _both_columnar(payloads)
    _assert_same_columns(got, want)
    ref = tensorize.SpanTensorizer(num_services=8).columns_from_records(
        [kafka_orders.order_to_record(kafka_orders.decode_order(p)) for p in payloads])
    np.testing.assert_array_equal(ref.svc, got.svc)
    np.testing.assert_allclose(ref.lat_us, got.lat_us, rtol=1e-6)
    np.testing.assert_array_equal(ref.trace_key, got.trace_key)
    np.testing.assert_array_equal(ref.attr_crc, got.attr_crc)
    raw = native.decode_orders(payloads)
    want_raw = jnative.decode_orders(payloads)
    for a, b in zip(raw, want_raw):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_columnar_equals_the_reference_on_a_seeded_corpus():
    payloads = [p for _, p in _order_stream(np.random.default_rng(3), 2000)]
    got, want, _ = _both_columnar(payloads)
    _assert_same_columns(got, want)
    assert len(np.unique(got.trace_key)) == 2000
    # The per-message path gives the same bytes: a replay through either
    # path leaves the same state.
    recs = tensorize.SpanTensorizer(num_services=8).columns_from_records(
        [kafka_orders.order_to_record(kafka_orders.decode_order(p)) for p in payloads])
    _assert_same_columns(recs, got)


def test_empty_batch():
    got, want, _ = _both_columnar([])
    assert got.rows == want.rows == 0
    _assert_same_columns(got, want)


def test_value_lane_is_usd_normalised_both_ways():
    jpy = kafka_orders.encode_order(Order("o-j", "t", 1500.0, 1, ("P",), 1, currency="JPY"))
    usd = kafka_orders.encode_order(Order("o-u", "t", 1500.0, 1, ("P",), 1))
    rec_jpy = kafka_orders.order_to_record(kafka_orders.decode_order(jpy))
    assert rec_jpy.duration_us == pytest.approx(1500.0 * currency_data.to_usd_factor("JPY"))
    assert rec_jpy.duration_us < 20.0
    got, want, _ = _both_columnar([jpy, usd])
    _assert_same_columns(got, want)
    np.testing.assert_allclose(got.lat_us, [rec_jpy.duration_us, 1500.0], rtol=1e-6)


def test_numeric_currency_code_falls_back_to_usd_both_ways():
    money = wire.encode_int(1, 5) + wire.encode_int(2, 3)
    payload = wire.encode_len(1, b"ord-n") + wire.encode_len(3, money)
    assert kafka_orders.decode_order(payload).currency == "USD"
    got, want, _ = _both_columnar([payload])
    _assert_same_columns(got, want)
    assert got.lat_us[0] == pytest.approx(3.0)


MALFORMED = {
    "empty money units": wire.encode_len(1, b"ord-e") + wire.encode_len(
        3, wire.encode_len(1, b"USD") + wire.encode_len(2, b"")),
    "truncated varint": b"\xff\xff\xff\xff",
    "truncated length": wire.encode_len(1, b"ord-x")[:-2],
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_payloads_raise_both_ways(case):
    payload = MALFORMED[case]
    good = kafka_orders.encode_order(ORDERS[0])
    with pytest.raises(Exception):
        kafka_orders.decode_order(payload)
    with pytest.raises(Exception):
        jorders.decode_order(payload)
    with pytest.raises(ValueError, match="malformed OrderResult"):
        native.decode_orders([good, payload])
    with pytest.raises(ValueError):
        jnative.decode_orders([good, payload])
    with pytest.raises(ValueError):
        kafka_orders.decode_orders_columnar([payload], tensorize.SpanTensorizer())


def test_first_non_empty_product_id_is_the_attribute():
    items = (wire.encode_len(5, wire.encode_len(1, wire.encode_len(1, b"")))
             + wire.encode_len(5, wire.encode_len(1, wire.encode_len(1, b"P1"))))
    payload = wire.encode_len(1, b"ord-9") + items
    assert kafka_orders.order_to_record(kafka_orders.decode_order(payload)).attr == "P1"
    got, want, _ = _both_columnar([payload])
    _assert_same_columns(got, want)
    assert got.attr_crc[0] == zlib.crc32(b"P1")


def test_columnar_decode_raises_without_the_library(monkeypatch):
    """No fallback: a decoder that cannot build raises with its error."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "no host C++ compiler (g++ or c++) on PATH")
    payload = kafka_orders.encode_order(ORDERS[0])
    with pytest.raises(RuntimeError, match="no host C"):
        kafka_orders.decode_orders_columnar([payload], tensorize.SpanTensorizer())
    with pytest.raises(RuntimeError, match="native ingest unavailable"):
        native.decode_orders([payload])


def test_the_rate_table_fits_the_native_cap():
    assert 0 < len(currency_data.EUR_RATES) <= 64


# -- the leg end to end --------------------------------------------------------------

CATALOG = ["TEL-DOB-10", "TEL-REF-80", "EYE-PLO-25", "FIL-OIII-2", "MNT-EQ6-GT",
           "CAM-ASI-294", "BIN-15X70", "RED-DOT-F", "CHA-ATLAS", "PWR-TANK-12"]
CFG = dict(num_services=8, hll_p=8, cms_width=512, warmup_batches=5.0, z_warmup_batches=20.0)
RATE, DT = 400.0, 0.1  # orders a second; pump cadence
CLEAN_S, FLOOD_S, DUP = 8.0, 2.0, 4


def _order_stream(rng, n):
    """(arrival time, OrderResult bytes): Poisson arrivals at RATE, Zipf
    (s = 1.1) products over the catalog, 60/25/15 % USD/EUR/JPY."""
    w = 1.0 / np.arange(1, len(CATALOG) + 1) ** 1.1
    t = np.cumsum(rng.exponential(1.0 / RATE, n))
    cur = rng.choice(["USD", "EUR", "JPY"], n, p=[0.6, 0.25, 0.15])
    cost_usd = rng.lognormal(np.log(8.0), 0.5, n)
    out = []
    for i in range(n):
        k = int(rng.integers(1, 4))
        lines = [(CATALOG[j], int(q), None) for j, q in zip(rng.choice(len(CATALOG), k, p=w / w.sum()),
                                                            rng.integers(1, 6, k))]
        cost = cost_usd[i] / currency_data.to_usd_factor(str(cur[i]))
        units = int(cost)
        payload = kafka_orders.encode_order_result(
            f"{i:08x}-{rng.bytes(6).hex()}", rng.bytes(8).hex(),
            (str(cur[i]), units, int((cost - units) * 1e9)), lines)
        out.append((float(t[i]), payload))
    return out


def _pumps(seed=7):
    """Per pump: the payloads that arrived in its 0.1 s, each published
    DUP times during the flood."""
    n = int((CLEAN_S + FLOOD_S) * RATE * 1.2)
    stream = [(t, p) for t, p in _order_stream(np.random.default_rng(seed), n) if t < CLEAN_S + FLOOD_S]
    n_pumps = int(round((CLEAN_S + FLOOD_S) / DT))
    out = [[] for _ in range(n_pumps)]
    for t, p in stream:
        k = min(int(t / DT), n_pumps - 1)
        out[k].extend([p] * (DUP if t >= CLEAN_S else 1))
    return out


class _Leg:
    """One package's broker, orders source and pipeline on one stream."""

    def __init__(self, which, det=None, offsets=None, broker=None, device="cpu"):
        self.which = which
        self.reports = []
        if which == "port":
            self.broker = broker or kafka_broker.KafkaBroker(num_partitions=3)
            det = det or AnomalyDetector(DetectorConfig(**CFG), device=device)
            self.pipe = DetectorPipeline(det, on_report=self._on_report, batch_size=512)
            self.source = kafka_orders.OrdersSource(f"127.0.0.1:{self.broker.port}")
        else:
            self.broker = broker or jbroker.KafkaBroker(num_partitions=3)
            det = det or JAnomalyDetector(JDetectorConfig(**CFG))
            self.pipe = JDetectorPipeline(det, on_report=self._on_report, batch_size=512)
            self.source = jorders.OrdersSource(f"127.0.0.1:{self.broker.port}")
        if broker is None:
            self.broker.start()
        if offsets:
            self.source.seek(offsets)
        self.offsets: dict = {}
        self.appended = 0

    def _on_report(self, t, rep, names):
        self.reports.append((t, {f: np.asarray(getattr(rep, f)).copy() for f in rep._fields}, names))

    def publish(self, payloads):
        for p in payloads:
            self.broker.append("orders", p, partition=self.appended % 3)
            self.appended += 1

    def pump(self, k, payloads):
        self.publish(payloads)
        while True:
            offsets, records = self.source.poll_batch(0.0)
            if not offsets:
                break
            self.pipe.submit(records)
            self.offsets.update(offsets)  # after the records reached the pipeline
        self.pipe.pump(k * DT)

    def state(self):
        if self.which == "port":
            return state_to_numpy(self.pipe.detector.state)._asdict()
        return {k: np.asarray(v) for k, v in self.pipe.detector.state._asdict().items()}

    def close(self, stop=True):
        self.source.close()
        if stop:
            self.broker.stop()


def _assert_states(got, want):
    for key, b in want.items():
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(got[key], b, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], b, rtol=1e-4, atol=1e-5, err_msg=key)


def _assert_reports(got, want):
    assert [(t, names) for t, _, names in got] == [(t, names) for t, _, names in want]
    for (_, a, _), (_, b, _) in zip(got, want):
        for f, x in b.items():
            np.testing.assert_allclose(a[f], x, rtol=1e-4, atol=1e-5, err_msg=f)


@pytest.fixture(scope="module")
def uninterrupted():
    pumps = _pumps()
    out = {}
    for which in ("port", "reference"):
        leg = _Leg(which)
        for k, payloads in enumerate(pumps):
            leg.pump(k, payloads)
        leg.pipe.drain()
        out[which] = (leg.reports, leg.state(), leg.pipe.stats.spans, leg.offsets)
        leg.close()
    return pumps, out


def test_the_orders_leg_equals_the_reference(uninterrupted):
    pumps, out = uninterrupted
    (reports, state, spans, offsets), (rreports, rstate, rspans, roffsets) = out["port"], out["reference"]
    assert spans == rspans == sum(len(p) for p in pumps)
    assert offsets == roffsets and sum(offsets.values()) == spans
    _assert_states(state, rstate)
    _assert_reports(reports, rreports)
    onset = CLEAN_S
    flagged = [(round(t, 6), names) for t, _, names in reports if names]
    assert flagged and flagged[0] == (onset, [kafka_orders.ORDERS_SERVICE])
    assert all(t >= onset for t, _ in flagged)


@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port"), ("port", "port")])
def test_a_checkpoint_with_offsets_resumes_in_either_package(uninterrupted, tmp_path, writer, reader):
    pumps, out = uninterrupted
    save_at = 50
    a = _Leg(writer)
    for k in range(save_at + 1):
        a.pump(k, pumps[k])
    path = str(tmp_path / "orders.ckpt")
    offsets = dict(a.offsets)
    save = checkpoint.save if writer == "port" else jckpt.save
    save(path, a.pipe.detector, offsets=offsets, service_names=a.pipe.tensorizer.service_names,
         dispatch_lock=a.pipe._dispatch_lock)
    a.pipe.drain()
    a.close(stop=False)
    # The broker lives on; the reader's package connects a new source to it.
    if reader == "port":
        det, meta = checkpoint.load(path, DetectorConfig(**CFG), device="cpu")
    else:
        det, meta = jckpt.load(path, JDetectorConfig(**CFG))
    assert meta["offsets"] == {str(p): o for p, o in offsets.items()}
    b = _Leg(reader, det=det, offsets=meta["offsets"], broker=a.broker)
    b.appended = a.appended
    b.pipe.tensorizer.adopt_names(meta["service_names"])
    for k in range(save_at + 1, len(pumps)):
        b.pump(k, pumps[k])
    b.pipe.drain()
    # No order counted twice: the resumed run dispatched only what came after.
    assert a.pipe.stats.spans + b.pipe.stats.spans == out["port"][2]
    _assert_states(b.state(), out[reader][1])
    tail = [(t, n) for t, _, n in out[reader][0] if t > save_at * DT]
    assert [(t, n) for t, _, n in b.reports] == tail
    b.close()


# -- on the card -------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_the_orders_leg_and_its_resume_on_the_card(uninterrupted, cuda_device, tmp_path):
    """The leg on the card equals the CPU's (the kernels against their
    plain versions); a snapshot saved on the card mid-stream, resumed on
    the card by a new source seeking its offsets, ends bit-identical to
    the card's uninterrupted run."""
    pumps, out = uninterrupted
    full = _Leg("port", device=cuda_device)
    for k, payloads in enumerate(pumps):
        full.pump(k, payloads)
    full.pipe.drain()
    _assert_states(full.state(), out["port"][1])
    _assert_reports(full.reports, out["port"][0])
    full.close()
    save_at = 50
    a = _Leg("port", device=cuda_device)
    for k in range(save_at + 1):
        a.pump(k, pumps[k])
    path = str(tmp_path / "card.ckpt")
    checkpoint.save(path, a.pipe.detector, offsets=dict(a.offsets),
                    service_names=a.pipe.tensorizer.service_names, dispatch_lock=a.pipe._dispatch_lock)
    a.pipe.drain()
    a.close(stop=False)
    det, meta = checkpoint.load(path, DetectorConfig(**CFG))
    assert det.device.type == "cuda"
    b = _Leg("port", det=det, offsets=meta["offsets"], broker=a.broker)
    b.appended = a.appended
    b.pipe.tensorizer.adopt_names(meta["service_names"])
    for k in range(save_at + 1, len(pumps)):
        b.pump(k, pumps[k])
    b.pipe.drain()
    got, want = b.state(), full.state()
    for key, x in want.items():
        assert got[key].tobytes() == x.tobytes(), key
    assert a.pipe.stats.spans + b.pipe.stats.spans == full.pipe.stats.spans
    b.close()
