"""The port's native OTLP decoder and columnar path against the reference.

The port builds its own copy of the C++ decoder (``csrc/host/ingest.cc``)
with the host compiler; the reference builds its copy from
``native/ingest.cc``. On the cases of ``tests/test_native_ingest.py``
(parity, seeded mutations, scanner boundaries) the two must give the
same eight columns, the same service lists and the same per-payload
verdicts, and the port's columns must equal its own Python decoder's.
Then ``columns_from_columnar`` (with and without an intern arena, across
a retirement), the span frames (byte for byte) and the GIL contract.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import pytest

from opentelemetry_demo_tpu.runtime import frame as jframe
from opentelemetry_demo_tpu.runtime import native as jnative
from opentelemetry_demo_tpu.runtime import tensorize as jtz
from opentelemetry_demo_tpu.runtime.faultwire import corrupt_bytes
from opentelemetry_demo_tpu_torch.runtime import frame, native, otlp, tensorize, wire

KEYS = otlp.MONITORED_ATTR_KEYS


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    """Both decoders must build here (g++ is on the test machines)."""
    assert native.available(), native.load_error()
    assert jnative.available(), jnative.load_error()


def _anyval(s):
    return wire.encode_len(1, s.encode())


def _kv(k, v):
    return wire.encode_len(1, k.encode()) + wire.encode_len(2, _anyval(v))


def _span(trace_id, start, end, attrs=(), err=False, extra=b""):
    span = (
        wire.encode_len(1, trace_id)
        + wire.encode_len(5, b"op")
        + wire.encode_fixed64(7, start)
        + wire.encode_fixed64(8, end)
    )
    for k, v in attrs:
        span += wire.encode_len(9, _kv(k, v))
    if err:
        span += wire.encode_len(15, wire.encode_int(3, 2))
    return span + extra


def _rs(service, span_bufs, with_resource=True):
    rs = b""
    if with_resource:
        rs += wire.encode_len(1, wire.encode_len(1, _kv("service.name", service)))
    rs += wire.encode_len(2, b"".join(wire.encode_len(2, s) for s in span_bufs))
    return wire.encode_len(1, rs)


def _event(t_ns, name, attrs=()):
    body = wire.encode_fixed64(1, t_ns) + wire.encode_len(2, name)
    for k, v in attrs:
        body += wire.encode_len(3, _kv(k, v))
    return wire.encode_len(11, body)


def _large_request():
    rng = np.random.default_rng(3)
    payload = b""
    for i in range(12):
        spans = [
            _span(
                bytes(rng.integers(0, 256, 16, dtype=np.uint8)), 0, int(rng.integers(1, 10**9)),
                [("app.session.id", f"sess-{int(rng.integers(0, 50))}")],
                err=bool(rng.random() < 0.3),
            )
            for _ in range(40)
        ]
        payload += _rs(f"svc-{i % 5}", spans)
    return payload


def _deep_nesting():
    deep = b"z"
    for _ in range(1000):
        deep = wire.encode_len(13, deep)
    nested_attr = wire.encode_len(
        9, wire.encode_len(1, b"app.product.id") + wire.encode_len(2, wire.encode_len(1, b"P-deep"))
    )
    return _rs("checkout", [_span(b"\x01" * 16, 1_000, 9_000, extra=deep + nested_attr)])


_SPAN_C = _span(b"\x0c" * 16, 0, 10)
_RS_BODY = wire.encode_len(2, wire.encode_len(2, _SPAN_C))

# Every payload of tests/test_native_ingest.py::TestOtlpParity, well
# formed or not.
PAYLOADS = {
    "basic": _rs("payment", [
        _span(b"\x01" * 16, 10**9, 10**9 + 250 * 10**6, [("app.product.id", "P-7")], err=True),
        _span(b"\x02" * 16, 10**9, 10**9 + 10**6),
    ]),
    "multi_resource_and_missing_resource": (
        _rs("checkout", [_span(b"\x03" * 16, 0, 5000)])
        + _rs("ignored", [], with_resource=True)
        + _rs("", [_span(b"\x04" * 16, 0, 1000)], with_resource=False)
        + _rs("cart", [_span(b"\x05" * 16, 7, 7)])
    ),
    "attr_priority_and_last_wins": _rs("ad", [_span(b"\x06" * 16, 0, 10, [
        ("session.id", "s-1"), ("app.product.id", "P-old"), ("app.product.id", "P-new"),
    ])]),
    "unknown_fields": (
        _rs("quote", [_span(b"\x07" * 16, 0, 10, extra=wire.encode_len(99, b"\xff\xff\xff"))])
        + wire.encode_len(9, b"\xde\xad")
    ),
    "short_and_empty_trace_ids": _rs("email", [_span(b"abc", 0, 10), _span(b"", 0, 10)]),
    "malformed_truncated_length": b"\x0a\xff",
    "malformed_span": wire.encode_len(1, wire.encode_len(2, b"\x12\x7f")),
    "malformed_field_zero": b"\x00\x01",
    "malformed_sgroup": b"\x0b",
    "empty": b"",
    "nul_in_service_name": _rs("a\0b", [_span(b"\x08" * 16, 0, 1)]) + _rs("c", [_span(b"\x09" * 16, 0, 1)]),
    "empty_vs_missing_service_name": (
        _rs("", [_span(b"\x0a" * 16, 0, 1)]) + _rs("x", [_span(b"\x0b" * 16, 0, 1)], with_resource=False)
    ),
    "resource_spans_as_varint": wire.encode_int(1, 5),
    "scope_spans_as_varint": wire.encode_len(1, wire.encode_int(2, 1)),
    "resource_as_varint": wire.encode_len(1, wire.encode_int(1, 7) + _RS_BODY),
    "attributes_as_varint": wire.encode_len(
        1, wire.encode_len(2, wire.encode_len(2, _SPAN_C + wire.encode_int(9, 3)))
    ),
    "resource_zero_is_absent": wire.encode_len(1, wire.encode_int(1, 0) + _RS_BODY),
    "span_events_and_exception_fold": _rs("checkout", [
        _span(b"\x21" * 16, 0, 5_000_000, extra=(
            _event(1_000_000, b"prepared")
            + _event(2_000_000, b"charged", [("app.payment.transaction.id", "tx")])
            + _event(3_000_000, b"shipped")
        )),
        _span(b"\x22" * 16, 0, 1_000_000, extra=_event(500_000, b"exception", [("exception.message", "boom")])),
        _span(b"\x23" * 16, 0, 1_000_000, extra=_event(0, b"error")),
        _span(b"\x28" * 16, 0, 1_000_000, extra=_event(0, b"Error", [("exception.message", "ad fail")])),
        _span(b"\x24" * 16, 0, 1_000_000),
    ]),
    "events_as_varint": _rs("s", [_span(b"\x25" * 16, 0, 10, extra=wire.encode_int(11, 3))]),
    "numeric_event_name": _rs("s", [_span(b"\x26" * 16, 0, 10, extra=wire.encode_len(
        11, wire.encode_int(2, 7) + wire.encode_len(1, b"")
    ))]),
    "event_attrs_as_varint": _rs("s", [_span(b"\x27" * 16, 0, 10, extra=wire.encode_len(
        11, wire.encode_len(2, b"ev") + wire.encode_int(3, 1)
    ))]),
    "large_request_many_services": _large_request(),
    "max_nesting": _deep_nesting(),
}


def _decode_or_error(decode, payload):
    try:
        return decode(payload, KEYS)
    except ValueError as e:
        return e


def assert_same_columns(a, b, what=""):
    assert a._fields == b._fields
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
            assert x.tobytes() == y.tobytes(), (what, name)
        else:
            assert x == y, (what, name)


@pytest.mark.parametrize("case", sorted(PAYLOADS))
def test_port_decoder_equals_reference_decoder(case):
    payload = PAYLOADS[case]
    got = _decode_or_error(native.decode_otlp, payload)
    ref = _decode_or_error(jnative.decode_otlp, payload)
    assert isinstance(got, ValueError) == isinstance(ref, ValueError), (got, ref)
    python_ok = True
    try:
        records = otlp.decode_export_request(payload)
    except ValueError:
        python_ok = False
    assert python_ok == (not isinstance(got, ValueError))
    if isinstance(got, ValueError):
        return
    assert_same_columns(got, ref, case)
    # And the port's native path equals its own Python decoder.
    tz_nat, tz_py = tensorize.SpanTensorizer(16), tensorize.SpanTensorizer(16)
    cols = tz_nat.columns_from_columnar(got)
    want = tz_py.columns_from_records(records)
    assert tz_nat.service_names == tz_py.service_names
    assert_same_columns(cols, want, case)
    assert got.event_count.tolist() == [len(r.events) for r in records]


def test_exception_events_fold_into_the_error_lane():
    cols = native.decode_otlp(PAYLOADS["span_events_and_exception_fold"], KEYS)
    assert cols.has_exception.tolist() == [0, 1, 1, 1, 0]
    got = tensorize.SpanTensorizer(16).columns_from_columnar(cols)
    assert got.is_error.tolist() == [0.0, 1.0, 1.0, 1.0, 0.0]


def _fuzz_bases():
    spans = [
        _span(bytes([i + 1]) * 16, 1_000, 5_000 + i * 997,
              attrs=[("app.product.id", f"P{i}")], err=bool(i % 2))
        for i in range(6)
    ]
    return [
        _rs("checkout", spans),
        _rs("cart", spans[:2]) + _rs("frontend", spans[2:4]),
        _rs("", spans[:1], with_resource=False),
    ]


@pytest.mark.parametrize("seeds", [range(s, s + 8) for s in range(0, 40, 8)],
                         ids=lambda r: f"seeds{r.start}-{r.stop - 1}")
def test_seeded_mutations_match_the_reference(seeds):
    """TestDecodeFuzz's corpus: each mutated batch, with an intact
    witness, through both decoders: same verdicts, columns and services,
    and the witness always survives."""
    bases = _fuzz_bases()
    witness = bases[0]
    for seed in seeds:
        rate = 0.002 + (seed % 8) * 0.01
        batch = [corrupt_bytes(p, seed=seed, rate=rate)[0] for p in bases] + [witness]
        got, rows = native.decode_otlp_many(batch, KEYS)
        ref, ref_rows = jnative.decode_otlp_many(batch, KEYS)
        assert rows.tolist() == ref_rows.tolist(), seed
        assert int(rows[-1]) == 6
        assert_same_columns(got, ref, seed)
        for p, r in zip(batch, rows):
            try:
                otlp.decode_export_request(p)
                python_ok = True
            except ValueError:
                python_ok = False
            assert python_ok == (int(r) >= 0), seed
        out = tensorize.SpanTensorizer(16).columns_from_columnar(got, copy=True)
        assert out.rows == got.duration_us.shape[0]


def _varied_spans_payload(n_spans=4096, seed=5):
    rng = np.random.default_rng(seed)
    bufs = []
    for i in range(n_spans):
        tid = bytes(rng.integers(0, 256, int(rng.integers(0, 17)), dtype=np.uint8))
        extra = b""
        if i % 7 == 0:
            extra = wire.encode_len(14, b"x" * int(rng.integers(0, 160)))
        bufs.append(_span(tid, 1_000 + i, 5_000 + i * 31, attrs=[("app.product.id", f"P{i % 13}")],
                          err=bool(i % 3 == 0), extra=extra))
    return _rs("checkout", bufs)


@pytest.mark.parametrize("threads", [1, 2, 3, 4])
def test_sharded_decode_matches_serial_and_the_reference(threads):
    payload = _varied_spans_payload()
    ref, ref_rows = jnative.decode_otlp_many([payload], KEYS, threads=1)
    got, rows = native.decode_otlp_many([payload], KEYS, threads=threads, shard_min_bytes=0)
    assert rows.tolist() == ref_rows.tolist() == [4096]
    assert_same_columns(got, ref, threads)


def test_sharded_mutation_fuzz_matches_the_reference():
    base = _varied_spans_payload(n_spans=2048, seed=9)
    witness = _varied_spans_payload(n_spans=600, seed=11)
    for seed in range(12):
        batch = [corrupt_bytes(base, seed=seed, rate=0.004)[0], witness]
        ser, ser_rows = native.decode_otlp_many(batch, KEYS, threads=1)
        thr, thr_rows = native.decode_otlp_many(batch, KEYS, threads=3, shard_min_bytes=0)
        ref, ref_rows = jnative.decode_otlp_many(batch, KEYS, threads=3, shard_min_bytes=0)
        assert ser_rows.tolist() == thr_rows.tolist() == ref_rows.tolist(), seed
        assert int(thr_rows[1]) == 600
        assert_same_columns(thr, ser, seed)
        assert_same_columns(thr, ref, seed)


def test_truncation_at_every_pass1_boundary_matches_the_reference():
    payload = _varied_spans_payload(n_spans=64, seed=13)
    idx = native.scan_otlp(payload)
    ref_idx = jnative.scan_otlp(payload)
    assert_same_columns(idx, ref_idx)
    cuts = sorted({int(o) for o in idx.span_off} | {int(o) + int(n) for o, n in zip(idx.span_off, idx.span_len)})
    assert len(cuts) >= 64
    for cut in cuts:
        m = payload[:cut]
        _, rows = native.decode_otlp_many([m], KEYS)
        _, ref_rows = jnative.decode_otlp_many([m], KEYS)
        assert rows.tolist() == ref_rows.tolist(), cut
        try:
            otlp.decode_export_request(m)
            python_ok = True
        except ValueError:
            python_ok = False
        assert (int(rows[0]) >= 0) == python_ok, cut


def test_extract_of_a_scan_equals_the_one_call_decode():
    payload = PAYLOADS["large_request_many_services"]
    idx = native.scan_otlp(payload)
    assert_same_columns(native.extract_otlp(payload, idx, KEYS), native.decode_otlp(payload, KEYS))
    assert_same_columns(
        native.extract_otlp(payload, idx, KEYS), jnative.extract_otlp(payload, jnative.scan_otlp(payload), KEYS)
    )


def test_batched_decode_threads_equal_serial_with_bad_payloads():
    """Four threads == one; each malformed payload gets its own -1 while
    its batchmates keep their rows, as in the reference."""
    good = [_varied_spans_payload(n_spans=300 + 50 * i, seed=20 + i) for i in range(6)]
    batch = [good[0], b"\x0a\xff", good[1], good[2], PAYLOADS["malformed_span"], good[3], good[4], b"", good[5]]
    ser, ser_rows = native.decode_otlp_many(batch, KEYS, threads=1)
    thr, thr_rows = native.decode_otlp_many(batch, KEYS, threads=4, shard_min_bytes=0)
    ref, ref_rows = jnative.decode_otlp_many(batch, KEYS, threads=4, shard_min_bytes=0)
    assert ser_rows.tolist() == thr_rows.tolist() == ref_rows.tolist()
    assert ser_rows.tolist() == [300, -1, 350, 400, -1, 450, 500, 0, 550]
    assert_same_columns(thr, ser)
    assert_same_columns(thr, ref)


def test_scratch_views_and_the_copy_that_outlives_them():
    """With a scratch the decode returns views into it; the columns a
    pipeline queues must be copied before the scratch is reused."""
    a = _varied_spans_payload(n_spans=200, seed=31)
    b = _varied_spans_payload(n_spans=200, seed=32)
    scratch = native.alloc_scratch(*native.scratch_dims(len(a) + len(b), 2))
    cols, _ = native.decode_otlp_many([a], KEYS, scratch=scratch)
    assert np.shares_memory(cols.trace_key, scratch.trace)
    tz = tensorize.SpanTensorizer(16)
    kept = tz.columns_from_columnar(cols, copy=True)
    view = tz.columns_from_columnar(cols)
    want = tensorize.SpanTensorizer(16).columns_from_columnar(native.decode_otlp(a, KEYS))
    native.decode_otlp_many([b], KEYS, scratch=scratch)  # reuses the scratch
    assert_same_columns(kept, want)
    assert not np.array_equal(view.trace_key, want.trace_key)


def _stream(n, seed):
    """Columnar batches over a shifting set of services."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        names = [f"svc-{(k + i) % 11}" for i in range(4)]
        payload = b"".join(
            _rs(name, [_span(bytes(rng.integers(0, 256, 16, dtype=np.uint8)), 0, int(rng.integers(1, 10**6)),
                             [("app.product.id", f"P{int(rng.integers(0, 9))}")]) for _ in range(5)])
            for name in names
        )
        if k % 3 == 0:
            payload += _rs("", [_span(b"\x01" * 16, 0, 9)], with_resource=False)
        out.append(payload)
    return out


@pytest.mark.parametrize("use_arena", [False, True])
def test_columns_from_columnar_equals_the_reference_across_a_retirement(use_arena):
    """The same native batches through both tensorizers, with a
    retirement sweep halfway (the generation bump drops the arenas'
    caches; freed ids go to new services)."""
    tz, jtzr = tensorize.SpanTensorizer(8), jtz.SpanTensorizer(8)
    arena = tensorize.InternArena(tz) if use_arena else None
    jarena = jtz.InternArena(jtzr) if use_arena else None
    for k, payload in enumerate(_stream(12, seed=3)):
        if k == 6:
            gone = [n for n in tz.service_names[:3]]
            assert tz.retire_services(gone) == jtzr.retire_services(gone)
            assert tz.generation == jtzr.generation == 1
        cols = native.decode_otlp(payload, KEYS)
        got = tz.columns_from_columnar(cols, copy=k % 2 == 1, arena=arena)
        ref = jtzr.columns_from_columnar(jnative.decode_otlp(payload, KEYS), copy=k % 2 == 1, arena=jarena)
        assert_same_columns(got, ref, k)
        assert tz.service_names == jtzr.service_names
        assert got.trace_key.base is None or k % 2 == 0  # copy=True owns its memory


def test_arena_never_caches_the_overflow_id():
    tz = tensorize.SpanTensorizer(3)  # two real slots
    arena = tensorize.InternArena(tz)
    assert arena.lookup(["a", "b", "c"]) == [0, 1, 2]
    tz.retire_services(["a"])
    assert arena.lookup(["c", "b"]) == [0, 1]  # the freed id went to "c"


def test_span_frames_are_the_reference_bytes():
    payload = PAYLOADS["large_request_many_services"] + PAYLOADS["empty_vs_missing_service_name"]
    cols = native.decode_otlp(payload, KEYS)
    ref = jnative.decode_otlp(payload, KEYS)
    blob = frame.encode_spans(cols)
    assert blob == jframe.encode_spans(ref)
    assert frame.SPAN_SCHEMA == jframe.SPAN_SCHEMA
    back = frame.decode_spans(blob)
    assert_same_columns(back, cols)
    assert_same_columns(jframe.decode_spans(blob), ref)
    assert frame.span_column_crcs(cols) == jframe.span_column_crcs(ref)
    for bad in (blob[: len(blob) // 2], blob[:40] + bytes([blob[40] ^ 1]) + blob[41:]):
        with pytest.raises(frame.FrameCorrupt):
            frame.decode_spans(bad)


def test_span_column_crcs_catch_a_scribbled_scratch():
    scratch = native.alloc_scratch(*native.scratch_dims(200_000, 1))
    cols, _ = native.decode_otlp_many([PAYLOADS["large_request_many_services"]], KEYS, scratch=scratch)
    crcs = frame.span_column_crcs(cols)
    assert frame.verify_span_columns(cols, crcs) == []
    scratch.duration[3] += 1.0
    assert frame.verify_span_columns(cols, crcs) == ["duration_us"]


def test_library_is_a_cdll_and_two_threads_decode_alike():
    """``ctypes.CDLL`` (not ``PyDLL``) releases the GIL for every call;
    two threads decoding at once get the same columns as one alone."""
    lib = native._load()
    assert type(lib) is ctypes.CDLL and not isinstance(lib, ctypes.PyDLL)
    payloads = [_varied_spans_payload(n_spans=3000, seed=40 + i) for i in range(3)]
    want, want_rows = native.decode_otlp_many(payloads, KEYS, threads=2, shard_min_bytes=0)
    results: list = [None, None]
    errors: list = []

    def work(i):
        try:
            for _ in range(5):
                results[i] = native.decode_otlp_many(payloads, KEYS, threads=2, shard_min_bytes=0)
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    ths = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=60)
    assert not errors
    for cols, rows in results:
        assert rows.tolist() == want_rows.tolist()
        assert_same_columns(cols, want)


def test_columnar_decode_raises_without_the_library(monkeypatch):
    """No fallback: a decoder that cannot build raises with its error."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "no host C++ compiler (g++ or c++) on PATH")
    with pytest.raises(RuntimeError, match="no host C"):
        otlp.decode_export_request_columnar(PAYLOADS["basic"])
    with pytest.raises(RuntimeError, match="native ingest unavailable"):
        native.decode_otlp_many([PAYLOADS["basic"]], KEYS)


def test_library_is_named_by_its_source_hash():
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libingest_") and path.suffix == ".so"
    assert "-pthread" in native.build_command(path)
