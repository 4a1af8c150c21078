"""The port's trace-based test harness against the reference's.

The cases of ``tests/test_tracetest.py``: the selector and assertion
helpers give the reference's verdicts on the same spans, and every suite
under ``tracetesting/`` passes against the port's live stack
(``tracetest.make_rig``: the port's ``Shop``, ``ShopGateway``,
``FlagEditorUI`` and, where ``grpc`` imports, ``GrpcShopEdge``). The
gRPC suites compile ``proto/demo.proto`` with ``protoc``.
"""

from pathlib import Path

import pytest

from opentelemetry_demo_tpu import tracetest as ref_tt
from opentelemetry_demo_tpu_torch import tracetest as tt
from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanRecord

REPO = Path(__file__).resolve().parent.parent


def span(service, name, error=False, attr=None, dur=100.0):
    return SpanRecord(service=service, duration_us=dur, trace_id=b"\1" * 16,
                      is_error=error, attr=attr, name=name)


def test_json_path():
    doc = {"a": {"b": [{"c": 5}]}}
    for path, want in (("a.b.0.c", 5), ("a.missing", None), ("a.b.0.c.d", None), ("a.b.7", None)):
        assert tt._json_path(doc, path) == ref_tt._json_path(doc, path) == want


def test_select_and_assert():
    spans = [
        span("checkout", "PlaceOrder"),
        span("checkout", "orders publish"),
        span("payment", "Charge", error=True, attr="card"),
    ]
    assert len(tt._select(spans, {"service": "checkout"})) == 2
    assert len(tt._select(spans, {"service": "checkout", "name": "publish"})) == 1
    assert len(tt._select(spans, {"error": True})) == 1
    cases = [
        ({"metric": "count", "op": "eq", "value": 2}, tt._select(spans, {"service": "checkout"}), None, True),
        ({"metric": "error_count", "op": "eq", "value": 0}, tt._select(spans, {"service": "payment"}), None, False),
        ({"metric": "attr", "op": "eq", "value": "card"}, tt._select(spans, {"service": "payment"}), None, True),
        ({"json_path": "order.id", "op": "ne", "value": ""}, [], {"order": {"id": "x1"}}, True),
        ({"metric": "duration_us_max", "op": "lte", "value": 100.0}, spans, None, True),
        ({"metric": "duration_us_min", "op": "gt", "value": 100.0}, spans, None, False),
        ({"metric": "nope", "op": "eq", "value": 1}, spans, None, False),
    ]
    for assertion, selected, body, want in cases:
        got = tt._check_assertion(assertion, selected, body)
        assert got == ref_tt._check_assertion(assertion, selected, body)
        assert got[0] is want
    assert "unknown metric" in tt._check_assertion({"metric": "nope", "op": "eq", "value": 1}, spans, None)[1]


@pytest.mark.requires_env("protoc")
def test_all_suites_pass_against_live_gateway():
    suites = tt.load_suites(REPO / "tracetesting")
    assert suites == ref_tt.load_suites(REPO / "tracetesting")
    assert len(suites) == 11
    gw, client, stop = tt.make_rig(seed=5)
    try:
        results, code = tt.run_suites(client, suites, parallel=True)
    finally:
        stop()
    report = tt.format_results(results)
    assert code == 0, report
    assert len(results) == sum(len(t) for t in suites.values())
    assert type(gw).__module__ == "opentelemetry_demo_tpu_torch.services.gateway"
