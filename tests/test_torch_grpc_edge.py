"""The port's gRPC edge against the reference's, over real sockets.

Each case of ``tests/test_grpc_edge.py`` runs against two edges at once,
a reference ``GrpcShopEdge`` and a port ``GrpcShopEdge`` over shops of
one seed (both tracers' trace ids from one seeded source, so order,
transaction and tracking ids agree). Every request is serialised once
with the reference's protoc stubs of ``proto/demo.proto`` (and of the
public ``grpc.health.v1`` and ``flagd.evaluation.v1`` protos), sent as
the same bytes to both edges, and the two answers must be the same
bytes, or the same status code and details; the reference case's
assertions then hold on the port's answer, decoded with the same stubs.
The concurrent-clients case runs on both edges and compares every
client's final cart; the h2c splice case runs through each package's
gateway.
"""

from __future__ import annotations

import importlib.util
import random
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

grpc = pytest.importorskip("grpc")

from opentelemetry_demo_tpu.services.gateway import ShopGateway as RefGateway  # noqa: E402
from opentelemetry_demo_tpu.services.grpc_edge import GrpcShopEdge as RefEdge  # noqa: E402
from opentelemetry_demo_tpu.services.shop import Shop as RefShop  # noqa: E402
from opentelemetry_demo_tpu.services.shop import ShopConfig as RefShopConfig  # noqa: E402
from opentelemetry_demo_tpu.telemetry import tracer as ref_tracer  # noqa: E402
from opentelemetry_demo_tpu_torch.runtime import structpb  # noqa: E402
from opentelemetry_demo_tpu_torch.services.gateway import ShopGateway  # noqa: E402
from opentelemetry_demo_tpu_torch.services.grpc_edge import GrpcShopEdge  # noqa: E402
from opentelemetry_demo_tpu_torch.services.shop import Shop, ShopConfig  # noqa: E402
from opentelemetry_demo_tpu_torch.telemetry import tracer as port_tracer  # noqa: E402
from tests.test_grpc_edge import FLAGD_PROTO, HEALTH_PROTO, _conv_req  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(
    shutil.which("protoc") is None or importlib.util.find_spec("google.protobuf") is None,
    reason="protoc / protobuf runtime unavailable",
)


class _SeededIds:
    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def token_bytes(self, n: int) -> bytes:
        return self._rng.randbytes(n)


def _protoc(out: Path, rel: str, module: str, cwd: Path):
    subprocess.run(["protoc", "--python_out", str(out), rel], check=True, cwd=cwd)
    sys.path.insert(0, str(out / "proto"))
    try:
        return importlib.import_module(module)
    finally:
        sys.path.remove(str(out / "proto"))
        sys.modules.pop(module, None)


@pytest.fixture(scope="module")
def pb2(tmp_path_factory):
    return _protoc(tmp_path_factory.mktemp("proto_gen_edge"), "proto/demo.proto", "demo_pb2", REPO)


def _proto_module(tmp_path_factory, name: str, text: str):
    out = tmp_path_factory.mktemp(f"{name}_gen")
    (out / "proto").mkdir()
    (out / "proto" / f"{name}.proto").write_text(text)
    return _protoc(out, f"proto/{name}.proto", f"{name}_pb2", out)


@pytest.fixture(scope="module")
def health_pb2(tmp_path_factory):
    return _proto_module(tmp_path_factory, "health", HEALTH_PROTO)


@pytest.fixture(scope="module")
def flagd_pb2(tmp_path_factory):
    return _proto_module(tmp_path_factory, "flagd", FLAGD_PROTO)


class _Failed(Exception):
    """Both edges answered with this status (and the same details)."""

    def __init__(self, code):
        super().__init__(code)
        self._code = code

    def code(self):
        return self._code


class EdgePair:
    """A reference and a port edge over shops of one seed."""

    def __init__(self, seed: int):
        self.ref = RefEdge(RefShop(RefShopConfig(users=0, seed=seed)), host="127.0.0.1", port=0)
        self.port = GrpcShopEdge(Shop(ShopConfig(users=0, seed=seed)), host="127.0.0.1", port=0)
        self.edges = (self.ref, self.port)
        for edge in self.edges:
            edge.start()
        self.channels = [grpc.insecure_channel(f"127.0.0.1:{e.port}") for e in self.edges]

    @property
    def shops(self):
        return (self.ref.shop, self.port.shop)

    def call(self, path: str, request: bytes) -> bytes:
        """The same request bytes to both edges: the same answer bytes,
        or the same status and details."""
        got = []
        for channel in self.channels:
            try:
                got.append(("ok", channel.unary_unary(path)(request, timeout=10)))
            except grpc.RpcError as e:
                got.append(("error", e.code(), e.details()))
        assert got[1] == got[0], path
        if got[1][0] == "error":
            raise _Failed(got[1][1])
        return got[1][1]

    def stub(self, service: str, method: str, resp_cls, package: str = "oteldemo"):
        path = f"/{package}.{service}/{method}"
        return lambda req, timeout=5: resp_cls.FromString(self.call(path, req.SerializeToString()))

    def stop(self) -> None:
        for channel in self.channels:
            channel.close()
        for edge in self.edges:
            edge.stop()


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_tracer, "secrets", _SeededIds(11))
        mp.setattr(port_tracer, "secrets", _SeededIds(11))
        p = EdgePair(seed=11)
        try:
            yield p
        finally:
            p.stop()


def test_catalog_surface(pair, pb2):
    resp = pair.stub("ProductCatalogService", "ListProducts", pb2.ListProductsResponse)(pb2.Empty())
    assert len(resp.products) >= 5
    first = resp.products[0]
    assert first.id and first.name
    assert first.price_usd.currency_code == "USD" and first.price_usd.units > 0
    p = pair.stub("ProductCatalogService", "GetProduct", pb2.Product)(pb2.GetProductRequest(id=first.id))
    assert p.id == first.id and p.picture.endswith(".svg")
    hits = pair.stub("ProductCatalogService", "SearchProducts", pb2.SearchProductsResponse)(
        pb2.SearchProductsRequest(query="telescope"))
    assert hits.results


def test_cart_round_trip(pair, pb2):
    add = pair.stub("CartService", "AddItem", pb2.Empty)
    get = pair.stub("CartService", "GetCart", pb2.Cart)
    empty = pair.stub("CartService", "EmptyCart", pb2.Empty)
    add(pb2.AddItemRequest(user_id="u1", item=pb2.CartItem(product_id="TEL-DOB-10", quantity=2)))
    cart = get(pb2.GetCartRequest(user_id="u1"))
    assert cart.user_id == "u1"
    assert [(i.product_id, i.quantity) for i in cart.items] == [("TEL-DOB-10", 2)]
    empty(pb2.EmptyCartRequest(user_id="u1"))
    assert not get(pb2.GetCartRequest(user_id="u1")).items


def test_currency_convert(pair, pb2):
    out = pair.stub("CurrencyService", "Convert", pb2.Money)(pb2.CurrencyConversionRequest(
        **{"from": pb2.Money(currency_code="USD", units=10)}, to_code="EUR"))
    assert out.currency_code == "EUR"
    assert 0 < out.units + out.nanos / 1e9 < 10.5
    codes = pair.stub("CurrencyService", "GetSupportedCurrencies", pb2.GetSupportedCurrenciesResponse)(
        pb2.Empty()).currency_codes
    assert "USD" in codes and "EUR" in codes


def test_currency_convert_negative_money(pair, pb2):
    out = pair.stub("CurrencyService", "Convert", pb2.Money)(pb2.CurrencyConversionRequest(
        **{"from": pb2.Money(currency_code="USD", units=-2, nanos=-500_000_000)}, to_code="USD"))
    assert out.units == -2 and out.nanos == -500_000_000


def test_shipping_and_payment(pair, pb2):
    q = pair.stub("ShippingService", "GetQuote", pb2.GetQuoteResponse)(pb2.GetQuoteRequest(items=[
        pb2.CartItem(product_id="X", quantity=2), pb2.CartItem(product_id="Y", quantity=1)]))
    assert q.cost_usd.units > 0
    assert len(pair.stub("ShippingService", "ShipOrder", pb2.ShipOrderResponse)(
        pb2.ShipOrderRequest()).tracking_id) == 36
    resp = pair.stub("PaymentService", "Charge", pb2.ChargeResponse)(pb2.ChargeRequest(
        amount=pb2.Money(currency_code="USD", units=30),
        credit_card=pb2.CreditCardInfo(credit_card_number="4432801561520454",
                                       credit_card_expiration_year=2030, credit_card_expiration_month=1)))
    assert resp.transaction_id


def test_place_order_full_path(pair, pb2):
    pair.stub("CartService", "AddItem", pb2.Empty)(pb2.AddItemRequest(
        user_id="buyer", item=pb2.CartItem(product_id="EYE-PLO-25", quantity=2)))
    resp = pair.stub("CheckoutService", "PlaceOrder", pb2.PlaceOrderResponse)(pb2.PlaceOrderRequest(
        user_id="buyer", user_currency="USD", email="b@example.com",
        credit_card=pb2.CreditCardInfo(credit_card_number="4432801561520454",
                                       credit_card_expiration_year=2030, credit_card_expiration_month=1)))
    assert resp.order.order_id
    assert len(resp.order.shipping_tracking_id) == 36
    assert [(i.item.product_id, i.item.quantity) for i in resp.order.items] == [("EYE-PLO-25", 2)]
    line = resp.order.items[0]
    price = pair.port.shop.catalog.price_of("EYE-PLO-25").to_float()
    line_cost = line.cost.units + line.cost.nanos / 1e9
    assert line_cost == pytest.approx(2 * price, abs=0.01)
    ship = resp.order.shipping_cost.units + resp.order.shipping_cost.nanos / 1e9
    assert 0 < ship < line_cost


def test_recommendations_and_ads(pair, pb2):
    out = pair.stub("RecommendationService", "ListRecommendations", pb2.ListRecommendationsResponse)(
        pb2.ListRecommendationsRequest(user_id="u", product_ids=["TEL-DOB-10"]))
    assert out.product_ids and "TEL-DOB-10" not in out.product_ids
    resp = pair.stub("AdService", "GetAds", pb2.AdResponse)(pb2.AdRequest(context_keys=["telescopes"]))
    assert resp.ads and all(a.text for a in resp.ads)


def test_email_confirmation(pair, pb2):
    pair.stub("EmailService", "SendOrderConfirmation", pb2.Empty)(pb2.SendOrderConfirmationRequest(
        email="a@b.c", order=pb2.OrderResult(order_id="o-1")))


def test_feature_flag_service(pair, pb2):
    create = pair.stub("FeatureFlagService", "CreateFlag", pb2.CreateFlagResponse)
    get = pair.stub("FeatureFlagService", "GetFlag", pb2.GetFlagResponse)
    update = pair.stub("FeatureFlagService", "UpdateFlag", pb2.UpdateFlagResponse)
    list_flags = pair.stub("FeatureFlagService", "ListFlags", pb2.ListFlagsResponse)
    delete = pair.stub("FeatureFlagService", "DeleteFlag", pb2.DeleteFlagResponse)
    resp = create(pb2.CreateFlagRequest(name="adFailure", description="break ads", enabled=True))
    assert resp.flag.name == "adFailure" and resp.flag.enabled
    assert all(shop.flags.evaluate("adFailure", False) is True for shop in pair.shops)
    update(pb2.UpdateFlagRequest(name="adFailure", enabled=False))
    assert not get(pb2.GetFlagRequest(name="adFailure")).flag.enabled
    assert all(shop.flags.evaluate("adFailure", True) is False for shop in pair.shops)
    assert "adFailure" in [fl.name for fl in list_flags(pb2.ListFlagsRequest()).flag]
    delete(pb2.DeleteFlagRequest(name="adFailure"))
    assert "adFailure" not in [fl.name for fl in list_flags(pb2.ListFlagsRequest()).flag]
    with pytest.raises(_Failed) as exc:
        get(pb2.GetFlagRequest(name="nope"))
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    for shop in pair.shops:
        shop.flags.replace({"flags": {"paymentFailure": {
            "state": "ENABLED", "variants": {"50%": 0.5, "100%": 1.0}, "defaultVariant": "100%"}}})
    update(pb2.UpdateFlagRequest(name="paymentFailure", enabled=False))
    assert all(shop.flags.evaluate("paymentFailure", 0.0) == 0.0 for shop in pair.shops)
    assert not get(pb2.GetFlagRequest(name="paymentFailure")).flag.enabled
    update(pb2.UpdateFlagRequest(name="paymentFailure", enabled=True))
    assert all(shop.flags.evaluate("paymentFailure", 0.0) == 1.0 for shop in pair.shops)


def test_service_error_is_internal_status(pair, pb2):
    with pytest.raises(_Failed) as exc:
        pair.stub("CheckoutService", "PlaceOrder", pb2.PlaceOrderResponse)(pb2.PlaceOrderRequest(
            user_id="nobody", user_currency="USD", email="x@y.z"))
    assert exc.value.code() == grpc.StatusCode.INTERNAL


def test_malformed_request_bytes_get_the_references_answer(pair, pb2):
    """Bytes no stub would send (a truncated varint, a wrong wire type,
    a garbage body): both edges answer alike."""
    for path in ("/oteldemo.CartService/GetCart", "/oteldemo.CurrencyService/Convert",
                 "/oteldemo.CheckoutService/PlaceOrder", "/oteldemo.ProductCatalogService/GetProduct"):
        for body in (b"\x0a\xff", b"\x08", b"\xff\xff\xff\xff", b"\x0d\x00\x00\x00\x00"):
            try:
                pair.call(path, body)
            except _Failed:
                pass


def test_structpb_codec_equals_the_references():
    from opentelemetry_demo_tpu.runtime import structpb as ref_structpb

    for value in ({"limit": 3, "mode": "slow"}, {"a": [1, "x", None, True, {"b": 2.5}]}, {}, {"n": -1e300}):
        enc = structpb.encode_struct(value)
        assert enc == ref_structpb.encode_struct(value)
        assert structpb.decode_struct(enc) == ref_structpb.decode_struct(enc)


def _health_call(pair, health_pb2, service: str):
    return health_pb2.HealthCheckResponse.FromString(pair.call(
        "/grpc.health.v1.Health/Check", health_pb2.HealthCheckRequest(service=service).SerializeToString()))


def test_health_check_round_trip(pair, health_pb2):
    assert _health_call(pair, health_pb2, "").status == health_pb2.HealthCheckResponse.SERVING
    assert _health_call(pair, health_pb2, "oteldemo.CartService").status == health_pb2.HealthCheckResponse.SERVING
    with pytest.raises(_Failed) as exc:
        _health_call(pair, health_pb2, "no.such.Service")
    assert exc.value.code() == grpc.StatusCode.NOT_FOUND


def _watch_statuses(edge_cls, shop, health_pb2) -> list:
    e = edge_cls(shop, host="127.0.0.1", port=0)
    e.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{e.port}")
    watch = channel.unary_stream(
        "/grpc.health.v1.Health/Watch",
        request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
        response_deserializer=health_pb2.HealthCheckResponse.FromString,
    )
    stream = watch(health_pb2.HealthCheckRequest(service=""), timeout=30)
    statuses = []

    def consume():
        try:
            for resp in stream:
                statuses.append(resp.status)
        except grpc.RpcError:
            pass

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    while not statuses and time.monotonic() < deadline:
        time.sleep(0.05)
    first = list(statuses)
    e.stop()
    t.join(timeout=5)
    channel.close()
    return first, statuses


def test_health_watch_streams_shutdown_transition(health_pb2):
    ref = _watch_statuses(RefEdge, RefShop(RefShopConfig(users=0, seed=12)), health_pb2)
    port = _watch_statuses(GrpcShopEdge, Shop(ShopConfig(users=0, seed=12)), health_pb2)
    assert port[0][:1] == ref[0][:1] == [health_pb2.HealthCheckResponse.SERVING]
    assert health_pb2.HealthCheckResponse.NOT_SERVING in port[1]
    assert set(port[1]) == set(ref[1])


def test_parallel_clients_across_services(pb2):
    """Six clients at once across read and write RPCs on each edge: no
    lost cart item, and every client's final cart the same bytes on both
    edges."""
    carts = []
    for edge_cls, shop in ((RefEdge, RefShop(RefShopConfig(users=0, seed=11))),
                           (GrpcShopEdge, Shop(ShopConfig(users=0, seed=11)))):
        edge = edge_cls(shop, host="127.0.0.1", port=0)
        edge.start()
        errors, final = [], {}

        def client(i: int) -> None:
            try:
                channel = grpc.insecure_channel(f"127.0.0.1:{edge.port}")
                call = lambda path, msg: channel.unary_unary(path)(msg.SerializeToString(), timeout=10)  # noqa: E731
                user = f"par-{i}"
                for _ in range(8):
                    call("/oteldemo.ProductCatalogService/ListProducts", pb2.Empty())
                    call("/oteldemo.CartService/AddItem", pb2.AddItemRequest(
                        user_id=user, item=pb2.CartItem(product_id="OLJCESPC7Z", quantity=1)))
                    call("/oteldemo.CurrencyService/Convert", _conv_req(pb2))
                raw = call("/oteldemo.CartService/GetCart", pb2.GetCartRequest(user_id=user))
                total = sum(item.quantity for item in pb2.Cart.FromString(raw).items)
                if total != 8:
                    errors.append(f"{user}: {total} != 8")
                final[user] = raw
                channel.close()
            except Exception as e:  # noqa: BLE001 — collected for the assert
                errors.append(f"client {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        edge.stop()
        assert not errors, errors
        carts.append(final)
    assert carts[1] == carts[0] and len(carts[1]) == 6


def test_flagd_typed_resolvers(pair, flagd_pb2):
    for shop in pair.shops:
        shop.set_flag("boolFlag", True)
        shop.set_flag("stringFlag", "blue")
        shop.set_flag("intFlag", 40)
        shop.set_flag("floatFlag", 0.25)
        shop.set_flag("objFlag", {"limit": 3, "mode": "slow"})

    def resolve(kind, key):
        req = getattr(flagd_pb2, f"Resolve{kind}Request")(flag_key=key)
        return pair.stub("Service", f"Resolve{kind}", getattr(flagd_pb2, f"Resolve{kind}Response"),
                         package="flagd.evaluation.v1")(req)

    resp = resolve("Boolean", "boolFlag")
    assert resp.value is True and resp.variant == "on" and resp.reason == "STATIC"
    assert resolve("String", "stringFlag").value == "blue"
    assert resolve("Int", "intFlag").value == 40
    assert resolve("Float", "floatFlag").value == 0.25
    from google.protobuf.json_format import MessageToDict

    assert MessageToDict(resolve("Object", "objFlag").value) == {"limit": 3.0, "mode": "slow"}


def test_flagd_error_contract(pair, flagd_pb2):
    rb = pair.stub("Service", "ResolveBoolean", flagd_pb2.ResolveBooleanResponse, package="flagd.evaluation.v1")
    with pytest.raises(_Failed) as exc:
        rb(flagd_pb2.ResolveBooleanRequest(flag_key="nope"))
    assert exc.value.code() == grpc.StatusCode.NOT_FOUND
    for shop in pair.shops:
        shop.set_flag("intFlag2", 7)
    with pytest.raises(_Failed) as exc:
        rb(flagd_pb2.ResolveBooleanRequest(flag_key="intFlag2"))
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def _event_types(edge, flagd_pb2, shop) -> list:
    channel = grpc.insecure_channel(f"127.0.0.1:{edge.port}")
    es = channel.unary_stream(
        "/flagd.evaluation.v1.Service/EventStream",
        request_serializer=flagd_pb2.EventStreamRequest.SerializeToString,
        response_deserializer=flagd_pb2.EventStreamResponse.FromString,
    )
    stream = es(flagd_pb2.EventStreamRequest(), timeout=30)
    events = []

    def consume():
        try:
            for ev in stream:
                events.append(ev.type)
                if "configuration_change" in events:
                    stream.cancel()
                    return
        except grpc.RpcError:
            pass

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    while "provider_ready" not in events and time.monotonic() < deadline:
        time.sleep(0.05)
    first = list(events)
    shop.set_flag("allBool", False, variants={"off": False})
    deadline = time.monotonic() + 5
    while "configuration_change" not in events and time.monotonic() < deadline:
        time.sleep(0.05)
    t.join(timeout=5)
    channel.close()
    return first, events


def test_flagd_resolve_all_and_event_stream(pair, flagd_pb2):
    for shop in pair.shops:
        shop.set_flag("allBool", True)
        shop.set_flag("allNum", 5)
    ra = pair.stub("Service", "ResolveAll", flagd_pb2.ResolveAllResponse, package="flagd.evaluation.v1")
    resp = ra(flagd_pb2.ResolveAllRequest())
    assert resp.flags["allBool"].bool_value is True
    assert resp.flags["allNum"].double_value == 5.0
    ref_first, ref_events = _event_types(pair.ref, flagd_pb2, pair.ref.shop)
    first, events = _event_types(pair.port, flagd_pb2, pair.port.shop)
    assert first[:1] == ref_first[:1] == ["provider_ready"]
    assert "configuration_change" in events and "configuration_change" in ref_events
    resp2 = ra(flagd_pb2.ResolveAllRequest())
    assert resp2.flags["allBool"].WhichOneof("value") == "bool_value"
    assert resp2.flags["allBool"].bool_value is False


def test_grpc_through_http_edge_h2c_splice(flagd_pb2, pb2):
    import urllib.request

    answers = []
    for gw_cls, edge_cls, shop in ((RefGateway, RefEdge, RefShop(RefShopConfig(users=0, seed=13))),
                                   (ShopGateway, GrpcShopEdge, Shop(ShopConfig(users=0, seed=13)))):
        gw = gw_cls(shop, host="127.0.0.1", port=0)
        e = edge_cls(shop, host="127.0.0.1", port=0, lock=gw._lock)
        gw.grpc_target = ("127.0.0.1", e.port)
        gw.start()
        e.start()
        try:
            shop.set_flag("edgeFlag", True)
            channel = grpc.insecure_channel(f"127.0.0.1:{gw.port}")
            rb = channel.unary_unary("/flagd.evaluation.v1.Service/ResolveBoolean")
            flag = rb(flagd_pb2.ResolveBooleanRequest(flag_key="edgeFlag").SerializeToString(), timeout=10)
            lp = channel.unary_unary("/oteldemo.ProductCatalogService/ListProducts")
            listed = lp(pb2.Empty().SerializeToString(), timeout=10)
            channel.close()
            with urllib.request.urlopen(f"http://127.0.0.1:{gw.port}/api/products", timeout=10) as r:
                assert r.status == 200
        finally:
            e.stop()
            gw.stop()
        answers.append((flag, listed))
    assert answers[1] == answers[0]
    assert flagd_pb2.ResolveBooleanResponse.FromString(answers[1][0]).value is True
    assert len(pb2.ListProductsResponse.FromString(answers[1][1]).products) >= 5
