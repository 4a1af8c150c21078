"""gRPC edge: the reference's 9-service gRPC surface over the shop.

The reference's business services ARE gRPC servers (pb/demo.proto
services; e.g. checkout serves CheckoutService, cart CartService). This
framework's services are in-proc objects behind the HTTP gateway; the
gRPC edge exposes the same wire surface — method paths
``/oteldemo.<Service>/<Method>`` with the reference's field numbers
(proto/demo.proto) — so a client built against the reference's stubs
talks to this shop unchanged.

Transport is grpcio generic raw-bytes handlers (the ``otlp_grpc``
pattern): requests decode by field number through the wire scanner,
responses encode with the wire helpers — no generated stubs anywhere in
the runtime. Interop with REAL protoc stubs is pinned by
tests/test_torch_grpc_edge.py (the same bytes as the JAX package's edge).

Concurrency: mutating RPCs take the shop lock exclusively (the graph is
single-writer by design — the HTTP gateway serializes the same way),
but read-only RPCs (:data:`READ_METHODS`) run CONCURRENTLY under the
shared side of a :class:`~..utils.concurrency.RWLock` — a product-
catalog fan-out no longer queues behind a PlaceOrder. The health
service (``grpc.health.v1``, the registration every reference service
performs — the upstream demo's src/checkout/main.go:223-224,
src/currency/src/server.cpp:92-102) answers entirely outside the lock.
"""

from __future__ import annotations

import functools
import struct as _struct
import threading

from ..runtime import structpb, wire
from ..runtime.kafka_orders import encode_placed_order
from ..telemetry.tracer import TraceContext
from ..utils.concurrency import RWLock
from .base import ServiceError
from .money import Money

PKG = "oteldemo"
FLAGD_PKG = "flagd.evaluation.v1"

# RPCs with no shop-graph writes: safe under the shared lock. Span
# emission, metrics, and rng draws inside them are individually
# thread-safe (atomic list append / MetricRegistry mutex / LockedRng).
READ_METHODS = frozenset({
    f"/{PKG}.CartService/GetCart",
    f"/{PKG}.RecommendationService/ListRecommendations",
    f"/{PKG}.ProductCatalogService/ListProducts",
    f"/{PKG}.ProductCatalogService/GetProduct",
    f"/{PKG}.ProductCatalogService/SearchProducts",
    f"/{PKG}.ShippingService/GetQuote",
    f"/{PKG}.CurrencyService/GetSupportedCurrencies",
    f"/{PKG}.CurrencyService/Convert",
    f"/{PKG}.AdService/GetAds",
    f"/{PKG}.FeatureFlagService/GetFlag",
    f"/{PKG}.FeatureFlagService/ListFlags",
    f"/{FLAGD_PKG}.Service/ResolveBoolean",
    f"/{FLAGD_PKG}.Service/ResolveString",
    f"/{FLAGD_PKG}.Service/ResolveFloat",
    f"/{FLAGD_PKG}.Service/ResolveInt",
    f"/{FLAGD_PKG}.Service/ResolveObject",
    f"/{FLAGD_PKG}.Service/ResolveAll",
})



# -- message codecs (field numbers = proto/demo.proto) ------------------


def _enc_money(m: Money) -> bytes:
    out = wire.encode_len(1, m.currency.encode())
    if m.units:
        out += wire.encode_int(2, m.units)
    if m.nanos:
        out += wire.encode_int(3, m.nanos)
    return out


def _dec_money(buf: bytes) -> Money:
    f = wire.scan_fields(buf)
    code = wire.first(f, 1, b"USD")
    # int64/int32 varints need sign extension — a negative Money (a
    # refund) arrives as 64-bit two's complement on the wire.
    return Money(
        code.decode() if isinstance(code, bytes) else "USD",
        wire.to_int64(int(wire.first(f, 2, 0) or 0)),
        wire.to_int64(int(wire.first(f, 3, 0) or 0)),
    )


def _dec_str(fields: dict, n: int, default: str = "") -> str:
    raw = wire.first(fields, n, None)
    return raw.decode("utf-8", "replace") if isinstance(raw, bytes) else default


def _enc_cart_item(product_id: str, qty: int) -> bytes:
    return wire.encode_len(1, product_id.encode()) + wire.encode_int(2, qty)


def _enc_product(p: dict) -> bytes:
    out = wire.encode_len(1, p["id"].encode())
    out += wire.encode_len(2, p.get("name", "").encode())
    if p.get("description"):
        out += wire.encode_len(3, p["description"].encode())
    out += wire.encode_len(4, f"/images/{p['id']}.svg".encode())
    out += wire.encode_len(5, _enc_money(Money.from_float("USD", p["priceUsd"])))
    for cat in p.get("categories", []):
        out += wire.encode_len(6, cat.encode())
    return out


class GrpcShopEdge:
    """Serves the oteldemo gRPC surface; delegates into a Shop."""

    def __init__(self, shop, host: str = "0.0.0.0", port: int = 0,
                 lock: threading.Lock | RWLock | None = None,
                 max_workers: int = 8):
        import grpc
        from concurrent import futures

        self.shop = shop
        # An RWLock (default, and what the gateway shares) runs read
        # RPCs concurrently; a plain Lock (legacy callers) degrades to
        # exclusive-for-everything.
        self._lock = lock if lock is not None else RWLock()
        self._shared = getattr(self._lock, "shared", None)
        self._stop_event = threading.Event()
        edge = self

        handlers = {
            f"/{PKG}.CartService/AddItem": self._add_item,
            f"/{PKG}.CartService/GetCart": self._get_cart,
            f"/{PKG}.CartService/EmptyCart": self._empty_cart,
            f"/{PKG}.RecommendationService/ListRecommendations":
                self._list_recommendations,
            f"/{PKG}.ProductCatalogService/ListProducts": self._list_products,
            f"/{PKG}.ProductCatalogService/GetProduct": self._get_product,
            f"/{PKG}.ProductCatalogService/SearchProducts": self._search_products,
            f"/{PKG}.ShippingService/GetQuote": self._get_quote,
            f"/{PKG}.ShippingService/ShipOrder": self._ship_order,
            f"/{PKG}.CurrencyService/GetSupportedCurrencies":
                self._supported_currencies,
            f"/{PKG}.CurrencyService/Convert": self._convert,
            f"/{PKG}.PaymentService/Charge": self._charge,
            f"/{PKG}.EmailService/SendOrderConfirmation": self._send_confirmation,
            f"/{PKG}.CheckoutService/PlaceOrder": self._place_order,
            f"/{PKG}.AdService/GetAds": self._get_ads,
            f"/{PKG}.FeatureFlagService/GetFlag": self._get_flag,
            f"/{PKG}.FeatureFlagService/CreateFlag": self._create_flag,
            f"/{PKG}.FeatureFlagService/UpdateFlag": self._update_flag,
            f"/{PKG}.FeatureFlagService/ListFlags": self._list_flags,
            f"/{PKG}.FeatureFlagService/DeleteFlag": self._delete_flag,
            # flagd's own gRPC evaluation protocol (the :8013 surface
            # every OpenFeature flagd provider dials — schemas.flagd.dev;
            # SURVEY §1 "flagd gRPC :8013"). Typed resolvers + ResolveAll;
            # EventStream is registered as a streaming method below.
            f"/{FLAGD_PKG}.Service/ResolveBoolean":
                functools.partial(self._resolve_typed, bool),
            f"/{FLAGD_PKG}.Service/ResolveString":
                functools.partial(self._resolve_typed, str),
            f"/{FLAGD_PKG}.Service/ResolveFloat":
                functools.partial(self._resolve_typed, float),
            f"/{FLAGD_PKG}.Service/ResolveInt":
                functools.partial(self._resolve_typed, int),
            f"/{FLAGD_PKG}.Service/ResolveObject":
                functools.partial(self._resolve_typed, dict),
            f"/{FLAGD_PKG}.Service/ResolveAll": self._resolve_all,
        }

        # grpc.health.v1 (shared implementation, runtime.grpc_health):
        # answers for the oteldemo services plus "" (overall server
        # health, the probe every reference healthcheck queries).
        from ..runtime.grpc_health import HealthService

        self._health = HealthService(
            {m.split("/")[1] for m in handlers},
            self._stop_event,
            watcher_slots=2,
        )

        # flagd EventStream watchers share the health-watch thread
        # budget rationale: slot-bounded so parked streams can't starve
        # the executor pool.
        self._event_watchers = threading.Semaphore(2)

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                health = edge._health.add_to_generic_handlers(
                    grpc, details.method
                )
                if health is not None:
                    return health
                if details.method == f"/{FLAGD_PKG}.Service/EventStream":
                    return grpc.unary_stream_rpc_method_handler(
                        edge._event_stream_rpc,
                        request_deserializer=None, response_serializer=None,
                    )
                fn = handlers.get(details.method)
                if fn is None:
                    return None
                read_only = details.method in READ_METHODS
                is_flagd = details.method.startswith(f"/{FLAGD_PKG}.")

                def call(request: bytes, context) -> bytes:
                    # W3C context rides gRPC metadata (every reference
                    # SDK propagates traceparent/baggage this way);
                    # from_headers handles absence (fresh trace id) and
                    # parses baggage either way.
                    meta = {
                        k: v for k, v in (context.invocation_metadata() or [])
                        if isinstance(v, str)
                    }
                    ctx = TraceContext.from_headers(meta)
                    try:
                        if read_only and edge._shared is not None:
                            with edge._shared():
                                return fn(ctx, request)
                        with edge._lock:
                            return fn(ctx, request)
                    except ServiceError as e:
                        context.abort(grpc.StatusCode.INTERNAL, str(e))
                    except KeyError as e:
                        if not is_flagd:
                            # A KeyError in a business handler is a
                            # server bug, not a missing flag — let the
                            # framework surface INTERNAL, never a
                            # plausible-looking NOT_FOUND.
                            raise
                        # flagd contract: unknown/disabled flag =
                        # FLAG_NOT_FOUND → gRPC NOT_FOUND.
                        context.abort(
                            grpc.StatusCode.NOT_FOUND,
                            f"flag not found: {e.args[0] if e.args else e}",
                        )
                    except (wire.WireError, ValueError) as e:
                        context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

                return grpc.unary_unary_rpc_method_handler(
                    call, request_deserializer=None, response_serializer=None
                )

        self._server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=max_workers, thread_name_prefix="grpc-edge"
            )
        )
        self._server.add_generic_rpc_handlers((Handler(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            raise OSError(f"gRPC edge failed to bind {host}:{port}")

    def start(self) -> None:
        self._server.start()

    def stop(self, grace: float = 1.0) -> None:
        # Flip health to NOT_SERVING first so Watch streams deliver the
        # transition before the server tears down (the drain order
        # health-gated load balancers rely on).
        self._stop_event.set()
        self._server.stop(grace).wait()

    # -- cart ----------------------------------------------------------

    def _add_item(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        user_id = _dec_str(f, 1)
        item = wire.scan_fields(wire.first(f, 2, b"") or b"")
        self.shop.cart.add_item(
            ctx, user_id, _dec_str(item, 1), int(wire.first(item, 2, 1) or 1)
        )
        return b""

    def _get_cart(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        user_id = _dec_str(f, 1)
        items = self.shop.cart.get_cart(ctx, user_id)
        out = wire.encode_len(1, user_id.encode())
        for pid, qty in items.items():
            out += wire.encode_len(2, _enc_cart_item(pid, qty))
        return out

    def _empty_cart(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        self.shop.cart.empty_cart(ctx, _dec_str(f, 1))
        return b""

    # -- recommendation / catalog --------------------------------------

    def _list_recommendations(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        exclude = [b.decode("utf-8", "replace") for b in f.get(2, [])]
        recs = self.shop.recommendation.list_recommendations(ctx, exclude)
        return b"".join(wire.encode_len(1, r.encode()) for r in recs)

    def _list_products(self, ctx, request: bytes) -> bytes:
        products = self.shop.catalog.list_products(ctx)
        return b"".join(
            wire.encode_len(1, _enc_product(p)) for p in products
        )

    def _get_product(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        return _enc_product(self.shop.catalog.get_product(ctx, _dec_str(f, 1)))

    def _search_products(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        hits = self.shop.catalog.search_products(ctx, _dec_str(f, 1))
        return b"".join(wire.encode_len(1, _enc_product(p)) for p in hits)

    # -- shipping ------------------------------------------------------

    @staticmethod
    def _item_count(f: dict) -> int:
        count = 0
        for item_buf in f.get(2, []):
            item = wire.scan_fields(item_buf)
            count += int(wire.first(item, 2, 1) or 1)
        return count

    def _get_quote(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        cost = self.shop.shipping.get_quote(ctx, self._item_count(f))
        return wire.encode_len(1, _enc_money(cost))

    def _ship_order(self, ctx, request: bytes) -> bytes:
        tracking = self.shop.shipping.ship_order(ctx)
        return wire.encode_len(1, tracking.encode())

    # -- currency / payment --------------------------------------------

    def _supported_currencies(self, ctx, request: bytes) -> bytes:
        codes = self.shop.currency.supported_currencies(ctx)
        return b"".join(wire.encode_len(1, c.encode()) for c in codes)

    def _convert(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        money = _dec_money(wire.first(f, 1, b"") or b"")
        converted = self.shop.currency.convert(ctx, money, _dec_str(f, 2))
        return _enc_money(converted)

    def _charge(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        amount = _dec_money(wire.first(f, 1, b"") or b"")
        card = wire.scan_fields(wire.first(f, 2, b"") or b"")
        txid = self.shop.payment.charge(
            ctx,
            amount,
            _dec_str(card, 1),
            int(wire.first(card, 3, 2030) or 2030),
            int(wire.first(card, 4, 1) or 1),
        )
        return wire.encode_len(1, txid.encode())

    # -- email / checkout / ad -----------------------------------------

    def _send_confirmation(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        order = wire.scan_fields(wire.first(f, 2, b"") or b"")
        self.shop.email.send_order_confirmation(
            ctx, _dec_str(f, 1), _dec_str(order, 1)
        )
        return b""

    def _place_order(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        card = wire.scan_fields(wire.first(f, 6, b"") or b"")
        kwargs = {}
        if _dec_str(card, 1):
            kwargs = {
                "card_number": _dec_str(card, 1),
                "expiry_year": int(wire.first(card, 3, 2030) or 2030),
                "expiry_month": int(wire.first(card, 4, 1) or 1),
            }
        placed = self.shop.checkout.place_order(
            ctx,
            _dec_str(f, 1),
            _dec_str(f, 2, "USD"),
            _dec_str(f, 5),
            **kwargs,
        )
        # OrderResult field 3 is shipping_cost (proto/demo.proto:202),
        # NOT the grand total — marshalled by the SAME helper checkout's
        # Kafka publish uses, so the two transports cannot diverge.
        return wire.encode_len(1, encode_placed_order(placed))

    def _get_ads(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        keys = [b.decode("utf-8", "replace") for b in f.get(1, [])]
        ads = self.shop.ad.get_ads(ctx, keys)
        out = b""
        for ad_text in ads:
            ad = wire.encode_len(1, b"/") + wire.encode_len(2, ad_text.encode())
            out += wire.encode_len(1, ad)
        return out

    # -- feature flags (the flagd-analogue store over gRPC) ------------
    #
    # The wire Flag{name, description, enabled} projects onto the flagd
    # document: enabled = state ENABLED with a truthy defaultVariant;
    # Create/Update write boolean on/off flags (richer variants stay
    # editable through the flag-editor UI, which shares the store).

    def _flags_copy(self) -> dict:
        """Copy-for-write via the store's public snapshot API; the edge
        lock serialises mutation (snapshot → edit → replace)."""
        doc = self.shop.flags.snapshot()
        doc.setdefault("flags", {})
        return doc

    def _enc_flag(self, name: str, spec: dict) -> bytes:
        enabled = (
            spec.get("state", "ENABLED") == "ENABLED"
            and bool(spec.get("variants", {}).get(spec.get("defaultVariant")))
        )
        out = wire.encode_len(1, name.encode())
        desc = spec.get("description", "")
        if desc:
            out += wire.encode_len(2, desc.encode())
        if enabled:
            out += wire.encode_int(3, 1)
        return out

    def _get_flag(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        name = _dec_str(f, 1)
        spec = self.shop.flags.flag_spec(name)  # read-only live view
        if spec is None:
            raise ValueError(f"no such flag {name!r}")
        return wire.encode_len(1, self._enc_flag(name, spec))

    def _create_flag(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        name = _dec_str(f, 1)
        enabled = bool(wire.first(f, 3, 0) or 0)
        doc = self._flags_copy()
        doc["flags"][name] = {
            "state": "ENABLED",
            "description": _dec_str(f, 2),
            "variants": {"on": True, "off": False},
            "defaultVariant": "on" if enabled else "off",
        }
        self.shop.flags.replace(doc)
        return wire.encode_len(
            1, self._enc_flag(name, doc["flags"][name])
        )

    def _update_flag(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        name = _dec_str(f, 1)
        enabled = bool(wire.first(f, 2, 0) or 0)
        doc = self._flags_copy()
        spec = doc["flags"].get(name)
        if spec is None:
            raise ValueError(f"no such flag {name!r}")
        if not enabled:
            # Prefer flipping to a falsy variant (the flag then
            # evaluates False for every caller); a variants map with no
            # falsy member (percentage flags) disables via state, and a
            # DISABLED flag evaluates to the caller's default.
            variants = spec.get("variants", {})
            off = next((k for k, v in variants.items() if not v), None)
            if off is not None:
                spec["state"] = "ENABLED"
                spec["defaultVariant"] = off
            else:
                spec["state"] = "DISABLED"
        else:
            spec["state"] = "ENABLED"
            variants = dict(spec.get("variants", {}))
            if not variants.get(spec.get("defaultVariant")):
                on = next(
                    (k for k, v in variants.items() if v), None
                )
                if on is None:
                    variants["on"] = True
                    spec["variants"] = variants
                    on = "on"
                spec["defaultVariant"] = on
        self.shop.flags.replace(doc)
        return b""

    def _list_flags(self, ctx, request: bytes) -> bytes:
        flags = self.shop.flags.flag_specs()  # read-only live view
        return b"".join(
            wire.encode_len(1, self._enc_flag(name, spec))
            for name, spec in sorted(flags.items())
        )

    def _delete_flag(self, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        name = _dec_str(f, 1)
        doc = self._flags_copy()
        doc["flags"].pop(name, None)
        self.shop.flags.replace(doc)
        return b""

    # -- flagd.evaluation.v1 (the :8013 protocol, schemas.flagd.dev) ----
    #
    # Request: {flag_key=1, context=2 Struct}; response: {value=1 typed,
    # reason=2, variant=3}. targetingKey comes from the evaluation
    # context Struct (falling back to session.id baggage, the key the
    # demo's fractional flags bucket on). Unknown/disabled flags raise
    # KeyError → NOT_FOUND (flagd's FLAG_NOT_FOUND); a value of the
    # wrong type raises ValueError → INVALID_ARGUMENT (TYPE_MISMATCH).

    def _resolve_typed(self, want: type, ctx, request: bytes) -> bytes:
        f = wire.scan_fields(request)
        key = _dec_str(f, 1)
        raw_ctx = wire.first(f, 2, b"")
        ectx = structpb.decode_struct(raw_ctx) if isinstance(raw_ctx, bytes) else {}
        targeting = str(
            ectx.get("targetingKey") or ctx.baggage.get("session.id", "")
        )
        value, variant, reason = self.shop.flags.resolve(key, targeting)
        out = self._enc_resolved_value(want, key, value)
        out += wire.encode_len(2, reason.encode())
        out += wire.encode_len(3, variant.encode())
        return out

    @staticmethod
    def _enc_resolved_value(want: type, key: str, value) -> bytes:
        def mismatch():
            return ValueError(
                f"flag {key!r}: variant value {value!r} is not "
                f"{want.__name__} (TYPE_MISMATCH)"
            )

        if want is bool:
            if not isinstance(value, bool):
                raise mismatch()
            return wire.encode_int(1, 1) if value else b""  # proto3 default
        if want is str:
            if not isinstance(value, str):
                raise mismatch()
            return wire.encode_len(1, value.encode())
        if want is int:
            if isinstance(value, bool) or not isinstance(value, int):
                raise mismatch()
            return wire.encode_int(1, value) if value else b""
        if want is float:
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                raise mismatch()
            v = float(value)
            # Plain (non-oneof) field: +0.0 is the proto3 default and
            # is omitted; -0.0 has nonzero bits and must be emitted.
            if _struct.pack("<d", v) == bytes(8):
                return b""
            return wire.encode_double(1, v)
        # object: Struct value
        if not isinstance(value, dict):
            raise mismatch()
        return wire.encode_len(1, structpb.encode_struct(value))

    def _resolve_all(self, ctx, request: bytes) -> bytes:
        """ResolveAll: every enabled flag as an AnyFlag{reason=1,
        variant=2, bool=3|string=4|double=5|object=6} map entry (the
        flagd schema has no int lane — numbers ride the double, exactly
        like flagd itself)."""
        f = wire.scan_fields(request)
        raw_ctx = wire.first(f, 1, b"")
        ectx = structpb.decode_struct(raw_ctx) if isinstance(raw_ctx, bytes) else {}
        targeting = str(
            ectx.get("targetingKey") or ctx.baggage.get("session.id", "")
        )
        out = b""
        for key in sorted(self.shop.flags.flag_keys()):
            try:
                value, variant, reason = self.shop.flags.resolve(key, targeting)
            except KeyError:
                continue  # DISABLED flags are omitted, like flagd
            af = wire.encode_len(1, reason.encode())
            af += wire.encode_len(2, variant.encode())
            # The value lanes live in a proto3 ONEOF: presence is
            # tracked, so the chosen lane is serialized even at its
            # default (False/0.0/"") — an off-state flag must not
            # vanish from WhichOneof("value").
            if isinstance(value, bool):
                af += wire.encode_int(3, 1 if value else 0)
            elif isinstance(value, str):
                af += wire.encode_len(4, value.encode())
            elif isinstance(value, (int, float)):
                af += wire.encode_double(5, float(value))
            elif isinstance(value, dict):
                af += wire.encode_len(6, structpb.encode_struct(value))
            else:
                continue  # unmappable variant value: skip the flag
            entry = wire.encode_len(1, key.encode()) + wire.encode_len(2, af)
            out += wire.encode_len(1, entry)
        return out

    def _event_stream_rpc(self, request: bytes, context):
        """flagd EventStream: provider_ready immediately, then a
        configuration_change event per flag-store version bump (the
        push channel OpenFeature providers re-evaluate on). Slot-
        bounded like health Watch — an over-budget watcher gets
        provider_ready and the stream ends (providers reconnect)."""
        del request
        yield self._enc_event("provider_ready", {})
        if not self._event_watchers.acquire(blocking=False):
            return
        try:
            last = self.shop.flags.poll_version()
            while context.is_active() and not self._stop_event.wait(0.2):
                version = self.shop.flags.poll_version()
                if version != last:
                    last = version
                    yield self._enc_event("configuration_change", {})
        finally:
            self._event_watchers.release()

    @staticmethod
    def _enc_event(event_type: str, data: dict) -> bytes:
        out = wire.encode_len(1, event_type.encode())
        if data:
            out += wire.encode_len(2, structpb.encode_struct(data))
        return out
