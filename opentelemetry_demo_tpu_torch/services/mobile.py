"""Mobile shop client: the react-native-app analogue.

The reference ships a React Native storefront (~5,600 LoC,
the upstream demo's src/react-native-app/): tab screens
``app/(tabs)/{index,cart}.tsx``, an API gateway
(``gateways/Api.gateway.ts``) that calls the frontend's ``/api/*``
routes, a session gateway (``gateways/Session.gateway.ts``) minting a
per-install session id, and OTel JS client telemetry with a
``SessionIdProcessor`` stamping every span
(``utils/SessionIdProcessor.ts``). It is built beside the stack
(Makefile:284-285), not inside compose.

This module keeps that capability: a session-scoped client whose
"screens" issue the same API sequence the RN screens do, emitting
client-side spans (service ``react-native-app``) with the session id on
baggage — a second client class beside the load generator, usable
against the in-proc :class:`~.frontend.Frontend` or a live HTTP
gateway.
"""

from __future__ import annotations

import json
import urllib.request
import uuid
from dataclasses import dataclass

from .checkout import placed_order_json
from .frontend import Frontend
from ..telemetry.tracer import TraceContext, Tracer


@dataclass
class CheckoutForm:
    """The RN CheckoutForm's IFormData shape
    (src/react-native-app/components/CheckoutForm/CheckoutForm.tsx,
    consumed by cart.tsx onPlaceOrder): email + shipping address +
    credit card, defaults matching the form's prefilled demo values.
    The RN app hard-codes the currency to USD (cart.tsx comment)."""

    email: str = "someone@example.com"
    street_address: str = "1600 Amphitheatre Parkway"
    city: str = "Mountain View"
    state: str = "CA"
    country: str = "United States"
    zip_code: str = "94043"
    credit_card_number: str = "4432-8015-6152-0454"
    credit_card_cvv: str = "672"
    credit_card_expiration_month: int = 1
    credit_card_expiration_year: int = 2030
    currency: str = "USD"


class MobileSession:
    """Session gateway analogue: one id per app install/launch."""

    def __init__(self, session_id: str | None = None):
        self.session_id = session_id or str(uuid.uuid4())

    def new_context(self) -> TraceContext:
        """Every screen interaction starts a trace carrying the session
        id + synthetic marker on baggage (SessionIdProcessor behavior:
        the id rides every span/export)."""
        return TraceContext.new({
            "session.id": self.session_id,
            "synthetic_request": "true",
        })


class InProcTransport:
    """Api.gateway analogue over the in-proc frontend (test/sim path)."""

    def __init__(self, frontend: Frontend):
        self.frontend = frontend

    def products(self, ctx):
        return self.frontend.api_products(ctx)

    def product(self, ctx, product_id):
        return self.frontend.api_product(ctx, product_id)

    def recommendations(self, ctx, exclude):
        return self.frontend.api_recommendations(ctx, exclude)

    def cart_add(self, ctx, user_id, product_id, qty):
        self.frontend.api_cart_add(ctx, user_id, product_id, qty)

    def cart_get(self, ctx, user_id):
        items = self.frontend.api_cart_get(ctx, user_id)
        # Same wire shape the gateway's /api/cart returns.
        return [{"productId": p, "quantity": q} for p, q in items.items()]

    def cart_empty(self, ctx, user_id):
        self.frontend.api_cart_empty(ctx, user_id)

    def checkout(self, ctx, user_id, currency, email):
        order = self.frontend.api_checkout(ctx, user_id, currency, email)
        # One serializer with the gateway's /api/checkout route, so the
        # two transports cannot desynchronize.
        return placed_order_json(order)


class HttpTransport:
    """Api.gateway analogue over a live gateway (the RN app's real mode:
    fetch against the frontend's /api routes through the edge proxy)."""

    def __init__(self, base_url: str, timeout_s: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _call(self, ctx, method, path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base_url + path,
            data=data,
            method=method,
            headers={**ctx.to_headers(), "Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read() or b"null")

    def products(self, ctx):
        return self._call(ctx, "GET", "/api/products")["products"]

    def product(self, ctx, product_id):
        return self._call(ctx, "GET", f"/api/products/{product_id}")

    def recommendations(self, ctx, exclude):
        q = ",".join(exclude)
        return self._call(ctx, "GET", f"/api/recommendations?productIds={q}")["productIds"]

    def cart_add(self, ctx, user_id, product_id, qty):
        self._call(ctx, "POST", "/api/cart", {
            "userId": user_id, "item": {"productId": product_id, "quantity": qty},
        })

    def cart_get(self, ctx, user_id):
        return self._call(ctx, "GET", f"/api/cart?sessionId={user_id}")["items"]

    def cart_empty(self, ctx, user_id):
        self._call(ctx, "DELETE", f"/api/cart?sessionId={user_id}")

    def checkout(self, ctx, user_id, currency, email):
        return self._call(ctx, "POST", "/api/checkout", {
            "userId": user_id, "currencyCode": currency, "email": email,
        })


class MobileApp:
    """The RN app's screens as driveable flows.

    Client-side telemetry: each screen method emits one span under
    service ``react-native-app`` (the WebTracerProvider analogue —
    browser/app spans reaching the collector through the edge's
    /otlp-http route in the reference, FrontendTracer.ts:22-71).
    """

    SERVICE = "react-native-app"

    def __init__(
        self,
        transport,
        tracer: Tracer | None = None,
        session: MobileSession | None = None,
        email: str = "mobile.user@example.com",
    ):
        self.transport = transport
        self.tracer = tracer
        self.session = session or MobileSession()
        self.email = email
        self.orders: list[dict] = []

    # -- client span helper -------------------------------------------

    def _span(self, name: str, ctx: TraceContext, error: bool = False) -> None:
        if self.tracer is not None:
            # Client-side latency is negligible in sim; 100µs nominal.
            self.tracer.emit(self.SERVICE, name, ctx, 100.0, is_error=error)

    # -- screens ------------------------------------------------------

    def _screen(self, name: str, ctx: TraceContext, thunk):
        """Run one screen interaction; the client span records success
        or failure either way (error spans must be visible in the trace
        store for every screen, not just list/checkout)."""
        try:
            result = thunk()
        except Exception:
            self._span(name, ctx, error=True)
            raise
        self._span(name, ctx)
        return result

    def product_list_screen(self) -> list[dict]:
        """Tab ``index``: ProductList fetches all products."""
        ctx = self.session.new_context()
        return self._screen(
            "GET /api/products", ctx, lambda: self.transport.products(ctx)
        )

    def product_detail_screen(self, product_id: str) -> dict:
        """ProductCard tap: detail + recommendations."""
        ctx = self.session.new_context()

        def go():
            detail = self.transport.product(ctx, product_id)
            self.transport.recommendations(ctx, [product_id])
            return detail

        return self._screen("GET /api/products/{id}", ctx, go)

    def add_to_cart(self, product_id: str, qty: int = 1) -> None:
        ctx = self.session.new_context()
        self._screen(
            "POST /api/cart", ctx,
            lambda: self.transport.cart_add(
                ctx, self.session.session_id, product_id, qty
            ),
        )

    def cart_screen(self) -> dict:
        """Tab ``cart`` RENDERED (cart.tsx): the items resolved to full
        product rows (each row is a ProductCard over the cart item),
        the tab badge (total quantity), per-line and cart totals, and
        the EmptyCart state when nothing is held."""
        ctx = self.session.new_context()

        def go():
            items = self.transport.cart_get(ctx, self.session.session_id)
            rows = []
            for item in items:
                product = self.transport.product(ctx, item["productId"])
                price = float(product.get("priceUsd", 0.0))
                rows.append({
                    "productId": item["productId"],
                    "name": product.get("name"),
                    "priceUsd": price,
                    "quantity": item["quantity"],
                    "lineTotalUsd": round(price * item["quantity"], 2),
                })
            return {
                "empty": not rows,  # EmptyCart component state
                "badge": sum(r["quantity"] for r in rows),
                "rows": rows,
                "subtotalUsd": round(sum(r["lineTotalUsd"] for r in rows), 2),
            }

        return self._screen("GET /api/cart", ctx, go)

    def empty_cart(self) -> dict:
        """cart.tsx onEmptyCart: DELETE then a success toast."""
        ctx = self.session.new_context()
        self._screen(
            "DELETE /api/cart", ctx,
            lambda: self.transport.cart_empty(ctx, self.session.session_id),
        )
        return {"toast": "Your cart was emptied"}

    def checkout_flow(
        self, currency: str | None = None, form: CheckoutForm | None = None
    ) -> dict:
        """cart.tsx onPlaceOrder: submit the CheckoutForm, render the
        confirmation state (success toast + order fields + redirect
        home), mirroring the RN flow's Toast.show + router.replace."""
        form = form or CheckoutForm(email=self.email)
        ctx = self.session.new_context()
        order = self._screen(
            "POST /api/checkout", ctx,
            lambda: self.transport.checkout(
                ctx, self.session.session_id,
                currency or form.currency, form.email,
            ),
        )
        self.orders.append(order)
        total = order.get("total", {})
        return {
            "toast": "Your order is Complete!",
            "toastDetail": "We've sent you a confirmation email.",
            "orderId": order["orderId"],
            "shippingTrackingId": order["shippingTrackingId"],
            "itemCount": sum(
                line["item"]["quantity"] for line in order.get("items", [])
            ),
            "totalUsd": (
                float(total.get("units", 0)) + total.get("nanos", 0) / 1e9
            ),
            "currencyCode": total.get("currencyCode"),
            "order": order,
            "redirect": "/",  # router.replace("/") after the toast
        }

    # -- a full shopping journey (the RN demo's happy path) -----------

    def shopping_journey(self, rng, n_items: int = 2) -> dict:
        products = self.product_list_screen()
        ids = [p["id"] for p in products]
        for _ in range(n_items):
            pid = ids[int(rng.integers(0, len(ids)))]
            self.product_detail_screen(pid)
            self.add_to_cart(pid, int(rng.integers(1, 4)))
        self.cart_screen()
        confirmation = self.checkout_flow()
        return confirmation["order"]
