"""Web storefront: server-rendered HTML shop (the Next.js tier analogue).

The reference's web tier is a Next.js storefront (~8,100 LoC,
the upstream demo's src/frontend/): SSR pages + 20 components
(ProductCard, ProductList, CartDropdown, CheckoutForm, Ad, …), a
session cookie, currency switcher, and Cypress e2e specs driving Home /
ProductDetail / Checkout journeys
(the upstream demo's src/frontend/cypress/e2e/*.cy.ts). This module renders
the same journeys server-side over the in-proc frontend API — product
grid with ads, product detail with recommendations, cart with checkout
form, order confirmation — with the session id held in a cookie and
every page view emitting the same API-call spans the reference's SSR
handlers do.

Mounted on the gateway at ``/`` (HTML lives beside the JSON ``/api/*``
routes, like Next.js pages beside ``pages/api``).
"""

from __future__ import annotations

import uuid
from html import escape

from .base import ServiceError
from .frontend import Frontend
from ..telemetry.tracer import TraceContext

SESSION_COOKIE = "shop_session"

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title} · Astronomy Shop (TPU)</title>
<style>
body{{font-family:system-ui,sans-serif;margin:0;background:#f6f6f8;color:#1a1a2e}}
header{{background:#0b1026;color:#fff;padding:12px 24px;display:flex;gap:24px;align-items:center}}
header a{{color:#9fc2ff;text-decoration:none}}
main{{max-width:960px;margin:24px auto;padding:0 16px}}
.grid{{display:grid;grid-template-columns:repeat(auto-fill,minmax(200px,1fr));gap:16px}}
.card{{background:#fff;border-radius:8px;padding:12px;box-shadow:0 1px 3px rgba(0,0,0,.12)}}
.card img{{width:100%;height:120px;object-fit:contain}}
.ad{{background:#fff6d6;border:1px solid #e8d48a;border-radius:8px;padding:8px 12px;margin:12px 0}}
.error{{background:#ffe3e3;border:1px solid #d88;border-radius:8px;padding:12px}}
button,input,select{{padding:6px 10px;margin:2px 0}}
table{{border-collapse:collapse;width:100%}}td,th{{padding:6px;border-bottom:1px solid #ddd;text-align:left}}
</style></head>
<body><header><a href="/">Astronomy Shop</a><a href="/cart">Cart ({cart_n})</a>
<span style="margin-left:auto;font-size:12px">session {session}</span></header>
<main>{body}</main></body></html>"""


def _money_str(m) -> str:
    return f"{m.currency} {m.units + m.nanos / 1e9:.2f}"


class WebStorefront:
    """HTML routes over the in-proc frontend (SSR-handler analogue)."""

    def __init__(self, frontend: Frontend):
        self.frontend = frontend

    # -- session ------------------------------------------------------

    def _session(self, cookies: dict[str, str]) -> tuple[str, bool]:
        sid = cookies.get(SESSION_COOKIE, "")
        if sid:
            return sid, False
        return str(uuid.uuid4()), True

    def _page(
        self, ctx, title: str, body: str, session_id: str, cart_n: int | None = None
    ) -> bytes:
        if cart_n is None:
            try:
                cart_n = sum(self.frontend.api_cart_get(ctx, session_id).values())
            except ServiceError:
                cart_n = 0  # cartFailure must not take the whole page down
        return _PAGE.format(
            title=escape(title),
            body=body,
            cart_n=cart_n,
            session=escape(session_id[:8]),
        ).encode()

    # -- dispatch ------------------------------------------------------

    def handle(
        self,
        method: str,
        route: str,
        query: dict[str, str],
        form: dict[str, str],
        cookies: dict[str, str],
        ctx: TraceContext,
    ):
        """Returns (status, content_type, body, extra_headers)."""
        session_id, fresh = self._session(cookies)
        ctx.baggage.setdefault("session.id", session_id)
        extra = (
            {"Set-Cookie": f"{SESSION_COOKIE}={session_id}; Path=/; HttpOnly"}
            if fresh
            else {}
        )
        currency = query.get("currency", "USD")
        cart_n = None  # /cart computes it itself; other pages fetch in _page
        try:
            if route == "/" and method == "GET":
                body = self._home(ctx, currency)
            elif route.startswith("/product/") and method == "GET":
                body = self._product(ctx, route.split("/product/", 1)[1], currency)
            elif route == "/cart" and method == "GET":
                body, cart_n = self._cart(ctx, session_id, currency)
            elif route == "/cart/add" and method == "POST":
                pid = form.get("productId", "")
                self.frontend.api_cart_add(ctx, session_id, pid, int(form.get("quantity", "1")))
                return 303, "text/html", b"", {**extra, "Location": "/cart"}
            elif route == "/cart/checkout" and method == "POST":
                body = self._checkout(ctx, session_id, form)
            else:
                return 404, "text/html", b"<h1>404</h1>", extra
        except ServiceError as err:
            body = (
                f'<div class="error"><h2>Something went wrong</h2>'
                f"<p>{escape(str(err))}</p><a href='/'>back to shop</a></div>"
            )
            return 500, "text/html", self._page(ctx, "Error", body, session_id), extra
        return (
            200, "text/html",
            self._page(ctx, "Shop", body, session_id, cart_n), extra,
        )

    # -- pages ---------------------------------------------------------

    def _home(self, ctx, currency: str) -> str:
        products = self.frontend.api_products(ctx)
        try:
            ads = self.frontend.api_ads(
                ctx,
                [p["categories"][0] for p in products[:3] if p.get("categories")],
            )
        except ServiceError:
            ads = []  # adFailure degrades the banner, never the page
        codes = self.frontend.api_currency(ctx)
        cur = escape(currency, quote=True)
        cur_opts = "".join(
            f'<option value="{escape(c, quote=True)}"'
            f'{" selected" if c == currency else ""}>{escape(c)}</option>'
            for c in codes
        )
        ad_html = (
            f'<div class="ad">Ad: {escape(ads[0])}</div>' if ads else ""
        )
        cards = "".join(
            f'<div class="card"><a href="/product/{escape(p["id"], quote=True)}'
            f'?currency={cur}">'
            f'<img src="/images/{escape(p["id"], quote=True)}.svg" alt="">'
            f'<h3>{escape(p["name"])}</h3></a>'
            f'<p>{escape(_price_str(p))}</p></div>'
            for p in products
        )
        return (
            f'<form method="GET" action="/">currency '
            f'<select name="currency" onchange="this.form.submit()">{cur_opts}</select></form>'
            f"{ad_html}<div class=\"grid\">{cards}</div>"
        )

    def _product(self, ctx, product_id: str, currency: str) -> str:
        p = self.frontend.api_product(ctx, product_id)
        recs = self.frontend.api_recommendations(ctx, [product_id])
        rec_html = "".join(
            f'<a class="card" href="/product/{escape(r, quote=True)}">{escape(r)}</a>'
            for r in recs[:4]
        )
        pid = escape(p["id"], quote=True)
        return (
            f'<div class="card"><img src="/images/{pid}.svg" style="max-width:300px">'
            f'<h2>{escape(p["name"])}</h2><p>{escape(p.get("description", ""))}</p>'
            f"<p><b>{escape(_price_str(p))}</b></p>"
            f'<form method="POST" action="/cart/add">'
            f'<input type="hidden" name="productId" value="{pid}">'
            f'<input type="number" name="quantity" value="1" min="1" max="10">'
            f"<button>Add to cart</button></form></div>"
            f"<h3>You may also like</h3><div class=\"grid\">{rec_html}</div>"
        )

    def _cart(self, ctx, session_id: str, currency: str) -> tuple[str, int]:
        """Returns (body, item count) — the count also feeds the header
        badge so the page renders with ONE GetCart call."""
        items = self.frontend.api_cart_get(ctx, session_id)
        if not items:
            return "<h2>Your cart is empty</h2><a href='/'>keep shopping</a>", 0
        rows = "".join(
            f"<tr><td><a href='/product/{escape(pid, quote=True)}'>"
            f"{escape(pid)}</a></td><td>{qty}</td></tr>"
            for pid, qty in items.items()
        )
        ship = self.frontend.api_shipping(ctx, sum(items.values()), currency)
        body = (
            f"<h2>Your cart</h2><table><tr><th>product</th><th>qty</th></tr>{rows}</table>"
            f"<p>shipping: {escape(_money_str(ship))}</p>"
            f'<form method="POST" action="/cart/checkout"><h3>Checkout</h3>'
            f'<input name="email" value="someone@example.com"> '
            f'<input name="currencyCode" value="{escape(currency, quote=True)}" size="4"> '
            f'<input name="cardNumber" value="4432801561520454" size="20">'
            f"<button>Place order</button></form>"
        )
        return body, sum(items.values())

    def _checkout(self, ctx, session_id: str, form: dict[str, str]) -> str:
        order = self.frontend.api_checkout(
            ctx,
            session_id,
            form.get("currencyCode", "USD"),
            form.get("email", "someone@example.com"),
        )
        return (
            f'<div class="card"><h2>Order placed 🎉</h2>'
            f"<p>order id: <b>{escape(order.order_id)}</b></p>"
            f"<p>tracking: {escape(order.tracking_id)}</p>"
            f"<p>total: {escape(_money_str(order.total))}</p>"
            f"<a href='/'>continue shopping</a></div>"
        )


def _price_str(p: dict) -> str:
    # Catalog serves priceUsd as a plain float (catalog.py product table).
    return f"USD {float(p.get('priceUsd', 0.0)):.2f}"
