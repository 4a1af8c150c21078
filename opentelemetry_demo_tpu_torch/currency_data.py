"""The currency rate table — a leaf module with no imports.

Lives at the package root so any layer can import it without a cycle:
``runtime.kafka_orders`` and ``runtime.native`` normalise the detector's
order-value lane to USD with it, on the per-message path and in the
native decoder's rate table.

The same EUR-based table, value for value, as the JAX package's
``currency_data``: the two packages must put the same order value in
the latency lane.
"""

from __future__ import annotations

# EUR = 1.0; value = units of the currency per EUR.
EUR_RATES = {
    "EUR": 1.0,
    "USD": 1.09,
    "JPY": 171.5,
    "GBP": 0.853,
    "TRY": 35.1,
    "CAD": 1.47,
    "AUD": 1.65,
    "CHF": 0.955,
    "CNY": 7.83,
    "SEK": 11.4,
    "NZD": 1.78,
    "MXN": 18.6,
    "SGD": 1.46,
    "HKD": 8.52,
    "NOK": 11.7,
    "KRW": 1486.0,
    "INR": 91.2,
    "BRL": 6.05,
    "ZAR": 19.9,
    "DKK": 7.46,
    "PLN": 4.31,
    "THB": 38.2,
    "ILS": 4.02,
    "CZK": 25.2,
    "ISK": 150.9,
    "RON": 4.97,
    "HUF": 392.0,
    "PHP": 63.6,
    "MYR": 4.86,
    "BGN": 1.96,
    "IDR": 17650.0,
}


def to_usd_factor(code: str) -> float:
    """Multiplier taking an amount in ``code`` to USD.

    Unknown currencies pass through at 1.0 — for the detector's value
    lane an unrecognised code is better fed as-is than dropped (the
    anomaly, if any, still registers; the scale may be off for that
    producer, which is exactly the reference behaviour of a consumer
    with a stale rate table).
    """
    rate = EUR_RATES.get(code)
    if not rate:
        return 1.0
    return EUR_RATES["USD"] / rate
