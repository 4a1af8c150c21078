"""The Astronomy Shop capability layer, in-process.

Behavioural re-implementations of the reference's business services
(SURVEY.md §2.1) as one-process Python components wired by
:class:`~.shop.Shop` — the docker-compose analogue — emitting spans
through ``telemetry.Tracer`` into the anomaly-detector pipeline. Each
module's docstring cites the upstream service whose observable
behaviour it mirrors (APIs, failure flags, latency profiles).

Failure injection parity (SURVEY.md §5): every reference flagd flag has
an equivalent here and flips real behaviour the detector must catch.

The shop stays on the host; the detector it feeds runs on the card
(``DetectorPipeline`` on ``cuda`` unless a caller names the CPU). Its
edges are here too: the HTTP gateway (``ShopGateway``, with the web UI
and the mobile API), the gRPC edge and the HTTP load driver.
"""

from .gateway import ShopGateway
from .shop import Shop, ShopConfig

__all__ = ["Shop", "ShopConfig", "ShopGateway"]
