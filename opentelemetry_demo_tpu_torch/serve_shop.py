"""Serve the standalone shop stack with the detector on the card.

One process is the upstream demo's ``docker compose up`` for this
package: the HTTP gateway at :8080 (the Envoy routes: /api/*, /images/*,
/feature flag editor, /jaeger, /grafana, /loadgen, /otlp-http ingest,
/metrics), the in-process telemetry backend (collector → trace, metric
and log stores), and the anomaly-detector pipeline subscribed to the
span stream, on ``cuda`` unless ``--device`` names another device. With
``--otlp-endpoint`` the detector runs in its own process instead (the
compose topology) and this process exports the three signals to it;
``--load-only`` drives a remote gateway the way the upstream demo's
load-generator container drives Envoy.

Examples:
    python -m opentelemetry_demo_tpu_torch.serve_shop --port 8080 --users 5
    python -m opentelemetry_demo_tpu_torch.serve_shop --device cpu --port 0
    python -m opentelemetry_demo_tpu_torch.serve_shop --load-only --target http://host:8080

In process, :func:`build` returns the running stack (gateway, pipeline,
load control) without waiting for a signal; :meth:`Stack.close` shuts it
down in the order :func:`serve` does.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading
from dataclasses import dataclass, field

from .models import AnomalyDetector, DetectorConfig
from .runtime.pipeline import DetectorPipeline
from .services.gateway import ShopGateway
from .services.http_load import (
    BrowserLoadGenerator,
    HttpLoadGenerator,
    browser_traffic_enabled,
)
from .services.load_control import LoadControl
from .services.shop import Shop, ShopConfig
from .telemetry.metrics import export_report
from .utils.flag_ui import FlagEditorUI


@dataclass
class Stack:
    """The running stack of one ``serve_shop`` process."""

    shop: Shop
    gateway: ShopGateway
    load: LoadControl
    pipeline: DetectorPipeline | None = None
    grpc_edge: object | None = None
    broker: object | None = None
    exporters: list = field(default_factory=list)
    lines: list[str] = field(default_factory=list)  # what serve() prints

    def close(self) -> None:
        """Stop the load, the edges, then drain the pipeline and the
        exporters and close the bus and the broker."""
        self.load.stop()
        if self.grpc_edge is not None:
            self.grpc_edge.stop()
        self.gateway.stop()
        # Push the collector's unflushed span/log tail to the exporters
        # before draining them — batches land on the pump timer, and the
        # last window before shutdown has no later pump to flush it.
        self.shop.collector.force_flush(scrape=False)
        if self.pipeline is not None:
            self.pipeline.drain()
        for exporter in self.exporters:
            exporter.flush()
            exporter.close()
        if hasattr(self.shop.bus, "close"):
            self.shop.bus.close()
        if self.broker is not None:
            self.broker.stop()


def build(args) -> Stack:
    """Start the stack ``args`` (this module's parsed flags) describe.

    In-process mode builds ``AnomalyDetector(DetectorConfig(
    num_services=32))`` on ``args.device`` (the card when None; raises
    with no card) behind a ``DetectorPipeline`` of ``args.batch`` rows
    that the gateway pumps on every span flush."""
    lines: list[str] = []
    broker = None
    kafka_bootstrap = None
    if args.kafka == "auto":
        # Boot the in-repo broker beside the shop: one process fewer
        # than the compose topology, same wire path (checkout still
        # publishes over a real socket).
        from .runtime.kafka_broker import KafkaBroker

        broker = KafkaBroker(host="127.0.0.1", port=args.kafka_port)
        broker.start()
        kafka_bootstrap = f"127.0.0.1:{broker.port}"
        lines.append(f"kafka broker on {kafka_bootstrap}")
    elif args.kafka:
        kafka_bootstrap = args.kafka

    if args.minimal and kafka_bootstrap:
        if broker is not None:
            broker.stop()
        raise SystemExit("--minimal drops the async tier; it conflicts with --kafka")
    detector = None
    if not args.otlp_endpoint:
        # Resolve the device before anything listens: with no card and
        # no --device this raises.
        detector = AnomalyDetector(DetectorConfig(num_services=32), device=args.device)
    shop = Shop(ShopConfig(
        users=0, seed=args.seed, kafka_bootstrap=kafka_bootstrap,
        minimal=args.minimal,
    ))

    pipeline = None
    exporters: list = []
    if args.otlp_endpoint:
        # Compose topology: the detector runs in its OWN process (the
        # anomaly-detector container); this process exports spans and
        # scraped metrics to it over OTLP/HTTP, the otelcol exporter
        # pattern (otelcol-config.yml:85-92, docker-compose.yml:226-256).
        from .runtime.otlp_export import OtlpHttpLogsExporter, OtlpHttpSpanExporter
        from .runtime.otlp_metrics import OtlpHttpMetricsExporter

        span_exporter = OtlpHttpSpanExporter(args.otlp_endpoint)
        metrics_exporter = OtlpHttpMetricsExporter(args.otlp_endpoint)
        # Third signal (otelcol-config.yml:128-131): shop logs cross to
        # the sidecar's /v1/logs so a cross-process deployment carries
        # all three signals, not two.
        logs_exporter = OtlpHttpLogsExporter(args.otlp_endpoint)
        shop.collector.log_exporters.append(logs_exporter)
        exporters = [span_exporter, metrics_exporter, logs_exporter]
        exporters_by_signal = (
            ("traces", span_exporter),
            ("metrics", metrics_exporter),
            ("logs", logs_exporter),
        )

        def export_metrics_and_stats(now, jobs):
            metrics_exporter(now, jobs)
            # Sender-queue visibility (anomaly_export_dropped_total /
            # anomaly_export_queue_depth) on the scrape cadence: the
            # drop-oldest path lands in the shop's own scraped registry,
            # so a saturated sidecar shows on the anomaly dashboard.
            for signal_name, exporter in exporters_by_signal:
                exporter.publish_stats(shop.metrics, signal=signal_name)

        shop.collector.metrics_exporters.append(export_metrics_and_stats)
        on_spans = span_exporter
    else:
        # Single-process mode: the in-process detector pipeline.
        def on_report(t, report, flagged):
            export_report(
                shop.metrics,
                pipeline.tensorizer.service_names,
                report,
                flagged,
            )

        pipeline = DetectorPipeline(
            detector, flags=shop.flags, on_report=on_report, batch_size=args.batch
        )

        def on_spans(t, spans):
            pipeline.submit(spans)
            pipeline.pump(t)

    gw = ShopGateway(shop, host=args.host, port=args.port, on_spans=on_spans)
    if not args.minimal:
        # Minimal profile drops flagd-UI (the upstream demo's minimal
        # compose keeps flagd itself — OFREP evaluation stays served).
        gw.feature_ui = FlagEditorUI(shop.flags)
    gw.start()
    lines.append(
        f"shop gateway on http://{args.host}:{gw.port}  "
        + ("(minimal profile; metrics at /metrics)" if args.minimal else
           "(flag editor at /feature, metrics at /metrics)"))

    grpc_edge = None
    if args.grpc_port >= 0:
        # The upstream business services ARE gRPC servers; the edge
        # serves their whole oteldemo surface beside the HTTP gateway,
        # sharing the gateway's lock (one single-writer shop graph).
        from .services.grpc_edge import GrpcShopEdge

        try:
            grpc_edge = GrpcShopEdge(
                shop, host=args.host, port=args.grpc_port, lock=gw._lock
            )
        except BaseException:
            gw.stop()
            if broker is not None:
                broker.stop()
            raise
        grpc_edge.start()
        # Single-entry gRPC (the /flagservice/ Envoy route): h2c
        # connections hitting the HTTP port splice to this edge. Dial the
        # edge on the address it actually BOUND — loopback only when it
        # listens on a wildcard.
        splice_host = (
            "127.0.0.1" if args.host in ("0.0.0.0", "::", "") else args.host
        )
        gw.grpc_target = (splice_host, grpc_edge.port)
        lines.append(f"gRPC edge on {args.host}:{grpc_edge.port} "
                     f"(also tunnelled through :{gw.port})")

    # Loadgen control plane at /loadgen (the Locust web UI behind the
    # edge, envoy.tmpl.yaml:46): --users is the autostart default
    # (.env LOCUST_USERS/LOCUST_AUTOSTART), runtime-editable after.
    load = LoadControl(f"http://127.0.0.1:{gw.port}", seed=args.seed)
    gw.loadgen_ui = load
    browser_users = 1 if browser_traffic_enabled() else 0
    if args.users > 0 or browser_users:
        load.set_users(args.users, browser_users=browser_users or None)
        lines.append(f"in-proc load: {args.users} users"
                     + (", 1 browser user" if browser_users else ""))
    lines.append(f"loadgen control at http://{args.host}:{gw.port}/loadgen")
    return Stack(shop=shop, gateway=gw, load=load, pipeline=pipeline,
                 grpc_edge=grpc_edge, broker=broker, exporters=exporters, lines=lines)


def _wait_for_signal() -> None:
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()


def serve(args) -> None:
    stack = build(args)
    for line in stack.lines:
        print(line, flush=True)
    _wait_for_signal()
    stack.close()


def load_only(args) -> None:
    load = HttpLoadGenerator(args.target, users=args.users, seed=args.seed)
    load.start()
    print(f"load: {args.users} users → {args.target}", flush=True)
    browser_load = None
    if browser_traffic_enabled():
        browser_load = BrowserLoadGenerator(
            args.target, users=1, seed=args.seed
        )
        browser_load.start()
        print("browser load: 1 user", flush=True)
    _wait_for_signal()
    load.stop()
    if browser_load is not None:
        browser_load.stop()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m opentelemetry_demo_tpu_torch.serve_shop", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=int(os.getenv("SHOP_PORT", "8080")))
    p.add_argument("--users", type=int, default=int(os.getenv("SHOP_USERS", "0")))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument(
        "--device", default=None,
        help="torch device of the in-process detector (default: the CUDA "
        "card, raising without one; 'cpu' for the plain PyTorch path)",
    )
    p.add_argument("--load-only", action="store_true")
    p.add_argument(
        "--minimal", action="store_true",
        default=os.getenv("SHOP_MINIMAL", "") not in ("", "0", "false"),
        help="minimal profile (docker-compose.minimal.yml analogue): "
        "drops accounting, fraud-detection, the orders bus and the "
        "flag-editor UI; flagd evaluation (OFREP) stays",
    )
    p.add_argument("--target", default="http://127.0.0.1:8080")
    p.add_argument(
        "--grpc-port", type=int,
        default=int(os.getenv("SHOP_GRPC_PORT", "-1")),
        help="serve the oteldemo gRPC surface on this port "
        "(0 = ephemeral, -1 = disabled)",
    )
    p.add_argument(
        "--kafka", default=os.getenv("KAFKA_ADDR", ""),
        help="orders over a real TCP broker: 'auto' boots the in-repo "
        "KafkaBroker beside the shop, 'host:port' points at an external "
        "one (the compose overlay sets KAFKA_ADDR); empty = in-proc bus "
        "(the minimal-compose analogue, which also drops kafka)",
    )
    p.add_argument(
        "--kafka-port", type=int, default=int(os.getenv("KAFKA_PORT", "0")),
        help="listen port for --kafka auto (0 = ephemeral)",
    )
    p.add_argument(
        "--otlp-endpoint",
        default=os.getenv("OTEL_EXPORTER_OTLP_ENDPOINT", ""),
        help="export spans+metrics to an external anomaly-detector "
        "daemon instead of running one in-process; http(s)://host:4318 "
        "for OTLP/HTTP, grpc://host:4317 for OTLP/gRPC (the collector "
        "exporter default)",
    )
    return p


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    if args.load_only:
        load_only(args)
    else:
        serve(args)


if __name__ == "__main__":
    main()
