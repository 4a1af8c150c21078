"""Run the in-repo Kafka broker standalone — the compose topology's
kafka container as its own OS process.

The upstream demo runs an Apache Kafka image; this package's broker is
the wire-subset server in ``runtime.kafka_broker`` (Produce v0/v3, Fetch
v0/v4 with v2 RecordBatch headers, consumer-group offset storage). Point
``python -m opentelemetry_demo_tpu_torch.serve_shop --kafka host:port``
and the detector daemon's ``KAFKA_ADDR`` at it for the three-process
orders topology: shop (producer + accounting/fraud groups) and daemon
(anomaly-detector group) on one broker.

Usage: python -m opentelemetry_demo_tpu_torch.serve_kafka [--host 0.0.0.0] [--port 9092]
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from .runtime.kafka_broker import KafkaBroker


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m opentelemetry_demo_tpu_torch.serve_kafka", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument(
        "--port", type=int, default=int(os.getenv("KAFKA_PORT", "9092")),
        help="listen port (0 = ephemeral, printed at boot)",
    )
    args = parser.parse_args(argv)

    broker = KafkaBroker(host=args.host, port=args.port)
    broker.start()
    print(f"kafka broker on {args.host}:{broker.port}", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    broker.stop()


if __name__ == "__main__":
    main()
