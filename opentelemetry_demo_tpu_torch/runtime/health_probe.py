"""A grpc_health_probe for the port: exit 0 iff a gRPC server reports
SERVING.

    python -m opentelemetry_demo_tpu_torch.runtime.health_probe \\
        [--addr 127.0.0.1:4317] [--service opentelemetry.proto.collector.trace.v1.TraceService]

A raw-bytes unary call (no stubs): the request is
HealthCheckRequest{service}, and response field 1 must equal SERVING.

``--component NAME`` is shorthand for ``--service
anomaly.component.NAME``: exit 0 only while that supervised component
is up. ``--role`` and ``--shard`` read the daemon's ``/healthz`` JSON
on its metrics port (``--addr host:9464``) and print the replication
role and epoch, or the fleet block; the exit code is 0 whenever the
document was readable.
"""

from __future__ import annotations

import argparse
import sys

from . import wire
from .grpc_health import SERVING

# The per-component service-name prefix of the supervised runtime's
# health answers.
HEALTH_PREFIX = "anomaly.component."


def _healthz_doc(addr: str, timeout_s: float) -> dict | None:
    """The daemon's /healthz JSON, or None when unreachable. A 503
    (degraded) still carries the body, and a degraded daemon's role and
    fleet view must stay readable."""
    import json
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://{addr}/healthz", timeout=timeout_s) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read().decode())
        except Exception:  # noqa: BLE001 — an unreadable body is unknown
            return None
    except Exception:  # noqa: BLE001 — any transport or parse failure
        return None


def probe_role(addr: str, timeout_s: float = 3.0) -> tuple[str, int] | None:
    """(role, epoch) from /healthz, or None when unreachable. A daemon
    without replication omits both: primary at epoch 0."""
    doc = _healthz_doc(addr, timeout_s)
    if doc is None:
        return None
    return str(doc.get("role", "primary")), int(doc.get("epoch", 0))


def probe_shard(addr: str, timeout_s: float = 3.0) -> dict | None:
    """The /healthz ``fleet`` block, or None when unreachable or not a
    fleet member."""
    doc = _healthz_doc(addr, timeout_s)
    if doc is None:
        return None
    fleet = doc.get("fleet")
    return fleet if isinstance(fleet, dict) else None


def probe(addr: str, service: str = "", timeout_s: float = 3.0) -> bool:
    import grpc

    channel = grpc.insecure_channel(addr)
    check = channel.unary_unary(
        "/grpc.health.v1.Health/Check", request_serializer=None, response_deserializer=None,
    )
    request = wire.encode_len(1, service.encode()) if service else b""
    try:
        resp = check(request, timeout=timeout_s)
    except grpc.RpcError:
        return False
    finally:
        channel.close()
    return wire.first(wire.scan_fields(resp), 1) == SERVING


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--addr", default="127.0.0.1:4317")
    parser.add_argument("--service", default="")
    parser.add_argument(
        "--component", default="",
        help="supervised component name (shorthand for --service anomaly.component.<name>)",
    )
    parser.add_argument(
        "--role", action="store_true",
        help="print the replication role and epoch from /healthz on the metrics port",
    )
    parser.add_argument(
        "--shard", action="store_true",
        help="print the fleet block from /healthz on the metrics port; exit 0 iff it was readable",
    )
    parser.add_argument("--timeout", type=float, default=3.0)
    args = parser.parse_args()
    if args.shard:
        fleet = probe_shard(args.addr, args.timeout)
        if fleet is None:
            print("fleet view unreadable (not a fleet member?)", file=sys.stderr)
            sys.exit(1)
        peers = ", ".join(
            f"{p}={'up' if st.get('alive') else 'DOWN'}"
            for p, st in sorted(fleet.get("peers", {}).items())
        ) or "none"
        print(
            f"{fleet.get('shard', '?').upper()} "
            f"ring={fleet.get('ring_version', 0):#x} "
            f"live={fleet.get('shards_live')}/{fleet.get('shards_total')} "
            f"reshards={fleet.get('reshards_total')} "
            f"refused={fleet.get('reshards_refused')} "
            f"frozen={fleet.get('frozen')} peers: {peers}"
        )
        sys.exit(0)
    if args.role:
        role_epoch = probe_role(args.addr, args.timeout)
        if role_epoch is None:
            print("role unreadable", file=sys.stderr)
            sys.exit(1)
        role, epoch = role_epoch
        print(f"{role.upper()} epoch={epoch}")
        sys.exit(0)
    service = HEALTH_PREFIX + args.component if args.component else args.service
    sys.exit(0 if probe(args.addr, service, args.timeout) else 1)


if __name__ == "__main__":
    main()
