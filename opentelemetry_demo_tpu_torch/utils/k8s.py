"""Kubernetes deployment surface: the Helm-manifest analogue.

The reference ships a 12,848-line Helm-generated manifest
(the upstream demo's kubernetes/opentelemetry-demo.yaml: 23 Deployments,
25 Services, 7 ConfigMaps, 1 StatefulSet, RBAC + PodDisruptionBudget;
regenerated via the upstream demo's Makefile:163-176). This framework's
deployable units are fewer — the in-proc shop collapses the storefront
tier into one gateway process — so the generator emits exactly what a
cluster needs, from code rather than templates:

- **standalone stack**: shop-gateway (edge :8080 incl. flag editor +
  in-proc telemetry backend), anomaly-detector (OTLP :4318, metrics
  :9464, checkpoint PVC, PodDisruptionBudget), http load-generator.
- **sidecar overlay**: just the detector, wired to an *existing*
  reference-shop deployment the way deploy/docker-compose.anomaly.yml
  does for compose (same env shape as the reference's fraud-detection
  consumer, the upstream demo's docker-compose.yml:226-256). The detector
  exports its OWN self-telemetry traces (SELFTRACE_KNOBS) back to the
  cluster's ``otel-collector`` Service.

Memory limits follow the reference's budget style (load-gen 1500M,
detector sized like load-gen; docker-compose.yml resource limits).

The manifests run this package's entry points: ``python -m
opentelemetry_demo_tpu_torch`` for the detector, ``python -m
opentelemetry_demo_tpu_torch.serve_shop`` for the shop and the load
generator, ``python -m opentelemetry_demo_tpu_torch.serve_kafka`` for the
broker and ``python -m opentelemetry_demo_tpu_torch.runtime.aggregator``
for the aggregator. The detector runs on the card (it raises without
one), so every container that runs it asks for one GPU
(``nvidia.com/gpu: 1``).

Regenerate with ``python -m opentelemetry_demo_tpu_torch.utils.k8s``
(writes build/k8s_torch/*.yaml; ``--out`` to choose).
"""

from __future__ import annotations

import argparse
import os

APP_LABEL = "app.kubernetes.io/name"
PART_OF = "app.kubernetes.io/part-of"
STACK = "opentelemetry-demo-tpu-torch"
_GENERATED_MARKER = "# Generated by opentelemetry_demo_tpu_torch.utils.k8s"
IMAGE_DETECTOR = "opentelemetry-demo-tpu-torch:anomaly-detector"
IMAGE_GATEWAY = "opentelemetry-demo-tpu-torch:gateway"
DETECTOR_COMMAND = ["python", "-m", "opentelemetry_demo_tpu_torch"]
SHOP_COMMAND = ["python", "-m", "opentelemetry_demo_tpu_torch.serve_shop"]
GPU_RESOURCE = "nvidia.com/gpu"
DEFAULT_OUT = os.path.join("build", "k8s_torch")


def _labels(name: str) -> dict:
    return {APP_LABEL: name, PART_OF: STACK}


def deployment(
    name: str,
    image: str,
    *,
    env: dict[str, str] | None = None,
    ports: list[int] | None = None,
    memory: str = "300Mi",
    command: list[str] | None = None,
    volume_mounts: list[dict] | None = None,
    volumes: list[dict] | None = None,
    readiness_http: tuple[str, int] | None = None,
    liveness_http: tuple[str, int] | None = None,
    grpc_health_port: int | None = None,
    tcp_probe_port: int | None = None,
    readiness_tcp_port: int | None = None,
    replicas: int = 1,
    strategy: str | None = None,
    extra_pod_labels: dict[str, str] | None = None,
    gpus: int = 0,
) -> dict:
    container: dict = {
        "name": name,
        "image": image,
        "imagePullPolicy": "IfNotPresent",
        "resources": {"limits": {"memory": memory}},
    }
    if gpus:
        container["resources"]["limits"][GPU_RESOURCE] = gpus
    if command:
        container["command"] = command
    if env:
        container["env"] = [{"name": k, "value": str(v)} for k, v in sorted(env.items())]
    if ports:
        container["ports"] = [{"containerPort": p} for p in ports]
    if volume_mounts:
        container["volumeMounts"] = volume_mounts
    # One probe FAMILY per deployment: grpc/tcp set BOTH readiness and
    # liveness, so mixing them with each other or with the http pair
    # would silently overwrite one of the probes. The ONE sanctioned
    # mix is ``liveness_http`` + ``readiness_tcp_port`` — the HA
    # detector pair needs "alive" (healthz answers) decoupled from
    # "ready to receive traffic" (ingest port bound), because a standby
    # is healthy-but-not-serving and a fenced ex-primary is
    # alive-but-must-lose-its-endpoints.
    probe_kinds = [
        k for k, v in (
            ("http", readiness_http or liveness_http),
            ("grpc", grpc_health_port),
            ("tcp", tcp_probe_port),
        ) if v
    ]
    if readiness_tcp_port and (
        readiness_http or grpc_health_port or tcp_probe_port
    ):
        raise ValueError(
            "readiness_tcp_port composes only with liveness_http — any "
            "other probe source would silently overwrite it"
        )
    if len(probe_kinds) > 1:
        raise ValueError(
            f"multiple probe kinds {probe_kinds}: one would silently "
            "replace the other — pick one family per deployment"
        )
    if readiness_http:
        path, port = readiness_http
        container["readinessProbe"] = {
            "httpGet": {"path": path, "port": port},
            "initialDelaySeconds": 5,
            "periodSeconds": 10,
        }
    if liveness_http:
        # Liveness gets a longer grace than readiness: a slow boot must
        # gate traffic, not trigger a restart loop.
        path, port = liveness_http
        container["livenessProbe"] = {
            "httpGet": {"path": path, "port": port},
            "initialDelaySeconds": 30,
            "periodSeconds": 20,
            "failureThreshold": 3,
        }
    if grpc_health_port:
        # Native kubelet gRPC probe (k8s ≥1.24): queries the same
        # grpc.health.v1 service the reference's containers register
        # (main.go:223-224); liveness uses it too, with a longer grace.
        container["readinessProbe"] = {
            "grpc": {"port": grpc_health_port},
            "initialDelaySeconds": 5,
            "periodSeconds": 10,
        }
        container["livenessProbe"] = {
            "grpc": {"port": grpc_health_port},
            "initialDelaySeconds": 30,
            "periodSeconds": 20,
            "failureThreshold": 3,
        }
    if tcp_probe_port:
        # Raw socket-accept probes for wire-protocol servers with no
        # HTTP/gRPC surface (the broker) — the shape the reference's
        # kafka healthcheck takes (docker-compose.yml:681-687).
        container["readinessProbe"] = {
            "tcpSocket": {"port": tcp_probe_port},
            "initialDelaySeconds": 5,
            "periodSeconds": 10,
        }
        container["livenessProbe"] = {
            "tcpSocket": {"port": tcp_probe_port},
            "initialDelaySeconds": 30,
            "periodSeconds": 20,
            "failureThreshold": 3,
        }
    if readiness_tcp_port:
        # Readiness-only socket probe (see the mix rule above): the
        # endpoint joins/leaves Services on whether the INGEST port is
        # bound, while liveness stays on the always-on health surface.
        container["readinessProbe"] = {
            "tcpSocket": {"port": readiness_tcp_port},
            "initialDelaySeconds": 5,
            "periodSeconds": 5,
        }
    pod_labels = _labels(name)
    if extra_pod_labels:
        pod_labels = {**pod_labels, **extra_pod_labels}
    spec: dict = {
        "replicas": replicas,
        "selector": {"matchLabels": {APP_LABEL: name}},
        "template": {
            "metadata": {"labels": pod_labels},
            "spec": {
                # RBAC posture (the reference manifest ships per-service
                # ServiceAccounts): a dedicated identity per component,
                # with API credentials NOT mounted — nothing in this
                # stack talks to the kube API.
                "serviceAccountName": name,
                "containers": [container],
            },
        },
    }
    if volumes:
        spec["template"]["spec"]["volumes"] = volumes
    if strategy:
        spec["strategy"] = {"type": strategy}
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": name, "labels": _labels(name)},
        "spec": spec,
    }


def service_account(name: str) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "ServiceAccount",
        "metadata": {"name": name, "labels": _labels(name)},
        "automountServiceAccountToken": False,
    }


def service(
    name: str,
    ports: list[int],
    publish_not_ready: bool = False,
    selector_app: str | None = None,
) -> dict:
    spec: dict = {
        "selector": {APP_LABEL: selector_app or name},
        "ports": [{"name": f"port-{p}", "port": p, "targetPort": p} for p in ports],
    }
    if publish_not_ready:
        # Observability-only Services (`<role>-obs`: :9464 scrape,
        # :9465 read-replica queries) must reach pods whose readiness
        # probe (an ingest port) is deliberately down pre-promotion.
        # ONLY these carry the flag: publishing a not-ready primary's
        # ingest/health ports would let the standby's grpc-health
        # double-check (ANOMALY_PRIMARY_HEALTH_ADDR=<role>:4317) see
        # SERVING from a half-dead primary and refuse to promote.
        spec["publishNotReadyAddresses"] = True
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "labels": _labels(name)},
        "spec": spec,
    }


def configmap(name: str, data: dict[str, str]) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {"name": name, "labels": _labels(name)},
        "data": data,
    }


def pvc(name: str, size: str = "1Gi") -> dict:
    return {
        "apiVersion": "v1",
        "kind": "PersistentVolumeClaim",
        "metadata": {"name": name, "labels": _labels(name)},
        "spec": {
            "accessModes": ["ReadWriteOnce"],
            "resources": {"requests": {"storage": size}},
        },
    }


def pod_disruption_budget(name: str) -> dict:
    return {
        "apiVersion": "policy/v1",
        "kind": "PodDisruptionBudget",
        "metadata": {"name": name, "labels": _labels(name)},
        "spec": {
            # maxUnavailable (not minAvailable): with replicas=1,
            # minAvailable:1 would deadlock `kubectl drain` forever.
            "maxUnavailable": 1,
            "selector": {"matchLabels": {APP_LABEL: name}},
        },
    }


def _detector_env(kafka_addr: str | None) -> dict[str, str]:
    """The detector's base env block from the knob registries.

    Daemon-core + overload + ingest-pool + replication + frame + query
    knobs come from the ONE registry set (utils.config.
    DEPLOYED_KNOB_REGISTRIES), so the manifests can never drift from
    the daemon's env contract — staticcheck's knob-discipline pass and
    sanitycheck pin the same correspondence for the compose overlay."""
    from .config import (
        AUTOSCALE_KNOBS,
        DAEMON_KNOBS,
        FLEET_KNOBS,
        FRAME_KNOBS,
        FRONTDOOR_KNOBS,
        HISTORY_KNOBS,
        INGEST_KNOBS,
        KEYSPACE_KNOBS,
        OVERLOAD_KNOBS,
        PROVENANCE_KNOBS,
        QUERY_KNOBS,
        REMEDIATION_KNOBS,
        REPLICATION_KNOBS,
        SELFTRACE_KNOBS,
        SHADOW_KNOBS,
        SPINE_KNOBS,
    )

    env: dict[str, str] = {}
    for knob, (_kind, default, _help) in {
        **DAEMON_KNOBS, **OVERLOAD_KNOBS, **INGEST_KNOBS,
        **REPLICATION_KNOBS, **FRAME_KNOBS, **QUERY_KNOBS,
        **SPINE_KNOBS, **SELFTRACE_KNOBS, **HISTORY_KNOBS,
        **REMEDIATION_KNOBS, **FLEET_KNOBS, **AUTOSCALE_KNOBS,
        **SHADOW_KNOBS, **PROVENANCE_KNOBS, **FRONTDOOR_KNOBS,
        **KEYSPACE_KNOBS,
    }.items():
        env[knob] = str(default)
    # In-cluster overrides on the registry defaults: the snapshot
    # lands on the PVC, flags come from the shared flagd volume, and
    # the query plane binds a FIXED port (the registry default 0 =
    # ephemeral suits tests; a Service needs a number).
    env["ANOMALY_CHECKPOINT"] = "/var/lib/anomaly/detector"
    env["FLAGD_FILE"] = "/app/flagd/demo.flagd.json"
    env["ANOMALY_QUERY_PORT"] = "9465"
    # Self-telemetry: flight evidence lands on the state PVC, and the
    # detector's own traces export to the cluster's collector Service
    # (the same stack the shop feeds — detector batch traces appear in
    # Jaeger beside the traffic they flagged).
    env["ANOMALY_SELFTRACE_FLIGHT_DIR"] = "/var/lib/anomaly/flight"
    env["ANOMALY_SELFTRACE_ENDPOINT"] = "http://otel-collector:4318"
    # Time-travel tier: the segment log lives on the same state PVC as
    # the checkpoint (the registry default "" means tier-off, which
    # suits bare tests; a cluster deployment wants history on).
    env["ANOMALY_HISTORY_DIR"] = "/var/lib/anomaly/history"
    if kafka_addr:
        env["KAFKA_ADDR"] = kafka_addr
    else:
        # The registry's empty default means "no Kafka leg": drop the
        # key so the container env stays minimal and explicit.
        env.pop("KAFKA_ADDR", None)
    return env


HA_COMPONENT_LABEL = "app.kubernetes.io/component"
HA_COMPONENT = "anomaly-detector-ha"


def ha_service() -> dict:
    """The FAILOVER Service: selects BOTH detector roles by the shared
    component label, so whichever pod is Ready — the serving primary,
    or the standby once it promotes and binds its ingest ports — owns
    the collector's traffic. Readiness is what moves the endpoints:
    both deployments probe readiness on an INGEST port (tcp :4318 —
    the HTTP leg, which binds unconditionally when serving), so
    a pre-promotion standby and a fenced ex-primary (receivers stopped)
    are NotReady and hold no endpoints here. This is the address the
    collector/shop export to; the per-role Services remain for
    scraping/debugging a specific replica."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": HA_COMPONENT,
            "labels": _labels(HA_COMPONENT),
        },
        "spec": {
            "selector": {HA_COMPONENT_LABEL: HA_COMPONENT},
            "ports": [
                {"name": f"port-{p}", "port": p, "targetPort": p}
                for p in (4317, 4318)
            ],
        },
    }


def _detector_resources(kafka_addr: str | None) -> list[dict]:
    """Primary + hot-standby detector bundle (shared by both stacks).

    The primary ships epoch-stamped state deltas on :4319
    (runtime.replication); the ``anomaly-detector-standby`` Deployment
    applies them and promotes itself when the primary goes silent —
    k8s restarts the dead primary pod, which then boots FENCED (the
    broker's epoch-tagged commits outrank it) instead of
    split-braining. Each role keeps its OWN checkpoint PVC. Traffic
    follows readiness through :func:`ha_service`: liveness rides the
    always-on /healthz (a standby and a fenced ex-primary are ALIVE),
    readiness rides the ingest port (only a serving primary is READY).
    """
    env = _detector_env(kafka_addr)
    env["ANOMALY_ROLE"] = "primary"
    env["ANOMALY_REPLICATION_PORT"] = "4319"
    standby_env = _detector_env(kafka_addr)
    standby_env.update({
        "ANOMALY_ROLE": "standby",
        "ANOMALY_REPLICATION_PORT": "4319",
        "ANOMALY_REPLICATION_TARGET": "anomaly-detector:4319",
        # Promote only when the primary's health endpoint is ALSO dead
        # (a broken replication Service alone must not split-brain).
        "ANOMALY_PRIMARY_HEALTH_ADDR": "anomaly-detector:4317",
    })
    ha_labels = {HA_COMPONENT_LABEL: HA_COMPONENT}
    return [
        service_account("anomaly-detector"),
        deployment(
            "anomaly-detector",
            IMAGE_DETECTOR,
            command=DETECTOR_COMMAND,
            gpus=1,
            env=env,
            ports=[4317, 4318, 4319, 9464, 9465],
            liveness_http=("/healthz", 9464),
            readiness_tcp_port=4318,
            extra_pod_labels=ha_labels,
            memory="1500Mi",
            # Recreate: the RWO checkpoint PVC can't be attached by old
            # and new pods at once; RollingUpdate would wedge on
            # Multi-Attach when the replacement lands on another node.
            strategy="Recreate",
            volume_mounts=[
                {"name": "anomaly-state", "mountPath": "/var/lib/anomaly"},
                {"name": "flagd-config", "mountPath": "/app/flagd", "readOnly": True},
            ],
            volumes=[
                {
                    "name": "anomaly-state",
                    "persistentVolumeClaim": {"claimName": "anomaly-state"},
                },
                {
                    "name": "flagd-config",
                    "configMap": {"name": "flagd-config"},
                },
            ],
        ),
        # Ingest + health-check address: readiness-gated, so the
        # standby's promotion double-check gets connection-refused
        # (and promotes) when the primary is down.
        service("anomaly-detector", [4317, 4318, 4319]),
        # Scrape + read-replica address: published even when NotReady.
        service(
            "anomaly-detector-obs", [9464, 9465],
            publish_not_ready=True, selector_app="anomaly-detector",
        ),
        pvc("anomaly-state"),
        pod_disruption_budget("anomaly-detector"),
        service_account("anomaly-detector-standby"),
        deployment(
            "anomaly-detector-standby",
            IMAGE_DETECTOR,
            command=DETECTOR_COMMAND,
            gpus=1,
            env=standby_env,
            ports=[4317, 4318, 4319, 9464, 9465],
            # Alive on /healthz (role+epoch), READY only once promotion
            # binds the ingest ports — that readiness flip is what
            # moves the ha_service endpoints to the new primary.
            liveness_http=("/healthz", 9464),
            readiness_tcp_port=4318,
            extra_pod_labels=ha_labels,
            memory="1500Mi",
            strategy="Recreate",
            volume_mounts=[
                {
                    "name": "anomaly-state-standby",
                    "mountPath": "/var/lib/anomaly",
                },
                {"name": "flagd-config", "mountPath": "/app/flagd", "readOnly": True},
            ],
            volumes=[
                {
                    "name": "anomaly-state-standby",
                    "persistentVolumeClaim": {
                        "claimName": "anomaly-state-standby"
                    },
                },
                {
                    "name": "flagd-config",
                    "configMap": {"name": "flagd-config"},
                },
            ],
        ),
        service("anomaly-detector-standby", [4317, 4318, 4319]),
        service(
            "anomaly-detector-standby-obs", [9464, 9465],
            publish_not_ready=True,
            selector_app="anomaly-detector-standby",
        ),
        pvc("anomaly-state-standby"),
        pod_disruption_budget("anomaly-detector-standby"),
        ha_service(),
    ]


def _flagd_configmap() -> dict:
    """flagd file ConfigMap; content sourced from the deploy dir."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(here, "deploy", "demo.flagd.anomaly.json")
    try:
        with open(path) as f:
            flags = f.read()
    except OSError:
        flags = '{"flags": {}}\n'
    return configmap("flagd-config", {"demo.flagd.json": flags})


def aggregator_resources(shards: int = 3) -> list[dict]:
    """The sharded-fleet scatter-gather tier (runtime.aggregator) as
    its own component bundle — fleet-global ``/query/*`` on :9470,
    fanning out to the shard query planes and merging shard frames
    with per-shard timeout + labeled partial-answer degradation.

    NOT part of the standalone/minimal stacks: the fleet is an opt-in
    scale-out (``ANOMALY_FLEET_SHARDS`` >= 2 across N detector
    deployments, one per shard index); apply
    ``components/anomaly-aggregator.yaml`` alongside them. The default
    env here assumes ``shards`` detector Services named
    ``anomaly-detector-shard-<i>`` (the deployment pattern
    deploy/README.md documents)."""
    from .config import FLEET_KNOBS

    env = {
        knob: str(default)
        for knob, (_kind, default, _help) in FLEET_KNOBS.items()
    }
    env.update({
        "ANOMALY_FLEET_SHARDS": str(shards),
        "ANOMALY_FLEET_PEERS": ",".join(
            f"anomaly-detector-shard-{i}:9464" for i in range(shards)
        ),
        "ANOMALY_FLEET_QUERY_PEERS": ",".join(
            f"anomaly-detector-shard-{i}:9465" for i in range(shards)
        ),
        "ANOMALY_AGGREGATOR_PORT": "9470",
    })
    return [
        service_account("anomaly-aggregator"),
        deployment(
            "anomaly-aggregator",
            IMAGE_DETECTOR,
            command=[
                "python", "-m",
                "opentelemetry_demo_tpu_torch.runtime.aggregator",
            ],
            env=env,
            ports=[9470],
            readiness_http=("/", 9470),
            liveness_http=("/", 9470),
            memory="300Mi",  # stdlib HTTP fan-out: no sketches, no card
        ),
        service("anomaly-aggregator", [9470]),
        pod_disruption_budget("anomaly-aggregator"),
    ]


# Default keyspace for the generated fleet bundle: the demo shop's
# service names. Override with --fleet-services — the ONE order must
# match ANOMALY_FLEET_SERVICES on every shard (the bit-exact contract).
FLEET_DEFAULT_SERVICES = (
    "frontend", "cart", "checkout", "currency", "payment", "email",
    "shipping", "ad", "recommendation", "product-catalog",
)


def fleet_routing_configmap(
    shards: int,
    services: tuple[str, ...] | list[str],
    tenants: dict[str, str] | None = None,
) -> dict:
    """Collector-side OTLP routing + Kafka partition→shard assignment,
    EMITTED from FLEET_KNOBS and the real ring rather than hand-kept:

    - ``otelcol-fleet-routing.yml`` — a routing-connector fragment
      whose service→shard table is computed by the SAME
      ``runtime.fleet.HashRing`` the shards build, so collector
      routing and shard ownership can never disagree (a misrouted
      service would split one sketch row across two shards and break
      the bit-exact merge contract);
    - ``kafka-partition-map.json`` — the orders-topic assignment:
      partition p is consumed by shard p mod N (give the topic N
      partitions; each shard points KAFKA_ADDR at the broker).
    """
    from ..runtime.fleet import HashRing, shard_key, tenant_of
    from .config import FLEET_KNOBS

    vnodes = int(FLEET_KNOBS["ANOMALY_FLEET_VNODES"][1])
    members = [f"shard-{i}" for i in range(shards)]
    ring = HashRing(members, vnodes=vnodes)
    owner_of = {
        svc: ring.owner(shard_key(svc, tenant_of(svc, tenants or {})))
        for svc in services
    }
    lines = [
        "# Service->shard table computed by runtime.fleet.HashRing",
        f"# (vnodes={vnodes}); regenerate with make gen-k8s.",
        "connectors:",
        "  routing/anomaly-fleet:",
        "    default_pipelines: [traces/anomaly-shard-0]",
        "    table:",
    ]
    for svc in services:
        idx = owner_of[svc].rsplit("-", 1)[1]
        lines += [
            "      - statement: route() where "
            f"resource.attributes[\"service.name\"] == \"{svc}\"",
            f"        pipelines: [traces/anomaly-shard-{idx}]",
        ]
    lines.append("exporters:")
    for i in range(shards):
        lines += [
            f"  otlp/anomaly-shard-{i}:",
            f"    endpoint: \"anomaly-detector-shard-{i}:4317\"",
            "    tls: {insecure: true}",
        ]
    lines += ["service:", "  pipelines:"]
    for i in range(shards):
        lines += [
            f"    traces/anomaly-shard-{i}:",
            "      receivers: [routing/anomaly-fleet]",
            f"      exporters: [otlp/anomaly-shard-{i}]",
        ]
    import json as _json

    kafka_map = _json.dumps({
        "topic": "orders",
        "partitions": shards,
        "assignment": {
            str(p): f"anomaly-detector-shard-{p % shards}"
            for p in range(shards)
        },
    }, indent=2)
    return configmap("anomaly-fleet-routing", {
        "otelcol-fleet-routing.yml": "\n".join(lines) + "\n",
        "kafka-partition-map.json": kafka_map + "\n",
    })


def fleet_shard_resources(
    shards: int = 3,
    services: tuple[str, ...] | list[str] = FLEET_DEFAULT_SERVICES,
    tenants_csv: str = "",
    kafka_addr: str = "kafka:9092",
) -> list[dict]:
    """The N-way elastic fleet as cluster resources: one detector
    Deployment per shard index, peer/query/replication address lists
    generated from the shard Service names, the shared
    ANOMALY_FLEET_SERVICES order, and the routing ConfigMap above.

    ``ANOMALY_FLEET_REPL_PEERS`` wires the adoption tier: each shard
    mirrors its ring-successor's replication stream, so a
    declared-dead shard's keyspace is adopted by the survivor with
    zero operator action. The autoscaler ships OBSERVE-ONLY
    (``ANOMALY_AUTOSCALE_ENABLE=0`` from the registry default); a
    proposal it would make shows in anomaly_autoscale_* metrics, and
    acting on one is a FLEET_KNOBS change (SHARDS + peer lists)
    rolled out here. Component-only bundle — apply
    ``components/anomaly-fleet.yaml`` beside
    ``components/anomaly-aggregator.yaml``."""
    tenants = {}
    if tenants_csv:
        for pair in tenants_csv.split(","):
            svc, _, tenant = pair.partition(":")
            if svc and tenant:
                tenants[svc] = tenant
    names = [f"anomaly-detector-shard-{i}" for i in range(shards)]
    peers = ",".join(f"{n}:9464" for n in names)
    query_peers = ",".join(f"{n}:9465" for n in names)
    repl_peers = ",".join(f"{n}:4319" for n in names)
    docs: list[dict] = [
        fleet_routing_configmap(shards, services, tenants),
    ]
    for i, name in enumerate(names):
        env = _detector_env(kafka_addr)
        env.update({
            "ANOMALY_ROLE": "primary",
            "ANOMALY_REPLICATION_PORT": "4319",
            "ANOMALY_FLEET_SHARDS": str(shards),
            "ANOMALY_FLEET_SHARD_INDEX": str(i),
            "ANOMALY_FLEET_PEERS": peers,
            "ANOMALY_FLEET_QUERY_PEERS": query_peers,
            "ANOMALY_FLEET_REPL_PEERS": repl_peers,
            "ANOMALY_FLEET_SERVICES": ",".join(services),
        })
        if tenants_csv:
            env["ANOMALY_FLEET_TENANTS"] = tenants_csv
        docs += [
            service_account(name),
            deployment(
                name,
                IMAGE_DETECTOR,
                command=DETECTOR_COMMAND,
                gpus=1,
                env=env,
                ports=[4317, 4318, 4319, 9464, 9465],
                liveness_http=("/healthz", 9464),
                readiness_tcp_port=4318,
                memory="1500Mi",
                strategy="Recreate",
                volume_mounts=[
                    {
                        "name": "anomaly-state",
                        "mountPath": "/var/lib/anomaly",
                    },
                    {
                        "name": "flagd-config",
                        "mountPath": "/app/flagd",
                        "readOnly": True,
                    },
                ],
                volumes=[
                    {
                        "name": "anomaly-state",
                        "persistentVolumeClaim": {
                            "claimName": f"{name}-state"
                        },
                    },
                    {
                        "name": "flagd-config",
                        "configMap": {"name": "flagd-config"},
                    },
                ],
            ),
            # ONE Service per shard, published even when NotReady:
            # membership heartbeats + the adoption double-check poll
            # /healthz here, and a compile-stalled-but-serving shard
            # must stay REACHABLE (alive-but-slow is exactly the
            # state that must NOT be adopted); the routing connector
            # retries a not-ready shard's ingest ports harmlessly.
            service(name, [4317, 4318, 4319, 9464, 9465],
                    publish_not_ready=True),
            pvc(f"{name}-state"),
            pod_disruption_budget(name),
        ]
    return docs


def kafka_resources() -> list[dict]:
    """The async tier as its own component, like the reference's kafka
    container (docker-compose.yml kafka service): the in-repo broker
    process with socket-accept probes and a drain budget."""
    return [
        service_account("kafka"),
        deployment(
            "kafka",
            IMAGE_GATEWAY,
            command=["python", "-m", "opentelemetry_demo_tpu_torch.serve_kafka"],
            env={"KAFKA_PORT": "9092"},
            ports=[9092],
            tcp_probe_port=9092,
            memory="620Mi",  # the reference's kafka budget
            # Single in-memory broker: RollingUpdate would briefly run
            # TWO independent logs behind one Service (producer on one,
            # consumers on the other — orders silently unconsumed).
            strategy="Recreate",
        ),
        service("kafka", [9092]),
        pod_disruption_budget("kafka"),
    ]


def shop_resources(minimal: bool = False) -> list[dict]:
    """Edge + shop tier: gateway (HTTP :8080 incl. /jaeger + /grafana
    observability surfaces), gRPC edge :8443, wired to the broker and
    exporting all three OTLP signals to the detector service.
    ``minimal`` drops the broker wiring and serves the reduced profile
    (--minimal: no consumers, no flag-editor UI)."""
    command = list(SHOP_COMMAND)
    if minimal:
        command += ["--minimal"]
    else:
        command += ["--kafka", "kafka:9092"]
    command += ["--otlp-endpoint", "http://anomaly-detector-ha:4318"]
    return [
        service_account("shop-gateway"),
        deployment(
            "shop-gateway",
            IMAGE_GATEWAY,
            command=command,
            env={
                "SHOP_PORT": "8080",
                "SHOP_GRPC_PORT": "8443",
                "SHOP_USERS": "0",
            },
            ports=[8080, 8443],
            memory="500Mi",
            readiness_http=("/health", 8080),
            liveness_http=("/health", 8080),
        ),
        service("shop-gateway", [8080, 8443]),
        pod_disruption_budget("shop-gateway"),
    ]


def loadgen_resources() -> list[dict]:
    return [
        service_account("load-generator"),
        deployment(
            "load-generator",
            IMAGE_GATEWAY,
            command=SHOP_COMMAND + ["--load-only",
                     "--target", "http://shop-gateway:8080", "--users", "5"],
            memory="1500Mi",
        ),
    ]


def component_bundles() -> dict[str, list[dict]]:
    """Per-component resource bundles — the reference manifest's
    per-service breakout, generated instead of Helm-templated."""
    return {
        "kafka": kafka_resources(),
        "shop-gateway": shop_resources(),
        "load-generator": loadgen_resources(),
        "anomaly-detector": [_flagd_configmap()]
        + _detector_resources(kafka_addr="kafka:9092"),
    }


def standalone_stack() -> list[dict]:
    """The whole framework stack as cluster resources."""
    docs: list[dict] = []
    for bundle in component_bundles().values():
        docs.extend(bundle)
    return docs


def minimal_stack() -> list[dict]:
    """The reduced profile, docker-compose.minimal.yml's k8s analogue
    (the upstream demo's docker-compose.minimal.yml:16 drops accounting,
    fraud-detection, flagd-ui, kafka): shop gateway in --minimal mode,
    the detector on OTLP signals only (no consumer group), and the
    load generator. flagd evaluation stays in-proc behind OFREP."""
    return (
        shop_resources(minimal=True)
        + loadgen_resources()
        + [_flagd_configmap()]
        + _detector_resources(kafka_addr=None)
    )


def sidecar_overlay(kafka_addr: str = "kafka:9092") -> list[dict]:
    """Detector-only bundle for an existing reference-shop cluster."""
    return [_flagd_configmap()] + _detector_resources(kafka_addr=kafka_addr)


def to_yaml(docs: list[dict]) -> str:
    import yaml

    return yaml.safe_dump_all(docs, sort_keys=False, default_flow_style=False)


def write_manifests(
    outdir: str = DEFAULT_OUT,
    fleet_shards: int = 3,
    fleet_services: tuple[str, ...] | list[str] = FLEET_DEFAULT_SERVICES,
) -> list[str]:
    os.makedirs(outdir, exist_ok=True)
    targets = [
        (f"{STACK}.yaml", standalone_stack()),
        (f"{STACK}.minimal.yaml", minimal_stack()),
        ("anomaly-detector-sidecar.yaml", sidecar_overlay()),
    ]
    # Per-component breakout beside the aggregates (operate one tier at
    # a time, the way the reference's per-service Helm values allow).
    comp_dir = os.path.join(outdir, "components")
    os.makedirs(comp_dir, exist_ok=True)
    bundles = component_bundles()
    # Fleet scale-out tier: a component-only bundle (NOT folded into
    # the standalone/minimal aggregates — the fleet is an opt-in
    # deployment shape; a default aggregator with SHARDS=0 would just
    # crash-loop).
    bundles["anomaly-aggregator"] = aggregator_resources(
        shards=fleet_shards
    )
    # N-way shard tier behind the aggregator: per-shard Deployments
    # with ring-derived peer lists, plus the collector routing +
    # Kafka partition assignment emitted from FLEET_KNOBS and the
    # REAL HashRing (routing and ownership can never disagree).
    bundles["anomaly-fleet"] = fleet_shard_resources(
        shards=fleet_shards, services=tuple(fleet_services)
    )
    # Prune stale generations: a renamed/removed component must not
    # leave a "do not edit" file behind that `kubectl apply -f` would
    # still create.
    keep = {f"{name}.yaml" for name in bundles}
    for fname in os.listdir(comp_dir):
        if not fname.endswith(".yaml") or fname in keep:
            continue
        fpath = os.path.join(comp_dir, fname)
        # Only reap OUR stale generations: a hand-authored neighbour
        # (ingress.yaml, kustomization…) lacks the marker and is kept.
        try:
            with open(fpath) as f:
                first = f.readline()
        except OSError:
            continue
        if first.startswith(_GENERATED_MARKER):
            os.remove(fpath)
    for name, docs in bundles.items():
        targets.append((os.path.join("components", f"{name}.yaml"), docs))
    written = []
    for fname, docs in targets:
        path = os.path.join(outdir, fname)
        with open(path, "w") as f:
            f.write(_GENERATED_MARKER + " — do not edit.\n")
            f.write(to_yaml(docs))
        written.append(path)
    return written


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument(
        "--fleet-shards", type=int, default=3,
        help="shard count for the anomaly-fleet bundle (and the "
        "aggregator's scatter-gather fan-out)",
    )
    parser.add_argument(
        "--fleet-services", default=",".join(FLEET_DEFAULT_SERVICES),
        help="comma-separated keyspace for the fleet routing table — "
        "must match ANOMALY_FLEET_SERVICES on every shard",
    )
    args = parser.parse_args()
    services = tuple(
        s.strip() for s in args.fleet_services.split(",") if s.strip()
    )
    for path in write_manifests(
        args.out, fleet_shards=args.fleet_shards, fleet_services=services
    ):
        print(path)


if __name__ == "__main__":
    main()
