"""The port's deploy surface: the k8s generator and ``serve_shop``.

The cases of ``tests/test_deploy_surface.py`` on the port's generator
and entry point, then the generator against the reference's: every
document equal but for the named fields. Those are the stack's name
(the ``part-of`` label), the images, the generated-file marker and file
names, each container's command (the port's entry points, checked one
for one against the reference's), and ``nvidia.com/gpu: 1`` in the
limits of every container that runs the detector (the single detector,
the HA pair, the fleet shards) and of no other. ``write_manifests`` and
``python -m opentelemetry_demo_tpu_torch.utils.k8s`` write under
``build/k8s_torch`` by default, never under ``deploy/``.
``serve_shop --device cpu`` is booted as a process, in the full and the
minimal profile; without ``--device`` and without a card it raises.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch
import yaml

from opentelemetry_demo_tpu.utils import k8s as ref_k8s
from opentelemetry_demo_tpu_torch.utils import k8s

REPO = Path(__file__).resolve().parent.parent


def _by_kind_name(docs):
    return {(d["kind"], d["metadata"]["name"]): d for d in docs}


def _containers(doc):
    if doc["kind"] != "Deployment":
        return []
    return doc["spec"]["template"]["spec"]["containers"]


class TestManifests:
    def test_standalone_stack_resources(self):
        idx = _by_kind_name(k8s.standalone_stack())
        for name in ("shop-gateway", "anomaly-detector", "load-generator", "kafka"):
            assert ("Deployment", name) in idx, name
            assert ("ServiceAccount", name) in idx, name
        assert ("Service", "anomaly-detector") in idx
        assert ("Service", "kafka") in idx
        assert ("PersistentVolumeClaim", "anomaly-state") in idx
        for name in ("anomaly-detector", "kafka", "shop-gateway"):
            assert ("PodDisruptionBudget", name) in idx, name
        assert ("ConfigMap", "flagd-config") in idx

    def test_every_pod_runs_a_credentialless_service_account(self):
        idx = _by_kind_name(k8s.standalone_stack())
        for (kind, name), doc in idx.items():
            if kind == "Deployment":
                pod = doc["spec"]["template"]["spec"]
                assert pod["serviceAccountName"] == name
                assert idx[("ServiceAccount", name)]["automountServiceAccountToken"] is False

    def test_component_probe_shapes(self):
        idx = _by_kind_name(k8s.standalone_stack())
        shop = _containers(idx[("Deployment", "shop-gateway")])[0]
        assert shop["readinessProbe"]["httpGet"]["path"] == "/health"
        assert shop["livenessProbe"]["httpGet"]["path"] == "/health"
        assert shop["livenessProbe"]["initialDelaySeconds"] > shop["readinessProbe"]["initialDelaySeconds"]
        kafka = _containers(idx[("Deployment", "kafka")])[0]
        assert kafka["readinessProbe"]["tcpSocket"]["port"] == 9092
        assert kafka["livenessProbe"]["tcpSocket"]["port"] == 9092

    def test_full_topology_wiring(self):
        idx = _by_kind_name(k8s.standalone_stack())
        shop = _containers(idx[("Deployment", "shop-gateway")])[0]
        assert shop["command"][:3] == ["python", "-m", "opentelemetry_demo_tpu_torch.serve_shop"]
        assert shop["command"][shop["command"].index("--kafka") + 1] == "kafka:9092"
        assert "anomaly-detector-ha:4318" in shop["command"][shop["command"].index("--otlp-endpoint") + 1]
        assert {e["name"]: e["value"] for e in shop["env"]}["SHOP_GRPC_PORT"] == "8443"
        det = _containers(idx[("Deployment", "anomaly-detector")])[0]
        assert det["command"] == ["python", "-m", "opentelemetry_demo_tpu_torch"]
        assert {e["name"]: e["value"] for e in det["env"]}["KAFKA_ADDR"] == "kafka:9092"

    def test_detector_wiring(self):
        idx = _by_kind_name(k8s.sidecar_overlay(kafka_addr="kafka:9092"))
        dep = idx[("Deployment", "anomaly-detector")]
        container = _containers(dep)[0]
        env = {e["name"]: e["value"] for e in container["env"]}
        assert env["KAFKA_ADDR"] == "kafka:9092"
        assert env["ANOMALY_OTLP_PORT"] == "4318"
        assert env["FLAGD_FILE"] == "/app/flagd/demo.flagd.json"
        assert {p["containerPort"] for p in container["ports"]} == {4317, 4318, 4319, 9464, 9465}
        assert env["ANOMALY_QUERY_PORT"] == "9465"
        mounts = {m["mountPath"] for m in container["volumeMounts"]}
        assert "/var/lib/anomaly" in mounts and "/app/flagd" in mounts
        assert container["readinessProbe"]["tcpSocket"]["port"] == 4318
        assert container["livenessProbe"]["httpGet"]["port"] == 9464
        sb = idx[("Deployment", "anomaly-detector-standby")]
        sb_container = _containers(sb)[0]
        sb_env = {e["name"]: e["value"] for e in sb_container["env"]}
        assert sb_env["ANOMALY_ROLE"] == "standby"
        assert sb_env["ANOMALY_REPLICATION_TARGET"] == "anomaly-detector:4319"
        assert sb_env["ANOMALY_PRIMARY_HEALTH_ADDR"] == "anomaly-detector:4317"
        assert env.get("ANOMALY_ROLE") == "primary" and env["ANOMALY_REPLICATION_PORT"] == "4319"
        claims = {v["persistentVolumeClaim"]["claimName"] for v in sb["spec"]["template"]["spec"]["volumes"]
                  if "persistentVolumeClaim" in v}
        assert claims == {"anomaly-state-standby"}
        assert ("PersistentVolumeClaim", "anomaly-state-standby") in idx
        assert sb_container["readinessProbe"]["tcpSocket"]["port"] == 4318
        assert sb_container["livenessProbe"]["httpGet"]["port"] == 9464
        ha_svc = idx[("Service", "anomaly-detector-ha")]
        sel = set(ha_svc["spec"]["selector"].items())
        for d in (dep, sb):
            assert sel <= set(d["spec"]["template"]["metadata"]["labels"].items())
        assert {p["port"] for p in ha_svc["spec"]["ports"]} == {4317, 4318}

    def test_selectors_match_pod_labels(self):
        for docs in (k8s.standalone_stack(), k8s.sidecar_overlay()):
            idx = _by_kind_name(docs)
            for (kind, name), doc in idx.items():
                if kind != "Deployment":
                    continue
                pod_labels = set(doc["spec"]["template"]["metadata"]["labels"].items())
                assert set(doc["spec"]["selector"]["matchLabels"].items()) <= pod_labels
                svc = idx.get(("Service", name))
                if svc:
                    assert set(svc["spec"]["selector"].items()) <= pod_labels

    def test_minimal_stack_resources(self):
        idx = _by_kind_name(k8s.minimal_stack())
        assert ("Deployment", "kafka") not in idx
        for name in ("shop-gateway", "anomaly-detector", "load-generator"):
            assert ("Deployment", name) in idx, name
        shop = _containers(idx[("Deployment", "shop-gateway")])[0]
        assert "--minimal" in shop["command"] and "--kafka" not in shop["command"]
        assert "--otlp-endpoint" in shop["command"]
        det = _containers(idx[("Deployment", "anomaly-detector")])[0]
        assert "KAFKA_ADDR" not in {e["name"] for e in det["env"]}

    def test_minimal_stack_follows_the_minimal_compose_profile(self):
        """deploy/docker-compose.minimal.yml's reduction (a shop and a
        detector, no kafka, no consumer leg) is the port's minimal stack's."""
        doc = yaml.safe_load(open(REPO / "deploy" / "docker-compose.minimal.yml"))
        assert set(doc["services"]) == {"shop", "anomaly-detector"}
        assert "--minimal" in doc["services"]["shop"]["command"]
        assert not any(e.startswith("KAFKA_ADDR") for e in doc["services"]["anomaly-detector"]["environment"])
        deployments = {d["metadata"]["name"] for d in k8s.minimal_stack() if d["kind"] == "Deployment"}
        assert deployments == {"shop-gateway", "load-generator", "anomaly-detector", "anomaly-detector-standby"}

    def test_yaml_round_trip(self, tmp_path):
        paths = k8s.write_manifests(str(tmp_path))
        assert len(paths) == 3 + len(k8s.component_bundles()) + 2
        for p in paths:
            docs = list(yaml.safe_load_all(open(p)))
            assert all("apiVersion" in d and "kind" in d for d in docs)
        names = {p.split("/")[-1] for p in paths}
        assert {"kafka.yaml", "shop-gateway.yaml", "anomaly-detector.yaml", "load-generator.yaml",
                "anomaly-aggregator.yaml", "anomaly-fleet.yaml"} <= names
        standalone = {d["metadata"]["name"] for d in k8s.standalone_stack() if d["kind"] == "Deployment"}
        assert "anomaly-aggregator" not in standalone
        assert not any(n.startswith("anomaly-detector-shard-") for n in standalone)

    def test_flagd_configmap_carries_real_flags(self):
        cm = k8s._flagd_configmap()
        flags = yaml.safe_load(cm["data"]["demo.flagd.json"])
        assert "anomalyDetectorEnabled" in flags["flags"]
        assert cm["data"] == ref_k8s._flagd_configmap()["data"]


class TestGeneratorGuards:
    def test_probe_families_are_mutually_exclusive(self):
        with pytest.raises(ValueError, match="probe kinds"):
            k8s.deployment("x", "img", liveness_http=("/h", 1), tcp_probe_port=2)
        with pytest.raises(ValueError, match="probe kinds"):
            k8s.deployment("x", "img", readiness_http=("/h", 1), grpc_health_port=2)
        k8s.deployment("x", "img", liveness_http=("/h", 1), readiness_tcp_port=2)
        with pytest.raises(ValueError, match="readiness_tcp_port"):
            k8s.deployment("x", "img", grpc_health_port=1, readiness_tcp_port=2)

    def test_stale_component_files_pruned(self, tmp_path):
        stale = tmp_path / "components" / "removed-tier.yaml"
        stale.parent.mkdir()
        stale.write_text(k8s._GENERATED_MARKER + " — do not edit.\n")
        byhand = tmp_path / "components" / "ingress.yaml"
        byhand.write_text("kind: Ingress\n")
        # The reference's generations are not the port's: kept.
        theirs = tmp_path / "components" / "other-tier.yaml"
        theirs.write_text(ref_k8s._GENERATED_MARKER + " — do not edit.\n")
        k8s.write_manifests(str(tmp_path))
        assert not stale.exists()
        assert byhand.exists() and theirs.exists()
        assert (tmp_path / "components" / "kafka.yaml").exists()

    def test_kafka_recreate_strategy(self):
        dep = _by_kind_name(k8s.kafka_resources())[("Deployment", "kafka")]
        assert dep["spec"]["strategy"]["type"] == "Recreate"


# -- the generator against the reference's -------------------------------------------

STACKS = {
    "standalone": lambda m: m.standalone_stack(),
    "minimal": lambda m: m.minimal_stack(),
    "sidecar": lambda m: m.sidecar_overlay(),
    "aggregator": lambda m: m.aggregator_resources(shards=3),
    "fleet": lambda m: m.fleet_shard_resources(shards=3, services=tuple(m.FLEET_DEFAULT_SERVICES)),
}


def _port_command(ref_command):
    """The port's entry point for a reference container's command (None:
    the reference image's default entry point, the detector)."""
    if ref_command is None:
        return ["python", "-m", "opentelemetry_demo_tpu_torch"]
    if ref_command[:2] == ["python", "scripts/serve_shop.py"]:
        return ["python", "-m", "opentelemetry_demo_tpu_torch.serve_shop", *ref_command[2:]]
    if ref_command == ["python", "scripts/serve_kafka.py"]:
        return ["python", "-m", "opentelemetry_demo_tpu_torch.serve_kafka"]
    assert ref_command[:3] == ["python", "-m", "opentelemetry_demo_tpu.runtime.aggregator"], ref_command
    return ["python", "-m", "opentelemetry_demo_tpu_torch.runtime.aggregator", *ref_command[3:]]


def _masked(doc, module):
    """``doc`` with the named fields replaced by placeholders."""
    doc = copy.deepcopy(doc)

    def walk(node):
        if isinstance(node, dict):
            for k, v in list(node.items()):
                if k == module.PART_OF and v == module.STACK:
                    node[k] = "<stack>"
                elif k == "image" and v in (module.IMAGE_DETECTOR, module.IMAGE_GATEWAY):
                    node[k] = "<image:" + v.rsplit(":", 1)[1] + ">"
                else:
                    walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(doc)
    for c in _containers(doc):
        c.pop("command", None)
        c["resources"]["limits"].pop("nvidia.com/gpu", None)
    return doc


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_documents_equal_the_references_but_the_named_fields(stack):
    ref_docs, docs = STACKS[stack](ref_k8s), STACKS[stack](k8s)
    assert [(d["kind"], d["metadata"]["name"]) for d in docs] == [
        (d["kind"], d["metadata"]["name"]) for d in ref_docs]
    for ref_doc, doc in zip(ref_docs, docs):
        assert _masked(doc, k8s) == _masked(ref_doc, ref_k8s)
        for ref_c, c in zip(_containers(ref_doc), _containers(doc)):
            assert c.get("command") == _port_command(ref_c.get("command")), c["name"]
    assert k8s.to_yaml(docs).count("opentelemetry_demo_tpu.") == 0


def test_gpu_limit_on_every_detector_container_only():
    """Every container that runs ``python -m opentelemetry_demo_tpu_torch``
    asks for one card; no other container asks for any."""
    seen = set()
    for build in STACKS.values():
        for doc in build(k8s):
            for c in _containers(doc):
                gpu = c["resources"]["limits"].get("nvidia.com/gpu")
                if c["command"] == k8s.DETECTOR_COMMAND:
                    assert gpu == 1, c["name"]
                    seen.add(c["name"])
                else:
                    assert gpu is None, c["name"]
    assert {"anomaly-detector", "anomaly-detector-standby", "anomaly-detector-shard-0"} <= seen


def test_written_files_name_the_port(tmp_path):
    paths = k8s.write_manifests(str(tmp_path / "port"))
    ref_paths = ref_k8s.write_manifests(str(tmp_path / "ref"))
    names = [os.path.relpath(p, tmp_path / "port") for p in paths]
    ref_names = [os.path.relpath(p, tmp_path / "ref") for p in ref_paths]
    assert names == [n.replace("opentelemetry-demo-tpu", "opentelemetry-demo-tpu-torch") for n in ref_names]
    for p in paths:
        first = open(p).readline()
        assert first.startswith("# Generated by opentelemetry_demo_tpu_torch.utils.k8s")


def test_manifests_default_to_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    paths = k8s.write_manifests()
    assert paths and all(Path(p).resolve().is_relative_to(tmp_path / "build" / "k8s_torch") for p in paths)
    monkeypatch.setattr(sys, "argv", ["k8s"])
    k8s.main()
    assert sorted(os.listdir(tmp_path)) == ["build"]
    assert not (tmp_path / "deploy").exists()


# -- serve_shop ----------------------------------------------------------------------


def _serve(tmp_path, *args):
    return subprocess.Popen(
        [sys.executable, "-m", "opentelemetry_demo_tpu_torch.serve_shop", "--device", "cpu",
         "--port", "0", "--users", "0", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path)}, cwd=REPO,
    )


def _port_of(line: str) -> int:
    return int(line.split(":")[2].split()[0].rstrip("/").split("/")[0])


class TestServeShop:
    def test_serve_shop_end_to_end(self, tmp_path):
        proc = _serve(tmp_path)
        try:
            line = proc.stdout.readline()
            assert "shop gateway on" in line, line
            base = f"http://127.0.0.1:{_port_of(line)}"

            def get(path):
                with urllib.request.urlopen(base + path, timeout=30) as r:
                    return r.status, r.read()

            assert get("/health")[0] == 200
            status, body = get("/api/products")
            assert status == 200 and b"products" in body
            assert get("/feature/")[0] == 200
            assert get("/metrics")[0] == 200
            assert "loadgen control at" in proc.stdout.readline()
        finally:
            proc.terminate()
            proc.wait(timeout=20)

    def test_serve_shop_minimal_profile(self, tmp_path):
        proc = _serve(tmp_path, "--minimal")
        try:
            line = proc.stdout.readline()
            assert "shop gateway on" in line and "minimal" in line, line
            base = f"http://127.0.0.1:{_port_of(line)}"

            def get(path):
                with urllib.request.urlopen(base + path, timeout=30) as r:
                    return r.status, r.read()

            def post(path, payload):
                req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                             headers={"Content-Type": "application/json"}, method="POST")
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status, r.read()

            status, body = get("/api/products")
            assert status == 200 and b"products" in body
            post("/api/cart", {"userId": "m", "item": {"productId": "TEL-DOB-10", "quantity": 1}})
            status, body = post("/api/checkout", {"userId": "m", "currencyCode": "USD", "email": "m@x.io"})
            assert status == 200 and json.loads(body)["orderId"]
            with pytest.raises(urllib.error.HTTPError) as exc:
                get("/feature/")
            assert exc.value.code == 503
            with pytest.raises(urllib.error.HTTPError) as exc:
                post("/ofrep/v1/evaluate/flags/noSuchFlag", {})
            assert exc.value.code == 404
            assert b"FLAG_NOT_FOUND" in exc.value.read()
        finally:
            proc.terminate()
            proc.wait(timeout=20)

    def test_serve_shop_takes_the_card_unless_told_otherwise(self, monkeypatch):
        """In-process mode builds the detector on the card by default:
        with no card it raises before anything listens."""
        from opentelemetry_demo_tpu_torch.serve_shop import build, parser

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(parser().parse_args(["--host", "127.0.0.1", "--port", "0"]))

    def test_serve_shop_flags_are_the_references(self):
        """The reference script's flags, defaults and help, plus ``--device``."""
        from opentelemetry_demo_tpu_torch.serve_shop import parser

        text = (REPO / "scripts" / "serve_shop.py").read_text()
        ours = {a.dest: a.default for a in parser()._actions if a.dest != "help"}
        for dest in ours:
            if dest != "device":
                assert f'"--{dest.replace("_", "-")}"' in text, dest
        assert ours["device"] is None and ours["batch"] == 512 and ours["grpc_port"] == -1

    def test_stack_builds_in_process_on_the_cpu(self):
        """``build`` returns the running stack: the gateway answers, the
        pipeline takes its flushes, ``close`` drains it."""
        from opentelemetry_demo_tpu_torch.serve_shop import build, parser

        stack = build(parser().parse_args(["--host", "127.0.0.1", "--port", "0", "--device", "cpu"]))
        try:
            base = f"http://127.0.0.1:{stack.gateway.port}"
            for _ in range(3):
                req = urllib.request.Request(base + "/api/cart", data=json.dumps(
                    {"userId": "b", "item": {"productId": "TEL-DOB-10", "quantity": 1}}).encode(),
                    headers={"Content-Type": "application/json"}, method="POST")
                with urllib.request.urlopen(req, timeout=30) as r:
                    assert r.status == 200
            assert stack.pipeline.detector.device.type == "cpu"
            assert stack.pipeline.detector.config.num_services == 32
            assert stack.pipeline.tensorizer.batch_size == 512
            assert stack.lines[0].startswith("shop gateway on http://127.0.0.1:")
            assert stack.lines[-1].endswith("/loadgen")
        finally:
            stack.close()
        assert stack.pipeline.stats.spans > 0
