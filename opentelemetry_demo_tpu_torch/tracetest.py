"""Trace-based testing: the framework's Tracetest analogue.

The reference's primary test strategy is trace-based integration testing
(SURVEY.md §4): a Tracetest server triggers one real request against the
live stack and asserts on the *resulting distributed trace* — e.g.
test/tracetesting/checkout/place-order.yaml triggers
``CheckoutService/PlaceOrder`` and asserts the response body, the
``rpc.grpc.status_code`` on the checkout span, and the existence of a
Kafka ``orders publish`` producer span; run.bash fans suites out in
parallel and max-reduces their exit codes (:88-108).

This module is that harness for the PyTorch build, speaking the same spec
shape (YAML, ``type: Test`` / ``spec.trigger`` / ``spec.specs`` with
selectors + assertions) against the real HTTP edge:

- **Trigger**: one HTTP request to a :class:`~.services.gateway.ShopGateway`
  (plus optional ``setup`` requests, e.g. filling a cart before
  checkout), with a fresh generated trace id in the ``traceparent``
  header — the Tracetest trigger span analogue. ``type: grpc`` triggers
  drive the :class:`~.services.grpc_edge.GrpcShopEdge` instead, exactly
  like the reference's gRPC triggers (``tracetest.yaml`` ``trigger.grpc``
  blocks): the method path names the oteldemo RPC, the request is the
  message as YAML, and protoc-generated stubs (compiled on demand, the
  same build-artifact policy as tests/test_proto_contract.py) do the
  JSON↔protobuf mapping via descriptor reflection.
- **Selector**: ``{service: ..., name: ...}`` picks spans of the
  triggered trace (name = substring match, like tracetest's
  ``span[name=...]`` selectors on our reduced span model).
- **Assertions**: over the selected span set (``count``/``error_count``
  with ``gte/lte/eq/ne/lt/gt`` ops, ``duration_us`` bounds, ``attr``
  values) or over the JSON response body (``json_path`` dotted paths,
  the ``tracetest.response.body | json_path`` analogue).

Suites live in ``tracetesting/<service>/*.yaml`` at the repo root,
mirroring the reference's per-service directories; the runner
(`python -m opentelemetry_demo_tpu_torch.tracetest`) boots a Shop + gateway,
fans the suites out across worker threads, prints per-test results, and
exits with the max status — the run.bash contract.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
import uuid
from dataclasses import dataclass, field
from pathlib import Path

from .runtime.tensorize import SpanRecord
from .telemetry.tracer import TraceContext

_OPS = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "lte": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "gte": lambda a, b: a >= b,
    "contains": lambda a, b: b in str(a),
}


@dataclass
class CheckResult:
    test_id: str
    name: str
    passed: bool
    detail: str = ""


@dataclass
class TestResult:
    test_id: str
    name: str
    checks: list[CheckResult] = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return all(c.passed for c in self.checks)


def _json_path(doc, path: str):
    """Dotted-path lookup (the json_path subset the reference specs use)."""
    cur = doc
    for part in path.split("."):
        if isinstance(cur, list):
            try:
                cur = cur[int(part)]
            except (IndexError, ValueError):
                return None  # absent element asserts like a missing key
        elif isinstance(cur, dict):
            if part not in cur:
                return None
            cur = cur[part]
        else:
            return None
    return cur


def _select(spans: list[SpanRecord], selector: dict) -> list[SpanRecord]:
    out = spans
    if "service" in selector:
        out = [s for s in out if s.service == selector["service"]]
    if "name" in selector:
        out = [s for s in out if selector["name"] in (s.name or "")]
    if selector.get("error") is not None:
        out = [s for s in out if s.is_error == bool(selector["error"])]
    return out


def _check_assertion(spec: dict, spans: list[SpanRecord], response) -> tuple[bool, str]:
    """One assertion against the selected span set / response body."""
    op_name = spec.get("op", "eq")
    op = _OPS.get(op_name)
    if op is None:
        return False, f"unknown op {op_name!r}"
    expect = spec.get("value")

    if "json_path" in spec:
        actual = _json_path(response or {}, spec["json_path"])
        ok = actual is not None and op(actual, expect)
        return ok, f"json_path {spec['json_path']} = {actual!r} (want {op_name} {expect!r})"

    metric = spec.get("metric", "count")
    if metric == "count":
        actual = len(spans)
    elif metric == "error_count":
        actual = sum(1 for s in spans if s.is_error)
    elif metric == "event_count":
        # Span events over the selected set; `event:` narrows to one
        # event name (the reference asserts e.g. checkout's "charged"
        # narration — main.go:286).
        want = spec.get("event")
        actual = sum(
            1 for s in spans for e in s.events
            if want is None or e.name == want
        )
    elif metric == "duration_us_max":
        actual = max((s.duration_us for s in spans), default=0.0)
    elif metric == "duration_us_min":
        actual = min((s.duration_us for s in spans), default=0.0)
    elif metric == "attr":
        # Every selected span's monitored attribute must satisfy the op.
        bad = [s.attr for s in spans if not op(s.attr or "", expect)]
        return (len(spans) > 0 and not bad), f"attr values bad={bad!r} over {len(spans)} spans"
    else:
        return False, f"unknown metric {metric!r}"
    return op(actual, expect), f"{metric} = {actual!r} (want {op_name} {expect!r})"


class _GrpcStubs:
    """protoc-compiled demo.proto stubs + descriptor-driven codecs.

    Lazily compiled once per runner (stubs are build artifacts, not
    sources — the gen_proto.sh policy); YAML request dicts map to
    protobuf via json_format, responses map back for json_path
    assertions, mirroring Tracetest's reflection-based gRPC trigger.
    """

    def __init__(self):
        import subprocess
        import sys
        import tempfile

        repo_root = Path(__file__).resolve().parent.parent
        # Held on the instance so the stubs dir lives exactly as long
        # as the runner and is removed on GC/interpreter exit.
        self._tmp = tempfile.TemporaryDirectory(prefix="tracetest_pb_")
        subprocess.run(
            ["protoc", "--python_out", self._tmp.name, "proto/demo.proto"],
            check=True,
            cwd=repo_root,
        )
        sys.path.insert(0, str(Path(self._tmp.name) / "proto"))
        try:
            import demo_pb2  # noqa: F401

            self.pb2 = demo_pb2
        finally:
            sys.path.remove(str(Path(self._tmp.name) / "proto"))

    def method(self, full_method: str):
        """"oteldemo.Service/Method" → (path, req_cls, resp_cls)."""
        from google.protobuf import message_factory

        service_path, method_name = full_method.split("/", 1)
        _pkg, service_name = service_path.rsplit(".", 1)
        svc_desc = self.pb2.DESCRIPTOR.services_by_name[service_name]
        m = svc_desc.FindMethodByName(method_name)
        return (
            f"/{service_path}/{method_name}",
            message_factory.GetMessageClass(m.input_type),
            message_factory.GetMessageClass(m.output_type),
        )


class TraceTestClient:
    """Triggers spec'd requests against a gateway and collects the trace.

    ``span_log`` must be the (shared) list every gateway ``on_spans``
    flush appends to; the client filters it by the trigger's trace id.
    ``grpc_target`` (host:port of a GrpcShopEdge over the SAME shop)
    enables ``type: grpc`` triggers.
    """

    def __init__(self, base_url: str, span_log: list, pump, lock: threading.Lock,
                 grpc_target: str | None = None):
        self.base_url = base_url.rstrip("/")
        self.span_log = span_log
        self.pump = pump  # flushes pending shop spans into span_log
        self.lock = lock
        self.grpc_target = grpc_target
        self._stubs: _GrpcStubs | None = None
        self._channel = None
        self._grpc_init_lock = threading.Lock()

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None

    def _grpc_call(self, grpc_spec: dict, trace_id: str):
        import grpc
        from google.protobuf import json_format

        # Parallel suites share this client: one protoc compile, one
        # channel.
        with self._grpc_init_lock:
            if self._stubs is None:
                self._stubs = _GrpcStubs()
            if self._channel is None:
                if self.grpc_target is None:
                    raise RuntimeError("suite uses a grpc trigger but the "
                                       "rig has no gRPC edge")
                self._channel = grpc.insecure_channel(self.grpc_target)
        path, req_cls, resp_cls = self._stubs.method(grpc_spec["method"])
        request = json_format.ParseDict(
            grpc_spec.get("request", {}), req_cls()
        )
        fn = self._channel.unary_unary(
            path,
            request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString,
        )
        metadata = tuple(
            TraceContext(trace_id=bytes.fromhex(trace_id)).to_headers().items()
        )
        try:
            resp = fn(request, timeout=30, metadata=metadata)
        except grpc.RpcError as e:
            return int(e.code().value[0]), None
        return 0, json_format.MessageToDict(resp)  # grpc OK

    def _request(self, http_spec: dict, trace_id: str):
        body = http_spec.get("body")
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base_url + http_spec["path"],
            data=data,
            method=http_spec.get("method", "GET"),
            headers={
                "Content-Type": "application/json",
                **TraceContext(trace_id=bytes.fromhex(trace_id)).to_headers(),
                **http_spec.get("headers", {}),
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                payload = resp.read()
                status = resp.status
        except urllib.error.HTTPError as e:
            payload = e.read()
            status = e.code
        try:
            doc = json.loads(payload) if payload else None
        except json.JSONDecodeError:
            doc = None
        return status, doc

    def run_test(self, doc: dict) -> TestResult:
        spec = doc.get("spec", doc)
        result = TestResult(test_id=spec.get("id", "?"), name=spec.get("name", "?"))
        trace_id = uuid.uuid4().hex
        kind = spec["trigger"].get("type", "http")

        if kind == "grpc":
            trigger = spec["trigger"]["grpc"]
            for setup in trigger.get("setup", []):
                self._grpc_call(setup, trace_id)
            status, response = self._grpc_call(trigger, trace_id)
            want_status = trigger.get("expect_status", 0)  # grpc OK
            status_detail = f"grpc status {status} (want {want_status})"
        else:
            trigger = spec["trigger"]["http"]
            # Setup requests ride the same trace (cart fill first).
            for setup in trigger.get("setup", []):
                self._request(setup, trace_id)
            status, response = self._request(trigger, trace_id)
            want_status = trigger.get("expect_status", 200)
            status_detail = f"HTTP {status} (want {want_status})"
        self.pump()
        with self.lock:
            spans = [
                s for s in self.span_log
                if isinstance(s.trace_id, bytes) and s.trace_id.hex() == trace_id
            ]

        result.checks.append(CheckResult(
            result.test_id, "trigger status",
            status == want_status, status_detail,
        ))
        for check in spec.get("specs", []):
            selected = _select(spans, check.get("selector", {}))
            for assertion in check.get("assertions", []):
                ok, detail = _check_assertion(assertion, selected, response)
                result.checks.append(
                    CheckResult(result.test_id, check.get("name", "?"), ok, detail)
                )
        return result


def load_suites(root: str | Path) -> dict[str, list[dict]]:
    """``tracetesting/<service>/*.yaml`` → {suite name: [test docs]}."""
    import yaml

    suites: dict[str, list[dict]] = {}
    root = Path(root)
    for path in sorted(root.glob("*/*.yaml")):
        docs = [d for d in yaml.safe_load_all(path.read_text()) if d]
        suites.setdefault(path.parent.name, []).extend(
            d for d in docs if d.get("type") == "Test"
        )
    return suites


def run_suites(
    client: TraceTestClient,
    suites: dict[str, list[dict]],
    parallel: bool = True,
) -> tuple[list[TestResult], int]:
    """Fan suites out, max-reduce exit codes (run.bash:88-108)."""
    results: list[TestResult] = []
    results_lock = threading.Lock()
    exit_codes: dict[str, int] = {}

    def run_suite(name: str, tests: list[dict]):
        code = 0
        for doc in tests:
            try:
                res = client.run_test(doc)
            except Exception as e:  # a broken spec fails its suite
                res = TestResult(test_id=name, name=str(doc.get("spec", {}).get("name", "?")))
                res.checks.append(CheckResult(name, "harness", False, f"exception: {e}"))
            with results_lock:
                results.append(res)
            if not res.passed:
                code = 1
        exit_codes[name] = code

    if parallel:
        threads = [
            threading.Thread(target=run_suite, args=(n, t), name=f"suite-{n}")
            for n, t in suites.items()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        for n, t in suites.items():
            run_suite(n, t)
    return results, max(exit_codes.values(), default=0)


def make_rig(seed: int = 0):
    """Boot a Shop + gateway (+ gRPC edge) + span log.

    Returns (gateway, client, stop); the edge serves the same shop under
    the gateway's lock so HTTP and gRPC triggers hit one object graph.
    """
    from .services import Shop, ShopConfig, ShopGateway
    from .utils.flag_ui import FlagEditorUI

    shop = Shop(ShopConfig(users=0, seed=seed))
    span_log: list[SpanRecord] = []
    lock = threading.Lock()

    def on_spans(t, spans):
        with lock:
            span_log.extend(spans)

    gw = ShopGateway(shop, host="127.0.0.1", port=0, on_spans=on_spans)
    gw.feature_ui = FlagEditorUI(shop.flags)
    gw.start()

    grpc_target = None
    edge = None
    try:
        from .services.grpc_edge import GrpcShopEdge

        edge = GrpcShopEdge(shop, host="127.0.0.1", port=0, lock=gw._lock)
        edge.start()
        grpc_target = f"127.0.0.1:{edge.port}"
    except ImportError:  # grpcio absent: HTTP triggers only
        pass
    except Exception:
        # Edge bind/boot failure must not leak a serving gateway.
        gw.stop()
        raise

    def pump():
        with gw._lock:
            gw._pump_locked()

    client = TraceTestClient(
        f"http://127.0.0.1:{gw.port}", span_log, pump, lock,
        grpc_target=grpc_target,
    )

    def stop():
        client.close()
        if edge is not None:
            edge.stop()
        gw.stop()

    return gw, client, stop


def main(argv: list[str] | None = None) -> int:
    """CLI: boot the shop, run every suite, print results, max exit code."""
    import argparse

    parser = argparse.ArgumentParser(description="trace-based test runner")
    parser.add_argument(
        "suites_dir", nargs="?", default="tracetesting",
        help="directory of per-service suite dirs (default: tracetesting)",
    )
    parser.add_argument("--serial", action="store_true", help="no suite fan-out")
    args = parser.parse_args(argv)

    suites = load_suites(args.suites_dir)
    if not suites:
        print(f"no suites under {args.suites_dir}")
        return 2
    gw, client, stop = make_rig()
    try:
        results, code = run_suites(client, suites, parallel=not args.serial)
    finally:
        stop()
    print(format_results(results))
    return code


def format_results(results: list[TestResult]) -> str:
    lines = []
    for res in sorted(results, key=lambda r: r.test_id):
        mark = "PASS" if res.passed else "FAIL"
        lines.append(f"[{mark}] {res.test_id}: {res.name}")
        for c in res.checks:
            if not c.passed:
                lines.append(f"       ✗ {c.name}: {c.detail}")
    n_pass = sum(r.passed for r in results)
    lines.append(f"{n_pass}/{len(results)} trace tests passed")
    return "\n".join(lines)


if __name__ == "__main__":
    raise SystemExit(main())
