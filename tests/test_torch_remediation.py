"""The port's remediation controller against the reference.

Each scenario of the reference's controller suite that runs without the
daemon (guardrails, actuator safety, role and fencing, the pre-flight
park/release/refuse flow) is written once and driven through both
packages: after every observed report the controller's state, its
stats, the token bucket, every actuator's writes and the flag document
are recorded, and the two packages' records must be equal. The flagd
chaos cases (a dead, a blackholed and a torn-JSON flag editor) run
against the port, as the reference's suite runs them against the
reference. ``CollectorActuator`` policy files and ``FlagFileStore``
documents compare byte for byte; ``SamplingActuator`` republishes into
``HistoryWriter.set_span_sample``.

Tolerance: everything compares exactly; the TTM samples are virtual
time. Wall-clock fields (flight events' ``t`` and ``verdict_s``) are
dropped.

The reference's ``RemediationController.drain`` reads "worker idle" and
"queue empty" apart, so a job the worker pops between the two readings
passes for done (ROADMAP §C, :func:`test_drain_waits_for_a_job_popped_while_it_reads`).
Every test here gives the reference's controller the port's one reading
under the lock, so a recorded step never depends on how the host
schedules the worker.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from opentelemetry_demo_tpu.runtime import flightrec as jflightrec
from opentelemetry_demo_tpu.runtime import history as jhistory
from opentelemetry_demo_tpu.runtime import remediation as jremediation
from opentelemetry_demo_tpu.runtime import replication as jreplication
from opentelemetry_demo_tpu.runtime import shadow as jshadow
from opentelemetry_demo_tpu.utils import flags as jflags
from opentelemetry_demo_tpu_torch.runtime import flightrec, history, remediation, replication, shadow
from opentelemetry_demo_tpu_torch.utils import flags

PKGS = {
    "port": types.SimpleNamespace(rem=remediation, flags=flags, flight=flightrec, fence=replication.EpochFence,
                                  shadow=shadow, history=history),
    "reference": types.SimpleNamespace(rem=jremediation, flags=jflags, flight=jflightrec,
                                       fence=jreplication.EpochFence, shadow=jshadow, history=jhistory),
}
FLAG = "recommendationCacheFailure"
SVC = "recommendation"


@pytest.fixture(autouse=True)
def steady_reference_drain(monkeypatch):
    monkeypatch.setattr(jremediation.RemediationController, "drain", remediation.RemediationController.drain)


def _doc(default="on", key=FLAG, variants=None) -> dict:
    return {"flags": {key: {"state": "ENABLED", "variants": variants or {"on": True, "off": False},
                            "defaultVariant": default}}}


class Rig:
    """One package's controller, actuators and a recorder of what they
    do after each observed report."""

    def __init__(self, pkg, tmp_path, actuators=("flagd",), doc=None, policy=None, **kw):
        self.pkg = pkg
        self.store = pkg.flags.FlagEvaluator(doc or _doc())
        self.published: list = []
        self.flight = pkg.flight.FlightRecorder(dump_dir=str(tmp_path), clock=lambda: 0.0)
        acts = []
        if "flagd" in actuators:
            self.flagd = pkg.rem.FlagdActuator(store=self.store, policy=policy or {SVC: (FLAG,)})
            acts.append(self.flagd)
        if "sampling" in actuators:
            self.sampler = pkg.rem.SamplingActuator(
                publish=lambda pol, seeds: self.published.append((dict(pol), dict(seeds))),
                base_policy={"*": 0.1}, exemplar_fn=lambda svc: ["aabbccdd"])
            acts.append(self.sampler)
        acts += [a(pkg) if callable(a) else a for a in kw.pop("extra", ())]
        kw.setdefault("enabled", True)
        kw.setdefault("act_batches", 3)
        kw.setdefault("clear_batches", 4)
        kw.setdefault("budget", 4)
        kw.setdefault("budget_refill_s", 1e9)
        kw.setdefault("deadline_s", 30.0)
        self.ctrl = pkg.rem.RemediationController(acts, flight=self.flight, **kw)
        self.t = 0.0
        self.trace: list = []

    def observe(self, n, flagged, services=(SVC,), dt=0.25):
        for _ in range(n):
            self.ctrl.observe(self.t, list(flagged), services=list(services))
            self.t += dt
            assert self.ctrl.drain(10.0)
            self.record()

    def record(self):
        st = self.ctrl.stats()
        self.trace.append(dict(
            stats=st,
            doc=json.dumps(self.store.snapshot(), sort_keys=True),
            writes=getattr(getattr(self, "flagd", None), "writes", None),
            published=list(self.published),
            ttm=self.ctrl.take_ttm_samples(),
            preflight=self.ctrl.take_preflight_samples() and None,
        ))

    def finish(self):
        self.ctrl.close()
        events = [{k: v for k, v in ev.items() if k not in ("t", "verdict_s")} for ev in self.flight.snapshot()]
        d = self.flight.dump_dir
        return self.trace, events, sorted(os.listdir(d)) if os.path.isdir(d) else []


def _hysteresis(r):
    r.observe(2, [SVC])
    r.observe(4, [])


def _roundtrip(r):
    r.observe(3, [SVC])
    r.observe(4, [])


def _flapping(r):
    for _ in range(20):
        r.observe(2, [SVC])
        r.observe(2, [])


def _rollback(r):
    r.observe(3, [SVC])
    r.observe(12, [SVC])
    r.observe(2, [])
    r.observe(4, [])


def _act_revert_rollback(r):
    r.observe(3, [SVC])
    r.observe(2, [])
    r.observe(3, [SVC])
    r.observe(12, [SVC])


def _shared_flag(r):
    both = ["checkout", "fraud-detection"]
    r.observe(2, both, services=both)
    r.observe(2, ["fraud-detection"], services=both)
    r.observe(2, [], services=both)


class _Flaky:
    name = "flaky"

    def __init__(self, pkg):
        self.revert_calls: list = []

    def apply(self, service):
        return {"token": "T"}

    def revert(self, service, token):
        self.revert_calls.append(token)
        if len(self.revert_calls) == 1:
            raise OSError("transient RST")


class _Dead:
    name = "dead"

    def __init__(self, pkg):
        pass

    def apply(self, service):
        raise OSError("blackholed")

    def revert(self, service, token):
        raise OSError("blackholed")


def _preflight(answers):
    """A pre-flight gate answering from ``answers`` in turn: a package's
    own ``PreflightVerdict`` (released or refused) or a bare bool."""
    def make(pkg):
        it = iter(answers)

        def gate(_svc):
            a = next(it)
            if isinstance(a, bool):
                return a
            return pkg.shadow.refused(a) if a != "cleared" else pkg.shadow.refused(a)._replace(would_help=True)

        return gate

    return make


def _with_preflight(answers, **kw):
    return lambda pkg: dict(kw, preflight=_preflight(answers)(pkg))


SCENARIOS = {
    "hysteresis": (_hysteresis, {}, ("flagd",)),
    "act_verify_revert": (_roundtrip, {}, ("flagd", "sampling")),
    "flapping_cannot_oscillate": (_flapping, dict(act_batches=2, clear_batches=2, budget=2), ("flagd",)),
    "rollback_on_failed_recovery": (_rollback, dict(deadline_s=2.0), ("flagd",)),
    "flight_evidence": (_act_revert_rollback, dict(deadline_s=2.0, clear_batches=2), ("flagd",)),
    "transient_revert_failure": (
        _roundtrip, dict(act_batches=2, clear_batches=2, retry_attempts=3, backoff_cap_s=0.02, extra=(_Flaky,)), ()),
    "failed_apply_refunds": (
        lambda r: r.observe(2, [SVC]), dict(act_batches=2, budget=2, retry_attempts=2, backoff_cap_s=0.01,
                                            extra=(_Dead,)), ()),
    "standby_never_actuates": (lambda r: r.observe(10, [SVC]), dict(role_fn=lambda: "standby"), ("flagd",)),
    "observe_only": (lambda r: r.observe(10, [SVC]), dict(enabled=False), ("flagd",)),
    "preflight_released": (_roundtrip, _with_preflight(["cleared"]), ("flagd", "sampling")),
    "preflight_refused_then_released": (
        lambda r: (r.observe(3, [SVC]), r.observe(3, [SVC]), r.observe(4, [])),
        _with_preflight([shadow.REASON_STILL_FLAGGED, True]), ("flagd",)),
    "preflight_refused_bool": (lambda r: r.observe(6, [SVC]), _with_preflight([False, False]), ("flagd",)),
    "preflight_deadline": (lambda r: r.observe(4, [SVC]), _with_preflight([shadow.REASON_DEADLINE]), ("flagd",)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_runs_as_the_reference_runs_it(tmp_path, name):
    drive, kw, actuators = SCENARIOS[name]
    out = {}
    for pkg_name, pkg in PKGS.items():
        kwargs = kw(pkg) if callable(kw) else dict(kw)
        doc, policy = None, None
        if name == "shared_flag":
            doc = _doc(key="kafkaQueueProblems", variants={"on": 100, "off": 0})
            policy = {"checkout": ("kafkaQueueProblems",), "fraud-detection": ("kafkaQueueProblems",)}
        rig = Rig(pkg, tmp_path / pkg_name, actuators=actuators, doc=doc, policy=policy, **kwargs)
        drive(rig)
        out[pkg_name] = rig.finish()
    assert out["port"] == out["reference"]
    trace, events, dumps = out["port"]
    last = trace[-1]["stats"]
    if name == "act_verify_revert":
        assert last["verified"] == 1 and json.loads(trace[-1]["doc"])["flags"][FLAG]["state"] == "ENABLED"
        assert any(t["ttm"] for t in trace) and trace[-1]["published"][-1][0] == {"*": 0.1}
    if name == "flapping_cannot_oscillate":
        assert last["actions"] == {"flagd": 2} and last["budget_exhausted"] > 0
    if name == "rollback_on_failed_recovery":
        assert last["rollbacks"] == 1 and any(d.startswith("flight-mitigation-failed-") for d in dumps)
    if name == "failed_apply_refunds":
        assert last["actions"] == {} and last["tokens"] == 2.0 and last["actuator_errors"] == 1
    if name == "standby_never_actuates":
        assert last["refused_role"] == 1 and trace[-1]["writes"] == 0
    if name == "preflight_refused_then_released":
        assert last["preflight_verdicts"] == {"refused": 1, "released": 1}
        assert any(d.startswith("flight-preflight-refused-") for d in dumps)


def test_shared_flag_is_released_only_by_its_last_holder(tmp_path):
    out = {}
    for pkg_name, pkg in PKGS.items():
        rig = Rig(pkg, tmp_path / pkg_name, doc=_doc(key="kafkaQueueProblems", variants={"on": 100, "off": 0}),
                  policy={"checkout": ("kafkaQueueProblems",), "fraud-detection": ("kafkaQueueProblems",)},
                  act_batches=2, clear_batches=2)
        _shared_flag(rig)
        out[pkg_name] = rig.finish()
    assert out["port"] == out["reference"]
    states = [json.loads(t["doc"])["flags"]["kafkaQueueProblems"]["state"] for t in out["port"][0]]
    assert states[1:4] == ["DISABLED"] * 3 and states[-1] == "ENABLED"


def test_a_fenced_process_actuates_nothing(tmp_path):
    out = {}
    for pkg_name, pkg in PKGS.items():
        fence = pkg.fence(0)
        fence.observe(5)
        rig = Rig(pkg, tmp_path / pkg_name, fence=fence)
        rig.observe(5, [SVC])
        out[pkg_name] = (rig.finish(), fence.fenced_by_path)
    assert out["port"] == out["reference"]
    assert out["port"][1]["remediation"] >= 1 and out["port"][0][0][-1]["writes"] == 0


def test_token_bucket_refills_as_the_reference_bucket():
    got, want = remediation.TokenBucket(2, 10.0), jremediation.TokenBucket(2, 10.0)
    seq = []
    for t in (0.0, 0.0, 0.0, 3.0, 10.0, 10.0, 25.0, 24.0, 60.0):
        got.advance(t)
        want.advance(t)
        seq.append((got.take(), want.take(), got.tokens, want.tokens))
    assert all(a == b and c == d for a, b, c, d in seq)


def test_flag_file_store_documents_are_byte_identical(tmp_path):
    files = {}
    for pkg_name, pkg in PKGS.items():
        path = tmp_path / pkg_name / "flags.json"
        path.parent.mkdir()
        path.write_text(json.dumps(_doc()))
        store = pkg.flags.FlagFileStore(str(path))
        act = pkg.rem.FlagdActuator(store=store, policy={SVC: (FLAG,)})
        token = act.apply(SVC)
        after_apply = path.read_bytes()
        act.revert(SVC, token)
        files[pkg_name] = (token, after_apply, path.read_bytes(), act.writes)
    assert files["port"] == files["reference"]
    assert json.loads(files["port"][1])["flags"][FLAG]["state"] == "DISABLED"


def test_collector_policy_documents_are_byte_identical(tmp_path):
    out = {}
    for pkg_name, pkg in PKGS.items():
        path = tmp_path / pkg_name / "policy.json"
        path.parent.mkdir()
        names = ["frontend", "cart", "payment", "ad"]
        col = pkg.rem.CollectorActuator(policy_path=str(path), base_keep=0.1,
                                        exemplar_fn=lambda svc: [f"{svc}-ex"], services_fn=lambda: names)
        steps = []
        t1 = col.apply("payment")
        steps.append((path.read_bytes(), col.keep_ratio()))
        t2 = col.apply("cart")
        col.apply("cart")  # joins the hold
        steps.append((path.read_bytes(), col.keep_ratio(), col.render_policy()))
        col.revert("cart", t2)
        steps.append((path.read_bytes(), col.keep_ratio()))
        col.revert("cart", t2)
        col.revert("payment", t1)
        steps.append((path.exists(), col.keep_ratio(), col.writes))
        # An existing file is restored exactly at the last release.
        path.write_text('{"operator": "owned"}')
        t3 = col.apply("ad")
        col.revert("ad", t3)
        steps.append((path.read_bytes(), col.writes))
        out[pkg_name] = steps
    assert out["port"] == out["reference"]
    assert out["port"][3][0] is False and json.loads(out["port"][4][0]) == {"operator": "owned"}


def test_the_sampling_actuator_republishes_into_the_history_writer(tmp_path):
    out = {}
    for pkg_name, pkg in PKGS.items():
        store = pkg.history.HistoryStore(str(tmp_path / pkg_name))
        writer = pkg.history.HistoryWriter(store, lambda: ({}, {}), capture_spans=True,
                                           span_sample={"*": 0.05})
        sampler = pkg.rem.SamplingActuator(publish=lambda pol, seeds: writer.set_span_sample(pol),
                                           base_policy={"*": 0.05})
        rig = Rig(pkg, tmp_path / f"{pkg_name}-flight", actuators=("flagd",), extra=(sampler,))
        rig.observe(3, [SVC])
        promoted = writer.span_sample_policy()
        rig.observe(4, [])
        out[pkg_name] = (promoted, writer.span_sample_policy(), rig.finish())
        writer.close()
    assert out["port"] == out["reference"]
    assert out["port"][0] == {"*": 0.05, SVC: 1.0} and out["port"][1] == {"*": 0.05}


class _SlowRead(threading.Event):
    """An event whose reading yields the interpreter for 20 ms after it
    has read: another thread runs between the reading and the caller's
    next statement."""

    def is_set(self):
        value = super().is_set()
        time.sleep(0.02)
        return value


def test_drain_waits_for_a_job_popped_while_it_reads():
    """``drain`` must not take a job the worker pops between its two
    readings (worker idle, then queue empty) for a finished one: with the
    readings apart, the pre-flight below would still be running when
    drain returned (the reference's ``drain`` reads them apart and
    returns early on a machine whose scheduler wakes the worker there)."""
    store = flags.FlagEvaluator(_doc())

    def gate(_svc):
        time.sleep(0.05)
        return True

    ctrl = remediation.RemediationController(
        [remediation.FlagdActuator(store=store, policy={SVC: (FLAG,)})], enabled=True, act_batches=2,
        preflight=gate)
    ctrl._idle = _SlowRead()
    ctrl._idle.set()
    try:
        ctrl.observe(0.0, [SVC], services=[SVC])
        ctrl.observe(0.25, [SVC], services=[SVC])
        assert ctrl.drain(10.0)
        assert ctrl.stats()["preflight_verdicts"] == {"released": 1}
        assert store.flag_spec(FLAG)["state"] == "DISABLED"
    finally:
        ctrl.close()


# --- flagd chaos: the hot path never stalls -------------------------------


def _hot_path_worst(ctrl, n=120):
    worst, t = 0.0, 0.0
    for _ in range(n):
        t0 = time.perf_counter()
        ctrl.observe(t, [SVC], services=[SVC])
        worst = max(worst, time.perf_counter() - t0)
        t += 0.25
    return worst


class _Quiet(ThreadingHTTPServer):
    daemon_threads = True


def _torn_json_server():
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            body = b'{"flags": {"recomm'  # torn mid-document
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802
            self.send_response(500)
            self.end_headers()

        def log_message(self, *args):
            pass

    return _Quiet(("127.0.0.1", 0), Handler)


@pytest.fixture
def flagd_url(request):
    """A sick flag editor: ``dead`` refuses connections, ``blackhole``
    accepts and never answers, ``torn`` answers torn JSON."""
    kind = request.param
    if kind == "dead":
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()  # nobody listens: every connect is refused
        yield f"http://127.0.0.1:{port}"
    elif kind == "blackhole":
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(64)
        held: list = []
        stop = threading.Event()

        def accept():
            s.settimeout(0.1)
            while not stop.is_set():
                try:
                    held.append(s.accept()[0])
                except OSError:
                    continue

        th = threading.Thread(target=accept, daemon=True)
        th.start()
        yield f"http://127.0.0.1:{s.getsockname()[1]}"
        stop.set()
        th.join(timeout=2.0)
        for c in held:
            c.close()
        s.close()
    else:
        server = _torn_json_server()
        threading.Thread(target=server.serve_forever, daemon=True).start()
        yield f"http://127.0.0.1:{server.server_address[1]}"
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("flagd_url", ["dead", "blackhole", "torn"], indirect=True)
def test_a_sick_flagd_never_blocks_the_hot_path(flagd_url):
    flagd = remediation.FlagdActuator(url=flagd_url, timeout_s=0.2)
    ctrl = remediation.RemediationController([flagd], enabled=True, act_batches=3, clear_batches=4, budget=4,
                                             budget_refill_s=1e9, retry_attempts=2, backoff_cap_s=0.05)
    try:
        worst = _hot_path_worst(ctrl)
        assert worst < 0.05, f"observe() stalled {worst:.3f}s"
        assert ctrl.drain(10.0)
        assert ctrl.stats()["actuator_errors"] >= 1 and flagd.writes <= 1
    finally:
        ctrl.close()


@pytest.mark.parametrize("flagd_url", ["blackhole"], indirect=True)
def test_the_action_queue_is_bounded_and_fails_closed(flagd_url):
    names = [f"svc{i}" for i in range(64)]
    flagd = remediation.FlagdActuator(url=flagd_url, timeout_s=0.5, policy={n: (FLAG,) for n in names})
    ctrl = remediation.RemediationController(
        [flagd], enabled=True, act_batches=1, clear_batches=4, budget=1000, budget_refill_s=0.001,
        deadline_s=30.0, queue_max=4, retry_attempts=3, backoff_cap_s=0.2)
    try:
        t = 0.0
        for _ in range(40):
            ctrl.observe(t, names, services=names)
            t += 0.25
        st = ctrl.stats()
        assert st["queue_depth"] <= 4 and st["queue_dropped"] > 0
    finally:
        ctrl.close()
