"""The port's ``utils/config.py`` against the reference's.

Every knob registry must equal the reference's literal dict (keys,
types, defaults and help text), and every resolver must give the
reference's answer under the same environment: the defaults, a valid
override of each knob, and a malformed value of each numeric knob, which
must raise ``ConfigError`` with the reference's message. The parse
helpers (``history_ladder``, ``history_spans_policy``,
``fleet_tenant_map``) run on the same inputs. Last, the repair of the
knobs the replay, shadow and mitigation benches read: a malformed value
raises the reference's ``ConfigError`` there too, not a ``ValueError``.
"""

from __future__ import annotations

import re

import pytest

from opentelemetry_demo_tpu.runtime import mitigbench as ref_mitigbench
from opentelemetry_demo_tpu.runtime import replaybench as ref_replaybench
from opentelemetry_demo_tpu.utils import config as ref
from opentelemetry_demo_tpu_torch.runtime import mitigbench as port_mitigbench
from opentelemetry_demo_tpu_torch.runtime import replaybench as port_replaybench
from opentelemetry_demo_tpu_torch.utils import config as port

REGISTRIES = sorted(
    name for name in dir(ref) if name.endswith("_KNOBS") and isinstance(getattr(ref, name), dict)
)

# resolver → the registry it reads.
RESOLVERS = {
    "overload_config": "OVERLOAD_KNOBS",
    "ingest_config": "INGEST_KNOBS",
    "frame_config": "FRAME_KNOBS",
    "query_config": "QUERY_KNOBS",
    "spine_config": "SPINE_KNOBS",
    "daemon_config": "DAEMON_KNOBS",
    "selftrace_config": "SELFTRACE_KNOBS",
    "history_config": "HISTORY_KNOBS",
    "remediation_config": "REMEDIATION_KNOBS",
    "fleet_config": "FLEET_KNOBS",
    "autoscale_config": "AUTOSCALE_KNOBS",
    "shadow_config": "SHADOW_KNOBS",
    "provenance_config": "PROVENANCE_KNOBS",
    "frontdoor_config": "FRONTDOOR_KNOBS",
    "keyspace_config": "KEYSPACE_KNOBS",
    "replication_config": "REPLICATION_KNOBS",
}


@pytest.fixture
def clean_env(monkeypatch):
    """Every registered knob unset: each case sets only what it tests."""
    for name in REGISTRIES:
        for knob in getattr(ref, name):
            monkeypatch.delenv(knob, raising=False)
    return monkeypatch


def _outcome(module, resolver: str):
    """(result dict, None) or (None, (exception class name, message))."""
    try:
        return getattr(module, resolver)(), None
    except Exception as e:  # noqa: BLE001 — the outcome is what is compared
        return None, (type(e).__name__, str(e))


def _same_outcome(resolver: str, what: str):
    got, got_err = _outcome(port, resolver)
    want, want_err = _outcome(ref, resolver)
    assert got_err == want_err, f"{resolver} under {what}"
    assert got == want, f"{resolver} under {what}"
    if got_err is not None:
        with pytest.raises(port.ConfigError):
            getattr(port, resolver)()
    return want_err


def test_the_registries_and_resolvers_are_the_references():
    port_regs = sorted(
        name for name in dir(port) if name.endswith("_KNOBS") and isinstance(getattr(port, name), dict)
    )
    assert port_regs == REGISTRIES
    assert set(RESOLVERS.values()) <= set(REGISTRIES)
    for resolver in RESOLVERS:
        assert callable(getattr(port, resolver))


def _without_change_history(help_text: str) -> str:
    """The reference's help text with its mentions of its own change
    history taken out, as the port words them; every other character of
    every entry is the reference's."""
    return re.sub(r"PR \d+ (behavior, )?", "", help_text)


# Knobs whose behaviour the port extends, with the words the port adds
# to the reference's help text: (the reference's words, the port's).
PORT_WORDING = {
    "ANOMALY_ADAPTIVE_BATCH": (
        "can't keep pace;",
        "can't keep pace, and widens a take to the ladder width that holds the pending backlog;",
    ),
    "ANOMALY_SPINE_RING": ("buffers a stager thread packs", "buffers the pump thread packs"),
    "ANOMALY_SPINE_OVERLAP": (
        "with a step in flight, dispatch only batches whose put already completed",
        "dispatch without waiting on the host for the put: the step waits for it on the card",
    ),
    "ANOMALY_RETRY_AFTER_S": (
        "Retry-After hint (seconds) handed to throttled OTLP producers",
        "the longest Retry-After hint (seconds) handed to throttled OTLP producers; a saturated "
        "queue answers the time its pump needs to drain to the low watermark, at most this",
    ),
}


def _as_the_port_words_it(knob: str, help_text: str) -> str:
    help_text = _without_change_history(help_text)
    if knob in PORT_WORDING:
        ref_words, port_words = PORT_WORDING[knob]
        assert help_text.count(ref_words) == 1, knob
        help_text = help_text.replace(ref_words, port_words)
    return help_text


@pytest.mark.parametrize("name", REGISTRIES)
def test_registry_equals_the_references(name):
    got, want = getattr(port, name), getattr(ref, name)
    assert list(got) == list(want)
    for knob, (kind, default, help_text) in want.items():
        assert got[knob] == (kind, default, _as_the_port_words_it(knob, help_text)), knob


@pytest.mark.parametrize("resolver", sorted(RESOLVERS))
def test_resolver_defaults_equal_the_references(clean_env, resolver):
    assert _same_outcome(resolver, "defaults") is None


def _valid_override(kind: str, default):
    if kind == "int":
        return str(int(default) + 1)
    if kind == "float":
        return repr(float(default) * 2.0 + 0.5)
    return "override-value"


@pytest.mark.parametrize("resolver", sorted(RESOLVERS))
def test_resolver_overrides_equal_the_references(clean_env, resolver):
    """One knob at a time set to a value near its default: both packages
    resolve it the same way, or refuse it with the same message (a
    cross-knob validator may refuse an override alone)."""
    registry = getattr(ref, RESOLVERS[resolver])
    for knob, (kind, default, _help) in registry.items():
        clean_env.setenv(knob, _valid_override(kind, default))
        _same_outcome(resolver, f"{knob}={_valid_override(kind, default)}")
        clean_env.delenv(knob)


@pytest.mark.parametrize("resolver", sorted(RESOLVERS))
def test_resolver_malformed_values_raise_the_references_error(clean_env, resolver):
    registry = getattr(ref, RESOLVERS[resolver])
    numeric = [knob for knob, (kind, _d, _h) in registry.items() if kind in ("int", "float")]
    assert numeric, resolver
    for knob in numeric:
        clean_env.setenv(knob, "abc")
        err = _same_outcome(resolver, f"{knob}=abc")
        assert err is not None and err[0] == "ConfigError", knob
        assert knob in err[1]
        clean_env.delenv(knob)


LADDERS = [
    ("1,60,3600", "0,0,0"),
    ("1,60,3600", "600,86400,604800"),
    ("5, 300", "60,3600"),
    ("", ""),
    ("1,60", "1"),
    ("60,1", "0,0"),
    ("1,x", "0,0"),
    ("0,60", "0,0"),
]


@pytest.mark.parametrize("rungs,retention", LADDERS)
def test_history_ladder_equals_the_references(rungs, retention):
    def run(module):
        try:
            return module.history_ladder(rungs, retention), None
        except Exception as e:  # noqa: BLE001
            return None, (type(e).__name__, str(e))

    assert run(port) == run(ref)


SPAN_POLICIES = ["0", "1", "", "checkout:1.0", "checkout:1.0,*:0.01", "checkout:2", "checkout", "a:b", "*:0.5, cart:0"]


@pytest.mark.parametrize("raw", SPAN_POLICIES)
def test_history_spans_policy_equals_the_references(raw):
    def run(module):
        try:
            return module.history_spans_policy(raw), None
        except Exception as e:  # noqa: BLE001
            return None, (type(e).__name__, str(e))

    assert run(port) == run(ref)


TENANT_MAPS = ["", "frontend:web, cart:web ,*:bulk", "frontend", "a/b:t", "x:", ":y", "a:b,,c:d"]


@pytest.mark.parametrize("raw", TENANT_MAPS)
def test_fleet_tenant_map_equals_the_references(raw):
    def run(module):
        try:
            return module.fleet_tenant_map(raw), None
        except Exception as e:  # noqa: BLE001
            return None, (type(e).__name__, str(e))

    assert run(port) == run(ref)


def test_env_helpers_raise_the_references_messages(clean_env):
    for helper in ("env_int", "env_float", "env_str"):
        clean_env.delenv("OTD_TEST_KNOB", raising=False)
        for value in (None, "abc", "7"):
            if value is None:
                clean_env.delenv("OTD_TEST_KNOB", raising=False)
            else:
                clean_env.setenv("OTD_TEST_KNOB", value)

            def run(module):
                try:
                    return getattr(module, helper)("OTD_TEST_KNOB"), None
                except Exception as e:  # noqa: BLE001
                    return None, (type(e).__name__, str(e))

            assert run(port) == run(ref), (helper, value)


# -- the repaired knob reads of the benches ----------------------------


def _raised(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 — the error is what is compared
        return type(e).__name__, str(e), e
    raise AssertionError("no error raised")


def test_replay_rate_knob_raises_the_references_error(clean_env):
    clean_env.setenv("ANOMALY_HISTORY_REPLAY_RATE", "abc")
    got = _raised(lambda: port_replaybench.measure_replay(device="cpu"))
    want = _raised(ref_replaybench.measure_replay)
    assert got[:2] == want[:2] == ("ConfigError", "ANOMALY_HISTORY_REPLAY_RATE='abc' is not a number")
    assert isinstance(got[2], port.ConfigError)


def test_shadow_rate_knob_raises_the_references_error(clean_env):
    clean_env.setenv("ANOMALY_SHADOW_RATE", "abc")
    got = _raised(lambda: port_mitigbench.measure_shadow(device="cpu"))
    want = _raised(ref_mitigbench.measure_shadow)
    assert got[:2] == want[:2] == ("ConfigError", "ANOMALY_SHADOW_RATE='abc' is not a number")
    assert isinstance(got[2], port.ConfigError)


def test_bench_shadow_knob_raises_the_references_error(clean_env):
    clean_env.setenv("BENCH_SHADOW", "abc")
    clean_env.setattr("sys.argv", ["mitigbench"])
    # The mitigation leg runs before the knob is read; it is not under test.
    clean_env.setattr(port_mitigbench, "measure_mitigation", lambda *a, **k: {})
    clean_env.setattr(ref_mitigbench, "measure_mitigation", lambda *a, **k: {})
    got = _raised(port_mitigbench.main)
    want = _raised(ref_mitigbench.main)
    assert got[:2] == want[:2] == ("ConfigError", "BENCH_SHADOW='abc' is not an integer")
    assert isinstance(got[2], port.ConfigError)
