"""The repo's staticcheck passes over the port and the port's overlay.

``tests/test_staticcheck.py`` holds the JAX package to zero unsuppressed
violations: ``Repo`` picks the first package it finds, which is the
reference. Here the same ``run_repo`` reads the port instead
(``Repo._detect_package`` set to ``opentelemetry_demo_tpu_torch``) and
the knob-discipline pass reads the port's compose overlay
(``deploy/torch/docker-compose.anomaly.yml``). The passes are the
reference's, unchanged. Then two mutations on a copy of the tree: the
gate must find ``ANOMALY_SPINE_OVERLAP`` once the daemon stops threading
it, and once the overlay stops setting it.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import pytest

from scripts.staticcheck import core
from scripts.staticcheck.passes import knobs

pytestmark = pytest.mark.staticcheck

REPO = Path(__file__).resolve().parent.parent
PORT = "opentelemetry_demo_tpu_torch"
OVERLAY = "deploy/torch/docker-compose.anomaly.yml"


@pytest.fixture
def on_the_port(monkeypatch):
    monkeypatch.setattr(core.Repo, "_detect_package", lambda self: PORT)
    monkeypatch.setattr(knobs, "COMPOSE_REL", OVERLAY)


def test_the_port_and_its_overlay_run_clean(on_the_port):
    violations, pragma_errors, _suppressed = core.run_repo(str(REPO))
    rendered = "\n".join(v.render() for v in violations + pragma_errors)
    assert not violations and not pragma_errors, f"staticcheck violations in the port:\n{rendered}"


def test_the_gate_reads_the_port():
    """Without the patch the reference is read; with it, the port."""
    assert core.Repo(str(REPO)).package == "opentelemetry_demo_tpu"


MUTATIONS = {
    "daemon": (
        f"{PORT}/runtime/daemon.py",
        '            spine_overlap=bool(int(sp["ANOMALY_SPINE_OVERLAP"])),\n',
        "not threaded through runtime/daemon.py",
    ),
    "overlay": (
        OVERLAY,
        "      - ANOMALY_SPINE_OVERLAP=1\n",
        f"not threaded through {OVERLAY}",
    ),
}


@pytest.mark.parametrize("where", sorted(MUTATIONS))
def test_the_gate_finds_an_unthreaded_spine_overlap(on_the_port, tmp_path, where):
    rel, line, message = MUTATIONS[where]
    shutil.copytree(REPO / PORT, tmp_path / PORT, ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / OVERLAY).parent.mkdir(parents=True)
    shutil.copy(REPO / OVERLAY, tmp_path / OVERLAY)
    text = (tmp_path / rel).read_text()
    assert line in text
    (tmp_path / rel).write_text(text.replace(line, ""))
    violations, _, _ = core.run_repo(str(tmp_path), ["knob-discipline"])
    found = [v.message for v in violations if "ANOMALY_SPINE_OVERLAP" in v.message]
    assert any(message in m for m in found), found


def test_the_trace_discipline_pass_runs_clean_over_the_port(on_the_port):
    violations, pragma_errors, _suppressed = core.run_repo(str(REPO), ["trace-discipline"])
    assert not violations and not pragma_errors, "\n".join(v.render() for v in violations)


# The six phases of the timeline, each observed at one call site.
NEW_PHASES = {
    "PHASE_QUEUE_WAIT": f"{PORT}/runtime/ingest_pool.py",
    "PHASE_PENDING_WAIT": f"{PORT}/runtime/pipeline.py",
    "PHASE_SPINE_WAIT": f"{PORT}/runtime/pipeline.py",
    "PHASE_INFLIGHT": f"{PORT}/runtime/pipeline.py",
    "PHASE_REPORT": f"{PORT}/runtime/pipeline.py",
    "PHASE_PUMP": f"{PORT}/runtime/pipeline.py",
}


@pytest.mark.parametrize("const", sorted(NEW_PHASES))
def test_trace_discipline_finds_a_phase_observed_by_a_literal(on_the_port, tmp_path, const):
    """Each phase's call site passes its ``selftrace`` constant: written as
    a literal instead, the pass reports the literal and the orphaned
    constant."""
    from opentelemetry_demo_tpu_torch.runtime import selftrace

    rel = NEW_PHASES[const]
    shutil.copytree(REPO / PORT, tmp_path / PORT, ignore=shutil.ignore_patterns("__pycache__"))
    text = (tmp_path / rel).read_text()
    site = f"self.phase_observe({const}, "
    assert text.count(site) == 1
    (tmp_path / rel).write_text(text.replace(site, f'self.phase_observe("{getattr(selftrace, const)}", '))
    violations, _, _ = core.run_repo(str(tmp_path), ["trace-discipline"])
    found = [v.message for v in violations]
    assert any("string literal" in m and repr(getattr(selftrace, const)) in m for m in found), found
    assert any(m.startswith(f"{const} ") and "never referenced" in m for m in found), found
