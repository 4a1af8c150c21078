"""The port stands alone: no module of it imports JAX or the JAX package.

Every module of ``opentelemetry_demo_tpu_torch`` and ``chip_smoke.py``
is imported in one subprocess in which ``jax`` and
``opentelemetry_demo_tpu`` are blocked (``sys.modules[name] = None``
makes any import of them, or of a submodule, raise). Imports made inside
functions are not run by an import, so the sources are also read: no
``import`` statement anywhere in the port or the script names either
package.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "opentelemetry_demo_tpu_torch"
BLOCKED = ("jax", "jaxlib", "opentelemetry_demo_tpu")


def _modules() -> list[str]:
    out = []
    for path in sorted(PORT.rglob("*.py")):
        parts = list(path.relative_to(ROOT).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


MODULES = _modules()
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_CHILD = r"""
import importlib, importlib.util, json, sys, traceback
for name in {blocked!r}:
    sys.modules[name] = None
sys.path.insert(0, {root!r})
out = {{}}
for name in {modules!r}:
    try:
        importlib.import_module(name)
        out[name] = None
    except BaseException:
        out[name] = traceback.format_exc(limit=3)
try:
    spec = importlib.util.spec_from_file_location("chip_smoke_module", {script!r})
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    out["chip_smoke.py"] = None
except BaseException:
    out["chip_smoke.py"] = traceback.format_exc(limit=3)
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in {blocked!r})
print(json.dumps({{"imports": out, "loaded": loaded}}))
"""


@pytest.fixture(scope="module")
def blocked_imports():
    code = _CHILD.format(blocked=BLOCKED, root=str(ROOT), modules=MODULES,
                         script=str(ROOT / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", MODULES + ["chip_smoke.py"])
def test_imports_with_jax_and_the_jax_package_blocked(blocked_imports, name):
    assert blocked_imports["imports"][name] is None, blocked_imports["imports"][name]


def test_nothing_of_either_package_was_loaded(blocked_imports):
    assert blocked_imports["loaded"] == []


def _imported_names(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_either_package(path):
    bad = [n for n in _imported_names(path) if n.split(".")[0] in BLOCKED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# The modules of the shop's slice, named so that a change to the discovery
# above cannot quietly drop them from the two checks.
SHOP_SLICE = (
    "utils.concurrency", "telemetry.tracer", "telemetry.tracestore", "telemetry.tsdb",
    "telemetry.collector", "services", "services.money", "services.base", "services.bus",
    "services.ad", "services.cart", "services.catalog", "services.currency", "services.email",
    "services.payment", "services.recommendation", "services.shipping", "services.checkout",
    "services.consumers", "services.frontend", "services.loadgen", "services.kafka_bus",
    "services.shop", "services.rig",
)


# The bench entry points (the flagship line and the four scripts).
BENCH_SLICE = (
    "bench", "scripts", "scripts.bench_lag", "scripts.bench_ingest", "scripts.profile_step",
    "scripts.profile_chain",
)


def _held_to_the_rule(name: str) -> None:
    """``name`` is among the modules imported with both packages blocked
    and among the sources read for an import of either."""
    assert f"opentelemetry_demo_tpu_torch.{name}" in MODULES
    path = PORT.joinpath(*name.split(".")).with_suffix(".py")
    if not path.exists():
        path = PORT.joinpath(*name.split("."), "__init__.py")
    assert path in SOURCES


@pytest.mark.parametrize("name", SHOP_SLICE)
def test_the_shop_slice_is_held_to_the_rule(name):
    _held_to_the_rule(name)


@pytest.mark.parametrize("name", BENCH_SLICE)
def test_the_bench_slice_is_held_to_the_rule(name):
    _held_to_the_rule(name)
