"""Finds a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root, ``configs/<name>.json``, ``traffic/<name>.json`` and
``metrics/<name>.py`` beside this package. Adding a configuration, a
traffic mix or a per-layer metric adds files and entries; nothing here
changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


def load_benchmark(root: Path) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(root: Path, bench: dict, name: str) -> dict:
    entry = find(bench["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def load_traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((Path(bench_dir) / "traffic" / f"{name}.json").read_text())


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
