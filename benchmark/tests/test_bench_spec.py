"""BENCHMARK.json keeps to its contract, and a new configuration,
traffic mix or per-layer metric is found by its name with no edit."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark.harness import spec
from benchmark.tests.conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_has_exactly_the_contract_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1] == "benchmark/run.py"
    assert 1 <= b["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_entries():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    metrics = b["end_to_end"] + b["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        reported = {m["name"] for m in b["end_to_end"] if w["name"] in m.get("workloads", cells)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in b["per_layer"] if w["name"] in m.get("workloads", cells)]
        assert layer and all(m["moves"] in reported for m in layer)
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in b["workloads"])


def test_every_cell_finds_its_parts():
    b = bench()
    for w in b["workloads"]:
        cfg = spec.load_config(ROOT, b, w["config"])
        assert cfg["name"] == w["config"]
        assert spec.load_traffic(w["traffic"])["loop"] in ("closed", "paced")
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_closed_mixes_never_push_the_queue_past_its_budget():
    """No operation of a cell may fail: a closed loop checks admission
    before each body, so the bodies it can have past that check must fit
    between the high watermark and the queue's row budget, or admission
    sheds them."""
    from benchmark.harness.system import knobs

    b = bench()
    for w in b["workloads"]:
        mix = spec.load_traffic(w["traffic"])
        if mix["loop"] != "closed":
            continue
        k = knobs(spec.load_config(ROOT, b, w["config"]).get("overrides", {}))
        budget = int(k["ANOMALY_QUEUE_MAX_ROWS"])
        high = int(budget * float(k["ANOMALY_QUEUE_HIGH_WATERMARK"]))
        assert (high - 1) + int(mix["in_flight"]) * int(mix["spans_per_body"]) <= budget, w["name"]


def test_a_new_config_traffic_and_metric_need_no_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    cfg = json.loads((BENCH / "configs" / "shop.json").read_text())
    cfg["name"] = "dummy"
    (root / "benchmark" / "configs" / "dummy.json").write_text(json.dumps(cfg))
    (root / "benchmark" / "traffic" / "dummy_mix.json").write_text(json.dumps({"loop": "paced"}))
    (root / "benchmark" / "metrics" / "dummy_ms.x.py").write_text("def read(rec):\n    return rec['x'] * 2\n")
    b["configs"].append(dict(b["configs"][0], name="dummy", file="benchmark/configs/dummy.json"))
    b["workloads"].append(dict(b["workloads"][0], name="dummy.cell", config="dummy", traffic="dummy_mix"))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    loaded = spec.load_benchmark(root)
    cell = spec.find(loaded["workloads"], "dummy.cell", "workload")
    assert spec.load_config(root, loaded, cell["config"])["name"] == "dummy"
    assert spec.load_traffic(cell["traffic"], root / "benchmark")["loop"] == "paced"
    assert spec.metric_reader("dummy_ms.x", root / "benchmark")({"x": 21}) == 42
    with pytest.raises(KeyError):
        spec.find(loaded["workloads"], "absent", "workload")
