"""The port's bench entry points against the reference's, on the CPU at
small sizes: ``opentelemetry_demo_tpu_torch.bench`` against the root
``bench.py``, and the four ``opentelemetry_demo_tpu_torch.scripts``
modules against ``scripts/``.

- the batch pool: the same draws give the same column bits;
- the rotation-mask cadence: the port's list is the one the reference's
  ``measure_throughput`` feeds its steps (its jit, clock and pool
  replaced by stand-ins, so the loop runs as written and records each
  step's mask);
- the timed chain: ``run_chain`` against the reference's jitted, donated
  chain on the same batches and masks: integer state exact (HLL, CMS,
  ``step_idx``), float state and reports within rtol 1e-4 / atol 1e-5,
  flags identical;
- the JSON line: the key set of each package's ``main`` at the same
  small knobs, equal but for the named differences;
- no failure is swallowed: a leg that raises ends ``main``, and a
  subprocess leg that exits 1 raises with its stderr;
- the scripts: ``bench_lag``'s line has the reference's keys and, after
  ``reports_skipped``, the port's two pump counters,
  ``bench_ingest`` prints the reference's rows (and ``--raw`` runs),
  ``profile_step`` and ``profile_chain`` print the reference's rows.
"""

from __future__ import annotations

import importlib.util
import json
import re
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import detector as ref_detector
from opentelemetry_demo_tpu_torch import bench
from opentelemetry_demo_tpu_torch.models import DetectorConfig
from opentelemetry_demo_tpu_torch.runtime import replaybench
from opentelemetry_demo_tpu_torch.scripts import bench_ingest, bench_lag, profile_chain, profile_step

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-4, 1e-5
INT_FIELDS = ("hll_bank", "cms_bank", "step_idx")
# Every leg knob at 0 but the matrix (off the card it is {} in both).
SMALL_KNOBS = {
    "BENCH_BATCH": "2048", "BENCH_LAG_SECONDS": "1", "BENCH_MATRIX": "1",
    **{k: "0" for k in bench.LEG_KNOBS if k != "BENCH_MATRIX"},
}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ref_bench():
    return _load("reference_bench", ROOT / "bench.py")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The slope regions run for a fixed time; one intra-op thread keeps
    # the port's steps from contending with other test workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_knobs(monkeypatch):
    for k in bench.BENCH_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in SMALL_KNOBS.items():
        monkeypatch.setenv(k, v)


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


# -- the batch pool and the mask cadence --------------------------------------


def test_batch_pool_has_the_references_bits(ref_bench):
    config = DetectorConfig()
    want = ref_bench.make_batch_pool(ref_detector.DetectorConfig(), 1024, 2, np.random.default_rng(0))
    got = bench.make_batch_pool(config, 1024, 2, np.random.default_rng(0), "cpu")
    assert len(got) == len(want) == 2
    for g_batch, w_batch in zip(got, want):
        assert len(g_batch) == len(w_batch) == 8
        for g, w in zip(g_batch, w_batch):
            w = np.asarray(w)
            assert g.shape == w.shape and g.numpy().tobytes() == w.tobytes()


@pytest.mark.parametrize("batch", [2048, 16384, 524288])
def test_mask_cadence_is_the_references(ref_bench, monkeypatch, batch):
    clock = [0.0]
    seen: list[tuple] = []

    def fake_jit(fn, donate_argnums=()):
        def step(state, *args):
            seen.append(tuple(bool(x) for x in np.asarray(args[-1])))
            clock[0] += 1e-3
            return state._replace(step_idx=state.step_idx + 1), None

        return step

    monkeypatch.setattr(ref_bench, "jax", SimpleNamespace(jit=fake_jit))
    monkeypatch.setattr(ref_bench, "time", SimpleNamespace(perf_counter=lambda: clock[0]))
    monkeypatch.setattr(ref_bench, "make_batch_pool", lambda *a: [()] * 4)
    ref_bench.measure_throughput(ref_detector.DetectorConfig(), batch, None)
    # Warm-up (1), probes (4, 12), then the timed regions k1 and 3·k1.
    k1 = (len(seen) - 17) // 4
    assert 17 + 4 * k1 == len(seen)
    masks = bench.rotation_masks(batch)
    assert 3 * k1 >= len(masks)  # the last region walks the whole list and wraps
    assert seen[-3 * k1:] == [masks[i % len(masks)] for i in range(3 * k1)]


# -- the timed chain ----------------------------------------------------------


def _assert_state_close(got, want):
    for name in ref_detector.DetectorState._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        if name in INT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


def _assert_report_close(got, want):
    for name in ref_detector.DetectorReport._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name == "flags":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


def test_run_chain_is_the_references_jitted_chain(ref_bench):
    """12 steps at B=512 on the composed path, masks rotating the 1 s
    window every step and the 10 s window at steps 0 and 10."""
    k, b = 12, 512
    ref_config = ref_detector.DetectorConfig(sketch_impl="xla")
    config = DetectorConfig(sketch_impl="xla")
    masks = bench.rotation_masks(524288)
    ref_pool = ref_bench.make_batch_pool(ref_config, b, 4, np.random.default_rng(3))
    pool = bench.make_batch_pool(config, b, 4, np.random.default_rng(3), "cpu")

    step = jax.jit(partial(ref_detector.detector_step, ref_config), donate_argnums=0)
    dt = jnp.float32(b / ref_bench.BASELINE_SPANS_PER_SEC)
    state = ref_detector.detector_init(ref_config)
    ref_reports = []
    for i in range(k):
        state, report = step(state, *ref_pool[i % 4], dt, jnp.asarray(masks[i % len(masks)]))
        ref_reports.append(report)

    dev_masks = bench.device_masks(masks, "cpu")
    chained, last = bench.run_chain(config, pool, dev_masks, k, "cpu")
    _assert_state_close(chained, state)
    _assert_report_close(last, ref_reports[-1])

    # Step by step: every report, and the same state as the chain.
    stepped = None
    for i in range(k):
        stepped, report = bench.run_chain(config, [pool[i % 4]], [dev_masks[i]], 1, "cpu", stepped)
        _assert_report_close(report, ref_reports[i])
    for a, c in zip(stepped, chained):
        assert torch.equal(a, c)


# -- the JSON line and failures -----------------------------------------------


def test_main_line_has_the_references_keys(ref_bench, small_knobs, capsys):
    got = bench.main(["--device", "cpu"])
    assert _last_json(capsys.readouterr().out) == json.loads(json.dumps(got))
    ref_bench.main()
    want = _last_json(capsys.readouterr().out)
    assert list(got)[:4] == list(want)[:4] == ["metric", "value", "unit", "vs_baseline"]
    assert set(got) - {"device", "legs_skipped", "host_ingest_vs_serial"} == set(want) - {"host_ingest_vs_r5"}
    assert "host_ingest_vs_r5" not in got
    assert got["device"] == {"name": None, "power_limit_w": None}
    assert got["legs_skipped"] == [k for k in bench.LEG_KNOBS if SMALL_KNOBS[k] == "0"]
    assert got["sketch_impl_matrix"] == want["sketch_impl_matrix"] == {}
    assert got["value"] > 0 and got["lag_p99_ms"] > 0 and got["lag_batches"] > 0


def test_a_leg_that_raises_ends_main(small_knobs, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_REPLAY", "1")
    monkeypatch.setattr(bench, "measure_throughput", lambda *a, **k: 1.0)

    def broken(**kw):
        raise RuntimeError("replay leg broke")

    monkeypatch.setattr(replaybench, "measure_replay", broken)
    with pytest.raises(RuntimeError, match="replay leg broke"):
        bench.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_a_subprocess_leg_that_exits_1_raises_with_its_stderr(monkeypatch):
    # bench_lag asked for the card where the child sees none exits 1.
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError) as e:
        bench.measure_module_subprocess("opentelemetry_demo_tpu_torch.scripts.bench_lag", 120.0, "cuda")
    assert "exited 1" in str(e.value) and "no CUDA device is available" in str(e.value)


def test_no_card_no_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_lag.main(["--device", "cuda"])


# -- the scripts ---------------------------------------------------------------


# The port's counters of how deep the pump pipelines (``PipelineStats``).
PUMP_COUNTERS = ("pumps_caught_up", "pumps_widened", "reports_same_pump")


def test_bench_lag_line_has_the_references_keys(monkeypatch, capsys):
    ref = _load("reference_bench_lag", ROOT / "scripts" / "bench_lag.py")
    monkeypatch.setattr("sys.argv", ["bench_lag.py", "--seconds", "0.5"])
    ref.main()
    want = _last_json(capsys.readouterr().out)
    got = bench_lag.main(["--seconds", "0.5", "--device", "cpu"])
    assert _last_json(capsys.readouterr().out) == got
    keys = list(want)
    at = keys.index("reports_skipped") + 1
    assert list(got) == keys[:at] + list(PUMP_COUNTERS) + keys[at:]
    # The paced loop pumps after each submit: every pump is caught up.
    assert got["pumps_caught_up"] == got["reports_same_pump"] == got["batches"]
    assert got["pumps_widened"] == 0
    assert got["metric"] == "detection_lag_p99" and got["batches"] > 0


def _rows(text: str) -> list[str]:
    return [line.split(":")[0] for line in text.strip().splitlines()]


@pytest.mark.parametrize("args", [["--workers", "1"], ["--raw"]])
def test_bench_ingest_prints_the_references_rows(monkeypatch, capsys, args):
    ref = _load("reference_bench_ingest", ROOT / "scripts" / "bench_ingest.py")
    monkeypatch.setattr("sys.argv", ["bench_ingest.py", *args])
    ref.main()
    want = _rows(capsys.readouterr().out)
    bench_ingest.main(args)
    got = _rows(capsys.readouterr().out)
    assert got == want and "one fat payload" in got


def test_profile_step_prints_the_references_rows(capsys):
    src = (ROOT / "scripts" / "profile_step.py").read_text()
    names = re.findall(r'slope\("([^"]+)"', src) + re.findall(r"\{'(-> [^']+)':34s\}", src)
    assert len(names) == 5
    rows = profile_step.main(["256", "--device", "cpu"])
    out = capsys.readouterr().out
    printed = [line[:34].rstrip() for line in out.splitlines()]
    assert all(name in printed for name in names), (names, printed)
    assert "fused update (pallas) alone" in printed
    assert all(v > 0 for v in rows.values())


def test_profile_chain_prints_the_references_rows(capsys):
    src = (ROOT / "scripts" / "profile_chain.py").read_text()
    names = re.findall(r'run\("([^"]+)"', src)
    assert len(names) == 5
    rows = profile_chain.main(["256", "--device", "cpu"])
    printed = [line[:45].rstrip() for line in capsys.readouterr().out.splitlines()]
    assert printed == names and list(rows) == names
