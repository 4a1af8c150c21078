"""The port's sharded detector step against the JAX sharded step.

One spawned four-rank gloo world on the CPU
(``opentelemetry_demo_tpu_torch.parallel.launch``), module-scoped,
builds each layout's mesh in turn, replays every scenario of this file
on it and returns the results; the test cases read them. The JAX reference runs ``make_sharded_step`` on the same
layout of the conftest's virtual 8-device CPU mesh, on the same batches
(packed with numpy from a seed, as ``tests/test_parallel.py`` packs
them). The world has a hard deadline, so a hung rendezvous fails its
tests instead of running the suite into its limit.

Integer sketch banks and ``svc_count`` must be bit-exact; float state
within rtol 1e-4 / atol 1e-4 and the z-scores and ``hh_ratio`` within
rtol 1e-3 / atol 1e-3 (the tolerances of ``tests/test_parallel.py``:
stats are summed across ranks in another order); flags identical; and
the batch replicas of one sketch coordinate bit-identical.
"""

import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import DetectorConfig as JConfig
from opentelemetry_demo_tpu.parallel import make_hybrid_mesh as jhybrid
from opentelemetry_demo_tpu.parallel import make_mesh as jmesh
from opentelemetry_demo_tpu.parallel import make_sharded_step as jsharded
from opentelemetry_demo_tpu.runtime import SpanTensorizer
from opentelemetry_demo_tpu_torch.models import detector as tdet
from opentelemetry_demo_tpu_torch.ops import collectives
from opentelemetry_demo_tpu_torch.parallel import launch, place_state, ring, shard_batch
from opentelemetry_demo_tpu_torch.parallel import make_sharded_step

B = 512
DT = 0.25
N_STEPS = 4
WORLD_TIMEOUT_S = 120.0

LAYOUTS = {"4x1": (4, 1), "2x2": (2, 2), "hybrid2x1x2": (2, 1, 2)}
MERGES = ("direct", "ring")
FLOAT_STATE = (
    "lat_mean", "lat_var", "err_mean", "rate_mean", "rate_var", "card_mean",
    "card_var", "obs_batches", "obs_windows", "cusum", "span_total",
)
FLOAT_REPORT = ("lat_z", "err_z", "rate_z", "card_z", "hh_ratio", "card_est", "cusum")

BASE = dict(num_services=8, cms_depth=4)
SMALL = dict(num_services=8, hll_p=8, cms_depth=4, cms_width=512)
FAULT = dict(num_services=8, warmup_batches=5.0, z_warmup_batches=20.0)
FAULT_CLEAN = 30
RING_X = (np.arange(4 * 13 * 7, dtype=np.int32).reshape(4, 13, 7) * 37) % 101


def _batches(seed, n_steps):
    """The reference test's recipe: 5 of 8 services, 37 padding lanes."""
    rng = np.random.default_rng(seed)
    tz = SpanTensorizer(num_services=8, batch_size=B)
    out = []
    for _ in range(n_steps):
        n = B - 37
        batch = tz.pack_arrays(
            svc=rng.integers(0, 5, size=n),
            lat_us=rng.normal(300.0, 30.0, size=n).astype(np.float32),
            trace_id=rng.integers(0, 2**63, size=n, dtype=np.uint64),
            is_error=(rng.random(n) < 0.05).astype(np.float32),
            attr_key=rng.zipf(1.5, size=n).astype(np.uint64),
        )
        out.append(tuple(batch))
    return out


def _fault_batches(seed):
    """The reference's fault case: 4 of 8 services at ~200 µs, then one
    batch with service 2 ten times slower."""
    rng = np.random.default_rng(seed)
    tz = SpanTensorizer(num_services=8, batch_size=B)
    out = []
    for k in range(FAULT_CLEAN + 1):
        svc = rng.integers(0, 4, size=B)
        lat = rng.normal(200.0, 10.0, size=B)
        lat[svc == 2] *= 10.0 if k == FAULT_CLEAN else 1.0
        batch = tz.pack_arrays(
            svc=svc, lat_us=lat.astype(np.float32),
            trace_id=rng.integers(0, 2**63, size=B, dtype=np.uint64),
        )
        out.append(tuple(batch))
    return out


BATCHES = _batches(0, N_STEPS)
ROTATES = [np.array([k % 2 == 1, False, k == 3]) for k in range(N_STEPS)]
SMALL_BATCHES = _batches(1, 2)
SMALL_ROTATES = [np.array([k == 1, False, False]) for k in range(2)]
FAULT_BATCHES = _fault_batches(2)
NO_ROTATE = [np.zeros(3, bool)] * (FAULT_CLEAN + 1)


def _scenarios(layout):
    sc = [
        launch.Scenario(tdet.DetectorConfig(**BASE), BATCHES, ROTATES, DT, merge)
        for merge in MERGES
    ]
    if layout == (2, 2):
        sc += [
            launch.Scenario(tdet.DetectorConfig(**SMALL, sketch_impl=impl), SMALL_BATCHES, SMALL_ROTATES, DT)
            for impl in ("interpret", "pallas")
        ]
        sc.append(launch.Scenario(tdet.DetectorConfig(**FAULT), FAULT_BATCHES, NO_ROTATE, DT))
    return sc


@pytest.fixture(scope="module")
def world():
    """Per rank: the replays of every layout (in ``LAYOUTS`` order), then
    the ring merges — one four-rank world for the whole module."""
    tasks = [
        (launch.replay_sharded, (layout, "cpu", _scenarios(layout)))
        for layout in LAYOUTS.values()
    ]
    tasks.append((launch.ring_allreduce, (RING_X, (2, 4), "cpu")))
    return launch.run_world(launch.run_tasks, 4, "cpu", None, WORLD_TIMEOUT_S, tasks)


@pytest.fixture(scope="module")
def worlds(world):
    """Layout name → per-rank scenario results of that layout."""
    return lambda name: [rank_out[list(LAYOUTS).index(name)] for rank_out in world]


def _jax_mesh(layout):
    if len(layout) == 2:
        return jmesh(*layout)
    return jhybrid(n_dcn=layout[0], n_batch=layout[1], n_sketch=layout[2])


@pytest.fixture(scope="module")
def jax_runs():
    """(layout name, scenario index) → JAX sharded (states, reports)."""
    cache = {}

    def get(name, idx):
        key = (name, idx)
        if key not in cache:
            sc = _scenarios(LAYOUTS[name])[idx]
            cfg = JConfig(**sc.config._asdict())
            step, state = jsharded(cfg, _jax_mesh(LAYOUTS[name]), comm_impl=sc.comm_impl)
            reports = []
            for batch, rot in zip(sc.batches, sc.rotates):
                state, rep = step(
                    state, *map(jnp.asarray, batch), jnp.float32(sc.dt), jnp.asarray(rot)
                )
                reports.append(jax.device_get(rep))
            cache[key] = (jax.device_get(state), reports)
        return cache[key]

    return get


def _single_device(sc):
    """The port's single-device step on the CPU over a scenario."""
    cfg = sc.config
    state = tdet.detector_init(cfg, "cpu")
    reports = []
    for batch, rot in zip(sc.batches, sc.rotates):
        lanes = [torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x) for x in batch]
        state, rep = tdet.detector_step(cfg, state, *lanes, torch.tensor(sc.dt), torch.from_numpy(rot))
        reports.append(tdet.DetectorReport(*(t.numpy() for t in rep)))
    return tdet.state_to_numpy(state), reports


def _assert_matches(ref_state, ref_reports, got_state, got_reports):
    for name in ("hll_bank", "cms_bank", "step_idx"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref_state, name)), getattr(got_state, name), err_msg=name
        )
    for name in FLOAT_STATE:
        np.testing.assert_allclose(
            np.asarray(getattr(ref_state, name)), getattr(got_state, name),
            rtol=1e-4, atol=1e-4, err_msg=name,
        )
    assert len(ref_reports) == len(got_reports)
    for k, (ref, got) in enumerate(zip(ref_reports, got_reports)):
        np.testing.assert_array_equal(np.asarray(ref.svc_count), got.svc_count, err_msg=f"svc_count @ {k}")
        np.testing.assert_array_equal(np.asarray(ref.flags), got.flags, err_msg=f"flags @ {k}")
        for name in FLOAT_REPORT:
            np.testing.assert_allclose(
                np.asarray(getattr(ref, name)), getattr(got, name),
                rtol=1e-3, atol=1e-3, err_msg=f"{name} @ {k}",
            )


def _merge_index(merge):
    return MERGES.index(merge)


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_step_matches_jax_sharded_step(worlds, jax_runs, layout, merge):
    idx = _merge_index(merge)
    got = worlds(layout)[0][idx]
    ref_state, ref_reports = jax_runs(layout, idx)
    _assert_matches(ref_state, ref_reports, got["state"], got["reports"])


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_step_matches_single_device_step(worlds, layout, merge):
    idx = _merge_index(merge)
    sc = _scenarios(LAYOUTS[layout])[idx]
    ref_state, ref_reports = _single_device(sc)
    for rank_out in worlds(layout):
        got = rank_out[idx]
        _assert_matches(ref_state, ref_reports, got["state"], got["reports"])


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_batch_replicas_are_bit_identical(worlds, layout, merge):
    """Ranks holding the same sketch slice hold the same bits: state and
    every report, after all-reduced float stats."""
    idx = _merge_index(merge)
    by_sketch = {}
    for rank_out in worlds(layout):
        got = rank_out[idx]
        by_sketch.setdefault(got["coords"]["sketch"], []).append(got)
    n_sketch = LAYOUTS[layout][-1]
    assert sorted(by_sketch) == list(range(n_sketch))
    for replicas in by_sketch.values():
        assert len(replicas) == 4 // n_sketch
        first = replicas[0]
        for other in replicas[1:]:
            for name, a, b in zip(first["local_state"]._fields, first["local_state"], other["local_state"]):
                assert a.tobytes() == b.tobytes(), name
            for ra, rb in zip(first["local_reports"], other["local_reports"]):
                for name, a, b in zip(ra._fields, ra, rb):
                    assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_places_ranks_row_major(worlds, layout):
    shape = LAYOUTS[layout]
    names = ("batch", "sketch") if len(shape) == 2 else ("dcn", "batch", "sketch")
    for rank, rank_out in enumerate(worlds(layout)):
        got = rank_out[0]
        assert got["shape"] == dict(zip(names, shape))
        assert tuple(got["coords"].values()) == tuple(np.unravel_index(rank, shape))


@pytest.mark.parametrize("impl", ["interpret", "pallas"])
def test_sharded_kernel_impls_match_jax_interpret(worlds, jax_runs, impl):
    """The delta kernel's branch on a (2 × 2) mesh at a small geometry
    (p=8, Wc=512): the port's ``"interpret"`` (plain version) and
    ``"pallas"`` (the wrapper; its plain version on CPU tensors) against
    the JAX sharded step running ``_delta_kernel`` in interpret mode."""
    idx = 2 + ("interpret", "pallas").index(impl)
    got = worlds("2x2")[0][idx]
    ref_state, ref_reports = jax_runs("2x2", 2)  # JAX: sketch_impl="interpret"
    _assert_matches(ref_state, ref_reports, got["state"], got["reports"])


def test_sharded_step_detects_fault(worlds):
    """End to end on the (2 × 2) mesh: 30 clean batches flag nothing, then
    a ×10 latency step on service 2 flags it alone, on that batch."""
    reports = worlds("2x2")[0][4]["reports"]
    assert not any(r.flags.any() for r in reports[:FAULT_CLEAN])
    flags = reports[FAULT_CLEAN].flags
    assert flags[2] and flags.sum() == 1


@pytest.mark.parametrize("op", ["max", "sum"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_allreduce_matches_direct(world, n, op):
    """13 × 7 elements, padded to n chunks on both ring sizes: the ring
    merge and the direct all-reduce (``merge_states_across`` both ways)
    equal the reduction of every rank's rows."""
    want = RING_X[:n].max(axis=0) if op == "max" else RING_X[:n].sum(axis=0)
    k = ("max", "sum").index(op)
    for rank in range(n):
        got = world[rank][-1][n]
        for merged in (got[k], got[2 + k]):
            assert merged.shape == want.shape
            np.testing.assert_array_equal(merged, want)


@pytest.mark.parametrize(
    "kw,n_sketch,comm_impl,match",
    [
        (dict(num_services=8), 3, "direct", "num_services"),
        (dict(num_services=6, cms_depth=4), 3, "direct", "cms_depth"),
        (dict(num_services=8), 2, "carrier-pigeon", "comm_impl"),
    ],
)
def test_make_sharded_step_validates(kw, n_sketch, comm_impl, match):
    mesh = types.SimpleNamespace(shape={"batch": 2, "sketch": n_sketch})
    with pytest.raises(ValueError, match=match):
        make_sharded_step(tdet.DetectorConfig(**kw), mesh, comm_impl)


def test_comm_merge_routing(monkeypatch):
    """Which transport each merge takes: an unknown merge raises before any
    early return; small merges stay one all-reduce even in ring mode; on
    a hybrid mesh the inner batch axis is reduced direct and only the dcn
    group rides the ring; float merges never ride it."""
    calls = []
    monkeypatch.setattr(
        collectives.dist, "all_reduce",
        lambda x, op, group: calls.append(("direct", group, x.numel())),
    )
    for name in ("ring_merge_sum", "ring_merge_max"):
        monkeypatch.setattr(
            ring, name,
            lambda x, group, host_staged, name=name: calls.append((name, group, x.numel())) or x,
        )
    with pytest.raises(ValueError, match="merge_impl"):
        collectives.Comm(merge_impl="rign").psum_batch(torch.zeros(4))

    flat = collectives.Comm(batch_group="batch", ring_group="batch", merge_impl="ring")
    flat.psum_batch(torch.zeros(4, dtype=torch.int32))
    flat.pmax_batch(torch.zeros(64, 64, dtype=torch.int32))
    assert calls == [("direct", "batch", 4), ("ring_merge_max", "batch", 4096)]

    calls.clear()
    hybrid = collectives.Comm(
        batch_group="dcn*batch", ring_group="dcn", inner_group="batch", merge_impl="ring"
    )
    hybrid.psum_batch(torch.zeros(64, 64, dtype=torch.int32))
    hybrid.psum_batch_f32(torch.zeros(4, 64))
    hybrid.pmax_batch(torch.zeros(3, 8))
    assert calls == [
        ("direct", "batch", 4096), ("ring_merge_sum", "dcn", 4096),
        ("direct", "dcn*batch", 256), ("direct", "dcn*batch", 24),
    ]

    calls.clear()
    direct = collectives.Comm(batch_group="dcn*batch", sketch_group="sketch", sketch_rank=1)
    direct.psum_batch(torch.zeros(64, 64, dtype=torch.int32))
    direct.pmin_sketch(torch.zeros(3, 5))
    assert calls == [("direct", "dcn*batch", 4096), ("direct", "sketch", 15)]
    assert direct.sketch_index() == 1
    assert collectives.NO_COMM.psum_batch_f32(torch.ones(2)).sum() == 2 and not calls[2:]


def test_place_state_takes_this_ranks_sketch_slice(rng):
    cfg = tdet.DetectorConfig(**BASE)
    glob = tdet.state_to_numpy(tdet.detector_init(cfg, "cpu"))
    glob = tdet.DetectorState(*(
        (rng.random(x.shape) * 100).astype(x.dtype) for x in glob
    ))
    mesh = types.SimpleNamespace(
        shape={"batch": 2, "sketch": 2}, coords={"batch": 1, "sketch": 1},
        device=torch.device("cpu"),
    )
    local = place_state(glob, mesh)
    np.testing.assert_array_equal(local.hll_bank.numpy(), glob.hll_bank[:, :, 4:])
    np.testing.assert_array_equal(local.cms_bank.numpy(), glob.cms_bank[:, :, 2:])
    np.testing.assert_array_equal(local.lat_mean.numpy(), glob.lat_mean[4:])
    np.testing.assert_array_equal(local.obs_batches.numpy(), glob.obs_batches[4:])
    np.testing.assert_array_equal(local.span_total.numpy(), glob.span_total)
    local.cms_bank.add_(1)  # a copy: the global state is untouched
    assert not np.array_equal(local.cms_bank.numpy(), glob.cms_bank[:, :, 2:])


def test_shard_batch_takes_the_flattened_batch_block():
    mesh = types.SimpleNamespace(
        shape={"dcn": 2, "batch": 2, "sketch": 2},
        coords={"dcn": 1, "batch": 0, "sketch": 1}, device=torch.device("cpu"),
    )
    svc = np.arange(16, dtype=np.int32)
    hi = np.arange(16, dtype=np.uint32) + np.uint32(2**31)
    got_svc, got_hi = shard_batch([svc, hi], mesh)
    np.testing.assert_array_equal(got_svc.numpy(), svc[8:12])  # block 1·2 + 0
    assert got_hi.dtype == torch.int32
    np.testing.assert_array_equal(got_hi.numpy().view(np.uint32), hi[8:12])
    with pytest.raises(ValueError, match="divide"):
        shard_batch([np.arange(6, dtype=np.int32)], mesh)


def test_run_world_reports_a_failed_rank():
    """A rank that raises fails the world at once, with its traceback."""
    with pytest.raises(RuntimeError, match="needs 3 ranks"):
        launch.run_world(launch.replay_sharded, 2, "cpu", None, WORLD_TIMEOUT_S, (3, 1), "cpu", [])


def test_run_world_kills_a_hung_world_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="gave no result"):
        launch.run_world(time.sleep, 2, "cpu", None, 5.0, 120.0)
    assert time.monotonic() - t0 < 30.0
