"""The port's OTLP-metrics leg against the JAX reference: metric bodies
→ records (bit for bit), the metrics head over a chained run, and the
feed that folds records into head steps.

Tolerance of the head: the state and z within rtol 1e-5 / atol 1e-5.
The step is the same float32 arithmetic in the same order in both
packages; only exp/sqrt come from different math libraries (an ulp
apart), and the EWMA carries that ulp on. ``cell_flags`` and ``flags``
must be identical.
"""

import json

import jax
import numpy as np
import pytest
import torch

from opentelemetry_demo_tpu.models import metrics_head as jmh
from opentelemetry_demo_tpu.runtime import metrics_feed as jfeed
from opentelemetry_demo_tpu.runtime import otlp_metrics as jom
from opentelemetry_demo_tpu.runtime import wire as jwire
from opentelemetry_demo_tpu_torch.models import metrics_head as tmh
from opentelemetry_demo_tpu_torch.runtime import metrics_feed, otlp_metrics

RTOL, ATOL = 1e-5, 1e-5
SMALL = dict(num_services=6, num_metrics=5, warmup_obs=4.0)


def _payload(rng, k, n_svc=5, slow=None):
    """One scrape: a cumulative counter, an error counter and a gauge per
    service; ``slow`` steps one service's request rate ×10."""
    out = []
    for i in range(n_svc):
        rate = 100.0 * (i + 1) * (10.0 if i == slow else 1.0)
        out.append((f"svc-{i}", [
            ("requests_total", float(rate * 10.0 * k + rng.normal(0, 5.0)), True),
            ("errors_total", float(k + rng.integers(0, 2)), True),
            ("queue_depth", float(rng.normal(50.0, 2.0)), False),
        ]))
    return out


def _histogram_body():
    """A body with the kinds the encoder does not make: histograms (delta
    and cumulative), delta sums, integer points, a resource without a
    service name."""
    w = jwire

    def point(fields):
        return b"".join(fields)

    num_int = point([w.encode_fixed64(3, 77), w.encode_tag(6, 1) + (-5 & (2**64 - 1)).to_bytes(8, "little")])
    hist_dp = point([w.encode_fixed64(3, 88), w.encode_fixed64(4, 12), w.encode_double(5, 3.5)])
    metrics = [
        w.encode_len(1, b"lat") + w.encode_len(9, w.encode_len(1, hist_dp) + w.encode_int(2, 1)),
        w.encode_len(1, b"lat2") + w.encode_len(9, w.encode_len(1, hist_dp) + w.encode_int(2, 2)),
        w.encode_len(1, b"delta") + w.encode_len(
            7, w.encode_len(1, num_int) + w.encode_int(2, 1) + w.encode_int(3, 1)),
        w.encode_len(1, b"level") + w.encode_len(5, w.encode_len(1, num_int)),
    ]
    scope = b"".join(w.encode_len(2, m) for m in metrics)
    rm = w.encode_len(2, scope)  # no resource: service "unknown"
    named = jom.encode_metrics_request([("cart", [("x", 1.5, True)])], t_ns=5)
    return w.encode_len(1, rm) + named


def _json_body(payload, t_ns):
    doc = {"resourceMetrics": []}
    for svc, metrics in payload:
        ms = []
        for name, value, is_counter in metrics:
            dp = {"timeUnixNano": str(t_ns), "asDouble": value}
            if is_counter:
                ms.append({"name": name, "sum": {"dataPoints": [dp], "isMonotonic": True,
                                                 "aggregationTemporality": "AGGREGATION_TEMPORALITY_CUMULATIVE"}})
            else:
                ms.append({"name": name, "gauge": {"dataPoints": [dp]}})
        ms.append({"name": "h", "histogram": {"aggregationTemporality": 1,
                                              "dataPoints": [{"count": "3", "sum": 1.25}]}})
        ms.append({"name": "i", "sum": {"dataPoints": [{"asInt": "-4"}], "aggregationTemporality": 1,
                                        "isMonotonic": False}})
        doc["resourceMetrics"].append({
            "resource": {"attributes": [{"key": "service.name", "value": {"stringValue": svc}}]},
            "scopeMetrics": [{"metrics": ms}],
        })
    return json.dumps(doc).encode()


def test_constants_and_config_mirror_the_reference():
    for name in ("TEMPORALITY_UNSPECIFIED", "TEMPORALITY_DELTA", "TEMPORALITY_CUMULATIVE"):
        assert getattr(otlp_metrics, name) == getattr(jom, name)
    assert otlp_metrics.MetricRecord._fields == jom.MetricRecord._fields
    assert tmh.MetricsHeadConfig._fields == jmh.MetricsHeadConfig._fields
    assert tuple(tmh.MetricsHeadConfig()) == tuple(jmh.MetricsHeadConfig())
    assert tmh.MetricsHeadState._fields == jmh.MetricsHeadState._fields
    assert tmh.MetricsHeadReport._fields == jmh.MetricsHeadReport._fields


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encoded_bodies_are_the_references(seed):
    payload = _payload(np.random.default_rng(seed), seed + 1)
    assert otlp_metrics.encode_metrics_request(payload, 10**18, 10**17) == jom.encode_metrics_request(
        payload, 10**18, 10**17)


@pytest.mark.parametrize("kind", ["protobuf", "protobuf_kinds", "json"])
def test_decoded_records_equal_the_references(kind):
    payload = _payload(np.random.default_rng(3), 4)
    if kind == "protobuf":
        body = otlp_metrics.encode_metrics_request(payload, 10**18)
        got, ref = otlp_metrics.decode_metrics_request(body), jom.decode_metrics_request(body)
    elif kind == "protobuf_kinds":
        body = _histogram_body()
        got, ref = otlp_metrics.decode_metrics_request(body), jom.decode_metrics_request(body)
        assert {r.name for r in got} >= {"lat_count", "lat_sum", "delta", "level"}
        assert any(r.service == "unknown" for r in got)
    else:
        body = _json_body(payload, 10**18)
        got, ref = otlp_metrics.decode_metrics_request_json(body), jom.decode_metrics_request_json(body)
    assert len(got) == len(ref) > 0
    assert [tuple(r) for r in got] == [tuple(r) for r in ref]


def _head_inputs(rng, n_steps, s, m, onset):
    """Chained observations: cells warm on noisy levels, some cells are
    quiet each step, and one cell steps ×10 at ``onset``."""
    base = rng.uniform(5.0, 500.0, (s, m))
    out = []
    for k in range(n_steps):
        x = base * (1.0 + rng.normal(0.0, 0.03, (s, m)))
        if k >= onset:
            x[2, 1] *= 10.0
        observed = rng.random((s, m)) < 0.9
        observed[2, 1] = True
        dt = float(rng.uniform(5.0, 15.0))
        out.append((x.astype(np.float32), observed, dt))
    return out


def test_chained_head_run_matches_the_reference():
    cfg_kw = dict(SMALL)
    jcfg, tcfg = jmh.MetricsHeadConfig(**cfg_kw), tmh.MetricsHeadConfig(**cfg_kw)
    ref, got = jmh.MetricsHead(jcfg), tmh.MetricsHead(tcfg, device="cpu")
    onset = 20
    flagged_at = None
    for k, (x, observed, dt) in enumerate(_head_inputs(np.random.default_rng(5), 30, 6, 5, onset)):
        r, g = ref.observe(x, observed, dt), got.observe(x, observed, dt)
        np.testing.assert_array_equal(np.asarray(r.cell_flags), g.cell_flags.numpy(), err_msg=f"step {k}")
        np.testing.assert_array_equal(np.asarray(r.flags), g.flags.numpy(), err_msg=f"step {k}")
        np.testing.assert_allclose(np.asarray(r.z), g.z.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"z @ {k}")
        rs = jax.device_get(ref.state)
        for name in tmh.MetricsHeadState._fields:
            a, b = np.asarray(getattr(rs, name)), getattr(got.state, name).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{name} @ {k}")
        if flagged_at is None and g.flags.any():
            flagged_at = k
    assert flagged_at == onset, "the ×10 cell flags on its first step after onset, not before"


def test_step_functions_match_on_a_random_state():
    """One step from a random warm state, with cells below and past the
    warm-up and some unobserved."""
    rng = np.random.default_rng(6)
    s, m, t = 6, 5, 3
    cfg = dict(SMALL)
    state_np = jmh.MetricsHeadState(
        mean=rng.uniform(0.0, 100.0, (s, m, t)).astype(np.float32),
        var=rng.uniform(0.0, 50.0, (s, m, t)).astype(np.float32),
        obs=rng.integers(0, 10, (s, m)).astype(np.float32),
        step_idx=np.asarray(7, np.int32),
    )
    x = rng.uniform(0.0, 200.0, (s, m)).astype(np.float32)
    observed = rng.random((s, m)) < 0.7
    j_state, j_rep = jmh.metrics_head_step(jmh.MetricsHeadConfig(**cfg), state_np, x, observed,
                                           np.float32(10.0))
    t_state, t_rep = tmh.metrics_head_step(
        tmh.MetricsHeadConfig(**cfg), tmh.head_state_from_numpy(state_np, "cpu"),
        torch.from_numpy(x), torch.from_numpy(observed), torch.tensor(10.0),
    )
    for name in tmh.MetricsHeadState._fields:
        np.testing.assert_allclose(np.asarray(getattr(j_state, name)), getattr(t_state, name).numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(np.asarray(j_rep.cell_flags), t_rep.cell_flags.numpy())
    np.testing.assert_array_equal(np.asarray(j_rep.flags), t_rep.flags.numpy())


def _feed_pair(**kw):
    cfg = dict(SMALL)
    return (jfeed.MetricsFeed(jmh.MetricsHeadConfig(**cfg), **kw),
            metrics_feed.MetricsFeed(tmh.MetricsHeadConfig(**cfg), device="cpu", **kw))


def test_feed_reports_equal_the_references():
    """Records and pump times through both feeds: quiet intervals,
    repeated timestamps, a counter reset, names past capacity; after
    warm-up one service's request rate steps ×10 and flags at once."""
    rng = np.random.default_rng(7)
    ref, got = _feed_pair()
    onset, flagged = 16, []
    for k in range(24):
        payload = _payload(rng, k, n_svc=7, slow=3 if k >= onset else None)  # 7 > 6 slots
        if k == 9:
            payload[1][1][0] = ("requests_total", 5.0, True)  # a counter reset
        recs = jom.decode_metrics_request(jom.encode_metrics_request(payload, 10**18 + k))
        if k != 5:  # one quiet interval
            ref.submit(recs)
            got.submit(recs)
        for t in ((10.0 * k,) if k != 12 else (10.0 * k, 10.0 * k)):  # a repeated timestamp
            r, g = ref.pump(t), got.pump(t)
            assert (r is None) == (g is None), k
            if r is None:
                continue
            np.testing.assert_array_equal(np.asarray(r.cell_flags), g.cell_flags.numpy(), err_msg=f"{k}")
            np.testing.assert_array_equal(np.asarray(r.flags), g.flags.numpy(), err_msg=f"{k}")
            np.testing.assert_allclose(np.asarray(r.z), g.z.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{k}")
            names = got.service_names
            assert got.flagged_services(g, names) == ref.flagged_services(r, names)
            if g.flags.any():
                flagged.append((k, got.flagged_services(g, names)))
    assert (got.points_total, got.points_overflow) == (ref.points_total, ref.points_overflow)
    assert got.points_overflow > 0
    assert got.service_names == ref.service_names and got.metric_slot_names() == ref.metric_slot_names()
    # The quiet interval (two intervals' counts in one) and the counter
    # reset flag in both packages alike; after them nothing flags until
    # the onset, and the onset flags its service at once.
    assert [f for f in flagged if f[0] > 10][0] == (onset, ["svc-3"])
    rs = jax.device_get(ref.head.state)
    for name in tmh.MetricsHeadState._fields:
        np.testing.assert_allclose(np.asarray(getattr(rs, name)), getattr(got.head.state, name).numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_feed_with_an_external_service_id_and_delta_sums():
    ids = {"a": 0, "b": 4, "c": 9}
    ref, got = _feed_pair(service_id=lambda n: ids.get(n, -1))
    for k in range(6):
        recs = [otlp_metrics.MetricRecord(n, "d", float(k + i), temporality=otlp_metrics.TEMPORALITY_DELTA)
                for i, n in enumerate(("a", "b", "c", "z"))]
        ref.submit([jom.MetricRecord(*r) for r in recs])
        got.submit(recs)
        r, g = ref.pump(2.0 * k), got.pump(2.0 * k)
        assert (r is None) == (g is None)
        if r is not None:
            np.testing.assert_allclose(np.asarray(r.z), g.z.numpy(), rtol=RTOL, atol=ATOL)
    assert (got.points_total, got.points_overflow) == (ref.points_total, ref.points_overflow) == (12, 12)
    np.testing.assert_allclose(np.asarray(jax.device_get(ref.head.state).mean),
                               got.head.state.mean.numpy(), rtol=RTOL, atol=ATOL)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the metrics head runs on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_head_on_the_card_matches_the_cpu(cuda_device):
    cfg = tmh.MetricsHeadConfig(**SMALL)
    card, cpu = tmh.MetricsHead(cfg, device=cuda_device), tmh.MetricsHead(cfg, device="cpu")
    for k, (x, observed, dt) in enumerate(_head_inputs(np.random.default_rng(8), 30, 6, 5, 20)):
        a, b = card.observe(x, observed, dt), cpu.observe(x, observed, dt)
        assert torch.equal(a.flags.cpu(), b.flags) and torch.equal(a.cell_flags.cpu(), b.cell_flags), k
        torch.testing.assert_close(a.z.cpu(), b.z, rtol=RTOL, atol=ATOL)
    for name in tmh.MetricsHeadState._fields:
        torch.testing.assert_close(getattr(card.state, name).cpu(), getattr(cpu.state, name),
                                   rtol=RTOL, atol=ATOL)
