"""The generator: deterministic by seed, true to its parameters, and
bodies the port's native decoder reads back as the generator's spans."""

from __future__ import annotations

import zlib

import numpy as np
import pytest

from benchmark.harness import traffic
from benchmark.tests.conftest import CLOSED, PACED, small_config


@pytest.mark.parametrize("mix", [CLOSED, PACED], ids=["closed", "paced"])
def test_same_seed_same_bodies_other_seed_other_bodies(mix):
    table = traffic.service_table(small_config())
    _, w1, t1 = traffic.build(table, mix, 7, 2.0)
    _, w2, t2 = traffic.build(table, mix, 7, 2.0)
    _, _, t3 = traffic.build(table, mix, 2**31 + 8, 2.0)
    assert [s.body for s in w1 + t1] == [s.body for s in w2 + t2]
    assert [s.due for s in t1] == [s.due for s in t2]
    assert [s.body for s in t1] != [s.body for s in t3]


def test_closed_mix_sizes_and_pool():
    table = traffic.service_table(small_config())
    corpus, warm, timed = traffic.build(table, CLOSED, 3, 2.0)
    assert len(timed) == CLOSED["pool_bodies"]
    assert all(len(s.rows) == CLOSED["spans_per_body"] and s.due is None for s in timed)
    assert [len(s.rows) for s in warm] == CLOSED["warmup_bodies"]
    keys = corpus.span_keys()
    assert np.unique(keys).shape[0] == keys.shape[0]


def test_paced_mix_flushes_per_agent_and_cap():
    table = traffic.service_table(small_config())
    mix = dict(PACED, cap=30)
    seconds = 3.0
    _, _, timed = traffic.build(table, mix, 5, seconds)
    dues = np.array([s.due for s in timed])
    assert np.all(np.diff(dues) >= 0) and dues.min() >= 0 and dues.max() < seconds
    # Each agent flushes on its own phase every flush_s, at most once a slot.
    per_slot = np.round(dues / (mix["flush_s"] / mix["agents"])).astype(int)
    assert np.unique(per_slot).shape[0] == per_slot.shape[0]
    assert len(timed) <= mix["agents"] * seconds / mix["flush_s"]
    assert max(len(s.rows) for s in timed) == 30


def test_service_shares_and_error_share_follow_the_table():
    cfg = small_config()
    table = traffic.service_table(cfg)
    rows = cfg["services"]["table"]
    assert table.names == [r["name"] for r in rows]
    corpus = traffic.Corpus(table, 1)
    corpus.draw([200_000], stream=2)
    counts = np.bincount(corpus.cols["svc"], minlength=len(rows)) / 200_000
    assert np.allclose(counts, table.share, atol=0.005)
    err = np.array([r["error_rate"] for r in rows])
    assert err.min() > 0
    assert corpus.cols["err"].mean() == pytest.approx(float(table.share @ err), rel=0.15)


def test_the_native_decoder_reads_the_generators_spans():
    native = pytest.importorskip("opentelemetry_demo_tpu_torch.runtime.native")
    if not native.available():
        pytest.skip(f"native decoder unavailable: {native.load_error()}")
    from opentelemetry_demo_tpu_torch.runtime.otlp import MONITORED_ATTR_KEYS

    table = traffic.service_table(small_config())
    corpus, warm, timed = traffic.build(table, PACED, 11, 1.0)
    c = corpus.cols
    for s in warm + timed[:5]:
        cols = native.decode_otlp(s.body, MONITORED_ATTR_KEYS)
        r = s.rows
        assert [cols.services[i] for i in cols.svc_idx] == [table.names[i] for i in c["svc"][r]]
        assert np.array_equal(cols.duration_us, c["dur_us"][r].astype(np.float32))
        assert np.array_equal(cols.trace_key, c["trace_lo"][r])
        assert np.array_equal(cols.is_error.astype(bool), c["err"][r])
        vals = [corpus.attr_values[a] if a >= 0 else "" for a in c["attr"][r]]
        assert np.array_equal(cols.attr_crc, np.array([zlib.crc32(v.encode()) for v in vals], np.uint32))
