"""The comparison that decides `correct`: sound runs of the port on the
CPU pass it, and the control and each fault the cells can have fail it.

Each case drives a whole run of the harness (generator, pool, pipeline,
spine, pump, harvest, judge) on the CPU at a small size; the faults are
planted under the timed path by patching the port in this process."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness.k1_bytes import batch_bytes
from benchmark.reference.hashing import cms_cells, hll_cells
from benchmark.tests.conftest import CLOSED, PACED, run_small, small_config


@pytest.mark.parametrize("name,mix", [("shop", CLOSED), ("shop", PACED)],
                         ids=["shop-closed", "shop-paced"])
def test_the_port_on_the_cpu_agrees_with_the_reference(name, mix):
    run = run_small(small_config(name), mix, control=True)
    v = run["verdict"]
    assert v["correct"], v["numbers"]
    assert v["batches"] > 5 and v["reports"] == v["batches"]
    # The control (the reference in bfloat16) fails what the run passed.
    c = v["control"]
    limits = small_config(name)["limits"]
    assert c["score_gap"] > limits["score_gap"] or c["head_gap"] > limits["head_gap"]


def _patch_step(monkeypatch, wrap):
    from opentelemetry_demo_tpu_torch.models import detector

    for name in ("observe_staged_packed", "observe_packed"):
        orig = getattr(detector.AnomalyDetector, name)
        monkeypatch.setattr(detector.AnomalyDetector, name, wrap(orig))


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    def wrap(orig):
        def frozen(self, lanes, t_now):
            saved = [t.clone() for t in self.state]
            out = orig(self, lanes, t_now)
            for dst, src in zip(self.state, saved):
                dst.copy_(src)
            return out
        return frozen

    _patch_step(monkeypatch, wrap)
    v = run_small()["verdict"]
    assert not v["correct"] and v["numbers"]["sketch_cells_wrong"][0] > 0


def test_half_the_batch_left_out_fails(monkeypatch):
    def wrap(orig):
        def half(self, lanes, t_now):
            if isinstance(lanes, torch.Tensor) and lanes.dim() == 1:
                b = lanes.shape[0] // 8
                lanes = lanes.clone()
                lanes[7 * b + b // 2: 8 * b] = 0  # the valid lane of the second half
            else:
                lanes = lanes._replace(valid=np.where(np.arange(lanes.valid.shape[0]) < lanes.valid.shape[0] // 2,
                                                      lanes.valid, False))
            return orig(self, lanes, t_now)
        return half

    _patch_step(monkeypatch, wrap)
    v = run_small()["verdict"]
    assert not v["correct"] and v["numbers"]["sketch_cells_wrong"][0] > 0


def test_a_span_altered_where_it_is_decoded_fails(monkeypatch):
    from opentelemetry_demo_tpu_torch.runtime.tensorize import SpanTensorizer

    orig = SpanTensorizer.columns_from_columnar

    def altered(self, cols, copy=False, arena=None):
        out = orig(self, cols, copy=copy, arena=arena)
        lat = out.lat_us.copy()
        lat[0] += 1.0
        return out._replace(lat_us=lat)

    monkeypatch.setattr(SpanTensorizer, "columns_from_columnar", altered)
    v = run_small()["verdict"]
    assert not v["correct"] and v["numbers"]["decode_rows_wrong"][0] > 0


def test_error_lane_rows_shed_as_ok_rows_fail(monkeypatch):
    from opentelemetry_demo_tpu_torch.runtime.pipeline import DetectorPipeline

    orig = DetectorPipeline.submit_columns

    def drop_errors(self, cols, *a, **kw):
        err = np.asarray(cols.is_error) > 0.0
        if err.any():
            cols = cols.compress(~err)
            self.stats.shed_rows["ok"] += int(err.sum())
        return orig(self, cols, *a, **kw)

    monkeypatch.setattr(DetectorPipeline, "submit_columns", drop_errors)
    v = run_small()["verdict"]
    assert not v["correct"] and v["numbers"]["decode_rows_wrong"][0] > 0
    assert v["decode"]["missing_error"] > 0


def test_a_flag_altered_where_the_report_is_read_fails(monkeypatch):
    from opentelemetry_demo_tpu_torch.runtime import pipeline

    orig = pipeline.report_unpack
    count = [0]

    def flipped(flat, config):
        rep = orig(flat, config)
        count[0] += 1
        if count[0] % 4 == 0:
            flags = rep.flags.copy()
            flags[0] = not flags[0]
            rep = rep._replace(flags=flags)
        return rep

    monkeypatch.setattr(pipeline, "report_unpack", flipped)
    v = run_small()["verdict"]
    assert not v["correct"] and v["numbers"]["flags_wrong"][0] > 0


def test_k1_bytes_of_a_hand_counted_batch():
    g = dict(num_services=4, hll_p=4, cms_depth=2, cms_width=8, taus_s=[1.0, 10.0], windows_s=[1.0, 10.0, 60.0])
    slot = np.array([0, 0, 3, 3, 3])
    trace = np.array([5, 5, 9, 10, 9], np.uint64)
    attr = np.array([1, 1, 2, 2, 2], np.uint64)
    bucket, _ = hll_cells(trace, 4)
    hll = len({(int(s), int(b)) for s, b in zip(slot, bucket)})
    idx = cms_cells(attr, slot, 2, 8)
    cms = len({(d, int(i)) for d in range(2) for i in idx[d]})
    # 8 lanes of 4 B x 5 + 1 B + 4 B x D; touched cells x 3 windows x read+write;
    # heads: 5 [S, T] and 4 [S] read+written, 3 [S, T] z's and 4 [S] stats written, 8 B of scalars.
    want = 8 * (20 + 1 + 8) + (hll + cms) * 3 * 8 + (5 * 4 * 2 + 3 * 4 + 4) * 8 + 3 * 4 * 2 * 4 + 16 * 4 + 8
    assert batch_bytes(g, 8, slot, trace, attr) == want
    assert hll == 3 and cms <= 4
