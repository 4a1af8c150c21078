"""The cardinality soaks of the port's front door, on the CPU.

``measure_million_key_soak`` and ``measure_churn_soak`` run through the
native front door into a pipeline on the CPU, at a reduced size stated
in each test (the card runs them at their defaults: ``chip_smoke.py``
``phase_fleet``). The gates are the card phase's: the intern table
holds exactly its capacity of keys and reads them back bit-stable, the
fleet merge refuses a drifted geometry and a keyspace-generation bump,
no pooled frame is corrupt, and under churn the live cohort keeps its
ids and rows while evicted keys answer from history. The million-key
soak's key accounting (capacity, keys interned, keys refused into the
overflow bucket) equals the reference's soak at the same size; it does
not depend on timing. Everything compares exactly.
"""

from __future__ import annotations

import pytest
import torch

from opentelemetry_demo_tpu.runtime import frontdoorbench as jfrontdoorbench
from opentelemetry_demo_tpu_torch.runtime import frontdoorbench

# A sixteenth of the default million keys, at the default geometry
# (4096 services, 4096 keys a request, B = 4096).
MILLION_SOAK_CPU = dict(target_keys=65_536)
# The reference's comparison at a smaller geometry (its CPU step at
# 4096 services compiles for long): 512 services, 16,384 keys.
MILLION_SOAK_SMALL = dict(target_keys=16_384, services_per_request=1024, num_services=512, batch=1024)
# Four waves of the default eight, at the default 512 services.
CHURN_SOAK_CPU = dict(waves=4)

ACCOUNTING = ("distinct_keys", "distinct_interned", "intern_capacity", "overflow_keys", "intern_exact",
              "readback_ok", "drift_refused", "frames_corrupt", "decode_errors", "soak_ok")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The geometries here are small: torch's intra-op pool gains
    nothing and spins against XLA's pool and the other test processes'
    threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.fixture(scope="module")
def million():
    return frontdoorbench.measure_million_key_soak(device="cpu", **MILLION_SOAK_CPU)


def test_the_million_key_soak_holds_its_gates(million):
    out = million
    assert out["via_frontdoor"] is True and out["device"] == "cpu"
    assert out["sketch_num_services"] == 4096
    assert out["intern_exact"] and out["readback_ok"] and out["drift_refused"]
    assert out["distinct_interned"] == out["intern_capacity"] == 4095
    assert out["overflow_keys"] == out["distinct_keys"] - out["intern_capacity"]
    assert out["frames_corrupt"] == out["decode_errors"] == 0
    assert out["soak_ok"] is True
    # Trimmed below half a million keys: the RSS gate has no verdict.
    assert out["soak_rss_ok"] is None and out["rss_per_million_keys_mb"] is not None


def test_the_million_key_soaks_accounting_is_the_references():
    got = frontdoorbench.measure_million_key_soak(device="cpu", **MILLION_SOAK_SMALL)
    want = jfrontdoorbench.measure_million_key_soak(**MILLION_SOAK_SMALL)
    assert want["via_frontdoor"] is True
    assert {k: got[k] for k in ACCOUNTING} == {k: want[k] for k in ACCOUNTING}


def test_the_churn_soak_keeps_the_live_cohort():
    out = frontdoorbench.measure_churn_soak(device="cpu", **CHURN_SOAK_CPU)
    assert out["via_frontdoor"] is True and out["device"] == "cpu"
    assert out["evictions"] > 0 and out["generation"] > 0 and out["eviction_records"] > 0
    assert out["live_ids_stable"] and out["live_rows_ok"]
    assert out["evicted_query_ok"] and out["gen_refused"]
    assert out["frames_corrupt"] == 0 and out["rss_slope_ok"] is not False
    assert out["churn_ok"] is True

