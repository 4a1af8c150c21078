"""Detector self-telemetry: the phase names of an ingest flush.

A flush's wall time is split into phases, each accumulated by the
decode pool (``runtime.ingest_pool``, ``IngestPool.phase_s``):
``decode`` (the native call, whole), its two passes ``scan`` and
``extract`` (sub-phases inside ``decode``, never summed beside it),
``verify`` (the scratch's CRC manifest), ``tensorize`` (intern and
column pass) and ``submit`` (the pipeline merge). The batch-lifecycle
tracer and the phase histograms that consume these names arrive with a
later slice.
"""

from __future__ import annotations

PHASE_DECODE = "decode"
PHASE_SCAN = "scan"
PHASE_EXTRACT = "extract"
PHASE_VERIFY = "verify"
PHASE_TENSORIZE = "tensorize"
PHASE_SUBMIT = "submit"
