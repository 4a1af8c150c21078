"""opentelemetry_demo_tpu_torch — the streaming anomaly detector in PyTorch.

A port of ``opentelemetry_demo_tpu`` (the JAX reference, which stays in
the repository unchanged) to PyTorch on an NVIDIA H100. The module
layout and public names mirror the reference so each counterpart is
easy to find:

- ``ops``      sketch operations on tensors (hashing, HLL, CMS, EWMA, the
               fused batch update) with hand-written CUDA kernels under
               ``csrc/`` and a plain PyTorch version beside each one.
- ``models``   the detector: config, state, the per-batch step, the
               packed report, and the ``AnomalyDetector`` driver.
- ``runtime``  host side: OTLP decode, tensorization, the pipeline.

The package imports neither ``jax`` nor the reference package; it keeps
its own copies of the host modules it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request they raise.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another. ``None`` with no CUDA device raises instead of
    carrying on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
