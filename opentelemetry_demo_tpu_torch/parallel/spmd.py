"""The sharded detector step: one rank of a (batch × sketch) mesh.

Layout:

- **batch axes** (data parallel): every span-batch array is sharded in
  contiguous blocks; state is replicated. Merges: sum (CMS deltas,
  segment stats, counts) and max (HLL deltas, heavy-hitter maxima), every
  step.
- **sketch axis**: per-service state (HLL service axis, EWMA heads) and
  the CMS depth axis are sharded. No gather is needed on the forward
  path: global service ids localise by subtraction and out-of-slice ids
  fall off through scatter-drop and one-hot miss; only the CMS point
  query needs a min across the axis.

The local function is ``models.detector_step`` itself, given a
:class:`~..ops.collectives.Comm` over the mesh's process groups: the
single-device and sharded programs are one implementation.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.detector import (
    DetectorConfig,
    DetectorReport,
    DetectorState,
    detector_init,
    detector_step,
)
from ..ops.collectives import Comm
from .mesh import Mesh, host_staged


def sharded_state_specs() -> DetectorState:
    """Per field of ``DetectorState``, the axis each dimension lives on
    (``"sketch"`` or ``None``, replicated), in the manner of a
    ``PartitionSpec``. Every field is replicated over the batch axes. The
    specs are shape-independent, so placement needs no config."""
    per_service = ("sketch", None)
    return DetectorState(
        hll_bank=(None, None, "sketch", None),
        cms_bank=(None, None, "sketch", None),  # depth axis sharded
        span_total=(None, None),
        lat_mean=per_service,
        lat_var=per_service,
        err_mean=per_service,
        rate_mean=per_service,
        rate_var=per_service,
        card_mean=per_service,
        card_var=per_service,
        obs_batches=("sketch",),
        obs_windows=per_service,
        cusum=per_service,
        step_idx=(),
    )


def report_specs() -> DetectorReport:
    """Per field of ``DetectorReport``: per-service fields on ``sketch``."""
    per_service = ("sketch", None)
    return DetectorReport(
        lat_z=per_service,
        err_z=per_service,
        rate_z=per_service,
        card_z=per_service,
        card_est=per_service,
        hh_ratio=per_service,
        svc_count=("sketch",),
        cusum=per_service,
        flags=("sketch",),
    )


def _sketch_dim(spec: tuple) -> int | None:
    return spec.index("sketch") if "sketch" in spec else None


def place_state(state, mesh: Mesh) -> DetectorState:
    """A global detector state (numpy arrays or tensors, by field name —
    e.g. ``state_to_numpy`` of a single-device state) → this rank's slice,
    copied onto ``mesh.device``. The elastic-checkpoint primitive: global
    shapes carry no device count, so moving a snapshot between layouts is
    exactly this placement."""
    n, k = mesh.shape["sketch"], mesh.coords["sketch"]
    fields = []
    for name, spec in zip(DetectorState._fields, sharded_state_specs()):
        x = getattr(state, name)
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        dim = _sketch_dim(spec)
        if dim is not None:
            size = x.shape[dim]
            if size % n:
                raise ValueError(f"{name}: axis {dim} of {size} does not divide by {n}")
            x = x.narrow(dim, k * (size // n), size // n)
        fields.append(torch.empty(x.shape, dtype=x.dtype, device=mesh.device).copy_(x))
    return DetectorState(*fields)


def _gather(tuple_, specs, mesh: Mesh):
    """All-gather each sketch-sharded field over the sketch group, into
    numpy; replicated fields are this rank's copy."""
    group = mesh.groups["sketch"]
    n = mesh.shape["sketch"]
    out = []
    for x, spec in zip(tuple_, specs):
        dim = _sketch_dim(spec)
        if dim is None or n == 1:
            out.append(x.detach().cpu().numpy())
            continue
        # The gather is for the host, so a gloo world gathers host copies.
        x = x.detach().contiguous()
        if dist.get_backend(group) == "gloo":
            x = x.cpu()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        out.append(torch.cat(parts, dim=dim).cpu().numpy())
    return type(tuple_)(*out)


def gather_state(state: DetectorState, mesh: Mesh) -> DetectorState:
    """This rank's slice → the global state as numpy arrays (on every
    rank of the sketch group; a collective over it)."""
    return _gather(state, sharded_state_specs(), mesh)


def gather_report(report: DetectorReport, mesh: Mesh) -> DetectorReport:
    """This rank's report → the global report as numpy arrays."""
    return _gather(report, report_specs(), mesh)


def shard_batch(arrays: Sequence, mesh: Mesh) -> list[torch.Tensor]:
    """This rank's contiguous block of each global batch array, on
    ``mesh.device``. Blocks follow the flattened batch-shard index
    ``dcn · n_batch + batch``; uint32 hash lanes arrive as int32 bits."""
    n = mesh.shape.get("dcn", 1) * mesh.shape["batch"]
    i = mesh.coords.get("dcn", 0) * mesh.shape["batch"] + mesh.coords["batch"]
    out = []
    for x in arrays:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} does not divide by {n} batch shards")
        out.append(x[i * (b // n):(i + 1) * (b // n)].to(mesh.device).contiguous())
    return out


def make_sharded_step(
    config: DetectorConfig, mesh: Mesh, comm_impl: str = "direct"
) -> tuple[Callable, DetectorState]:
    """The sharded step and this rank's slice of a fresh state.

    Returns ``(step_fn, state)``; ``step_fn(state, *batch_shard, dt,
    rotate)`` has the single-device step's signature and semantics (state
    updated in place and returned, with the report), on this rank's batch
    shard (:func:`shard_batch`). ``num_services`` and ``cms_depth`` must
    divide by the sketch-axis size.

    ``comm_impl`` selects the delta merge (``Comm.merge_impl``):
    ``"direct"`` one all-reduce, ``"ring"`` the neighbour ring on the
    long-haul axis — on a hybrid mesh the ``dcn`` hop rides the ring while
    the inner ``batch`` merge stays direct.
    """
    n_sketch = mesh.shape["sketch"]
    if config.num_services % n_sketch:
        raise ValueError("num_services must divide by the sketch axis")
    if config.cms_depth % n_sketch:
        raise ValueError("cms_depth must divide by the sketch axis")
    if comm_impl not in ("direct", "ring"):
        raise ValueError(f"unknown comm_impl {comm_impl!r}")
    hybrid = "dcn" in mesh.shape
    comm = Comm(
        batch_group=mesh.groups["batch_axes"],
        sketch_group=mesh.groups["sketch"],
        sketch_rank=mesh.coords["sketch"],
        merge_impl=comm_impl,
        ring_group=mesh.groups["dcn" if hybrid else "batch"],
        inner_group=mesh.groups["batch"] if hybrid else None,
        host_staged=host_staged(mesh.device),
    )
    step = functools.partial(detector_step, config, comm=comm)
    state = place_state(detector_init(config, mesh.device), mesh)
    return step, state
