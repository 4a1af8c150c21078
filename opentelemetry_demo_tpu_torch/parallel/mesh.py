"""Mesh construction for the detector's (batch × sketch) layout.

A mesh is this world's ranks laid out on named axes, built on
``torch.distributed.device_mesh.init_device_mesh``: ``("batch",
"sketch")``, or ``("dcn", "batch", "sketch")`` where an outer axis spans
hosts. Ranks are placed row-major, so global rank ``r`` sits at sketch
coordinate ``r % n_sketch`` and batch-shard index ``r // n_sketch``
(``dcn · n_batch + batch`` on a hybrid mesh).

The process group's backend is the world's: NCCL for a world of cards,
gloo on the CPU (``parallel.launch.run_world`` picks them). A world may
run gloo on CUDA tensors, as several ranks sharing one card must (NCCL
refuses two ranks on one device); the communicator then stages the ring's
point-to-point hops through host memory (``ops.collectives.Comm``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


class Mesh(NamedTuple):
    """This rank's view of a mesh.

    ``groups`` holds one process group per axis (the one containing this
    rank) and, under ``"batch_axes"``, the group over every batch-sharding
    axis at this rank's sketch coordinate (``dcn × batch`` on a hybrid
    mesh, ``batch`` otherwise)."""

    device_mesh: DeviceMesh
    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, dist.ProcessGroup]
    device: torch.device


def rank_device(device_type: str) -> torch.device:
    """This rank's device: its current card on ``"cuda"``."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def host_staged(device: torch.device) -> bool:
    """Whether point-to-point hops must go through host memory: gloo
    carries CUDA tensors in its collectives, but its send/recv take host
    tensors only."""
    return device.type == "cuda" and dist.get_backend() == "gloo"


def _build(device_type: str, sizes: dict[str, int]) -> Mesh:
    world = dist.get_world_size()
    n = 1
    for size in sizes.values():
        n *= size
    if n != world:
        layout = " × ".join(f"{v} {k}" for k, v in sizes.items())
        raise ValueError(f"mesh ({layout}) needs {n} ranks; the world has {world}")
    names = tuple(sizes)
    dm = init_device_mesh(device_type, tuple(sizes.values()), mesh_dim_names=names)
    groups = {name: dm.get_group(name) for name in names}
    if "dcn" in sizes:
        # One group over (dcn × batch) per sketch coordinate; every rank
        # creates every group, in the same order.
        n_sketch = sizes["sketch"]
        n_shards = world // n_sketch
        groups["batch_axes"], _ = dist.new_subgroups_by_enumeration(
            [[i * n_sketch + k for i in range(n_shards)] for k in range(n_sketch)]
        )
    else:
        groups["batch_axes"] = groups["batch"]
    return Mesh(
        device_mesh=dm,
        shape=dict(sizes),
        coords=dict(zip(names, dm.get_coordinate())),
        groups=groups,
        device=rank_device(device_type),
    )


def make_mesh(
    n_batch: int | None = None, n_sketch: int = 1, device_type: str = "cuda"
) -> Mesh:
    """A ``("batch", "sketch")`` mesh over the whole world. ``n_batch``
    defaults to the world size over ``n_sketch``."""
    if n_batch is None:
        n_batch = max(dist.get_world_size() // n_sketch, 1)
    return _build(device_type, {"batch": n_batch, "sketch": n_sketch})


def make_hybrid_mesh(
    n_dcn: int,
    n_batch: int | None = None,
    n_sketch: int = 1,
    device_type: str = "cuda",
) -> Mesh:
    """A ``("dcn", "batch", "sketch")`` mesh: span batches shard over
    ``dcn × batch`` and the KB-scale sketch deltas reduce over both, so
    only monoid merges cross the long-haul ``dcn`` axis. ``n_batch``
    defaults to what the world leaves after ``n_dcn × n_sketch``."""
    if n_batch is None:
        n_batch = max(dist.get_world_size() // (n_dcn * n_sketch), 1)
    return _build(
        device_type, {"dcn": n_dcn, "batch": n_batch, "sketch": n_sketch}
    )
