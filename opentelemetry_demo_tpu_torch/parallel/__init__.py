"""Distributed backend: meshes of ranks + ``torch.distributed`` collectives.

The span batch is sharded over a ``batch`` axis (data parallelism) and
the sketch state over a ``sketch`` axis (service and CMS-row parallelism:
a service's sub-sketch is an independent "expert"). Sketch merges are
exactly the collectives:

- HLL registers  → all-reduce MAX (max-monoid union)
- CMS counters   → all-reduce SUM (sum-monoid union)
- segment stats  → all-reduce SUM (always direct)
- CMS row-shard queries → all-reduce MIN across the sketch axis

NCCL carries them between cards, gloo on the CPU; the ``ring`` module
provides the neighbour-hop variant for the long-haul axis, and
``launch`` a spawn launcher for one process per rank.
"""

from ..ops.collectives import NO_COMM, Comm
from .mesh import Mesh, make_hybrid_mesh, make_mesh
from .ring import merge_states_across, ring_merge_max, ring_merge_sum
from .spmd import (
    gather_report,
    gather_state,
    make_sharded_step,
    place_state,
    shard_batch,
    sharded_state_specs,
)

__all__ = [
    "Comm",
    "NO_COMM",
    "Mesh",
    "make_hybrid_mesh",
    "make_mesh",
    "make_sharded_step",
    "place_state",
    "gather_state",
    "gather_report",
    "shard_batch",
    "sharded_state_specs",
    "merge_states_across",
    "ring_merge_max",
    "ring_merge_sum",
]
