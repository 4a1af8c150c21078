"""The detector's communicator: its entire comm surface.

``detector_step`` is written against this small reduction interface. With
:data:`NO_COMM` every method is the identity and the step is the
single-device program; ``parallel.make_sharded_step`` builds a
:class:`Comm` over ``torch.distributed`` process groups, and the same step
then runs on every rank of a (batch × sketch) mesh, reconciled by four
reductions — what mergeable sketch monoids buy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

# Below this many elements a ring merge stays one direct all-reduce: the
# ring's 2(n-1) latency-bound hops would replace one collective for no
# bandwidth gain (the float stats and the per-service maxima).
RING_MIN_ELEMENTS = 256


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    x = x.contiguous()
    dist.all_reduce(x, op=op, group=group)
    return x


class Comm(NamedTuple):
    """Process groups; ``None`` means that axis is not sharded.

    - ``batch_group``: every rank that holds a batch shard beside this one
      with the same sketch coordinate (``dcn × batch`` on a hybrid mesh).
      Deltas merge over it.
    - ``sketch_group`` / ``sketch_rank``: the ranks sharing this batch
      shard, and this rank's coordinate among them.
    - ``merge_impl``: ``"direct"``, one all-reduce over ``batch_group``;
      or ``"ring"``, the two-phase neighbour ring (``parallel.ring``) on
      ``ring_group``, the long-haul axis. On a hybrid mesh the inner
      ``batch`` axis (``inner_group``) is reduced direct first and the
      outer ``dcn`` axis rides the ring; on a 2-D mesh the whole batch
      axis does.
    - ``host_staged``: the ring's point-to-point hops go through host
      memory (gloo carries CUDA tensors in its collectives, but its
      send/recv take host tensors only). Never set with NCCL.

    The reductions work in place on a contiguous ``x`` and return it.
    """

    batch_group: dist.ProcessGroup | None = None
    sketch_group: dist.ProcessGroup | None = None
    sketch_rank: int = 0
    merge_impl: str = "direct"
    ring_group: dist.ProcessGroup | None = None
    inner_group: dist.ProcessGroup | None = None
    host_staged: bool = False

    def _check_impl(self) -> None:
        # Validated before any early return: a typo'd impl on a directly
        # built Comm must raise, not quietly run direct.
        if self.merge_impl not in ("direct", "ring"):
            raise ValueError(f"unknown merge_impl {self.merge_impl!r}")

    def _merge_batch(self, x: torch.Tensor, op, ring_name: str) -> torch.Tensor:
        self._check_impl()
        if self.batch_group is None:
            return x
        if self.merge_impl != "ring" or x.numel() < RING_MIN_ELEMENTS:
            return _all_reduce(x, op, self.batch_group)
        # Imported here: parallel → spmd → models → ops would cycle at
        # module scope; by the first ring merge the package is loaded.
        from ..parallel import ring as ring_mod

        if self.inner_group is not None:
            x = _all_reduce(x, op, self.inner_group)
        ring_op = getattr(ring_mod, ring_name)
        return ring_op(x, self.ring_group, host_staged=self.host_staged)

    def psum_batch(self, x: torch.Tensor) -> torch.Tensor:
        return self._merge_batch(x, dist.ReduceOp.SUM, "ring_merge_sum")

    def psum_batch_f32(self, x: torch.Tensor) -> torch.Tensor:
        """Float sums stay direct in every ``merge_impl``: ring chunking
        would reorder the float32 reduction, so the EWMA inputs (and every
        score downstream) would differ between ring and direct runs.
        Integer monoids, exact in any order, are what rides the ring."""
        self._check_impl()
        if self.batch_group is None:
            return x
        return _all_reduce(x, dist.ReduceOp.SUM, self.batch_group)

    def pmax_batch(self, x: torch.Tensor) -> torch.Tensor:
        return self._merge_batch(x, dist.ReduceOp.MAX, "ring_merge_max")

    def pmin_sketch(self, x: torch.Tensor) -> torch.Tensor:
        if self.sketch_group is None:
            return x
        return _all_reduce(x, dist.ReduceOp.MIN, self.sketch_group)

    def sketch_index(self) -> int:
        return self.sketch_rank


NO_COMM = Comm()
