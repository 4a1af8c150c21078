"""The detector's communicator on a single device.

``detector_step`` is written against a small reduction interface; on one
device every reduction is the identity and the sketch index is 0. The
multi-device communicator (``torch.distributed`` process groups) lands
with the mesh path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Comm(NamedTuple):
    """Axis names; ``None`` means that axis is not sharded. Only the
    unsharded communicator :data:`NO_COMM` exists in this package yet."""

    batch_axis: str | None = None
    sketch_axis: str | None = None

    def _single(self) -> None:
        if self.batch_axis is not None or self.sketch_axis is not None:
            raise NotImplementedError(
                "sharded communicators are not ported yet; use NO_COMM"
            )

    def psum_batch(self, x: torch.Tensor) -> torch.Tensor:
        self._single()
        return x

    def psum_batch_f32(self, x: torch.Tensor) -> torch.Tensor:
        self._single()
        return x

    def pmax_batch(self, x: torch.Tensor) -> torch.Tensor:
        self._single()
        return x

    def pmin_sketch(self, x: torch.Tensor) -> torch.Tensor:
        self._single()
        return x

    def sketch_index(self) -> int:
        self._single()
        return 0


NO_COMM = Comm(None, None)
