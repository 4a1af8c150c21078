"""Sketch operations on tensors, with the hand-written CUDA kernels.

Sketch states are monoids (HLL registers merge by max, CMS tables by
add), so their batch updates are exact under any order of atomics.
"""

from .hashing import fmix32, hash_spans_synthetic, splitmix64_np
from .hll import HLL_P, hll_estimate, hll_indices, hll_init, hll_merge, hll_update
from .cms import (
    CMS_DEPTH,
    CMS_WIDTH,
    cms_count,
    cms_hist,
    cms_indices,
    cms_init,
    cms_merge,
    cms_query,
    cms_update,
    cms_update_hist,
)
from .ewma import ewma_init, ewma_update, segment_stats
from .fused import (
    HeadState,
    SketchDelta,
    head_update,
    resolve_impl,
    sketch_batch_delta,
    sketch_batch_update,
)

__all__ = [
    "SketchDelta",
    "HeadState",
    "head_update",
    "sketch_batch_delta",
    "sketch_batch_update",
    "resolve_impl",
    "fmix32",
    "hash_spans_synthetic",
    "splitmix64_np",
    "HLL_P",
    "hll_init",
    "hll_indices",
    "hll_update",
    "hll_estimate",
    "hll_merge",
    "CMS_DEPTH",
    "CMS_WIDTH",
    "cms_init",
    "cms_indices",
    "cms_update",
    "cms_update_hist",
    "cms_count",
    "cms_hist",
    "cms_query",
    "cms_merge",
    "ewma_init",
    "ewma_update",
    "segment_stats",
]
