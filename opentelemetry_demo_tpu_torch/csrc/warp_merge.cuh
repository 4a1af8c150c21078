// Warp-level merge of lanes that add to one counter, shared by the
// sketch kernels (sketch_kernels.cuh) and cms_hist.cu.
//
// A CMS batch is mostly duplicates (attribute keys are skewed, and a
// batch has far more lanes than a row has counters), and atomics on one
// address run one at a time. Lanes of a warp that share a key are
// grouped with __match_any_sync; the group's first lane sends one
// atomicAdd of the group's size. Integer adds are exact in any order.

#pragma once

#include <cuda_runtime.h>

namespace {

// The size of the group of lanes in `mask` (the caller among them) that
// hold `key`, for the group's first lane; 0 for the others.
__device__ __forceinline__ int merged_count(unsigned mask, int key, int lane) {
  const unsigned g = __match_any_sync(mask, key);
  return lane == __ffs(g) - 1 ? __popc(g) : 0;
}

}  // namespace
