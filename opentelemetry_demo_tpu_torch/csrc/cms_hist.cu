// cms_hist: the CMS count of a span batch, an exact unit-weight
// histogram, in one cooperative launch that clears its own output.
//
// Replaces: opentelemetry_demo_tpu/ops/cms.py::_hist_mxu_kernel (the
// Pallas kernel launched by _hist_mxu), which splits each flat key into
// (hi, lo) bytes, builds int8 one-hots of both and contracts them on the
// TPU's matrix unit, because TPU scatters serialise on duplicate keys.
//
// What it computes, for keys idx[D, B] (row d's keys at idx + d*B):
//   out[d, k] = #{i : valid[i] and idx[d, i] == k}   for k in [0, W),
// with keys outside [0, W) not counted and every lane valid when `valid`
// is null. ops/cms.py runs it two ways:
//   cms_count(idx[D, B], valid, W)  the batch's CMS count, the quantity
//                                   cms_update_hist adds to the table;
//   cms_hist(flat, n_bins)          one row of n_bins bins and no mask,
//                                   the counterpart of _hist_mxu (its
//                                   invalid-lane sentinel n_bins falls
//                                   out as out of range).
//
// Bound on the H100: bytes. Each lane's D indices and its valid byte (or
// each flat key) are read once and the D*W counts written once: at the
// composed path's shapes (B = 65536, D = 4, W = 8192) 1,114,112 + 131,072
// bytes, 0.37 us at 3.35 TB/s; 262,144 flat keys into 32,768 bins
// 1,179,648 bytes, 0.35 us. The launch and a few dependent memory round
// trips (lanes, grid barrier, atomics) are what the time is made of.
//
// Design, against what the first version of this kernel paid for:
//   - One device operation per call. The output is cleared by the launch
//     itself: every block clears a share (16 bytes a thread a pass), the
//     grid meets at cooperative_groups' grid.sync(), and only then does
//     any atomic land. The launch is cooperative (every block resident at
//     once, or it is refused and the wrapper raises), with at most one
//     block per SM.
//   - The keys are built in registers. A thread reads its lane's valid
//     byte and D row indices (row d of a warp's lanes is one coalesced
//     128-byte read) and counts row·W + index, skipping invalid lanes:
//     no arange, add, where or reshape runs before the launch.
//   - The grid follows the card. ops/_kernels.py::hist_plan gives each
//     block a run of whole 32-lane slices, as many blocks as the lanes
//     (or the clear, at 2,048 ints a block) need up to one per SM, and
//     512 threads a block; blocks past the lanes only share the clear.
//   - No private histogram, so no ceiling on the bins. Counts go straight
//     into the output with global atomics, so a block's cost follows its
//     keys, not the bin count: nothing to zero or scan per block, and
//     any D*W an int32 index addresses is counted.
//   - Hot keys are merged in the warp (warp_merge.cuh): lanes on one
//     counter send one atomicAdd of their number. Integer adds are exact
//     in any order, so two launches give the same bits.
//   - Each thread's first lane is loaded before the barrier, so the
//     loads overlap the clear, and each next lane before the current
//     lane's atomics (a load after an atomic would wait for it).
//
// Measured and dropped (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
// --alt at commit 1f53449; device ms per call, in turns with this
// kernel, whose time comes second):
//   - A thread-block cluster of 8 holding the bins in distributed shared
//     memory, a tile a block, flushed with global atomics after a cluster
//     barrier: 0.01258 against 0.00888 (cms_count, B = 65536, 4 x 8192,
//     Zipf keys), 0.01545 against 0.00944 (262,144 flat keys), 0.01481
//     against 0.00883 at 4 x 32768, 0.00696 against 0.00420 with no valid
//     lane. Every cluster zeroes, scans and flushes all the bins, which
//     costs more than the atomics it saves.
//   - The warps' counts merged once more per block in a 2,048-slot
//     shared-memory table: 0.00864 against 0.00888 and 0.00887 against
//     0.00944 on Zipf keys, but 0.00909 against 0.00782 on uniform keys
//     and 0.00465 against 0.00421 with no valid lane. A few percent on
//     skewed keys does not pay for a table every block clears, probes
//     and flushes.
// What is left is fixed cost: with no valid lane (the launch, the clear,
// the loads and the barrier) the kernel takes 0.0030 ms of its 0.0077 on
// the Zipf batch (torch.profiler, same run).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "warp_merge.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kMaxRows = 8;  // rows a lane keeps in registers
constexpr unsigned kFull = 0xffffffffu;

struct HistArgs {
  const int* idx;              // [D, B]
  const unsigned char* valid;  // [B], or null: every lane valid
  long long B;
  int D;
  int W;  // bins per row
  int lanes_per_block;
  int* out;  // [D, W], cleared by the launch
};

struct LaneKeys {
  bool on;  // in the batch and valid
  int keys[kMaxRows];
};

__device__ __forceinline__ LaneKeys load_lane(const HistArgs& a, long long i, bool in) {
  LaneKeys l;
  l.on = in && (a.valid == nullptr || a.valid[i]);
#pragma unroll
  for (int d = 0; d < kMaxRows; ++d) {
    l.keys[d] = (in && d < a.D) ? a.idx[(long long)d * a.B + i] : -1;
  }
  return l;
}

// One 32-lane slice of a warp into the output: per row, lanes with the
// same in-range key send one atomicAdd of their number.
__device__ __forceinline__ void count_lane(const HistArgs& a, const LaneKeys& l, int lane) {
#pragma unroll
  for (int d = 0; d < kMaxRows; ++d) {
    if (d >= a.D) break;
    const int key = l.keys[d];
    const bool ok = l.on && (unsigned)key < (unsigned)a.W;
    const unsigned mask = __ballot_sync(kFull, ok);
    if (ok) {
      const int c = merged_count(mask, key, lane);
      if (c) atomicAdd(a.out + (long long)d * a.W + key, c);
    }
  }
}

__device__ __forceinline__ void clear_output(const HistArgs& a) {
  const long long n = (long long)a.D * a.W;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int4* out4 = reinterpret_cast<int4*>(a.out);  // the wrapper's fresh tensor: 16-byte aligned
  for (long long i = t; i < n / 4; i += stride) out4[i] = make_int4(0, 0, 0, 0);
  for (long long i = n / 4 * 4 + t; i < n; i += stride) a.out[i] = 0;
}

__global__ void __launch_bounds__(kThreads) cms_hist_kernel(HistArgs a) {
  const int lane = threadIdx.x & 31;
  const long long b0 = (long long)blockIdx.x * a.lanes_per_block;
  const long long b1 = min(a.B, b0 + a.lanes_per_block);
  const long long first = b0 + (threadIdx.x & ~31);
  LaneKeys next = load_lane(a, first + lane, first + lane < b1);
  clear_output(a);
  cg::this_grid().sync();
  for (long long base = first; base < b1; base += blockDim.x) {
    const LaneKeys l = next;
    const long long nb = base + blockDim.x;
    if (nb < b1) next = load_lane(a, nb + lane, nb + lane < b1);
    count_lane(a, l, lane);
  }
}

}  // namespace

extern "C" int cms_hist_launch(const void* idx, const void* valid, long long B, int D, int W,
                               void* out, int grid, int threads, int lanes_per_block,
                               void* stream) {
  HistArgs a = {(const int*)idx, (const unsigned char*)valid, B, D, W, lanes_per_block,
                (int*)out};
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)cms_hist_kernel, dim3(grid),
                                          dim3(threads), args, 0, (cudaStream_t)stream);
}
