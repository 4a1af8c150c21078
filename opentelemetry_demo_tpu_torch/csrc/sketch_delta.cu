// sketch_delta: one span batch's standalone sketch delta, from zero — the
// mergeable quantity that crosses the batch-axis collectives of the
// sharded detector step.
//
// Replaces: opentelemetry_demo_tpu/ops/fused.py::_delta_kernel (the
// Pallas kernel launched by _delta_pallas from sketch_batch_delta), which
// on the TPU sweeps every sketch cell against every batch lane
// (O(B x cells) compare-reduce) over a sequential grid of batch tiles,
// because the TPU has no atomics.
//
// What it computes, for lanes i in [0, B):
//   hll[S, R]   max HLL rank per (service, bucket) over valid lanes with
//               0 <= svc < S, 0 elsewhere;
//   cms[D, Wc]  count per CMS counter over every valid lane;
//   stats[4, S] (count, sum log-lat, sum log-lat^2, sum err) over valid
//               lanes with 0 <= svc < S.
//
// Bound on the H100: bytes. Per lane the inputs are svc, log-lat, err,
// trace hi/lo (4 B each), valid (1 B) and D row indices (4 B each): 29 B
// at D = 2, 37 B at D = 4; the outputs are written whole, (S*R + D*Wc +
// 4*S) * 4 B. At B = 32768, S = 16, D = 2 that is about 1.3 MB, 0.4 us
// at 3.35 TB/s: the launch and a few dependent memory round trips set the
// time.
//
// Design: a delta into one bank is the fused update's sketch launch over
// a single bank without the heads (sketch_kernels.cuh), so both kernels
// share their device code and their stats order. The HLL and CMS outputs
// are two views of one buffer, which the launch clears itself: every
// block clears a share before the grid barrier (the grid has a block per
// SM at least, so a small batch's clear is spread over the card too), and
// no atomic comes before the barrier. Then warp-merged
// atomicMax/atomicAdd into the cleared registers and counters, while
// block 0 sums the fixed-order per-block stats partials in block order,
// so repeated runs give the same bits on every rank. One device
// operation per call.

#include "sketch_kernels.cuh"

extern "C" int sketch_delta_launch(
    const void* svc, const void* log_lat, const void* is_error,
    const void* trace_hi, const void* trace_lo, const void* cidx,
    const void* valid, int B, int S, int p, int D, int Wc, void* out,
    void* partials, void* stats, int stat_blocks, int threads,
    int lanes_per_block, int smem, int grid, void* stream) {
  const long long n_hll = (long long)S << p;
  SketchArgs a = {
      (const int*)svc, (const float*)log_lat, (const float*)is_error,
      (const int*)trace_hi, (const int*)trace_lo, (const int*)cidx,
      (const unsigned char*)valid, B, S, p, D, Wc, (int*)out, 0,
      (int*)out + n_hll, 0, 1, lanes_per_block, stat_blocks, (float*)partials,
      (float*)stats, (int*)out, n_hll + (long long)D * Wc};
  return (int)launch_sketch(a, HeadArgs{}, grid, threads, smem, (cudaStream_t)stream);
}
