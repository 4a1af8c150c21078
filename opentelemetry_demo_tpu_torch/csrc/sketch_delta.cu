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
// at 3.35 TB/s: launches and the per-block shared-memory clear and flush
// set the time.
//
// Design: a delta into one bank is the fused update's sketch launch over
// a single zeroed bank (sketch_kernels.cuh), so both kernels share their
// device code. The outputs are cleared with cudaMemsetAsync on the
// caller's stream, then:
//   - HLL: atomicMax per lane into the zeroed [S, R] registers;
//   - CMS: the D x Wc counters privatised in shared memory (128 KiB at
//     4 x 8192, inside the 227 KB a block may opt in to) and flushed with
//     one atomicAdd per non-zero counter;
//   - stats: fixed-order per-block partials, summed in block order by a
//     second launch, so repeated runs give the same bits on every rank.

#include "sketch_kernels.cuh"

extern "C" int sketch_delta_launch(
    const void* svc, const void* log_lat, const void* is_error,
    const void* trace_hi, const void* trace_lo, const void* cidx,
    const void* valid, int B, int S, int p, int D, int Wc, void* hll,
    void* cms, void* partials, int n_blocks, void* stats, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(hll, 0, ((size_t)S << p) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(cms, 0, (size_t)D * Wc * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  err = launch_sketch(
      svc, log_lat, is_error, trace_hi, trace_lo, cidx, valid, B, S, p, D,
      Wc, hll, 0, cms, 0, 1, partials, n_blocks, st);
  if (err != cudaSuccess) return (int)err;
  heads_kernel<<<(S + 127) / 128, 128, 0, st>>>(
      (const float*)partials, n_blocks, S, (float*)stats, 0, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr, HeadParams{});
  return (int)cudaGetLastError();
}
