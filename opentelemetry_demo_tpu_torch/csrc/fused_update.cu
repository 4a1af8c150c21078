// fused_update: one span batch folded into every current HLL and CMS
// window bank, the per-service moment stats, and (optionally) the
// EWMA/CUSUM detection heads.
//
// Replaces: the JAX package's ops/fused.py::_update_kernel (the
// Pallas kernel launched by _update_pallas from sketch_batch_update),
// which on the TPU sweeps every sketch cell against every batch lane
// (O(B x cells) compare-reduce) because the TPU has no atomics.
//
// What it computes, for lanes i in [0, B) (sketch_kernels.cuh has the
// device code and its design):
//   HLL  for valid lanes with 0 <= svc < S: max rank folded into cell
//        svc*R + bucket of every bank;
//   CMS  for valid lanes (any svc): +1 at counter d*Wc + cidx[d, i] of
//        every bank, for each of the D rows;
//   stats[4, S] = (count, sum log-lat, sum log-lat^2, sum err) over valid
//        lanes with 0 <= svc < S;
//   heads (when given): the reference's head_update on those stats.
//
// Bound on the H100: bytes, and at the main path's shapes far below the
// launch cost. Per lane the inputs are svc, log-lat, err, trace hi/lo
// (4 B each), valid (1 B) and D row indices (4 B each): 37 B at D = 4.
// Each touched bank cell is read and written once per window. At
// B = 2048 that is well under 1 MB, a fraction of a microsecond at
// 3.35 TB/s, so the launch and a few dependent memory round trips set
// the time.
//
// Design (sketch_kernels.cuh): one cooperative launch per call, at any
// service count, in shared memory that does not grow with it.
// Fixed-order per-block stats partials, a grid barrier, then warp-merged
// atomics straight into each of the W banks (atomicMax for HLL, atomicAdd
// for CMS) while every block sums the partials of its run of services in
// block order and runs their head_update cells.

#include "sketch_kernels.cuh"

extern "C" int fused_update_launch(
    const void* svc, const void* log_lat, const void* is_error,
    const void* trace_hi, const void* trace_lo, const void* cidx,
    const void* valid, int B, int S, int p, int D, int Wc, void* hll,
    long long hll_ws, void* cms, long long cms_ws, int n_windows,
    void* partials, void* stats, int grid, int threads,
    int lanes_per_block, int smem, int tile, int fold, void* lat_mean, void* lat_var,
    void* err_mean, void* rate_mean, void* rate_var, void* cusum,
    void* obs_batches, const void* dt, const void* step_idx, void* lat_z,
    void* err_z, void* rate_z, const float* taus, int n_taus, float warmup,
    float z_warmup, float cusum_k, float cusum_cap, float err_slack,
    void* stream) {
  if (n_taus > kMaxTaus) return (int)cudaErrorInvalidValue;
  SketchArgs a = {
      (const int*)svc, (const float*)log_lat, (const float*)is_error,
      (const int*)trace_hi, (const int*)trace_lo, (const int*)cidx,
      (const unsigned char*)valid, B, S, p, D, Wc, (int*)hll, hll_ws,
      (int*)cms, cms_ws, n_windows, lanes_per_block, tile, grid, (float*)partials,
      (float*)stats, nullptr, 0};
  HeadArgs h = {};
  h.fold = fold;
  if (fold) {
    h.lat_mean = (float*)lat_mean;
    h.lat_var = (float*)lat_var;
    h.err_mean = (float*)err_mean;
    h.rate_mean = (float*)rate_mean;
    h.rate_var = (float*)rate_var;
    h.cusum = (float*)cusum;
    h.obs_batches = (float*)obs_batches;
    h.dt = (const float*)dt;
    h.step_idx = (const int*)step_idx;
    h.lat_z = (float*)lat_z;
    h.err_z = (float*)err_z;
    h.rate_z = (float*)rate_z;
    h.hp.n_taus = n_taus;
    for (int t = 0; t < n_taus; ++t) {
      h.hp.taus[t] = taus[t];
      if (t == 0 || taus[t] > h.hp.tau_max) h.hp.tau_max = taus[t];
    }
    h.hp.warmup = warmup;
    h.hp.z_warmup = z_warmup;
    h.hp.cusum_k = cusum_k;
    h.hp.cusum_cap = cusum_cap;
    h.hp.err_slack = err_slack;
  }
  return (int)launch_sketch(a, h, grid, threads, smem, (cudaStream_t)stream);
}
