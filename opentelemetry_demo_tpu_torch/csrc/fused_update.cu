// fused_update: one span batch folded into every current HLL and CMS
// window bank, the per-service moment stats, and (optionally) the
// EWMA/CUSUM detection heads.
//
// Replaces: opentelemetry_demo_tpu/ops/fused.py::_update_kernel (the
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
// 3.35 TB/s, so two launches of a few microseconds each set the time.
//
// Design: HLL atomicMax straight into each of the W banks; CMS counts
// privatised in shared memory and atomicAdded into the W banks; stats as
// fixed-order per-block partials, reduced in block order by a second
// launch (heads_kernel) that also runs head_update.

#include "sketch_kernels.cuh"

extern "C" int fused_update_launch(
    const void* svc, const void* log_lat, const void* is_error,
    const void* trace_hi, const void* trace_lo, const void* cidx,
    const void* valid, int B, int S, int p, int D, int Wc, void* hll,
    long long hll_ws, void* cms, long long cms_ws, int n_windows,
    void* partials, int n_blocks, void* stats, int fold, void* lat_mean,
    void* lat_var, void* err_mean, void* rate_mean, void* rate_var,
    void* cusum, void* obs_batches, const void* dt, const void* step_idx,
    void* lat_z, void* err_z, void* rate_z, const float* taus, int n_taus,
    float warmup, float z_warmup, float cusum_k, float cusum_cap,
    float err_slack, void* stream) {
  if (n_taus > kMaxTaus) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_sketch(
      svc, log_lat, is_error, trace_hi, trace_lo, cidx, valid, B, S, p, D,
      Wc, hll, hll_ws, cms, cms_ws, n_windows, partials, n_blocks, st);
  if (err != cudaSuccess) return (int)err;

  HeadParams hp = {};
  hp.n_taus = n_taus;
  for (int t = 0; t < n_taus; ++t) {
    hp.taus[t] = taus[t];
    if (t == 0 || taus[t] > hp.tau_max) hp.tau_max = taus[t];
  }
  hp.warmup = warmup;
  hp.z_warmup = z_warmup;
  hp.cusum_k = cusum_k;
  hp.cusum_cap = cusum_cap;
  hp.err_slack = err_slack;
  heads_kernel<<<(S + 127) / 128, 128, 0, st>>>(
      (const float*)partials, n_blocks, S, (float*)stats, fold,
      (float*)lat_mean, (float*)lat_var, (float*)err_mean, (float*)rate_mean,
      (float*)rate_var, (float*)cusum, (float*)obs_batches, (const float*)dt,
      (const int*)step_idx, (float*)lat_z, (float*)err_z, (float*)rate_z, hp);
  return (int)cudaGetLastError();
}
