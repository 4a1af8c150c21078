// Device code shared by the sketch kernels: the batch → bank fold
// (sketch_kernel) and the block-order stats reduction with the optional
// EWMA/CUSUM head epilogue (heads_kernel).
//
// fused_update.cu launches them over the W current window banks with the
// heads; sketch_delta.cu over one zeroed bank without them. Both are
// built with --fmad=false, so every float sum and the head formulas round
// once per operation, as the plain PyTorch versions do.
//
// sketch_kernel, for lanes i in [0, B):
//   HLL  for valid lanes with 0 <= svc < S: bucket/rank from the 64-bit
//        trace hash (rank = leading zeros of h64 >> p in its 64-p bit
//        frame, + 1), atomicMax into cell svc*R + bucket of every bank;
//   CMS  for valid lanes (any svc): +1 at counter d*Wc + cidx[d, i] of
//        every bank, for each of the D rows. The D x Wc counters are
//        privatised in dynamic shared memory (opt-in via
//        cudaFuncSetAttribute); each block then atomicAdds its non-zero
//        counters into the banks. Integer max and add are exact in any
//        order;
//   stats partials[n_blocks, 4, S] = (count, sum log-lat, sum log-lat^2,
//        sum err) over the block's valid lanes with 0 <= svc < S, in a
//        fixed order (lane order within a warp, a fixed shuffle tree
//        across it), so runs are reproducible.
// Banks are passed with their window stride, so a strided view such as
// state.hll_bank[:, 0] needs no contiguous copy.
//
// heads_kernel, one thread per service: sums the partials in block order
// into stats[4, S] and, with fold set, runs the reference's head_update
// on them, reading the step position from the device step counter (no
// host sync) and writing the heads in place.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaus = 8;

struct HeadParams {
  float taus[kMaxTaus];
  float tau_max;
  int n_taus;
  float warmup;
  float z_warmup;
  float cusum_k;
  float cusum_cap;
  float err_slack;
};

__global__ void sketch_kernel(
    const int* __restrict__ svc, const float* __restrict__ log_lat,
    const float* __restrict__ is_error, const int* __restrict__ trace_hi,
    const int* __restrict__ trace_lo, const int* __restrict__ cidx,
    const unsigned char* __restrict__ valid, int B, int S, int p, int D,
    int Wc, int* __restrict__ hll, long long hll_ws, int* __restrict__ cms,
    long long cms_ws, int n_windows, float* __restrict__ partials) {
  extern __shared__ int cnt[];
  const int n_cnt = D * Wc;
  for (int i = threadIdx.x; i < n_cnt; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  const int chunk = (B + gridDim.x - 1) / gridDim.x;
  const int b0 = blockIdx.x * chunk;
  const int b1 = min(B, b0 + chunk);
  const unsigned r_mask = (1u << p) - 1u;
  for (int i = b0 + threadIdx.x; i < b1; i += blockDim.x) {
    if (!valid[i]) continue;
    for (int d = 0; d < D; ++d) {
      atomicAdd(&cnt[d * Wc + cidx[(long long)d * B + i]], 1);
    }
    const int s = svc[i];
    if (s < 0 || s >= S) continue;
    const unsigned hi = (unsigned)trace_hi[i];
    const unsigned lo = (unsigned)trace_lo[i];
    const unsigned w_lo = (lo >> p) | (hi << (32 - p));
    const unsigned w_hi = hi >> p;
    const int lz = w_hi != 0u ? __clz(w_hi) - p : (32 - p) + __clz(w_lo);
    const long long cell = ((long long)s << p) + (lo & r_mask);
    for (int w = 0; w < n_windows; ++w) atomicMax(&hll[w * hll_ws + cell], lz + 1);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_cnt; i += blockDim.x) {
    const int c = cnt[i];
    if (c) {
      for (int w = 0; w < n_windows; ++w) atomicAdd(&cms[w * cms_ws + i], c);
    }
  }

  // Per-service partial stats in a fixed order: warp `wp` owns services
  // wp, wp + n_warps, ...; each lane sums its strided lanes in order, then
  // a fixed shuffle tree combines the warp.
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int s = threadIdx.x >> 5; s < S; s += n_warps) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int i = b0 + lane; i < b1; i += 32) {
      if (valid[i] && svc[i] == s) {
        const float x = log_lat[i];
        a0 += 1.f;
        a1 += x;
        a2 += x * x;
        a3 += is_error[i];
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      a0 += __shfl_down_sync(0xffffffffu, a0, off);
      a1 += __shfl_down_sync(0xffffffffu, a1, off);
      a2 += __shfl_down_sync(0xffffffffu, a2, off);
      a3 += __shfl_down_sync(0xffffffffu, a3, off);
    }
    if (lane == 0) {
      float* out = partials + (long long)blockIdx.x * 4 * S;
      out[0 * S + s] = a0;
      out[1 * S + s] = a1;
      out[2 * S + s] = a2;
      out[3 * S + s] = a3;
    }
  }
}

__global__ void heads_kernel(
    const float* __restrict__ partials, int n_blocks, int S,
    float* __restrict__ stats, int fold, float* lat_mean, float* lat_var,
    float* err_mean, float* rate_mean, float* rate_var, float* cusum,
    float* obs_batches, const float* __restrict__ dt_ptr,
    const int* __restrict__ step_idx, float* __restrict__ lat_z_out,
    float* __restrict__ err_z_out, float* __restrict__ rate_z_out,
    HeadParams hp) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  float cnt = 0.f, lat_sum = 0.f, lat_sumsq = 0.f, err_sum = 0.f;
  for (int b = 0; b < n_blocks; ++b) {
    const float* part = partials + (long long)b * 4 * S;
    cnt += part[0 * S + s];
    lat_sum += part[1 * S + s];
    lat_sumsq += part[2 * S + s];
    err_sum += part[3 * S + s];
  }
  stats[0 * S + s] = cnt;
  stats[1 * S + s] = lat_sum;
  stats[2 * S + s] = lat_sumsq;
  stats[3 * S + s] = err_sum;
  if (!fold) return;

  // head_update, verbatim from the reference (ops/fused.py), per service.
  const int T = hp.n_taus;
  const float dt = *dt_ptr;
  const bool step_pos = *step_idx > 0;
  const float obs = obs_batches[s];
  const bool seen = cnt > 0.f;
  const bool warm = obs < hp.warmup;
  const bool z_warm = obs < hp.z_warmup;
  const float n = fmaxf(cnt, 1.f);
  const float debias = 1.f / (obs + 1.f);
  const float alpha_var = fmaxf(1.f - expf(-dt / hp.tau_max), debias);
  const float floor2 = (float)(0.15 * 0.15);
  const float xbar = lat_sum / fmaxf(cnt, 1.f);
  const float sq_mean = lat_sumsq / fmaxf(cnt, 1.f);
  const float dt_c = fmaxf(dt, 1e-3f);
  const bool rate_obs = (seen || obs > 0.f) && step_pos;
  const float rate_x = cnt / fmaxf(dt, 1e-3f);

  float lat_z_last = 0.f, rate_z_last = 0.f, err_mean_last = 0.f;
  for (int t = 0; t < T; ++t) {
    const int k = s * T + t;
    const float alpha = fmaxf(1.f - expf(-dt / hp.taus[t]), debias);

    const float mu = lat_mean[k];
    const float sigma2 = lat_var[k];
    const float lat_z = (xbar - mu) / sqrtf(sigma2 / n + floor2);
    lat_z_out[k] = (seen && !z_warm) ? lat_z : 0.f;
    lat_z_last = (seen && !warm) ? lat_z : 0.f;
    const float lm = seen ? mu + alpha * (xbar - mu) : mu;
    const float v_obs = sq_mean - 2.f * lm * xbar + lm * lm;
    lat_mean[k] = lm;
    lat_var[k] = seen ? sigma2 + alpha_var * (fmaxf(v_obs, 0.f) - sigma2) : sigma2;

    const float pe = err_mean[k];
    const float err_z = (err_sum - n * pe) / sqrtf(n * pe * (1.f - pe) + 1.f);
    err_z_out[k] = (seen && !z_warm) ? err_z : 0.f;
    const float em = seen ? pe + alpha * (err_sum / n - pe) : pe;
    err_mean[k] = em;
    err_mean_last = em;

    const float lam = rate_mean[k];
    const float rv = rate_var[k];
    const float expected = lam * dt_c;
    const float emp_var = rv * dt_c * dt_c;
    const float rate_z = (cnt - expected) / sqrtf(fmaxf(expected, emp_var) + 1.f);
    rate_z_out[k] = (rate_obs && !z_warm) ? rate_z : 0.f;
    rate_z_last = (rate_obs && !warm) ? rate_z : 0.f;
    const float dx = rate_x - lam;
    rate_mean[k] = rate_obs ? lam + alpha * dx : lam;
    rate_var[k] = rate_obs ? rv + alpha_var * (dx * dx - rv) : rv;
  }
  obs_batches[s] = obs + (seen ? 1.f : 0.f);

  const bool active = seen && !warm;
  const float s_lat = active ? lat_z_last - hp.cusum_k : 0.f;
  const float err_sigma = sqrtf(n * err_mean_last * (1.f - err_mean_last) + 1.f);
  const float s_err =
      active ? (err_sum - n * (err_mean_last + hp.err_slack)) / err_sigma - hp.cusum_k
             : 0.f;
  const float s_rate = (rate_obs && !warm) ? -rate_z_last - hp.cusum_k : 0.f;
  const float scores[3] = {s_lat, s_err, s_rate};
  for (int j = 0; j < 3; ++j) {
    const float c = cusum[s * 3 + j] + scores[j];
    cusum[s * 3 + j] = fminf(fmaxf(c, 0.f), hp.cusum_cap);
  }
}

// The sketch launch: opt in to the D x Wc shared-memory counters, launch
// on `st`, and return cudaGetLastError().
inline cudaError_t launch_sketch(
    const void* svc, const void* log_lat, const void* is_error,
    const void* trace_hi, const void* trace_lo, const void* cidx,
    const void* valid, int B, int S, int p, int D, int Wc, void* hll,
    long long hll_ws, void* cms, long long cms_ws, int n_windows,
    void* partials, int n_blocks, cudaStream_t st) {
  const size_t smem = (size_t)D * Wc * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      sketch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sketch_kernel<<<n_blocks, 512, smem, st>>>(
      (const int*)svc, (const float*)log_lat, (const float*)is_error,
      (const int*)trace_hi, (const int*)trace_lo, (const int*)cidx,
      (const unsigned char*)valid, B, S, p, D, Wc, (int*)hll, hll_ws,
      (int*)cms, cms_ws, n_windows, (float*)partials);
  return cudaGetLastError();
}

}  // namespace
