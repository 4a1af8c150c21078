// Device code shared by the sketch kernels: one launch folds a span
// batch into the HLL and CMS banks, reduces the per-service stats across
// the grid in a fixed order, and (for the fused update) runs the
// EWMA/CUSUM head epilogue.
//
// fused_update.cu launches it over the W current window banks with the
// heads; sketch_delta.cu over one bank, which the launch clears first,
// without them. Both are built with --fmad=false, so every float sum and
// the head formulas round once per operation, as the plain PyTorch
// versions do.
//
// sketch_kernel, for lanes i in [0, B):
//   CMS  for valid lanes (any svc): +1 at counter d*Wc + cidx[d, i] of
//        every bank, for each of the D rows;
//   HLL  for valid lanes with 0 <= svc < S: bucket/rank from the 64-bit
//        trace hash (rank = leading zeros of h64 >> p in its 64-p bit
//        frame, + 1), max into cell svc*R + bucket of every bank;
//   stats[4, S] = (count, sum log-lat, sum log-lat^2, sum err) over valid
//        lanes with 0 <= svc < S;
//   heads (fold set): the reference's head_update on those stats, reading
//        the step position from the device step counter (no host sync)
//        and writing the heads in place.
// Banks are passed with their window stride, so a strided view such as
// state.hll_bank[:, 0] needs no contiguous copy.
//
// Design. A block owns a fixed run of lanes_per_block lanes (the launch
// plan in ops/fused.py sizes the grid to the card's SMs, a thread per
// lane up to 512 a block, fewer when many services' stats fill shared
// memory) and walks it 32 lanes per warp at a time. Each warp loads its
// first slice's lanes (and, in block 0, the head memory of the epilogue)
// at once at the start,
// so the kernel waits on memory a few times in all, not once per field:
//   - Hot keys are merged inside the warp before any atomic. Lanes with
//     the same CMS counter (one __match_any_sync per row) send one
//     atomicAdd of the group's count per bank; lanes with the same HLL
//     cell send one atomicMax of the group's __reduce_max_sync per bank.
//     Integer add and max are exact in any order, so the banks are too.
//     The counters are not privatised in shared memory: a block's 128-512
//     lanes touch at most 512*D of the D*Wc counters (6% at 4 x 8192), so
//     clearing and scanning a private copy costs more than the atomics it
//     saves, and with no privatised copy the block's cost follows its
//     lanes and the grid can be as wide as the card.
//   - Stats are summed in a fixed order: lanes of one service in a warp
//     slice by the group's leader in lane order, the slices of a warp in
//     order, the warps of a block in order, then the blocks in block order
//     (below). Nothing depends on timing, so two launches give the same
//     bits, and fused_update and sketch_delta, which share this code and
//     the launch plan (a function of B, S and the card alone), give the
//     same stats for one batch.
//   - The cross-block reduction and the head epilogue run in the same
//     launch, which is cooperative (every block resident at once, or the
//     launch is refused): each block writes its partials, the grid meets
//     at cooperative_groups' grid.sync(), and then every block sends its
//     bank atomics while block 0 sums the partials in block order (each
//     stat's blocks cut into a few fixed chunks summed by as many
//     threads, loads issued 32 at a time, then the chunks in order) and
//     runs head_update, a thread per (service, timescale) cell, on the
//     heads it loaded at its start. A service's observation count and
//     CUSUM are read by all of its cells and written by its last one, so
//     block 0 copies them to shared memory at its start and no cell reads
//     them from global memory after any cell has written.
//   - A clear (the delta's outputs) is done by the launch itself: each
//     block clears a share before the grid.sync(), so no atomic lands
//     before the clear. Such a launch has at least a block per SM, so a
//     small batch's clear is spread over the card too: blocks past the
//     plan's grid own no lanes and write no partials, so the stats order
//     is the plan's.
//   - Nothing is kept between launches: the grid barrier is the runtime's.
//
// Bound on the H100: bytes, far below the launch cost at the main path's
// shapes (each lane is read once, about 37 B at D = 4, and each touched
// bank cell read and written once per window: under 1 MB at B = 2048,
// a fraction of a microsecond at 3.35 TB/s). There is no matrix product,
// so wgmma has nothing to do, and each lane is read once, so TMA's bulk
// copies would save no traffic: the time is the launch, a few dependent
// memory round trips (lanes, grid barrier, partials, heads) and the
// atomics.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "warp_merge.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxTaus = 8;
constexpr int kMaxDepth = 8;  // CMS rows a lane keeps in registers
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

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

struct SketchArgs {
  const int* svc;
  const float* log_lat;
  const float* is_error;
  const int* trace_hi;
  const int* trace_lo;
  const int* cidx;  // [D, B]
  const unsigned char* valid;
  int B, S, p, D, Wc;
  int* hll;  // [W][S, R] with window stride hll_ws
  long long hll_ws;
  int* cms;  // [W][D, Wc] with window stride cms_ws
  long long cms_ws;
  int n_windows;
  int lanes_per_block;
  int stat_blocks;  // blocks that own lanes (the launch plan's grid); any more only clear
  float* partials;  // [stat_blocks, 4, S]
  float* stats;     // [4, S]
  int* clear;  // cleared in the launch before any atomic, or null
  long long n_clear;
};

struct HeadArgs {
  int fold;
  float* lat_mean;
  float* lat_var;
  float* err_mean;
  float* rate_mean;
  float* rate_var;
  float* cusum;
  float* obs_batches;
  const float* dt;
  const int* step_idx;
  float* lat_z;
  float* err_z;
  float* rate_z;
  HeadParams hp;
};

// One lane's inputs, loaded together so that their loads are in flight
// at once (a load after an atomic would wait for it: the compiler cannot
// tell the banks from the lanes).
struct Lane {
  bool valid;
  int svc;
  float x;  // log-latency
  float e;  // error flag
  unsigned hi, lo;  // trace hash
  int keys[kMaxDepth];  // CMS row indices
};

__device__ __forceinline__ Lane load_lane(const SketchArgs& a, long long i, bool in) {
  Lane l = {};
  if (in) {
    l.valid = a.valid[i];
    l.svc = a.svc[i];
    l.x = a.log_lat[i];
    l.e = a.is_error[i];
    l.hi = (unsigned)a.trace_hi[i];
    l.lo = (unsigned)a.trace_lo[i];
#pragma unroll
    for (int d = 0; d < kMaxDepth; ++d) {
      if (d < a.D) l.keys[d] = a.cidx[(long long)d * a.B + i];
    }
  }
  return l;
}

// One (service, timescale) cell's own head memory, loaded before it is
// needed. Only the cell's thread reads and writes these.
struct HeadIn {
  float lat_mean, lat_var, err_mean, rate_mean, rate_var;
  float dt;
  int step;
};

__device__ __forceinline__ HeadIn load_head(const HeadArgs& h, int q) {
  HeadIn in;
  in.lat_mean = h.lat_mean[q];
  in.lat_var = h.lat_var[q];
  in.err_mean = h.err_mean[q];
  in.rate_mean = h.rate_mean[q];
  in.rate_var = h.rate_var[q];
  in.dt = *h.dt;
  in.step = *h.step_idx;
  return in;
}

// head_update, verbatim from the reference (ops/fused.py), for cell
// q = s*T + t: the EWMA heads of timescale t and, in the thread of the
// last timescale (whose z's and error mean the CUSUM reads), the CUSUM
// and the observation count of service s, read from `obs` and `cusum`
// (the block's copy, taken before any cell wrote). One thread per cell,
// so the timescales advance side by side.
__device__ void head_update(const HeadArgs& h, int q, const HeadIn& in, float obs,
                            const float* cusum, float cnt, float lat_sum,
                            float lat_sumsq, float err_sum) {
  const HeadParams& hp = h.hp;
  const int T = hp.n_taus;
  const int s = q / T;
  const int t = q - s * T;
  const float dt = in.dt;
  const bool step_pos = in.step > 0;
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
  const float alpha = fmaxf(1.f - expf(-dt / hp.taus[t]), debias);

  const float mu = in.lat_mean;
  const float sigma2 = in.lat_var;
  const float lat_z = (xbar - mu) / sqrtf(sigma2 / n + floor2);
  h.lat_z[q] = (seen && !z_warm) ? lat_z : 0.f;
  const float lm = seen ? mu + alpha * (xbar - mu) : mu;
  const float v_obs = sq_mean - 2.f * lm * xbar + lm * lm;
  h.lat_mean[q] = lm;
  h.lat_var[q] = seen ? sigma2 + alpha_var * (fmaxf(v_obs, 0.f) - sigma2) : sigma2;

  const float pe = in.err_mean;
  const float err_z = (err_sum - n * pe) / sqrtf(n * pe * (1.f - pe) + 1.f);
  h.err_z[q] = (seen && !z_warm) ? err_z : 0.f;
  const float em = seen ? pe + alpha * (err_sum / n - pe) : pe;
  h.err_mean[q] = em;

  const float lam = in.rate_mean;
  const float rv = in.rate_var;
  const float expected = lam * dt_c;
  const float emp_var = rv * dt_c * dt_c;
  const float rate_z = (cnt - expected) / sqrtf(fmaxf(expected, emp_var) + 1.f);
  h.rate_z[q] = (rate_obs && !z_warm) ? rate_z : 0.f;
  const float dx = rate_x - lam;
  h.rate_mean[q] = rate_obs ? lam + alpha * dx : lam;
  h.rate_var[q] = rate_obs ? rv + alpha_var * (dx * dx - rv) : rv;
  if (t != T - 1) return;

  h.obs_batches[s] = obs + (seen ? 1.f : 0.f);
  const float lat_z_last = (seen && !warm) ? lat_z : 0.f;
  const float rate_z_last = (rate_obs && !warm) ? rate_z : 0.f;
  const bool active = seen && !warm;
  const float s_lat = active ? lat_z_last - hp.cusum_k : 0.f;
  const float err_sigma = sqrtf(n * em * (1.f - em) + 1.f);
  const float s_err =
      active ? (err_sum - n * (em + hp.err_slack)) / err_sigma - hp.cusum_k : 0.f;
  const float s_rate = (rate_obs && !warm) ? -rate_z_last - hp.cusum_k : 0.f;
  const float scores[3] = {s_lat, s_err, s_rate};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float c = cusum[j] + scores[j];
    h.cusum[s * 3 + j] = fminf(fmaxf(c, 0.f), hp.cusum_cap);
  }
}

// A warp slice's stats into the warp's accumulators: lanes of one service
// are summed by the group's leader in lane order, through `stage`.
__device__ __forceinline__ void warp_stats(const Lane& l, int S, int lane, float* stage,
                                           float* wpart) {
  const bool ok = l.valid && l.svc >= 0 && l.svc < S;
  const unsigned ok_mask = __ballot_sync(kFull, ok);
  stage[lane] = l.x;
  stage[32 + lane] = l.e;
  __syncwarp();
  if (ok) {
    const unsigned g = __match_any_sync(ok_mask, l.svc);
    if (lane == __ffs(g) - 1) {
      float c = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (unsigned m = g; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const float xj = stage[j];
        c += 1.f;
        s1 += xj;
        s2 += xj * xj;
        s3 += stage[32 + j];
      }
      wpart[l.svc] += c;
      wpart[S + l.svc] += s1;
      wpart[2 * S + l.svc] += s2;
      wpart[3 * S + l.svc] += s3;
    }
  }
  __syncwarp();
}

// A warp slice into the banks: one atomic per bank for each group of
// lanes that share a CMS counter (the group's count) or an HLL cell (the
// group's largest rank).
__device__ __forceinline__ void warp_banks(const SketchArgs& a, const Lane& l, int lane) {
  const unsigned v_mask = __ballot_sync(kFull, l.valid);
  if (l.valid) {
#pragma unroll
    for (int d = 0; d < kMaxDepth; ++d) {
      if (d >= a.D) break;
      const int key = l.keys[d];
      const int c = merged_count(v_mask, key, lane);
      if (c) {
        int* dst = a.cms + (long long)d * a.Wc + key;
        for (int w = 0; w < a.n_windows; ++w) atomicAdd(dst + w * a.cms_ws, c);
      }
    }
  }
  const bool ok = l.valid && l.svc >= 0 && l.svc < a.S;
  const unsigned ok_mask = __ballot_sync(kFull, ok);
  if (ok) {
    const int p = a.p;
    const unsigned w_lo = (l.lo >> p) | (l.hi << (32 - p));
    const unsigned w_hi = l.hi >> p;
    const int lz = w_hi != 0u ? __clz(w_hi) - p : (32 - p) + __clz(w_lo);
    const unsigned long long cell =
        ((unsigned long long)l.svc << p) + (l.lo & ((1u << p) - 1u));
    const unsigned g = __match_any_sync(ok_mask, cell);
    const unsigned rank = __reduce_max_sync(g, (unsigned)(lz + 1));
    if (lane == __ffs(g) - 1) {
      for (int w = 0; w < a.n_windows; ++w) {
        atomicMax(a.hll + w * a.hll_ws + (long long)cell, (int)rank);
      }
    }
  }
}

// Sum of partials[b, o] over blocks b in [lo, hi), in block order; the
// loads are issued 32 at a time (from L2: other blocks wrote them).
__device__ __forceinline__ float sum_partials(const float* partials, int o, int stride,
                                              int lo, int hi) {
  float acc = 0.f;
  for (int b = lo; b < hi; b += 32) {
    float v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      v[j] = b + j < hi ? __ldcg(partials + (long long)(b + j) * stride + o) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (b + j < hi) acc += v[j];
    }
  }
  return acc;
}

// Dynamic shared memory: per-warp stats accumulators [n_warps][4][S],
// per-warp staging of one slice's log-lat and error [n_warps][2][32],
// block 0's chunk sums [blockDim.x], and block 0's copy of every
// service's observation count and CUSUM [S] + [S, 3]
// (fused.launch_plan keeps it all under the default 48 KB).
__global__ void __launch_bounds__(kMaxThreads) sketch_kernel(SketchArgs a, HeadArgs h) {
  extern __shared__ float smem[];
  const int S = a.S;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  float* part = smem;
  float* wpart = part + warp * 4 * S;
  float* stage = smem + n_warps * 4 * S + warp * 64;
  float* red = smem + n_warps * (4 * S + 64);
  float* snap_obs = red + blockDim.x;
  float* snap_cusum = snap_obs + S;
  const bool head_block = h.fold && blockIdx.x == 0;

  // The warp's first slice (its only one unless B > 512 a block) and, in
  // block 0, the heads of the thread's first cell and every service's
  // observation count and CUSUM: all loaded at once, before anything
  // waits, and before any cell writes them.
  const long long b0 = (long long)blockIdx.x * a.lanes_per_block;
  const long long b1 = min((long long)a.B, b0 + a.lanes_per_block);
  const long long first = b0 + warp * 32;
  const Lane mine = load_lane(a, first + lane, first + lane < b1);
  const int n_cells = S * h.hp.n_taus;
  HeadIn head_in = {};
  if (head_block && tid < n_cells) head_in = load_head(h, tid);
  if (head_block) {
    for (int s = tid; s < S; s += blockDim.x) {
      snap_obs[s] = h.obs_batches[s];
#pragma unroll
      for (int j = 0; j < 3; ++j) snap_cusum[s * 3 + j] = h.cusum[s * 3 + j];
    }
  }
  for (int t = tid; t < n_warps * 4 * S; t += blockDim.x) part[t] = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + tid; c < a.n_clear; c += stride) {
    a.clear[c] = 0;
  }
  __syncthreads();

  // Stats, in a fixed order.
  Lane l = mine;
  for (long long base = first; base < b1; base += blockDim.x) {
    if (base != first) l = load_lane(a, base + lane, base + lane < b1);
    warp_stats(l, S, lane, stage, wpart);
  }
  __syncthreads();

  // This block's partials (the warps in order), then the grid barrier,
  // which publishes every block's partials and its share of the clear.
  // The bank atomics come after it, so no atomic lands before the clear
  // and the barrier does not wait for them.
  float* out = a.partials + (long long)blockIdx.x * 4 * S;
  for (int t = tid; blockIdx.x < a.stat_blocks && t < 4 * S; t += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < n_warps; ++w) acc += part[w * 4 * S + t];
    out[t] = acc;
  }
  cg::this_grid().sync();

  l = mine;
  for (long long base = first; base < b1; base += blockDim.x) {
    if (base != first) l = load_lane(a, base + lane, base + lane < b1);
    warp_banks(a, l, lane);
  }
  if (blockIdx.x != 0) return;

  // Block 0: every block's partials, in block order. Each of the 4*S
  // stats is split into k chunks of blocks, summed by k threads, then the
  // chunks in order.
  const int n_out = 4 * S;
  const int G = a.stat_blocks;
  const int k = max(1, (int)blockDim.x / n_out);
  const int chunk = (G + k - 1) / k;
  float* st = part;
  if (k > 1) {
    if (tid < k * n_out) {
      const int j = tid / n_out;
      red[tid] = sum_partials(a.partials, tid % n_out, n_out, j * chunk,
                              min(G, (j + 1) * chunk));
    }
    __syncthreads();
  }
  for (int o = tid; o < n_out; o += blockDim.x) {
    float acc = 0.f;
    if (k > 1) {
      for (int j = 0; j < k; ++j) acc += red[j * n_out + o];
    } else {
      acc = sum_partials(a.partials, o, n_out, 0, G);
    }
    st[o] = acc;
    a.stats[o] = acc;
  }
  if (!h.fold) return;
  __syncthreads();
  for (int q = tid; q < n_cells; q += blockDim.x) {
    const HeadIn in = q == tid ? head_in : load_head(h, q);
    const int s = q / h.hp.n_taus;
    head_update(h, q, in, snap_obs[s], snap_cusum + s * 3, st[s], st[S + s],
                st[2 * S + s], st[3 * S + s]);
  }
}

// The launch, on `st`: cooperative, since the blocks wait for each other
// at the grid barrier and must all be resident (the launch is refused
// otherwise). Returns the launch's error.
inline cudaError_t launch_sketch(SketchArgs a, HeadArgs h, int grid, int threads, int smem,
                                 cudaStream_t st) {
  void* args[] = {&a, &h};
  return cudaLaunchCooperativeKernel((const void*)sketch_kernel, dim3(grid), dim3(threads),
                                     args, (size_t)smem, st);
}

}  // namespace
