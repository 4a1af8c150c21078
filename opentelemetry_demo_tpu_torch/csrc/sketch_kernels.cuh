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
// plan in ops/fused.py sizes the grid to the card's SMs and gives a block
// a thread per lane up to 512, at every service count) and walks it 32
// lanes per warp at a time. Each warp loads its first slice's lanes (and
// each block the head memory of its first cells) at once at the start,
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
//     (in runs of 32, below). Nothing depends on timing, so two launches give the same
//     bits, and fused_update and sketch_delta, which share this code and
//     the launch plan (a function of B, S and the card alone), give the
//     same stats for one batch.
//   - Shared memory does not grow with S. A warp's accumulators cover a
//     tile of the plan's `tile` services (all of them up to 168-744
//     services, by the block's warps); past it the block walks the
//     services a tile at a time, each tile's warp sums going in warp
//     order into the block's own row of the global partials [4, S]. Each
//     service lies in one tile, so the order is the same for any tile. A
//     block whose lanes are all invalid still writes its row (zeros).
//   - The cross-block reduction and the head epilogue run in the same
//     launch, which is cooperative (every block resident at once, or the
//     launch is refused): each block writes its row of partials, the grid
//     meets at cooperative_groups' grid.sync(), then every block sends
//     its bank atomics and takes a contiguous run of ceil(S / grid)
//     services, or a chunk (blockDim / max(T, 4) services) if that is
//     more: at the main path's few services block 0 takes them all, since
//     spreading a few services over many blocks was slower on the H100
//     (PERF.md). A block sums its services' partials over the plan's
//     blocks: runs of 32 blocks, each summed in block order by one lane
//     with its loads issued at once, then the runs in order by the first
//     of the stat's neighbouring lanes (an order set by the plan's grid
//     alone). In the fused update it then runs their head cells, a thread
//     per (service, timescale) cell, a chunk at a time. A block owns whole
//     services, so the rule that each cell reads its service's
//     observation count and CUSUM before any cell writes them (the last
//     timescale's cell writes them) is kept by a __syncthreads between
//     the reads and the writes, with no copy.
//   - A clear (the delta's outputs) is done by the launch itself: each
//     block clears a share before the grid.sync(), so no atomic lands
//     before the clear. Such a launch has at least a block per SM, so a
//     small batch's clear is spread over the card too: blocks past the
//     plan's grid own no lanes and write no partials, so the stats order
//     is the plan's; they take their run of services in the reduction.
//   - Nothing is kept between launches: the grid barrier is the runtime's.
//
// Bound on the H100: bytes. At the main path's shapes they are far below
// the launch cost (each lane is read once, about 37 B at D = 4, and each
// touched bank cell read and written once per window: under 1 MB at
// B = 2048, a fraction of a microsecond at 3.35 TB/s). At many services
// the head memory and the partials grow with S: at the million-key soak's
// B = 4096 (p = 8, CMS 4 x 1024, 3 windows, 3 timescales, 32 blocks) the
// function moves 1.18 MB at S = 4096 and 2.01 MB at S = 8192 (the
// heads read and written, the stats and z's written), and the partials,
// written whole by each block and read once, add 4.19 MB and 8.39 MB
// (32 x 4 x S floats each way): 5.4 MB and 10.4 MB, 1.6 and 3.1 us. There
// is no matrix product, so wgmma has nothing to do, and each lane is read
// once, so TMA's bulk copies would save no traffic: the time is the
// launch, a few dependent memory round trips (lanes, grid barrier,
// partials, heads) and the atomics.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "warp_merge.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxTaus = 8;
constexpr int kMaxDepth = 8;  // CMS rows a lane keeps in registers
constexpr int kMaxThreads = 512;
constexpr int kRun = 32;  // blocks one thread sums in the cross-block reduction
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
  int tile;  // services a warp's accumulators cover (the plan's tile)
  int stat_blocks;  // blocks that own lanes (the plan's grid); any more clear and reduce only
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

// One (service, timescale) cell's head memory, loaded before it is
// needed: the cell's own (only its thread reads and writes these) and its
// service's observation count and CUSUM, which every cell of the service
// reads and the last timescale's cell writes, so they are read before the
// barrier after which the cells write.
struct HeadIn {
  float lat_mean, lat_var, err_mean, rate_mean, rate_var;
  float dt;
  int step;
  float obs;
  float cusum[3];
};

__device__ __forceinline__ HeadIn load_head(const HeadArgs& h, int q) {
  HeadIn in;
  const int T = h.hp.n_taus;
  const int s = q / T;
  in.lat_mean = h.lat_mean[q];
  in.lat_var = h.lat_var[q];
  in.err_mean = h.err_mean[q];
  in.rate_mean = h.rate_mean[q];
  in.rate_var = h.rate_var[q];
  in.dt = *h.dt;
  in.step = *h.step_idx;
  in.obs = h.obs_batches[s];
#pragma unroll
  for (int j = 0; j < 3; ++j) in.cusum[j] = q - s * T == T - 1 ? h.cusum[s * 3 + j] : 0.f;
  return in;
}

// head_update, verbatim from the reference (ops/fused.py), for cell
// q = s*T + t: the EWMA heads of timescale t and, in the thread of the
// last timescale (whose z's and error mean the CUSUM reads), the CUSUM
// and the observation count of service s, from the values in `in` (read
// before any cell wrote). One thread per cell, so the timescales advance
// side by side.
__device__ void head_update(const HeadArgs& h, int q, const HeadIn& in, float cnt,
                            float lat_sum, float lat_sumsq, float err_sum) {
  const HeadParams& hp = h.hp;
  const int T = hp.n_taus;
  const int s = q / T;
  const int t = q - s * T;
  const float dt = in.dt;
  const float obs = in.obs;
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
    const float c = in.cusum[j] + scores[j];
    h.cusum[s * 3 + j] = fminf(fmaxf(c, 0.f), hp.cusum_cap);
  }
}

// A warp slice's stats for services [t0, t0 + n) into the warp's
// accumulators wpart [4][tile] (service t0 + k at k): lanes of one service
// are summed by the group's leader in lane order, through `stage`.
__device__ __forceinline__ void warp_stats(const Lane& l, int t0, int n, int tile, int lane,
                                           float* stage, float* wpart) {
  const bool ok = l.valid && l.svc >= t0 && l.svc < t0 + n;
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
      const int k = l.svc - t0;
      wpart[k] += c;
      wpart[tile + k] += s1;
      wpart[2 * tile + k] += s2;
      wpart[3 * tile + k] += s3;
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

// Sum of partials[b, o] over a run of blocks b in [lo, hi), at most kRun,
// in block order; the loads are issued at once (from L2: other blocks
// wrote them).
__device__ __forceinline__ float sum_run(const float* partials, int o, int stride, int lo,
                                         int hi) {
  float v[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    v[j] = lo + j < hi ? __ldcg(partials + (long long)(lo + j) * stride + o) : 0.f;
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (lo + j < hi) acc += v[j];
  }
  return acc;
}

// Dynamic shared memory, flat in S: per-warp stats accumulators for a
// tile of services [n_warps][4][tile], per-warp staging of one slice's
// log-lat and error [n_warps][2][32], and the epilogue's stats of a chunk
// of services [blockDim.x] (fused.launch_plan keeps it all under the
// default 48 KB).
__global__ void __launch_bounds__(kMaxThreads) sketch_kernel(SketchArgs a, HeadArgs h) {
  extern __shared__ float smem[];
  const int S = a.S;
  const int tile = a.tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  float* part = smem;
  float* wpart = part + warp * 4 * tile;
  float* stage = smem + n_warps * 4 * tile + warp * 64;
  float* st = smem + n_warps * (4 * tile + 64);

  // This block's run of services in the epilogue, a chunk at a time: a
  // thread per head cell of the chunk (fused update), and for each of its
  // stats `span` neighbouring lanes (a power of 2) that sum a run of kRun
  // blocks each, in passes over the block's threads. A block takes at
  // least a chunk: spreading a few services over more blocks was slower.
  const int T = h.fold ? h.hp.n_taus : 0;
  const int G = a.stat_blocks;
  const int runs = (G + kRun - 1) / kRun;
  int span = 1;
  while (span < runs) span <<= 1;
  const int chunk = blockDim.x / max(T, 4);
  const int per_block = max((S + gridDim.x - 1) / gridDim.x, min(S, chunk));
  const int s_lo = (int)min((long long)S, (long long)blockIdx.x * per_block);
  const int s_hi = min(S, s_lo + per_block);

  // The warp's first slice (its only one unless B > 512 a block) and the
  // head memory of the thread's first cell: loaded at once, before
  // anything waits, and before any cell writes.
  const long long b0 = (long long)blockIdx.x * a.lanes_per_block;
  const long long b1 = min((long long)a.B, b0 + a.lanes_per_block);
  const long long first = b0 + warp * 32;
  const Lane mine = load_lane(a, first + lane, first + lane < b1);
  HeadIn head_in = {};
  if (tid < min(chunk, s_hi - s_lo) * T) head_in = load_head(h, s_lo * T + tid);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + tid; c < a.n_clear; c += stride) {
    a.clear[c] = 0;
  }

  // Stats, in a fixed order, a tile of services at a time, into this
  // block's row of partials (the warps in order). Blocks past the plan's
  // grid own no lanes and write none.
  if (blockIdx.x < a.stat_blocks) {
    float* out = a.partials + (long long)blockIdx.x * 4 * S;
    for (int t0 = 0; t0 < S; t0 += tile) {
      const int n = min(tile, S - t0);
      for (int t = tid; t < n_warps * 4 * tile; t += blockDim.x) part[t] = 0.f;
      __syncthreads();
      Lane l = mine;
      for (long long base = first; base < b1; base += blockDim.x) {
        if (base != first) l = load_lane(a, base + lane, base + lane < b1);
        warp_stats(l, t0, n, tile, lane, stage, wpart);
      }
      __syncthreads();
      for (int t = tid; t < 4 * n; t += blockDim.x) {
        const int j = t / n;
        const int k = t - j * n;
        float acc = 0.f;
        for (int w = 0; w < n_warps; ++w) acc += part[(w * 4 + j) * tile + k];
        out[(long long)j * S + t0 + k] = acc;
      }
      if (t0 + tile < S) __syncthreads();
    }
  }

  // The grid barrier publishes every block's partials and its share of
  // the clear. The bank atomics come after it, so no atomic lands before
  // the clear and the barrier does not wait for them.
  cg::this_grid().sync();

  Lane l = mine;
  for (long long base = first; base < b1; base += blockDim.x) {
    if (base != first) l = load_lane(a, base + lane, base + lane < b1);
    warp_banks(a, l, lane);
  }

  // This block's services: each stat summed over the plan's blocks, the
  // runs of kRun blocks in block order, each in block order (the order is
  // a function of the plan's grid alone), then (fused update) their head
  // cells.
  for (int c0 = s_lo; c0 < s_hi; c0 += chunk) {
    const int n = min(chunk, s_hi - c0);
    const bool cell = tid < n * T;
    if (cell && c0 != s_lo) head_in = load_head(h, c0 * T + tid);
    for (int base = 0; base < 4 * n * span; base += blockDim.x) {
      const int o = (base + tid) / span;  // stat o of the chunk: stat j of service c0 + k
      const int r = base + tid - o * span;
      const int j = o / n;
      const int k = o - j * n;
      float v = 0.f;
      if (o < 4 * n && r < runs) {
        v = sum_run(a.partials, j * S + c0 + k, 4 * S, r * kRun, min(G, (r + 1) * kRun));
      }
      // The runs of a stat sit on neighbouring lanes; the first adds the
      // others in run order.
      float acc = v;
      for (int i = 1; i < span; ++i) {
        const float w = __shfl_sync(kFull, v, (lane & ~(span - 1)) + i);
        if (i < runs) acc += w;
      }
      if (o < 4 * n && r == 0) st[o] = acc;
    }
    // The chunk's stats are in; every cell has read its head memory.
    __syncthreads();
    for (int o = tid; o < 4 * n; o += blockDim.x) {
      const int j = o / n;
      a.stats[j * S + c0 + o - j * n] = st[o];
    }
    if (cell) {
      const int q = tid / T;
      head_update(h, c0 * T + tid, head_in, st[q], st[n + q], st[2 * n + q], st[3 * n + q]);
    }
    if (c0 + chunk < s_hi) __syncthreads();
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
