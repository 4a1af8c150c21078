// cms_hist: exact unit-weight histogram of int32 keys, for the CMS count
// of the composed ("xla") sketch path.
//
// Replaces: opentelemetry_demo_tpu/ops/cms.py::_hist_mxu_kernel (the
// Pallas kernel launched by _hist_mxu), which builds int8 one-hots of
// the keys' (hi, lo) bytes and contracts them on the TPU's matrix unit.
//
// What it computes: counts[b] = #{i : keys[i] == b} for b in [0, n_bins).
// Keys equal to n_bins (the invalid-lane sentinel) and any other key
// outside [0, n_bins) are not counted.
//
// Bound on the H100: bytes. Each key is read once (4 B) and each count
// written once (4 B); at the main path's shapes (262,144 keys, 32,768
// bins) that is 1.2 MB, about 0.4 us at 3.35 TB/s, so in practice the
// launch and the per-block zero/flush of the shared histogram set the
// time.
//
// Design: one shared-memory histogram of n_bins int32 counters per block
// (128 KiB at 4 x 8192, above the 48 KiB default, so the launcher opts in
// with cudaFuncSetAttribute). Keys are counted with shared-memory
// atomicAdd; each block then adds its non-zero counters into the global
// counts with one atomicAdd each. Integer adds are exact in any order, so
// the result is bit-exact whatever the schedule. The TPU's geometry rules
// (key count a multiple of 8192, bins a multiple of 256) do not apply.

#include <cuda_runtime.h>

namespace {

__global__ void cms_hist_kernel(const int* __restrict__ keys, long long n,
                                int n_bins, int* __restrict__ counts) {
  extern __shared__ int hist[];
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int k = keys[i];
    if ((unsigned)k < (unsigned)n_bins) atomicAdd(&hist[k], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int c = hist[i];
    if (c) atomicAdd(&counts[i], c);
  }
}

}  // namespace

extern "C" int cms_hist_launch(const void* keys, long long n, int n_bins,
                               void* counts, int n_blocks, void* stream) {
  const size_t smem = (size_t)n_bins * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      cms_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cms_hist_kernel<<<n_blocks, 512, smem, (cudaStream_t)stream>>>(
      (const int*)keys, n, n_bins, (int*)counts);
  return (int)cudaGetLastError();
}
