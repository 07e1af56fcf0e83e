// The white-noise table of the noise-forced engines, stand-alone: (K, 2)
// uint32 member keys -> (nt, K) float32 draws, bitwise
// jax.vmap(lambda k: jax.random.normal(k, (nt,), float32), out_axes=1)(keys).
//
// Replaces the TPU probe scripts/tpu_check.py:468, the pallas_call that runs
// energybalancemodel_jl_tpu/ops/pallas_year.py::_gen_noise_xk alone to check
// the in-kernel draws; the year kernels (miz_year.cu, classic_year.cu) make
// the same draws with the same device functions (prng.cuh). A second entry
// point maps raw 32-bit words through the draw pipeline, so every one of the
// 2^23 mantissas the pipeline can see is checkable against the plain version.
//
// What bounds it: one thread per draw, no data reuse. Each draw is ~120
// 32-bit integer operations (the cipher) and ~50 float operations, and
// writes 4 bytes: at (2000, 8192) that is ~2e9 integer operations (Hopper
// has half as many INT32 lanes as FP32 lanes) against 66 MB of stores, so
// the integer work bounds it. Consecutive threads write consecutive members
// of one row, so the stores coalesce.
#include <cuda_runtime.h>

#include "prng.cuh"

namespace {

__global__ void normal_table_kernel(const uint32_t* __restrict__ keys, float* __restrict__ out,
                                    int K, int nt) {
  const size_t n = (size_t)K * nt;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(idx % K);
    const uint32_t t = (uint32_t)(idx / K);
    out[idx] = normal_draw(keys[2 * m], keys[2 * m + 1], t);
  }
}

__global__ void normal_bits_kernel(const uint32_t* __restrict__ bits, float* __restrict__ out,
                                   int n) {
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n; idx += gridDim.x * blockDim.x)
    out[idx] = normal_from_bits(bits[idx]);
}

int grid_for(size_t n, int threads) {
  const size_t blocks = (n + threads - 1) / threads;
  return (int)(blocks < 65535 * 32 ? blocks : 65535 * 32);
}

}  // namespace

extern "C" {

int ebm_normal_table(const void* keys, void* out, int K, int nt, void* stream) {
  if (K < 1 || nt < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  normal_table_kernel<<<grid_for((size_t)K * nt, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<float*>(out), K, nt);
  return (int)cudaGetLastError();
}

int ebm_normal_bits(const void* bits, void* out, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  normal_bits_kernel<<<grid_for((size_t)n, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
