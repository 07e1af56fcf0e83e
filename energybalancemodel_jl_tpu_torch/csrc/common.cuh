// Device code shared by the package's kernels (miz_year.cu, classic_year.cu,
// pcr.cu, newton_t0.cu): NaN-aware helpers, a block-wide max, and the
// row-scaled parallel cyclic reduction of ops/tridiag.py::pcr_solve in shared
// memory.
//
// Every helper performs the same operations in the same order as the plain
// PyTorch code it stands for, so a kernel built with -fmad=false rounds where
// the plain version does.
#pragma once

#include <cuda_runtime.h>

namespace {

template <typename T> __device__ __forceinline__ bool is_nan(T v) { return v != v; }

template <typename T> __device__ __forceinline__ bool is_finite(T v) {
  return v - v == T(0);  // false for +-inf and NaN
}

// minimum/maximum that propagate NaN, like torch.minimum and jnp.minimum
template <typename T> __device__ __forceinline__ T nan_min(T a, T b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (b < a ? b : a));
}

template <typename T> __device__ __forceinline__ T nan_max(T a, T b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (a < b ? b : a));
}

template <typename T> __device__ __forceinline__ T abs_val(T v) { return v < T(0) ? -v : v; }

template <typename T> __device__ __forceinline__ T safe_div(T num, T den) {
  return den == T(0) ? T(0) : num / den;
}

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// a Newton update clipped to +-max_step (NaN stays NaN), then a non-finite
// update set to 0 (torch.clamp, then torch.where(isfinite))
template <typename T> __device__ __forceinline__ T clip_step(T delta, T max_step) {
  delta = delta < -max_step ? -max_step : (delta > max_step ? max_step : delta);
  return is_finite(delta) ? delta : T(0);
}

// NaN-propagating max over the block; every thread gets the same value.
// `red` holds one slot per warp.
template <typename T>
__device__ __forceinline__ T block_max(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = nan_max(m, red[w]);
  __syncthreads();
  return m;
}

// the four shared-memory rows of a PCR solve, one entry per system row
template <typename T>
struct PcrSmem {
  T* lo;
  T* di;
  T* up;
  T* b;
};

// Row-scaled parallel cyclic reduction of ONE system of n rows per block
// (ops/tridiag.py::pcr_solve): thread t holds rows t + c * blockDim.x,
// c < CPT, in the arrays. ceil(log2 n) = `steps` doubling levels; rows out of
// range are identity rows. On return b[c] holds the solution of row c.
template <typename T, int CPT>
__device__ __forceinline__ void pcr_solve(T (&lo)[CPT], T (&di)[CPT], T (&up)[CPT],
                                          T (&b)[CPT], const PcrSmem<T>& s, int n,
                                          int steps) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const T inv = T(1) / di[c];
    lo[c] = lo[c] * inv;
    up[c] = up[c] * inv;
    b[c] = b[c] * inv;
    di[c] = T(1);
  }
  for (int level = 0, st = 1; level < steps; ++level, st <<= 1) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int i = threadIdx.x + c * blockDim.x;
      if (i < n) {
        s.lo[i] = lo[c];
        s.di[i] = di[c];
        s.up[i] = up[c];
        s.b[i] = b[c];
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int i = threadIdx.x + c * blockDim.x;
      if (i < n) {
        const bool hm = i - st >= 0, hp = i + st < n;
        const T di_m = hm ? s.di[i - st] : T(1);
        const T di_p = hp ? s.di[i + st] : T(1);
        const T lo_m = hm ? s.lo[i - st] : T(0);
        const T up_m = hm ? s.up[i - st] : T(0);
        const T b_m = hm ? s.b[i - st] : T(0);
        const T lo_p = hp ? s.lo[i + st] : T(0);
        const T up_p = hp ? s.up[i + st] : T(0);
        const T b_p = hp ? s.b[i + st] : T(0);
        const T alpha = safe_div(-lo[c], di_m);
        const T beta = safe_div(-up[c], di_p);
        b[c] = b[c] + alpha * b_m + beta * b_p;
        di[c] = di[c] + alpha * up_m + beta * lo_p;
        lo[c] = alpha * lo_m;
        up[c] = beta * up_p;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) b[c] = b[c] / di[c];
}

// rows per thread of a block that strides n rows over at most 1024 threads
inline int rows_per_thread(int n) { return n <= 1024 ? 1 : (n <= 2048 ? 2 : 4); }

inline int round_up_32(int v) { return ((v + 31) / 32) * 32; }

// the dynamic shared memory a kernel asks for above the default 48 KB
template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
