// Batched tridiagonal solve by row-scaled parallel cyclic reduction: K
// independent systems of n rows, one launch.
//
// Replaces energybalancemodel_jl_tpu/ops/pallas_tridiag.py::_kernel (launched
// by pallas_pcr_solve), the solver='pcr_fused' path of the batched engine.
// ONE THREAD BLOCK PER SYSTEM, rows strided over at most 1024 threads (1, 2
// or 4 rows per thread, n <= 4096); the bands and right-hand side live in
// shared memory for the ceil(log2 n) doubling levels of common.cuh's
// pcr_solve, the same operations in the same order as
// ops/tridiag.py::pcr_solve (row scaling, safe_div, identity rows out of
// range), so a row's solution equals the plain version's.
//
// Bands are shared by all systems (row stride 0) or one row per system
// (row stride n); the right-hand side and the solution are (K, n).
//
// What bounds it: device memory sees the four inputs read once and the
// solution written once; in between, ceil(log2 n) block barriers (one per
// level up to n = 1024, two above: common.cuh). At
// (K, n) = (8192, 180) that is ~30 MB of traffic in f32, microseconds at
// the card's bandwidth, so a call is bound by launch latency and the barrier
// chain, not by bytes.
#include "common.cuh"

namespace {

template <typename T, int CPT>
__global__ void __launch_bounds__(1024)
    pcr_kernel(const T* __restrict__ lo, const T* __restrict__ di,
               const T* __restrict__ up, const T* __restrict__ b, T* __restrict__ x,
               int n, int lo_stride, int di_stride, int up_stride, int steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PcrSmem<T> s = pcr_begin<T>(smem_raw, n, steps);
  const size_t m = blockIdx.x;

  T l[CPT], d[CPT], u[CPT], r[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    const bool in = i < n;
    l[c] = in ? lo[m * lo_stride + i] : T(0);
    d[c] = in ? di[m * di_stride + i] : T(1);
    u[c] = in ? up[m * up_stride + i] : T(0);
    r[c] = in ? b[m * n + i] : T(0);
  }
  pcr_solve<T, CPT>(l, d, u, r, s, n, steps);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < n) x[m * n + i] = r[c];
  }
}

template <typename T, int CPT>
int launch_cells(cudaStream_t stream, const void* lo, const void* di, const void* up,
                 const void* b, void* x, int K, int n, int lo_stride, int di_stride,
                 int up_stride, int steps) {
  const int threads = round_up_32((n + CPT - 1) / CPT);
  const size_t shmem = pcr_shared_bytes<T>(n, steps);
  auto kernel = pcr_kernel<T, CPT>;
  const cudaError_t err = allow_shared(kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<K, threads, shmem, stream>>>(
      static_cast<const T*>(lo), static_cast<const T*>(di), static_cast<const T*>(up),
      static_cast<const T*>(b), static_cast<T*>(x), n, lo_stride, di_stride, up_stride,
      steps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* lo, const void* di, const void* up, const void* b, void* x,
           int K, int n, int lo_stride, int di_stride, int up_stride, int steps,
           void* stream) {
  if (K < 1 || n < 1 || n > 4096) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows_per_thread(n)) {
    case 1:
      return launch_cells<T, 1>(st, lo, di, up, b, x, K, n, lo_stride, di_stride,
                                up_stride, steps);
    case 2:
      return launch_cells<T, 2>(st, lo, di, up, b, x, K, n, lo_stride, di_stride,
                                up_stride, steps);
    default:
      return launch_cells<T, 4>(st, lo, di, up, b, x, K, n, lo_stride, di_stride,
                                up_stride, steps);
  }
}

}  // namespace

extern "C" {

int ebm_pcr_f32(const void* lo, const void* di, const void* up, const void* b, void* x,
                int K, int n, int lo_stride, int di_stride, int up_stride, int steps,
                void* stream) {
  return launch<float>(lo, di, up, b, x, K, n, lo_stride, di_stride, up_stride, steps,
                       stream);
}

int ebm_pcr_f64(const void* lo, const void* di, const void* up, const void* b, void* x,
                int K, int n, int lo_stride, int di_stride, int up_stride, int steps,
                void* stream) {
  return launch<double>(lo, di, up, b, x, K, n, lo_stride, di_stride, up_stride, steps,
                        stream);
}

}  // extern "C"
