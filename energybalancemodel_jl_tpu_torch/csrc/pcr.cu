// Batched tridiagonal solve by row-scaled parallel cyclic reduction: K
// independent systems of n rows, one launch.
//
// Replaces energybalancemodel_jl_tpu/ops/pallas_tridiag.py::_kernel (launched
// by pallas_pcr_solve), the solver='pcr_fused' path of the batched engine.
// Two layouts, both the ceil(log2 n) doubling levels of common.cuh with the
// same operations in the same order as ops/tridiag.py::pcr_solve (row
// scaling, safe_div, identity rows out of range), so a row's solution equals
// the plain version's:
//   - n <= 256: ONE WARP PER SYSTEM (warp_pcr_solve), WARPS systems per
//     block; row i in lane i % 32, slot i / 32, so the loads and stores of a
//     slot are coalesced and the levels exchange rows by shuffles, with no
//     barrier and no shared memory;
//   - n > 256: ONE THREAD BLOCK PER SYSTEM (pcr_solve), rows strided over at
//     most 1024 threads (1, 2 or 4 rows per thread, n <= 4096) in shared
//     memory;
//   - n > 4096 (up to 32768): the wide build (common.cuh), one block per
//     system with its rows in a workspace of device memory, each block
//     solving systems m, m + gridDim.x, ...
//
// Bands are shared by all systems (row stride 0) or one row per system
// (row stride n); the right-hand side and the solution are (K, n).
//
// What bounds it: device memory sees the four inputs read once and the
// solution written once: at (K, n) = (8192, 180) ~30 MB in f32, 8.8 us at
// the card's bandwidth. The block layout spent ~7x that on a barrier and a
// shared-memory round trip per level with one row per thread; the warp
// layout leaves each lane S independent rows and the instructions of the
// levels (two IEEE divisions and eight shuffles per row and level), which
// bound it above the byte bound.
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

constexpr int MAX_WIDE_N = 32768;

__host__ __device__ inline size_t pcr_wide_words(int n) { return wide_stride(wide_pcr_words(n)); }

// the wide build: each thread writes its rows to the workspace (a thread
// reads back only its own rows of the last solve before it writes the next
// system's, so the systems need no barrier between them)
template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    pcr_wide_kernel(const T* __restrict__ lo, const T* __restrict__ di,
                    const T* __restrict__ up, const T* __restrict__ b, T* __restrict__ x,
                    T* ws, int K, int n, int lo_stride, int di_stride, int up_stride, int steps) {
  const WidePcr<T> s = wide_pcr_begin(ws + (size_t)blockIdx.x * pcr_wide_words(n), n);
  for (size_t m = blockIdx.x; m < (size_t)K; m += gridDim.x) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      wide_pcr_row(s, i, lo[m * lo_stride + i], di[m * di_stride + i], up[m * up_stride + i],
                   b[m * n + i]);
    const PcrRow<T>* solved = wide_pcr_solve(s, steps);
    for (int i = threadIdx.x; i < n; i += blockDim.x) x[m * n + i] = wide_pcr_x(solved, i);
  }
}

template <typename T, int S, int WARPS, int MIN_BLOCKS>
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS)
    pcr_warp_kernel(const T* __restrict__ lo, const T* __restrict__ di,
                    const T* __restrict__ up, const T* __restrict__ b, T* __restrict__ x,
                    int K, int n, int lo_stride, int di_stride, int up_stride, int steps) {
  const int lane = threadIdx.x & 31;
  const size_t m = (size_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (m >= (size_t)K) return;
  T l[S], d[S], u[S], r[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = lane + 32 * s;
    const bool in = i < n;
    l[s] = in ? lo[m * lo_stride + i] : T(0);
    d[s] = in ? di[m * di_stride + i] : T(1);
    u[s] = in ? up[m * up_stride + i] : T(0);
    r[s] = in ? b[m * n + i] : T(0);
  }
  warp_pcr_solve<T, S>(l, d, u, r, n, steps, lane);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = lane + 32 * s;
    if (i < n) x[m * n + i] = r[s];
  }
}

// systems per block of the warp layout, and the blocks per SM its register
// cap holds: 24 systems per SM in float32 (80 registers), 12 in float64 (168)
constexpr int PCR_WARPS = 4;

template <typename T>
constexpr int pcr_warp_blocks() {
  return sizeof(T) == 4 ? 6 : 3;
}

template <typename T, int S>
int launch_warps(cudaStream_t stream, const void* lo, const void* di, const void* up,
                 const void* b, void* x, int K, int n, int lo_stride, int di_stride,
                 int up_stride, int steps) {
  pcr_warp_kernel<T, S, PCR_WARPS, pcr_warp_blocks<T>()>
      <<<(K + PCR_WARPS - 1) / PCR_WARPS, 32 * PCR_WARPS, 0, stream>>>(
          static_cast<const T*>(lo), static_cast<const T*>(di), static_cast<const T*>(up),
          static_cast<const T*>(b), static_cast<T*>(x), K, n, lo_stride, di_stride, up_stride,
          steps);
  return (int)cudaGetLastError();
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

// the wide build on min(K, ws_blocks) blocks, each with its workspace of
// pcr_wide_words(n) words at ws
template <typename T>
int launch_wide(cudaStream_t stream, const void* lo, const void* di, const void* up,
                const void* b, void* x, void* ws, int K, int n, int lo_stride, int di_stride,
                int up_stride, int steps, int ws_words, int ws_blocks) {
  if (ws == nullptr || ws_blocks < 1 || (size_t)ws_words != pcr_wide_words(n))
    return (int)cudaErrorInvalidValue;
  pcr_wide_kernel<T><<<K < ws_blocks ? K : ws_blocks, WIDE_THREADS, 0, stream>>>(
      static_cast<const T*>(lo), static_cast<const T*>(di), static_cast<const T*>(up),
      static_cast<const T*>(b), static_cast<T*>(x), static_cast<T*>(ws), K, n, lo_stride,
      di_stride, up_stride, steps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* lo, const void* di, const void* up, const void* b, void* x, void* ws,
           int K, int n, int lo_stride, int di_stride, int up_stride, int steps, int ws_words,
           int ws_blocks, void* stream) {
  if (K < 1 || n < 1 || n > MAX_WIDE_N) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 4096)
    return launch_wide<T>(st, lo, di, up, b, x, ws, K, n, lo_stride, di_stride, up_stride,
                          steps, ws_words, ws_blocks);
  if (n <= 256) {
    switch (warp_slots(n)) {
      case 1:
        return launch_warps<T, 1>(st, lo, di, up, b, x, K, n, lo_stride, di_stride, up_stride,
                                  steps);
      case 2:
        return launch_warps<T, 2>(st, lo, di, up, b, x, K, n, lo_stride, di_stride, up_stride,
                                  steps);
      case 4:
        return launch_warps<T, 4>(st, lo, di, up, b, x, K, n, lo_stride, di_stride, up_stride,
                                  steps);
      case 6:
        return launch_warps<T, 6>(st, lo, di, up, b, x, K, n, lo_stride, di_stride, up_stride,
                                  steps);
      default:
        return launch_warps<T, 8>(st, lo, di, up, b, x, K, n, lo_stride, di_stride, up_stride,
                                  steps);
    }
  }
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
                void* ws, int K, int n, int lo_stride, int di_stride, int up_stride, int steps,
                int ws_words, int ws_blocks, void* stream) {
  return launch<float>(lo, di, up, b, x, ws, K, n, lo_stride, di_stride, up_stride, steps,
                       ws_words, ws_blocks, stream);
}

int ebm_pcr_f64(const void* lo, const void* di, const void* up, const void* b, void* x,
                void* ws, int K, int n, int lo_stride, int di_stride, int up_stride, int steps,
                int ws_words, int ws_blocks, void* stream) {
  return launch<double>(lo, di, up, b, x, ws, K, n, lo_stride, di_stride, up_stride, steps,
                        ws_words, ws_blocks, stream);
}

}  // extern "C"
