// Fixed-iteration Newton solve of the MIZ ice surface temperature T0 for a
// (K, n) batch, one launch.
//
// Replaces energybalancemodel_jl_tpu/ops/pallas_newton.py::_kernel (launched
// by pallas_solve_T0), the solver='pallas' path of the batched engine. ONE
// THREAD BLOCK PER MEMBER, cells strided over at most 1024 threads (1, 2 or 4
// per thread, n <= 4096). Each of `iters` iterations evaluates the T0eq
// residual and its tridiagonal Jacobian (newton.cuh, shared with the year
// kernel; neighbour values through shared memory, zero outside the grid),
// solves the Jacobian by common.cuh's PCR, clips the update to +-max_step and
// sets a non-finite update to 0. There is no convergence test: a converged
// cell takes ~0 steps. The operations and their order are those of
// ops/newton_t0.py::newton_t0_reference. Above n = 4096 (up to 16384) the
// wide build (common.cuh, newton.cuh) keeps each cell's iterate, inputs and
// residual, the exchange and the PCR rows in a workspace of device memory,
// one block per member, each block solving members m, m + gridDim.x, ...
//
// What bounds it: device memory sees the five (K, n) inputs read once and T0
// written once, ~35 MB in float32 at (8192, 180), microseconds at the card's
// bandwidth. In between, an iteration is one barrier for the neighbour
// exchange and one per PCR level (every exchange writes two buffers in turn,
// common.cuh): 1 + ceil(log2 n) = 9 at n = 180, 54 for the 6 iterations of a
// call (108 before the buffers alternated). Between barriers a level is one
// 16-byte store and two 16-byte loads per row in float32 and two IEEE
// divisions (none at the first level), so a call is bound by the
// instructions the six blocks resident on an SM issue between barriers, not
// by bytes or flops; and a caller that passes its scalars as Python numbers
// waits longer for the wrapper's seven small copies than for the kernel
// (PERF.md). n <= 256 runs a 256-thread build that is not compiled under the
// register cap of a 1024-thread block; wider systems run the 1024-thread
// builds (two barriers per level and per exchange above n = 1024).
#include "newton.cuh"

namespace {

template <typename T>
size_t newton_shared_bytes(int n, int steps) {
  return pcr_shared_bytes<T>(n, steps) + halo_shared_bytes<T>(n);
}

template <typename T, int CPT, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
    newton_t0_kernel(const T* __restrict__ T0in, const T* __restrict__ hp,
                     const T* __restrict__ Tw, const T* __restrict__ phi,
                     const T* __restrict__ insol, const T* __restrict__ bands,
                     const T* __restrict__ D, const T* __restrict__ scal,
                     T* __restrict__ T0out, int n, int iters, int steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PcrSmem<T> s = pcr_begin<T>(smem_raw, n, steps);
  Halo<T> halo = halo_begin<T, false>(smem_raw + pcr_shared_bytes<T>(n, steps), n);
  const size_t m = blockIdx.x;
  // k, Tm, A, B, ai, f, max_step (ops/newton_t0.py), on the device: no host
  // round trip for scalars that are tensors there
  const T0Par<T> par{scal[0], scal[1], scal[2], scal[3], D[m], scal[5]};
  const T ai = scal[4], max_step = scal[6];

  // per cell: the iterate, the stencil bands, and the loop-invariant terms
  // hoisted out of the iteration (k/hp, (1 - phi) Tw, ai insol)
  T T0[CPT];
  T0Cell<T> cell[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    const int j = i < n ? i : 0;
    const size_t idx = m * n + j;
    T0[c] = T0in[idx];
    cell[c].kh = par.k / hp[idx];
    cell[c].phi = phi[idx];
    cell[c].water = (T(1) - cell[c].phi) * Tw[idx];
    cell[c].solar = ai * insol[idx];
    cell[c].glo = bands[j];
    cell[c].gdi = bands[n + j];
    cell[c].gup = bands[2 * n + j];
  }
  // the halo's zero cells are written before the first exchange's barrier

  T r[CPT], lo[CPT], di[CPT], up[CPT], b[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {  // rows beyond the system: identity
    r[c] = T(0);
    lo[c] = T(0);
    di[c] = T(1);
    up[c] = T(0);
  }
  for (int it = 0; it < iters; ++it) {
    t0_residual_bands<T, CPT, false, true>(T0, cell, par, halo, n, r, lo, di, up);
#pragma unroll
    for (int c = 0; c < CPT; ++c) b[c] = -r[c];
    pcr_solve<T, CPT>(lo, di, up, b, s, n, steps);
#pragma unroll
    for (int c = 0; c < CPT; ++c) T0[c] = T0[c] + clip_step(b[c], max_step);
  }

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < n) T0out[m * n + i] = T0[c];
  }
}

constexpr int MAX_WIDE_N = 16384;

// a cell's record is the solve's fields (newton.cuh)
__host__ __device__ inline size_t newton_wide_words(int n) {
  return wide_stride(wide_pcr_words(n) + wide_halo_words(n) + (size_t)N_NEWTON_FIELDS * n);
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    newton_t0_wide_kernel(const T* __restrict__ T0in, const T* __restrict__ hp,
                          const T* __restrict__ Tw, const T* __restrict__ phi,
                          const T* __restrict__ insol, const T* __restrict__ bands,
                          const T* __restrict__ D, const T* __restrict__ scal,
                          T* __restrict__ T0out, T* ws, int K, int n, int iters, int steps) {
  T* w = ws + (size_t)blockIdx.x * newton_wide_words(n);
  const WidePcr<T> s = wide_pcr_begin(w, n);
  Halo<T> halo = wide_halo_begin<T, false>(w + wide_pcr_words(n), n);
  const WideCells<T, N_NEWTON_FIELDS> wc{bands, bands + n, bands + 2 * n,
                                          w + wide_pcr_words(n) + wide_halo_words(n)};
  const T ai = scal[4], max_step = scal[6];
  for (size_t m = blockIdx.x; m < (size_t)K; m += gridDim.x) {
    const T0Par<T> par{scal[0], scal[1], scal[2], scal[3], D[m], scal[5]};
    // the iterate and the loop-invariant terms (k/hp, (1 - phi) Tw, ai
    // insol), each thread its own cells
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      T* c = wc.at(i);
      const size_t idx = m * n + i;
      c[F_T0] = T0in[idx];
      c[F_KH] = par.k / hp[idx];
      c[F_PHI] = phi[idx];
      c[F_WATER] = (T(1) - c[F_PHI]) * Tw[idx];
      c[F_SOLAR] = ai * insol[idx];
    }
    for (int it = 0; it < iters; ++it) {
      Pair<T>* cur = halo_turn(halo);
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        wide_t0_put<T, N_NEWTON_FIELDS, false>(wc, par, cur, i, n);
      __syncthreads();
      wide_t0_rows<T, N_NEWTON_FIELDS, true>(wc, par, cur, s, n);
      const PcrRow<T>* solved = wide_pcr_solve(s, steps);
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        T* c = wc.at(i);
        c[F_T0] = c[F_T0] + clip_step(wide_pcr_x(solved, i), max_step);
      }
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) T0out[m * n + i] = wc.at(i)[F_T0];
  }
}

// the wide build on min(K, ws_blocks) blocks, each with its workspace of
// newton_wide_words(n) words at ws
template <typename T>
int launch_wide(cudaStream_t stream, const void* T0, const void* hp, const void* Tw,
                const void* phi, const void* insol, const void* bands, const void* D,
                const void* scal, void* out, void* ws, int K, int n, int iters, int steps,
                int ws_words, int ws_blocks) {
  if (ws == nullptr || ws_blocks < 1 || (size_t)ws_words != newton_wide_words(n))
    return (int)cudaErrorInvalidValue;
  newton_t0_wide_kernel<T><<<K < ws_blocks ? K : ws_blocks, WIDE_THREADS, 0, stream>>>(
      static_cast<const T*>(T0), static_cast<const T*>(hp), static_cast<const T*>(Tw),
      static_cast<const T*>(phi), static_cast<const T*>(insol),
      static_cast<const T*>(bands), static_cast<const T*>(D), static_cast<const T*>(scal),
      static_cast<T*>(out), static_cast<T*>(ws), K, n, iters, steps);
  return (int)cudaGetLastError();
}

template <typename T, int CPT, int MAX_THREADS>
int launch_cells(cudaStream_t stream, const void* T0, const void* hp, const void* Tw,
                 const void* phi, const void* insol, const void* bands, const void* D,
                 const void* scal, void* out, int K, int n, int iters, int steps) {
  const int threads = round_up_32((n + CPT - 1) / CPT);
  const size_t shmem = newton_shared_bytes<T>(n, steps);
  auto kernel = newton_t0_kernel<T, CPT, MAX_THREADS>;
  const cudaError_t err = allow_shared(kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<K, threads, shmem, stream>>>(
      static_cast<const T*>(T0), static_cast<const T*>(hp), static_cast<const T*>(Tw),
      static_cast<const T*>(phi), static_cast<const T*>(insol),
      static_cast<const T*>(bands), static_cast<const T*>(D), static_cast<const T*>(scal),
      static_cast<T*>(out), n, iters, steps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* T0, const void* hp, const void* Tw, const void* phi,
           const void* insol, const void* bands, const void* D, const void* scal, void* out,
           void* ws, int K, int n, int iters, int steps, int ws_words, int ws_blocks,
           void* stream) {
  if (K < 1 || n < 1 || n > MAX_WIDE_N || iters < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 4096)
    return launch_wide<T>(st, T0, hp, Tw, phi, insol, bands, D, scal, out, ws, K, n, iters,
                          steps, ws_words, ws_blocks);
  switch (rows_per_thread(n)) {
    case 1:
      // the canonical n = 180 takes the 256-thread build
      if (n <= 256)
        return launch_cells<T, 1, 256>(st, T0, hp, Tw, phi, insol, bands, D, scal, out, K, n,
                                       iters, steps);
      return launch_cells<T, 1, 1024>(st, T0, hp, Tw, phi, insol, bands, D, scal, out, K, n,
                                      iters, steps);
    case 2:
      return launch_cells<T, 2, 1024>(st, T0, hp, Tw, phi, insol, bands, D, scal, out, K, n,
                                      iters, steps);
    default:
      return launch_cells<T, 4, 1024>(st, T0, hp, Tw, phi, insol, bands, D, scal, out, K, n,
                                      iters, steps);
  }
}

}  // namespace

extern "C" {

int ebm_newton_t0_f32(const void* T0, const void* hp, const void* Tw, const void* phi,
                      const void* insol, const void* bands, const void* D, const void* scal,
                      void* out, void* ws, int K, int n, int iters, int steps, int ws_words,
                      int ws_blocks, void* stream) {
  return launch<float>(T0, hp, Tw, phi, insol, bands, D, scal, out, ws, K, n, iters, steps,
                       ws_words, ws_blocks, stream);
}

int ebm_newton_t0_f64(const void* T0, const void* hp, const void* Tw, const void* phi,
                      const void* insol, const void* bands, const void* D, const void* scal,
                      void* out, void* ws, int K, int n, int iters, int steps, int ws_words,
                      int ws_blocks, void* stream) {
  return launch<double>(T0, hp, Tw, phi, insol, bands, D, scal, out, ws, K, n, iters, steps,
                        ws_words, ws_blocks, stream);
}

}  // extern "C"
