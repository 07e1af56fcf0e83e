// Fixed-iteration Newton solve of the MIZ ice surface temperature T0 for a
// (K, n) batch, one launch.
//
// Replaces energybalancemodel_jl_tpu/ops/pallas_newton.py::_kernel (launched
// by pallas_solve_T0), the solver='pallas' path of the batched engine. ONE
// THREAD BLOCK PER MEMBER, cells strided over at most 1024 threads (1, 2 or 4
// per thread, n <= 4096). Each of `iters` iterations evaluates the T0eq
// residual and its tridiagonal Jacobian (neighbour values through shared
// memory, zero outside the grid), solves the Jacobian by common.cuh's PCR,
// clips the update to +-max_step and sets a non-finite update to 0. There is
// no convergence test: a converged cell takes ~0 steps. The operations and
// their order are those of ops/newton_t0.py::newton_t0_reference.
//
// What bounds it: device memory sees the five (K, n) inputs read once and T0
// written once; in between, per iteration, 2 barriers for the neighbour
// exchange and 2 * ceil(log2 n) for the PCR levels. At (8192, 180) the
// traffic is ~35 MB in f32, so a call is bound by the barrier chain and launch
// latency, not by bytes.
#include "common.cuh"

namespace {

template <typename T, int CPT>
__global__ void __launch_bounds__(1024)
    newton_t0_kernel(const T* __restrict__ T0in, const T* __restrict__ hp,
                     const T* __restrict__ Tw, const T* __restrict__ phi,
                     const T* __restrict__ insol, const T* __restrict__ bands,
                     const T* __restrict__ D, const T* __restrict__ scal,
                     T* __restrict__ T0out, int n, int iters, int steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int rows = CPT * blockDim.x;
  const PcrSmem<T> s{sm, sm + rows, sm + 2 * rows, sm + 3 * rows};
  T* vTb = sm + 4 * rows;  // neighbour exchange of Tb and g
  T* vg = sm + 5 * rows;
  const size_t m = blockIdx.x;
  const T Dm = D[m];
  // k, Tm, A, B, ai, f, max_step (ops/newton_t0.py), on the device: no host
  // round trip for scalars that are tensors there
  const T k = scal[0], Tm = scal[1], A = scal[2], B = scal[3], ai = scal[4],
          f = scal[5], max_step = scal[6];

  // per cell: the iterate and the loop-invariant terms hoisted out of the
  // iteration (k/hp, (1 - phi) Tw, ai insol), and the stencil bands
  T T0[CPT], k_over_h[CPT], one_m_phi_Tw[CPT], solar_ice[CPT], ph[CPT];
  T glo[CPT], gdi[CPT], gup[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    const int j = i < n ? i : 0;
    const size_t idx = m * n + j;
    T0[c] = T0in[idx];
    k_over_h[c] = k / hp[idx];
    ph[c] = phi[idx];
    one_m_phi_Tw[c] = (T(1) - ph[c]) * Tw[idx];
    solar_ice[c] = ai * insol[idx];
    glo[c] = bands[j];
    gdi[c] = bands[n + j];
    gup[c] = bands[2 * n + j];
  }

  for (int it = 0; it < iters; ++it) {
    T Tb[CPT], g[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int i = threadIdx.x + c * blockDim.x;
      const T Ti = nan_min(T0[c], Tm);
      Tb[c] = Ti * ph[c] + one_m_phi_Tw[c];
      g[c] = ph[c] * (T0[c] < Tm ? T(1) : T(0));
      if (i < n) {
        vTb[i] = Tb[c];
        vg[i] = g[c];
      }
    }
    __syncthreads();
    T lo[CPT], di[CPT], up[CPT], b[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int i = threadIdx.x + c * blockDim.x;
      const bool hm = i >= 1, hp1 = i + 1 < n;  // zero outside the grid
      const T Tbm1 = hm ? vTb[i - 1] : T(0), Tbp1 = hp1 ? vTb[i + 1] : T(0);
      const T gm1 = hm ? vg[i - 1] : T(0), gp1 = hp1 ? vg[i + 1] : T(0);
      const T dTb = Dm * (glo[c] * Tbm1 + gdi[c] * Tb[c] + gup[c] * Tbp1);
      const T r = k_over_h[c] * (Tm - T0[c]) + solar_ice[c] +
                  ((-A) - B * (T0[c] - Tm)) + dTb + f;
      lo[c] = Dm * glo[c] * gm1;
      di[c] = -k_over_h[c] - B + Dm * gdi[c] * g[c];
      up[c] = Dm * gup[c] * gp1;
      b[c] = -r;
    }
    __syncthreads();
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

template <typename T, int CPT>
int launch_cells(cudaStream_t stream, const void* T0, const void* hp, const void* Tw,
                 const void* phi, const void* insol, const void* bands, const void* D,
                 const void* scal, void* out, int K, int n, int iters, int steps) {
  const int threads = round_up_32((n + CPT - 1) / CPT);
  const size_t shmem = (size_t)6 * CPT * threads * sizeof(T);
  auto kernel = newton_t0_kernel<T, CPT>;
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
           int K, int n, int iters, int steps, void* stream) {
  if (K < 1 || n < 1 || n > 4096 || iters < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows_per_thread(n)) {
    case 1:
      return launch_cells<T, 1>(st, T0, hp, Tw, phi, insol, bands, D, scal, out, K, n,
                                iters, steps);
    case 2:
      return launch_cells<T, 2>(st, T0, hp, Tw, phi, insol, bands, D, scal, out, K, n,
                                iters, steps);
    default:
      return launch_cells<T, 4>(st, T0, hp, Tw, phi, insol, bands, D, scal, out, K, n,
                                iters, steps);
  }
}

}  // namespace

extern "C" {

int ebm_newton_t0_f32(const void* T0, const void* hp, const void* Tw, const void* phi,
                      const void* insol, const void* bands, const void* D, const void* scal,
                      void* out, int K, int n, int iters, int steps, void* stream) {
  return launch<float>(T0, hp, Tw, phi, insol, bands, D, scal, out, K, n, iters, steps,
                       stream);
}

int ebm_newton_t0_f64(const void* T0, const void* hp, const void* Tw, const void* phi,
                      const void* insol, const void* bands, const void* D, const void* scal,
                      void* out, int K, int n, int iters, int steps, void* stream) {
  return launch<double>(T0, hp, Tw, phi, insol, bands, D, scal, out, K, n, iters, steps,
                        stream);
}

}  // extern "C"
