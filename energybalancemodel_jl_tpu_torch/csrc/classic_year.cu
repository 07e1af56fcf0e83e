// One WE15 Classic model year for a (K, nx) ensemble, fused into one launch.
//
// Replaces the two TPU kernels of energybalancemodel_jl_tpu/ops/pallas_year.py
// that compute this function in two layouts the TPU's (8, 128) tiling forced:
//   - pallas_year.py::_classic_kernel_xk (grid on sublanes, members on lanes;
//     the ensemble path, launched by _classic_year_xk), and
//   - pallas_year.py::_classic_kernel    (members on sublanes, grid on lanes;
//     the single-run 'kx' branch of pallas_classic_year, up to nx = 4096).
// On Hopper one layout serves both: ONE THREAD BLOCK PER MEMBER, grid cells
// strided over at most 1024 threads (CPT = 1, 2 or 4 cells per thread, so
// nx <= 4096). K = 1 and K = 8192 are the same kernel.
//
// Each thread keeps its cells' carry (E, Tg), their per-member constants
// (insolation factor S0 - S2 x^2, water coalbedo, implicit-matrix bands) and
// the three annual sums in registers for all nt steps. Device memory sees one
// read of the carry and one write of carry + seasonal store per simulated
// year; a raw-collected year (raw != nullptr) also writes every step's three
// outputs, raw[t][var][member][cell].
//
// Per step (models/classic.py::step, line for line, same operation order):
//   - insolation rows S_i and the wraparound S_{i+1} rebuilt from
//     (S0 - S2 x^2) - (S1 cos 2pi t) x, forcing f[t] + F;
//   - the albedo switch (zero at E == 0), T0, the three-regime T from the
//     pre-update E, the explicit E update;
//   - the implicit Tg step: the member's bands, kdi masked by the updated E,
//     one row-scaled PCR solve in shared memory (common.cuh);
//   - the seasonal store (winter/summer snapshots at w0/s0, sums / nt).
// The kernel reads the per-member scalars (cg/tau, dt/tau, M, kLf, dt D, ...)
// from the stack ops/classic_year.py builds with the same torch code as
// models/classic.py::statics, so it takes the operands the plain version takes.
//
// What bounds it: the year is a dependent chain of ceil(log2 nx) block
// barriers per step (the PCR levels, one barrier each with one cell per
// thread, common.cuh); the pointwise update between them is a few dozen flops
// per cell. Nothing touches device memory inside the year
// except the forcing and cos tables (L1-resident). Resident blocks per SM
// (members) share its issue slots and hide one another's barrier latency:
// the builds for the canonical grid (blocks of up to 192 threads) are held to
// the registers at which 5 (float32), 3 (float64) and 2 (float64 noisy)
// blocks share an SM; a single run uses one SM.
//
// The noisy years (template flag NOISY; replaces the TPU kernels
// pallas_year.py::_classic_kernel_xk_noisy :666 (K5), _classic_kernel_xk_ou
// :673 (K6), _classic_kernel_xk_gen_ou :703 (K7, K8) and the crossing=True
// branch of _classic_kernel_xk (K9), launched at :1908): the block's noise row
// in shared memory after the PCR rows, step t's forcing (f[t] + F) + offset,
// and, with a crossing output, the area sum_i w_i [E_i < 0] of the updated E
// each step, in the fixed order of noise.cuh (one more barrier). The deterministic year is the
// NOISY = false instantiation, unchanged.
#include "common.cuh"
#include "noise.cuh"

namespace {

constexpr int N_OUT = 3;
// member parameter row, ops/classic_year.py ROW_NAMES
enum Row {
  P_CG_TAU, P_DT_TAU, P_DC, P_M, P_KLF, P_DTD, P_CG, P_AI, P_A, P_FB, P_CW, P_LF,
  P_F, P_S0, P_S1, P_S2, P_A0, P_A2, N_ROWS
};

// MIN_BLOCKS blocks of MAX_THREADS share an SM: the compiler is held to the
// registers that allows
template <typename T, int CPT, int MAX_THREADS, int MIN_BLOCKS, bool NOISY>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    classic_year_kernel(const T* __restrict__ cin, const T* __restrict__ pars,
                        const T* __restrict__ cols, const T* __restrict__ cosv,
                        const T* __restrict__ fyear, T* __restrict__ cout,
                        T* __restrict__ wint, T* __restrict__ summ,
                        T* __restrict__ avg, T* __restrict__ raw, NoiseArgs<T> nz, int K,
                        int nx, int nt, int w0, int s0, int pcr_steps, T dt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the PCR buffers, the slots of the crossing sum, the noise rows
  PcrSmem<T> s = pcr_begin<T>(smem_raw, nx, pcr_steps);
  T* sm = reinterpret_cast<T*>(smem_raw + pcr_shared_bytes<T>(nx, pcr_steps));
  RedSmem<T> cross_red{sm, 0};
  __shared__ T p[N_ROWS];

  const int m = blockIdx.x;
  const size_t plane = (size_t)K * nx;
  if (threadIdx.x < N_ROWS) p[threadIdx.x] = pars[(size_t)m * N_ROWS + threadIdx.x];
  __syncthreads();
  const T cg_tau = p[P_CG_TAU], dt_tau = p[P_DT_TAU], dc = p[P_DC], M = p[P_M],
          kLf = p[P_KLF], dtD = p[P_DTD], cg = p[P_CG], ai = p[P_AI], A = p[P_A],
          Fb = p[P_FB], cw = p[P_CW], Lf = p[P_LF], Foff = p[P_F], S0 = p[P_S0],
          S1 = p[P_S1], S2 = p[P_S2], a0 = p[P_A0], a2 = p[P_A2];

  // per cell: carry, the member's constants (models/classic.py::statics),
  // annual sums
  T E[CPT], Tg[CPT], x[CPT], SA[CPT], aw[CPT], klo[CPT], kdi0[CPT], kup[CPT];
  T acc[CPT][N_OUT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    const int j = i < nx ? i : 0;
    x[c] = cols[j];
    const T x2 = cols[nx + j];
    SA[c] = S0 - S2 * x2;
    aw[c] = a0 - a2 * x2;
    klo[c] = -dtD * cols[2 * nx + j] / cg;
    kdi0[c] = (T(1) + dt_tau) - dtD * cols[3 * nx + j] / cg;
    kup[c] = -dtD * cols[4 * nx + j] / cg;
    E[c] = cin[(size_t)m * nx + j];
    Tg[c] = cin[plane + (size_t)m * nx + j];
#pragma unroll
    for (int v = 0; v < N_OUT; ++v) acc[c][v] = T(0);
  }

  // the member's per-step noise row and its OU and crossing state
  NoiseState<T> ns;
  if (NOISY) ns = noise_begin(nz, sm + RED_SLOTS, m, K, nt);

  for (int t = 0; t < nt; ++t) {
    const T s1c = S1 * cosv[t];
    const T s1n = S1 * cosv[t + 1];  // the wraparound row S_{i+1}
    T f = fyear[t] + Foff;
    if (NOISY) f = noise_forcing(nz, ns, f, t);
    T lo[CPT], di[CPT], up[CPT], b[CPT], out[CPT][N_OUT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const T Ec = E[c];
      const T pos = Ec > T(0) ? T(1) : T(0);
      const T neg = Ec < T(0) ? T(1) : T(0);
      const T nonneg = Ec >= T(0) ? T(1) : T(0);
      const T alpha = aw[c] * pos + ai * neg;  // zero at E == 0
      const T S_i = SA[c] - s1c * x[c];
      const T C = alpha * S_i + cg_tau * Tg[c] - A + f;
      const T T0 = Ec == T(0) ? T(0) : C / (M - kLf / Ec);
      const T t0neg = T0 < T(0) ? T(1) : T(0);
      const T Tc = Ec / cw * nonneg + T0 * (neg * t0neg);  // pre-update E
      const T En = Ec + dt * (C - M * Tc + Fb);

      const T negn = En < T(0) ? T(1) : T(0);
      const T nonnegn = En >= T(0) ? T(1) : T(0);
      const T denom = M - kLf / (En == T(0) ? T(1) : En);
      const T mask = t0neg * negn;
      const T S_ip1 = SA[c] - s1n * x[c];
      lo[c] = klo[c];
      di[c] = kdi0[c] - dc / denom * mask;
      up[c] = kup[c];
      b[c] = Tg[c] + dt_tau * (En / cw * nonnegn + (ai * S_ip1 - A + f) / denom * mask);
      out[c][0] = En;
      out[c][1] = Tc;
      out[c][2] = -En / Lf * negn;
      E[c] = En;
    }
    pcr_solve<T, CPT>(lo, di, up, b, s, nx, pcr_steps);

#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      Tg[c] = b[c];
      const int i = threadIdx.x + c * blockDim.x;
      // step 0's outputs seed the sums, as in the plain version (a -0.0
      // output stays -0.0)
#pragma unroll
      for (int v = 0; v < N_OUT; ++v) acc[c][v] = t == 0 ? out[c][v] : acc[c][v] + out[c][v];
      if (i >= nx) continue;
      const size_t idx = (size_t)m * nx + i;
      if (t == w0 || t == s0) {
        T* snap = t == w0 ? wint : summ;
#pragma unroll
        for (int v = 0; v < N_OUT; ++v) snap[v * plane + idx] = out[c][v];
        if (t == w0 && t == s0) {
#pragma unroll
          for (int v = 0; v < N_OUT; ++v) summ[v * plane + idx] = out[c][v];
        }
      }
      if (raw != nullptr) {
        T* row = raw + (size_t)t * N_OUT * plane;
#pragma unroll
        for (int v = 0; v < N_OUT; ++v) row[v * plane + idx] = out[c][v];
      }
    }
    if (NOISY && nz.cross_out != nullptr) {
      // the instantaneous ice area: the cells with E < 0, this thread's in
      // cell order
      T part = T(0);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int i = threadIdx.x + c * blockDim.x;
        const T v = i < nx ? nz.wts[i] * (out[c][0] < T(0) ? T(1) : T(0)) : T(0);
        part = c == 0 ? v : part + v;
      }
      noise_crossing(ns, part, cross_red, t);
    }
  }
  if (NOISY) noise_end(nz, ns, m, nt);

  // same `sum / nt` arithmetic as the JAX kernel and storage path
  const T ntf = T(nt);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i >= nx) continue;
    const size_t idx = (size_t)m * nx + i;
    cout[idx] = E[c];
    cout[plane + idx] = Tg[c];
#pragma unroll
    for (int v = 0; v < N_OUT; ++v) avg[v * plane + idx] = acc[c][v] / ntf;
  }
}

template <typename T, int CPT, int MAX_THREADS, int MIN_BLOCKS, bool NOISY>
int launch_cells(cudaStream_t stream, const void* cin, const void* pars,
                 const void* cols, const void* cosv, const void* f, void* cout,
                 void* wint, void* summ, void* avg, void* raw, const NoiseArgs<T>& nz,
                 int K, int nx, int nt, int w0, int s0, int pcr_steps, double dt) {
  const int threads = round_up_32((nx + CPT - 1) / CPT);
  const size_t shmem = pcr_shared_bytes<T>(nx, pcr_steps) + RED_SLOTS * sizeof(T) +
                       (NOISY ? noise_shared_bytes<T>(nt, nz.ou_mode) : 0);
  if (shmem > MAX_SHARED_BYTES) return (int)cudaErrorInvalidValue;
  auto kernel = classic_year_kernel<T, CPT, MAX_THREADS, MIN_BLOCKS, NOISY>;
  const cudaError_t err = allow_shared(kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<K, threads, shmem, stream>>>(
      static_cast<const T*>(cin), static_cast<const T*>(pars),
      static_cast<const T*>(cols), static_cast<const T*>(cosv),
      static_cast<const T*>(f), static_cast<T*>(cout), static_cast<T*>(wint),
      static_cast<T*>(summ), static_cast<T*>(avg), static_cast<T*>(raw), nz, K, nx, nt,
      w0, s0, pcr_steps, T(dt));
  return (int)cudaGetLastError();
}

// Blocks of 192 threads (the canonical nx = 180) that share an SM, by the
// registers the build is held to: float32 64 (five blocks), float64 112
// (deterministic, three) and 168 (noisy, two).
template <typename T, bool NOISY>
constexpr int canonical_blocks() {
  return sizeof(T) == 4 ? 5 : (NOISY ? 2 : 3);
}

template <typename T, bool NOISY>
int launch_noise(cudaStream_t st, const void* cin, const void* pars, const void* cols,
                 const void* cosv, const void* f, void* cout, void* wint, void* summ,
                 void* avg, void* raw, const NoiseArgs<T>& nz, int K, int nx, int nt,
                 int w0, int s0, int pcr_steps, double dt) {
  const int cpt = rows_per_thread(nx);
  // builds by block size, as the MIZ year has them: up to 192 threads with
  // the register cap that fills an SM with the canonical grid's blocks, up to
  // 256 with what a block of 256 can have, and up to 1024 (1, 2 or 4 cells
  // per thread)
  if (cpt == 1 && round_up_32(nx) <= 192)
    return launch_cells<T, 1, 192, canonical_blocks<T, NOISY>(), NOISY>(
        st, cin, pars, cols, cosv, f, cout, wint, summ, avg, raw, nz, K, nx, nt, w0, s0,
        pcr_steps, dt);
  if (cpt == 1 && round_up_32(nx) <= 256)
    return launch_cells<T, 1, 256, 1, NOISY>(st, cin, pars, cols, cosv, f, cout, wint, summ,
                                             avg, raw, nz, K, nx, nt, w0, s0, pcr_steps, dt);
  if (cpt == 1)
    return launch_cells<T, 1, 1024, 1, NOISY>(st, cin, pars, cols, cosv, f, cout, wint, summ,
                                              avg, raw, nz, K, nx, nt, w0, s0, pcr_steps, dt);
  if (cpt == 2)
    return launch_cells<T, 2, 1024, 1, NOISY>(st, cin, pars, cols, cosv, f, cout, wint, summ,
                                              avg, raw, nz, K, nx, nt, w0, s0, pcr_steps, dt);
  return launch_cells<T, 4, 1024, 1, NOISY>(st, cin, pars, cols, cosv, f, cout, wint, summ,
                                            avg, raw, nz, K, nx, nt, w0, s0, pcr_steps, dt);
}

template <typename T>
int launch(const void* cin, const void* pars, const void* cols, const void* cosv,
           const void* f, void* cout, void* wint, void* summ, void* avg, void* raw,
           const void* noise, const void* keys, const void* ou, void* eta_out,
           const void* cross, void* cross_out, const void* wts, int K, int nx, int nt,
           int w0, int s0, int pcr_steps, int ou_mode, int ou_unroll, double dt, void* stream) {
  if (K < 1 || nx < 1 || nx > 4096 || nt < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const NoiseArgs<T> nz = noise_args<T>(noise, keys, ou, eta_out, cross, cross_out, wts,
                                        ou_mode, ou_unroll);
  if (noise != nullptr || keys != nullptr)
    return launch_noise<T, true>(st, cin, pars, cols, cosv, f, cout, wint, summ, avg, raw,
                                 nz, K, nx, nt, w0, s0, pcr_steps, dt);
  return launch_noise<T, false>(st, cin, pars, cols, cosv, f, cout, wint, summ, avg, raw,
                                nz, K, nx, nt, w0, s0, pcr_steps, dt);
}

}  // namespace

extern "C" {

int ebm_classic_year_f32(const void* cin, const void* pars, const void* cols,
                         const void* cosv, const void* f, void* cout, void* wint,
                         void* summ, void* avg, void* raw, const void* noise,
                         const void* keys, const void* ou, void* eta_out, const void* cross,
                         void* cross_out, const void* wts, int K, int nx, int nt,
                         int w0, int s0, int pcr_steps, int ou_mode, int ou_unroll, double dt, void* stream) {
  return launch<float>(cin, pars, cols, cosv, f, cout, wint, summ, avg, raw, noise, keys, ou,
                       eta_out, cross, cross_out, wts, K, nx,
                       nt, w0, s0, pcr_steps, ou_mode, ou_unroll, dt, stream);
}

int ebm_classic_year_f64(const void* cin, const void* pars, const void* cols,
                         const void* cosv, const void* f, void* cout, void* wint,
                         void* summ, void* avg, void* raw, const void* noise,
                         const void* keys, const void* ou, void* eta_out, const void* cross,
                         void* cross_out, const void* wts, int K, int nx, int nt,
                         int w0, int s0, int pcr_steps, int ou_mode, int ou_unroll, double dt, void* stream) {
  return launch<double>(cin, pars, cols, cosv, f, cout, wint, summ, avg, raw, noise, keys, ou,
                       eta_out, cross, cross_out, wts, K, nx,
                        nt, w0, s0, pcr_steps, ou_mode, ou_unroll, dt, stream);
}

}  // extern "C"
