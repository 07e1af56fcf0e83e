// One WE15 Classic model year for a (K, nx) ensemble, fused into one launch.
//
// Replaces the two TPU kernels of energybalancemodel_jl_tpu/ops/pallas_year.py
// that compute this function in two layouts the TPU's (8, 128) tiling forced:
//   - pallas_year.py::_classic_kernel_xk (grid on sublanes, members on lanes;
//     the ensemble path, launched by _classic_year_xk), and
//   - pallas_year.py::_classic_kernel    (members on sublanes, grid on lanes;
//     the single-run 'kx' branch of pallas_classic_year, up to nx = 4096).
// On Hopper two layouts of one step serve both, K = 1 and K = 8192 alike:
//   - nx <= 256: ONE MEMBER PER WARP (classic_warp_kernel), lane l holding
//     cells l + 32 s of S = 1, 2, 4, 6 or 8 slots, several members a block;
//   - nx > 256 (up to 4096), K < WARP_MIN_K of ops/classic_year.py (the
//     single run), the associative OU scan, and where the warp builds would
//     keep fewer members per SM resident (long noisy years, whose rows fill
//     shared memory): ONE THREAD BLOCK PER MEMBER (classic_year_kernel),
//     grid cells strided over at most 1024 threads (CPT = 1, 2 or 4 cells
//     per thread).
//
// Each thread keeps its cells' carry (E, Tg), their per-member constants
// (insolation factor S0 - S2 x^2, water coalbedo, implicit-matrix bands) and
// the three annual sums in registers for all nt steps (the deterministic
// and the float64 warp builds keep the constants in the warp's shared
// memory). Device memory sees
// one read of the carry and one write of carry + seasonal store per simulated
// year; a raw-collected year (raw != nullptr) also writes every step's three
// outputs, raw[t][var][member][cell].
//
// Per step (models/classic.py::step, line for line, same operation order):
//   - insolation rows S_i and the wraparound S_{i+1} rebuilt from
//     (S0 - S2 x^2) - (S1 cos 2pi t) x, forcing f[t] + F;
//   - the albedo switch (zero at E == 0), T0, the three-regime T from the
//     pre-update E, the explicit E update;
//   - the implicit Tg step: the member's bands, kdi masked by the updated E,
//     one row-scaled PCR solve (common.cuh: pcr_solve in shared memory for a
//     block, warp_pcr_solve in registers for a warp);
//   - the seasonal store (winter/summer snapshots at w0/s0, sums / nt).
// The kernel reads the per-member scalars (cg/tau, dt/tau, M, kLf, dt D, ...)
// from the stack ops/classic_year.py builds with the same torch code as
// models/classic.py::statics, so it takes the operands the plain version takes.
//
// What bounds it: not memory (the year's traffic is microseconds) but the
// instructions of a dependent chain per step: eight IEEE divisions per cell
// in the pointwise update and two per PCR level, each a branch to nvcc's
// slow-path check. The block layout spends a barrier and a shared-memory
// round trip per level on one cell per thread: 1696 instructions per warp
// and step in its SASS (static: the time loop and 7 passes of the level
// loop), six warps per member, five members per SM. The warp layout keeps a
// member's S cells in each lane and exchanges PCR rows by shuffles with no
// barrier: ~4300 instructions per warp and step at S = 6 (static, the
// divisions' slow-path calls included), under half the block layout's per
// member, but one warp's chain is long (a member alone runs a year 2.5x
// slower than on a block), so its time comes from the members an SM holds:
// 24 (float32), 16 (float32 noisy), 12 (float64) and 8 (float64 noisy), held
// by the builds' register caps (chip_smoke.py phase 2), where the block
// builds of 192 threads hold 5, 5, 3 and 2.
//
// The noisy years (template flag NOISY; replaces the TPU kernels
// pallas_year.py::_classic_kernel_xk_noisy :666 (K5), _classic_kernel_xk_ou
// :673 (K6), _classic_kernel_xk_gen_ou :703 (K7, K8) and the crossing=True
// branch of _classic_kernel_xk (K9), launched at :1908): the member's noise
// row in shared memory (a block's after the PCR rows, a warp's after its
// constants), step t's forcing (f[t] + F) + offset, and, with a crossing
// output, the area sum_i w_i [E_i < 0] of the updated E each step, in the
// fixed order of noise.cuh (one more barrier in a block, shuffles in a
// warp). The deterministic year is the NOISY = false instantiation,
// unchanged.
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

// ONE MEMBER PER WARP (nx <= 256): lane l holds cells l + 32 s, s < S, in
// registers, and the implicit Tg step is warp_pcr_solve (common.cuh): no
// barrier, no shared memory in the step, S independent chains per lane.
// WARPS members share a block and MIN_BLOCKS blocks an SM; a warp whose
// member is beyond K leaves at once (nothing in the kernel waits for the
// block). The member's parameter row and the step's cos and forcing values
// are the same for all lanes: each lane reads them (one broadcast load per
// warp), the step's one step ahead. With CONSTS_SHARED the per-cell
// constants (x, S0 - S2 x^2, water coalbedo, the three bands) live in the
// warp's shared memory and are read each step, otherwise in registers. A
// noisy warp's rows follow them (noise.cuh, the warp versions). Every value
// is computed by the operations of classic_year_kernel, in its order; the
// step's outputs are summed and stored before the solve, which does not
// read them.
constexpr int N_CONSTS = 6;  // x, SA, aw, klo, kdi0, kup per cell

template <typename T, int S, int WARPS, int MIN_BLOCKS, bool NOISY, bool CONSTS_SHARED>
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS)
    classic_warp_kernel(const T* __restrict__ cin, const T* __restrict__ pars,
                        const T* __restrict__ cols, const T* __restrict__ cosv,
                        const T* __restrict__ fyear, T* __restrict__ cout,
                        T* __restrict__ wint, T* __restrict__ summ,
                        T* __restrict__ avg, T* __restrict__ raw, NoiseArgs<T> nz, int K,
                        int nx, int nt, int w0, int s0, int pcr_steps, T dt,
                        int warp_words) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (m >= K) return;
  T* wsm = reinterpret_cast<T*>(smem_raw) + (size_t)(threadIdx.x >> 5) * warp_words;
  T* cst = wsm;  // [N_CONSTS][32 S] with CONSTS_SHARED
  const size_t plane = (size_t)K * nx;
  const T* p = pars + (size_t)m * N_ROWS;
  const T cg_tau = p[P_CG_TAU], dt_tau = p[P_DT_TAU], dc = p[P_DC], M = p[P_M],
          kLf = p[P_KLF], ai = p[P_AI], A = p[P_A], Fb = p[P_FB], cw = p[P_CW], Lf = p[P_LF],
          Foff = p[P_F], S1 = p[P_S1];

  T E[S], Tg[S], acc[S][N_OUT];
  T xr[S], SAr[S], awr[S], klor[S], kdi0r[S], kupr[S];
  {
    const T dtD = p[P_DTD], cg = p[P_CG], S0 = p[P_S0], S2 = p[P_S2], a0 = p[P_A0],
            a2 = p[P_A2];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = lane + 32 * s;
      const int j = i < nx ? i : 0;
      const T x2 = cols[nx + j];
      xr[s] = cols[j];
      SAr[s] = S0 - S2 * x2;
      awr[s] = a0 - a2 * x2;
      klor[s] = -dtD * cols[2 * nx + j] / cg;
      kdi0r[s] = (T(1) + dt_tau) - dtD * cols[3 * nx + j] / cg;
      kupr[s] = -dtD * cols[4 * nx + j] / cg;
      if (CONSTS_SHARED) {
        T* c = cst + i;
        c[0] = xr[s];
        c[32 * S] = SAr[s];
        c[2 * 32 * S] = awr[s];
        c[3 * 32 * S] = klor[s];
        c[4 * 32 * S] = kdi0r[s];
        c[5 * 32 * S] = kupr[s];
      }
      E[s] = cin[(size_t)m * nx + j];
      Tg[s] = cin[plane + (size_t)m * nx + j];
#pragma unroll
      for (int v = 0; v < N_OUT; ++v) acc[s][v] = T(0);
    }
  }

  // (a lane reads back only the constants of its own cells)
  NoiseState<T> ns;
  if (NOISY)
    ns = warp_noise_begin(nz, wsm + (CONSTS_SHARED ? N_CONSTS * 32 * S : 0), m, K, nt, lane);

  T cos_t = cosv[0], cos_n = cosv[1], f_t = fyear[0];
  for (int t = 0; t < nt; ++t) {
    // step t + 1's values, read while step t runs (cosv has nt + 1 entries)
    const T cos_nn = cosv[t + 2 <= nt ? t + 2 : nt];
    const T f_n = fyear[t + 1 < nt ? t + 1 : t];
    const T s1c = S1 * cos_t;
    const T s1n = S1 * cos_n;
    T f = f_t + Foff;
    if (NOISY) f = noise_forcing(nz, ns, f, t);
    T lo[S], di[S], up[S], b[S], part[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = lane + 32 * s;
      const T* c = cst + i;
      const T xc = CONSTS_SHARED ? c[0] : xr[s];
      const T SA = CONSTS_SHARED ? c[32 * S] : SAr[s];
      const T aw = CONSTS_SHARED ? c[2 * 32 * S] : awr[s];
      const T Ec = E[s];
      const T pos = Ec > T(0) ? T(1) : T(0);
      const T neg = Ec < T(0) ? T(1) : T(0);
      const T nonneg = Ec >= T(0) ? T(1) : T(0);
      const T alpha = aw * pos + ai * neg;  // zero at E == 0
      const T S_i = SA - s1c * xc;
      const T C = alpha * S_i + cg_tau * Tg[s] - A + f;
      const T T0 = Ec == T(0) ? T(0) : C / (M - kLf / Ec);
      const T t0neg = T0 < T(0) ? T(1) : T(0);
      const T Tc = Ec / cw * nonneg + T0 * (neg * t0neg);  // pre-update E
      const T En = Ec + dt * (C - M * Tc + Fb);

      const T negn = En < T(0) ? T(1) : T(0);
      const T nonnegn = En >= T(0) ? T(1) : T(0);
      const T denom = M - kLf / (En == T(0) ? T(1) : En);
      const T mask = t0neg * negn;
      const T S_ip1 = SA - s1n * xc;  // the wraparound row S_{i+1}
      lo[s] = CONSTS_SHARED ? c[3 * 32 * S] : klor[s];
      di[s] = (CONSTS_SHARED ? c[4 * 32 * S] : kdi0r[s]) - dc / denom * mask;
      up[s] = CONSTS_SHARED ? c[5 * 32 * S] : kupr[s];
      b[s] = Tg[s] + dt_tau * (En / cw * nonnegn + (ai * S_ip1 - A + f) / denom * mask);
      const T out[N_OUT] = {En, Tc, -En / Lf * negn};
      E[s] = En;
      // step 0's outputs seed the sums, as in the plain version (a -0.0
      // output stays -0.0)
#pragma unroll
      for (int v = 0; v < N_OUT; ++v) acc[s][v] = t == 0 ? out[v] : acc[s][v] + out[v];
      if (NOISY && nz.cross_out != nullptr)
        part[s] = i < nx ? nz.wts[i] * (En < T(0) ? T(1) : T(0)) : T(0);
      if (i >= nx) continue;
      const size_t idx = (size_t)m * nx + i;
      if (t == w0 || t == s0) {
        T* snap = t == w0 ? wint : summ;
#pragma unroll
        for (int v = 0; v < N_OUT; ++v) snap[v * plane + idx] = out[v];
        if (t == w0 && t == s0) {
#pragma unroll
          for (int v = 0; v < N_OUT; ++v) summ[v * plane + idx] = out[v];
        }
      }
      if (raw != nullptr) {
        T* row = raw + (size_t)t * N_OUT * plane;
#pragma unroll
        for (int v = 0; v < N_OUT; ++v) row[v * plane + idx] = out[v];
      }
    }
    if (NOISY && nz.cross_out != nullptr) warp_noise_crossing<T, S>(ns, part, nx, t);
    warp_pcr_solve<T, S>(lo, di, up, b, nx, pcr_steps, lane);
#pragma unroll
    for (int s = 0; s < S; ++s) Tg[s] = b[s];
    cos_t = cos_n;
    cos_n = cos_nn;
    f_t = f_n;
  }
  if (NOISY) warp_noise_end(nz, ns, m, nt, lane);

  // same `sum / nt` arithmetic as the JAX kernel and storage path
  const T ntf = T(nt);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = lane + 32 * s;
    if (i >= nx) continue;
    const size_t idx = (size_t)m * nx + i;
    cout[idx] = E[s];
    cout[plane + idx] = Tg[s];
#pragma unroll
    for (int v = 0; v < N_OUT; ++v) avg[v * plane + idx] = acc[s][v] / ntf;
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

// the block build launch_noise_blocks picks for nx, and its blocks per SM
template <typename T, bool NOISY>
int block_members_per_sm(int nx, size_t shmem) {
  const int threads = round_up_32(nx);
  if (threads <= 192)
    return resident_blocks(classic_year_kernel<T, 1, 192, canonical_blocks<T, NOISY>(), NOISY>,
                           threads, shmem);
  return resident_blocks(classic_year_kernel<T, 1, 256, 1, NOISY>, threads, shmem);
}

template <typename T, bool NOISY>
int launch_noise_blocks(cudaStream_t st, const void* cin, const void* pars, const void* cols,
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

// The warp builds: WARP_MEMBERS members per block, and the blocks per SM
// each is held to by its register cap (__launch_bounds__). Which of the
// per-cell constants live in shared memory, and how many blocks share an SM,
// was chosen by timing the canonical year at K = 8192 on an H100 (PERF.md
// §6): float32 deterministic, constants in shared memory, 6 blocks (24
// members per SM, 80 registers); float32 noisy, constants in registers, 4
// blocks (16, 128 registers: its noise rows would leave shared memory for
// no more); float64, constants in shared memory, 3 blocks deterministic (12,
// 168 registers) and 2 noisy (8, whose rows fill shared memory at 2 blocks
// anyway, so it keeps 255 registers and spills nothing).
constexpr int WARP_MEMBERS = 4;

template <typename T, bool NOISY>
constexpr bool warp_consts_shared() {
  return sizeof(T) == 8 || !NOISY;
}

template <typename T, bool NOISY>
constexpr int warp_blocks() {
  return sizeof(T) == 4 ? (NOISY ? 4 : 6) : (NOISY ? 2 : 3);
}

// launch the warp build of S slots, or return -1 without launching when it
// would keep fewer members per SM resident than the block build (the noise
// rows of long years fill shared memory faster with four members a block)
template <typename T, int S, bool NOISY>
int launch_warp(cudaStream_t stream, const void* cin, const void* pars, const void* cols,
                const void* cosv, const void* f, void* cout, void* wint, void* summ,
                void* avg, void* raw, const NoiseArgs<T>& nz, int K, int nx, int nt, int w0,
                int s0, int pcr_steps, double dt) {
  constexpr bool CSH = warp_consts_shared<T, NOISY>();
  auto kernel = classic_warp_kernel<T, S, WARP_MEMBERS, warp_blocks<T, NOISY>(), NOISY, CSH>;
  const size_t words = (CSH ? (size_t)N_CONSTS * 32 * S : 0) + (NOISY ? (size_t)nt : 0);
  const size_t shmem = WARP_MEMBERS * words * sizeof(T);
  const int threads = 32 * WARP_MEMBERS;
  const size_t block_shmem = pcr_shared_bytes<T>(nx, pcr_steps) + RED_SLOTS * sizeof(T) +
                             (NOISY ? noise_shared_bytes<T>(nt, nz.ou_mode) : 0);
  if (WARP_MEMBERS * resident_blocks(kernel, threads, shmem) <
      block_members_per_sm<T, NOISY>(nx, block_shmem))
    return -1;
  const int blocks = (K + WARP_MEMBERS - 1) / WARP_MEMBERS;
  kernel<<<blocks, threads, shmem, stream>>>(
      static_cast<const T*>(cin), static_cast<const T*>(pars),
      static_cast<const T*>(cols), static_cast<const T*>(cosv),
      static_cast<const T*>(f), static_cast<T*>(cout), static_cast<T*>(wint),
      static_cast<T*>(summ), static_cast<T*>(avg), static_cast<T*>(raw), nz, K, nx, nt,
      w0, s0, pcr_steps, T(dt), (int)words);
  return (int)cudaGetLastError();
}

template <typename T, bool NOISY>
int launch_noise(cudaStream_t st, const void* cin, const void* pars, const void* cols,
                 const void* cosv, const void* f, void* cout, void* wint, void* summ,
                 void* avg, void* raw, const NoiseArgs<T>& nz, int K, int nx, int nt,
                 int w0, int s0, int pcr_steps, double dt, int warp_min_k) {
  // the associative OU scan (ou_mode 2) runs on the block build: its
  // nt-long work rows in shared memory left a warp build 12 members per SM,
  // six rounds of them at K = 8192, slower than the block build (PERF.md
  // §6)
  int err = -1;
  if (nx <= 256 && K >= warp_min_k && nz.ou_mode != 2) {
#define CLASSIC_WARP(S)                                                                   \
  err = launch_warp<T, S, NOISY>(st, cin, pars, cols, cosv, f, cout, wint, summ, avg, raw, \
                                 nz, K, nx, nt, w0, s0, pcr_steps, dt)
    switch (warp_slots(nx)) {
      case 1: CLASSIC_WARP(1); break;
      case 2: CLASSIC_WARP(2); break;
      case 4: CLASSIC_WARP(4); break;
      case 6: CLASSIC_WARP(6); break;
      default: CLASSIC_WARP(8); break;
    }
#undef CLASSIC_WARP
  }
  if (err >= 0) return err;
  return launch_noise_blocks<T, NOISY>(st, cin, pars, cols, cosv, f, cout, wint, summ, avg,
                                       raw, nz, K, nx, nt, w0, s0, pcr_steps, dt);
}

template <typename T>
int launch(const void* cin, const void* pars, const void* cols, const void* cosv,
           const void* f, void* cout, void* wint, void* summ, void* avg, void* raw,
           const void* noise, const void* keys, const void* ou, void* eta_out,
           const void* cross, void* cross_out, const void* wts, int K, int nx, int nt,
           int w0, int s0, int pcr_steps, int ou_mode, int ou_unroll, int warp_min_k, double dt,
           void* stream) {
  if (K < 1 || nx < 1 || nx > 4096 || nt < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const NoiseArgs<T> nz = noise_args<T>(noise, keys, ou, eta_out, cross, cross_out, wts,
                                        ou_mode, ou_unroll);
  if (noise != nullptr || keys != nullptr)
    return launch_noise<T, true>(st, cin, pars, cols, cosv, f, cout, wint, summ, avg, raw,
                                 nz, K, nx, nt, w0, s0, pcr_steps, dt, warp_min_k);
  return launch_noise<T, false>(st, cin, pars, cols, cosv, f, cout, wint, summ, avg, raw,
                                nz, K, nx, nt, w0, s0, pcr_steps, dt, warp_min_k);
}

}  // namespace

extern "C" {

int ebm_classic_year_f32(const void* cin, const void* pars, const void* cols,
                         const void* cosv, const void* f, void* cout, void* wint,
                         void* summ, void* avg, void* raw, const void* noise,
                         const void* keys, const void* ou, void* eta_out, const void* cross,
                         void* cross_out, const void* wts, int K, int nx, int nt,
                         int w0, int s0, int pcr_steps, int ou_mode, int ou_unroll,
                         int warp_min_k, double dt, void* stream) {
  return launch<float>(cin, pars, cols, cosv, f, cout, wint, summ, avg, raw, noise, keys, ou,
                       eta_out, cross, cross_out, wts, K, nx, nt, w0, s0, pcr_steps, ou_mode,
                       ou_unroll, warp_min_k, dt, stream);
}

int ebm_classic_year_f64(const void* cin, const void* pars, const void* cols,
                         const void* cosv, const void* f, void* cout, void* wint,
                         void* summ, void* avg, void* raw, const void* noise,
                         const void* keys, const void* ou, void* eta_out, const void* cross,
                         void* cross_out, const void* wts, int K, int nx, int nt,
                         int w0, int s0, int pcr_steps, int ou_mode, int ou_unroll,
                         int warp_min_k, double dt, void* stream) {
  return launch<double>(cin, pars, cols, cosv, f, cout, wint, summ, avg, raw, noise, keys, ou,
                        eta_out, cross, cross_out, wts, K, nx, nt, w0, s0, pcr_steps, ou_mode,
                        ou_unroll, warp_min_k, dt, stream);
}

}  // extern "C"
