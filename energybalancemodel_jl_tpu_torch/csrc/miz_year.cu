// One MIZ model year for a (K, nx) ensemble, fused into one launch.
//
// Replaces the two TPU kernels of energybalancemodel_jl_tpu/ops/pallas_year.py
// that compute this function in two layouts the TPU's (8, 128) tiling forced:
//   - pallas_year.py::_kernel_xk  (grid on sublanes, members on lanes; the
//     ensemble path, launched by _miz_year_xk), and
//   - pallas_year.py::_kernel     (members on sublanes, grid on lanes; the
//     single-run 'kx' branch of pallas_miz_year).
// On Hopper one layout serves both: ONE THREAD BLOCK PER MEMBER, one thread
// per grid cell (blockDim = round_up(nx, 32)) up to nx = 1024; above it (up
// to 16384, the JAX package's fused single-run reach) the CLUSTER build
// (miz_cluster_kernel, below) runs a member on a thread-block cluster, each
// block owning a slice of the cells, the PCR rows and the neighbour exchange
// in the owners' shared memory (cluster.cuh).
//
// Each thread keeps its cell's carry (Ei, Ew, h, D, phi, T0) and its ten
// annual sums in registers for all nt steps; it writes the winter/summer
// snapshots straight to global memory at ticks w0/s0 and the carry and
// sum/nt at the end. Device memory sees one read of the carry and one write
// of carry + seasonal store per simulated year (the property the TPU kernel
// exists for, pallas_year.py:3-14). A raw-collected year (raw != nullptr)
// also writes every step's ten outputs, raw[t][var][member][cell].
//
// Per step (models/miz.py::step, line for line, same operation order, the
// fused multiply-adds at its sites as fma_rn):
//   - insolation (S0 - (S1 x) cos 2pi t) - S2 x^2 and coalbedo a0 - a2 x^2
//     from the member's parameter row, forcing f[t] + F;
//   - warm-started Newton for T0 with tolerance max(abstol, reltol |r0|),
//     iterated while the MEMBER's max |r| exceeds it (a block reduction of
//     the magnitudes' bit patterns, common.cuh). The residual and its
//     Jacobian are newton.cuh's, shared with newton_t0.cu. The JAX kernels iterate until the
//     slowest lane of a 128-member block converges; per-member grouping is
//     within the same sub-tolerance contract (pallas_year.py:19-23) and
//     makes members independent: member k of an ensemble is bitwise equal to
//     the same member run alone;
//   - each Newton update solves the tridiagonal Jacobian by row-scaled
//     parallel cyclic reduction in shared memory: ceil(log2 nx) doubling
//     levels, out-of-range rows are identity rows (ops/tridiag.py);
//   - neighbour values of the diffusion stencil come through shared memory,
//     boundary-rolled like torch.roll (the wrapped value meets a zero band).
//
// What bounds it: nothing touches device memory inside the year. A step is
// 3 + (ceil(log2 nx) + 2) u block barriers for u Newton updates, 3 + 10 u on
// the canonical grid (every exchange between threads is write, one barrier,
// read on two buffers in turn, common.cuh; 6 + 20 u before the buffers
// alternated), and between barriers the blocks resident on an SM share its
// issue slots. Counted in the built code, a canonical float32 step issues
// about 760 instructions per warp plus about 780 per Newton update, most of
// them in the 17 IEEE divisions of an update and the 13 of the step's tail;
// at K = 8192 that is three quarters of the measured year, the flop count a
// twelfth (PERF.md). So the design spends registers, not flops: the member's
// parameters and the values derived from them alone stay in shared memory
// (one row, computed once per year), the first PCR level divides nothing
// (every diagonal is 1 there), the block max is two integer reductions, and
// the builds for the canonical grid (blocks of up to 192 threads) are held
// to the registers at which 6 (float32), 5 (float32 noisy) and 2 (float64)
// blocks share an SM. A wide ensemble fills the card; a single run uses one
// SM and is bound by the latency of its own chain (5.9 us per step).
//
// The COUNT = true instantiation (iters != nullptr) also counts the member's
// Newton updates over the year, thread 0 in shared memory, into iters[m]: the
// work behind the Newton part of the year's operation count. It is a build of
// its own so that the instantiations that run the model keep their registers.
//
// Minimums and maximums propagate NaN like jnp.minimum/jnp.maximum (and
// torch.minimum), and the Newton step clip keeps NaN, so the non-finite
// freeze of ops/newton.py sees the same values as the plain version.
//
// The noisy years (template flag NOISY; replaces the TPU kernels
// pallas_year.py::_kernel_xk_noisy :645 (K5), _kernel_xk_ou :654 (K6),
// _kernel_xk_gen_ou :682 with _gen_noise_xk :289 (K7), _assoc_ou_path :316
// (K8) and the crossing=True branch of _kernel_xk (K9)): before the time loop
// the block fills one nt-long row of shared memory with its member's
// per-step values, from the (nt, K) table or drawn from its (K, 2) key
// (prng.cuh). Step t's forcing is (f[t] + F) + offset, in that order
// (pallas_year.py:586-591); the offset is the row itself, or the OU value
// eta = fma(rho, eta, scale * xi[t]) kept in a register (serial), or the row
// after an in-place log-depth OU scan (assoc). With a crossing output, each
// step also sums w_i phi_i over the member's cells (NaN counts as 0) in the
// fixed order of noise.cuh, warps in parallel and one more barrier, and
// records the first step where sign * (area - thr) > 0. The noise work is one
// row fill and a few operations per step; what the NOISY build costs is its
// registers (5 resident blocks per SM instead of 6, PERF.md). The
// deterministic year is the NOISY = false instantiation.
#include <type_traits>

#include "cluster.cuh"
#include "newton.cuh"
#include "noise.cuh"

namespace {

constexpr int N_CARRY = 6;
constexpr int N_OUT = 10;
// member parameter row, ops/miz_year.py ROW_NAMES
enum Row {
  P_K, P_TM, P_A, P_B, P_AI, P_FB, P_CW, P_M1, P_LF, P_ALPHA, P_RL, P_DMIN,
  P_DMAX, P_HMIN, P_KAPPA, P_D, P_TM_POW_M2, P_F, P_S0, P_S1, P_S2, P_A0,
  P_A2, N_ROWS
};
// values of the step that depend on the member's parameters alone, computed
// once per year with the step's own operations (models/miz.py::step) and kept
// beside the parameter row
enum Derived {
  Q_NEG_INV_LF = N_ROWS,  // -1 / Lf
  Q_WELD,                 // kappa alpha / 4
  Q_DN_DEN,               // Lf alpha Dmin^2 hmin
  Q_LAT_MELT,             // (-pi / 2) alpha
  Q_TWO_LF,               // 2 Lf
  Q_TWO_RL,               // 2 rl
  N_SHARED
};

// The block's dynamic shared memory, in this order: the PCR buffers, the
// neighbour exchange, the slots of the two block reductions (Newton's max,
// the crossing sum), the noise rows.
template <typename T>
__host__ __device__ inline size_t base_shared_bytes(int nx, int pcr_steps) {
  return pcr_shared_bytes<T>(nx, pcr_steps) + halo_shared_bytes<T>(nx) +
         sizeof(T) * (size_t)(2 * RED_SLOTS);
}

// the derived values of the member's row (enum Derived), by one thread
template <typename T>
__device__ __forceinline__ void miz_derive(T* p) {
  const T Lf = p[P_LF], alpha = p[P_ALPHA], Dmin = p[P_DMIN];
  p[Q_NEG_INV_LF] = T(-1) / Lf;
  p[Q_WELD] = p[P_KAPPA] * alpha / T(4);
  p[Q_DN_DEN] = Lf * alpha * (Dmin * Dmin) * p[P_HMIN];
  p[Q_LAT_MELT] = T(-3.14159265358979323846 / 2.0) * alpha;  // -pi/2 (D_t quirk)
  p[Q_TWO_LF] = T(2) * Lf;
  p[Q_TWO_RL] = T(2) * p[P_RL];
}

// the insolation of a cell at x (x2 = x^2) for cos(2 pi t) = c
// (models/miz.py::insolation): S0 - (S1 x) c, then - S2 x^2, both contracted
template <typename T>
__device__ __forceinline__ T miz_insol(const T* p, T x, T x2, T c) {
  return fma_rn(-p[P_S2], x2, fma_rn(-(p[P_S1] * x), c, p[P_S0]));
}

// The step after the Newton solve (models/miz.py::step, its subnormal
// flushes included), for one cell, shared by the block and the cluster builds:
// miz_head before the Tb exchange, miz_tail after it.
template <typename T>
struct MizStep {
  T Tm, A, B, D, f, dt, Lf, alpha, Dmin, hmin;
};

template <typename T>
struct MizHead {
  T Ti, n, Tb, L;
};

template <typename T>
struct MizState {
  T Ei, Ew, h, Df, phi;
};

template <typename T>
__device__ __forceinline__ MizHead<T> miz_head(const MizStep<T>& sp, T T0, T h, T Df, T phi,
                                               T water) {
  MizHead<T> o;
  o.Ti = nan_min(T0, sp.Tm);
  if (h == T(0)) o.Ti = T(0);
  const bool zeroD = Df == T(0);
  o.n = flush_subnormal(zeroD ? T(0) : phi / (sp.alpha * (Df * Df)));

  o.Tb = fma_rn(o.Ti, phi, water);
  o.L = fma_rn(sp.B, o.Tb - sp.Tm, sp.A);
  return o;
}

// s: the cell's fields, updated in place; out: the step's outputs
template <typename T>
__device__ __forceinline__ void miz_tail(const T* p, const MizStep<T>& sp, const MizHead<T>& hd,
                                         MizState<T>& s, T Tw, T insol, T x2, T glo, T gdi,
                                         T gup, T Tbm1, T Tbp1, T (&out)[N_OUT]) {
  const T pi = T(3.14159265358979323846);
  const T Lf = sp.Lf, alpha = sp.alpha, Dmin = sp.Dmin, hmin = sp.hmin, dt = sp.dt;
  const T Ti = hd.Ti, n = hd.n, Ei = s.Ei, Ew = s.Ew, h = s.h, Df = s.Df, phi = s.phi;
  const bool zeroD = Df == T(0);
  const T lap = fma_rn(gup, Tbp1, fma_rn(glo, Tbm1, gdi * hd.Tb));
  const T aw = fma_rn(-p[P_A2], x2, p[P_A0]);  // water coalbedo
  const T base_i = fma_rn(p[P_AI], insol, -hd.L);
  const T base_w = fma_rn(aw, insol, -hd.L);
  // D lap: rounded where the JAX step reads both fluxes, contracted where
  // it reads one (models/miz.py::step)
  const T dTb = sp.D * lap;
  const T Fvi = base_i + dTb + p[P_FB] + sp.f;
  const T Fvw = base_w + dTb + p[P_FB] + sp.f;
  const T Fvi_1 = fma_rn(sp.D, lap, base_i) + p[P_FB] + sp.f;
  const T Fvw_1 = fma_rn(sp.D, lap, base_w) + p[P_FB] + sp.f;
  const T wl = p[P_M1] * (Tw - p[P_TM_POW_M2]);
  const T Flat = zeroD ? T(0) : phi * h * Lf * wl * pi / (alpha * Df);

  const T rEi = fma_rn(fma_rn(phi, Fvi, Flat), dt, Ei);
  const T rEw = fma_rn(fma_rn(T(1) - phi, Fvw, -Flat), dt, Ew);
  const T rEw_1 = fma_rn(fma_rn(T(1) - phi, Fvw_1, -Flat), dt, Ew);
  const T cEi = nan_min(rEi, T(0));
  const T cEw = nan_max(rEw, T(0));
  const T psiEidt = rEi - cEi;
  const T psiEwdt = rEw - cEw;
  T Ei1 = flush_subnormal(cEi + psiEwdt);
  const T Ew1 = flush_subnormal(cEw + psiEidt);

  const T Drl = Df + p[Q_TWO_RL];
  const T ring = alpha * n * fma_rn(Drl, Drl, -(Df * Df));
  const T Al = nan_min(ring, T(1) - phi);
  const T psiEw = (rEw_1 - nan_max(rEw_1, T(0))) * (T(1) / dt);
  const T Ql = phi == T(1) ? T(0) : Al / (T(1) - phi) * psiEw;
  const T Qp = psiEw - Ql;
  const T q = -Qp / p[Q_DN_DEN];  // dn = q dt

  const T lg_den = flush_subnormal(p[Q_TWO_LF] * h * phi);
  T lat_grow = lg_den == T(0) ? T(0) : -Df / lg_den * Ql;
  if (h == T(0)) lat_grow = T(0);
  const T weld_c = p[Q_WELD] * phi;
  const T rD = fma_rn(fma_rn(weld_c, Df * Df * Df, fma_rn(p[Q_LAT_MELT], wl, lat_grow)), dt, Df);
  const T total = flush_subnormal(fma_rn(q, dt, n));
  const bool zero_total = total == T(0);
  T D1 = zero_total ? T(0) : fma_rn(q, Dmin * dt, n * rD) / total;
  D1 = nan_min(nan_max(D1, Dmin), p[P_DMAX]);
  if (Ei1 == T(0)) D1 = T(0);

  const T rh = nan_max(fma_rn(p[Q_NEG_INV_LF] * Fvi_1, dt, h), T(0));
  const T h1 = flush_subnormal(zero_total ? T(0) : fma_rn(q, hmin * dt, n * rh) / total);

  T phi1 = flush_subnormal(h1 == T(0) ? T(0) : -Ei1 / (Lf * h1));
  if (phi1 > T(1)) phi1 = T(1);

  if (h1 == T(0)) Ei1 = T(0);
  const T E = fma_rn(phi1, Ei1, (T(1) - phi1) * Ew1);
  const T Tbar = fma_rn(Ti, phi1, (T(1) - phi1) * Tw);
  const T Ti_out = Ei1 == T(0) ? quiet_nan<T>() : Ti;
  const T Tw_out = phi1 > T(0.99) ? quiet_nan<T>() : Tw;

  s = MizState<T>{Ei1, Ew1, h1, D1, phi1};
  const T o[N_OUT] = {E, Tbar, h1, Ei1, Ew1, Ti_out, Tw_out, D1, phi1, n};
#pragma unroll
  for (int j = 0; j < N_OUT; ++j) out[j] = o[j];
}

// Registers a thread may use so that MIN_BLOCKS blocks of MAX_THREADS share
// an SM; the compiler is held to it.
template <typename T, int MAX_THREADS, int MIN_BLOCKS, bool NOISY, bool COUNT>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    miz_year_kernel(const T* __restrict__ cin, const T* __restrict__ pars,
                    const T* __restrict__ cols, const T* __restrict__ cosv,
                    const T* __restrict__ fyear, T* __restrict__ cout,
                    T* __restrict__ wint, T* __restrict__ summ, T* __restrict__ avg,
                    T* __restrict__ conv, int* __restrict__ iters, T* __restrict__ raw,
                    NoiseArgs<T> nz, int K, int nx, int nt, int w0, int s0, int pcr_steps,
                    int max_iter, T dt, T abstol, T reltol, T max_step) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T p[N_SHARED];
  __shared__ int n_updates;  // COUNT: the member's Newton updates, by thread 0
  PcrSmem<T> pcr = pcr_begin<T>(smem_raw, nx, pcr_steps);
  unsigned char* at = smem_raw + pcr_shared_bytes<T>(nx, pcr_steps);
  Halo<T> halo = halo_begin<T, true>(at, nx);
  T* sm = reinterpret_cast<T*>(at + halo_shared_bytes<T>(nx));
  RedSmem<T> red{sm, 0};
  RedSmem<T> cross_red{sm + RED_SLOTS, 0};

  const int m = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < nx;
  const size_t plane = (size_t)K * nx;
  const size_t idx = (size_t)m * nx + (active ? i : 0);

  if (i < N_ROWS) p[i] = pars[(size_t)m * N_ROWS + i];
  if (COUNT && i == 0) n_updates = 0;
  __syncthreads();
  if (i == 0) miz_derive(p);
  __syncthreads();

  T0Cell<T> cell[1] = {};
  T x = 0, x2 = 0;
  T Ei = 0, Ew = 0, h = 0, Df = 0, phi = 0, T0[1] = {0};
  if (active) {
    x = cols[i];
    x2 = cols[nx + i];
    cell[0].glo = cols[2 * nx + i];
    cell[0].gdi = cols[3 * nx + i];
    cell[0].gup = cols[4 * nx + i];
    Ei = cin[0 * plane + idx];
    Ew = cin[1 * plane + idx];
    h = cin[2 * plane + idx];
    Df = cin[3 * plane + idx];
    phi = cin[4 * plane + idx];
    T0[0] = cin[5 * plane + idx];
  }

  T acc[N_OUT];
#pragma unroll
  for (int j = 0; j < N_OUT; ++j) acc[j] = T(0);
  T conv_m = T(1);
  // the member's per-step noise row (after the reduction slots) and its OU
  // and crossing state
  NoiseState<T> ns;
  if (NOISY) ns = noise_begin(nz, sm + 2 * RED_SLOTS, m, K, nt);

  for (int t = 0; t < nt; ++t) {
    // the member's parameters are read from shared memory where they are
    // used: held in registers across the year they cost a block per SM
    const T Tm = p[P_TM], A = p[P_A], B = p[P_B], D = p[P_D], cw = p[P_CW];
    // -- step inputs ------------------------------------------------------
    const T insol = miz_insol(p, x, x2, cosv[t]);
    T f = fyear[t] + p[P_F];
    if (NOISY) f = noise_forcing(nz, ns, f, t);

    // -- temperatures ------------------------------------------------------
    const T den = (T(1) - phi) * cw;
    T Tw = Tm + (den == T(0) ? T(0) : Ew / den);
    if (is_nan(Tw)) Tw = T(0);
    cell[0].phi = phi;
    cell[0].water = (T(1) - phi) * Tw;
    cell[0].solar = p[P_AI] * insol;
    cell[0].insol = insol;
    cell[0].kh = h == T(0) ? p[P_HMIN] : h;
    const T0Par<T> tp{p[P_K], Tm, A, B, D, f, p[P_AI]};

    // -- Newton for T0 (per member) ---------------------------------------
    T r[1] = {T(0)}, jlo[1] = {T(0)}, jdi[1] = {T(1)}, jup[1] = {T(0)};
    t0_residual_bands<T, 1, true, false, true>(T0, cell, tp, halo, nx, r, jlo, jdi, jup);
    T rnorm = block_max_magnitude(active ? abs_val(r[0]) : T(0), red);
    const T tol = nan_max(abstol, reltol * rnorm);
    for (int it = 0; it < max_iter && rnorm > tol; ++it) {
      T delta[1] = {-r[0]};
      pcr_solve<T, 1, true>(jlo, jdi, jup, delta, pcr, nx, pcr_steps);
      if (active) T0[0] = T0[0] + clip_step(delta[0], max_step);
      t0_residual_bands<T, 1, true, false, false>(T0, cell, tp, halo, nx, r, jlo, jdi, jup);
      rnorm = block_max_magnitude(active ? abs_val(r[0]) : T(0), red);
      if (COUNT && i == 0) ++n_updates;
    }
    conv_m = nan_min(conv_m, rnorm <= tol ? T(1) : T(0));

    // -- the rest of the step (models/miz.py::step, its subnormal flushes
    // included) ------------------------------------------------------------
    const T Lf = p[P_LF], alpha = p[P_ALPHA], Dmin = p[P_DMIN], hmin = p[P_HMIN];
    const MizStep<T> sp{Tm, A, B, D, f, dt, Lf, alpha, Dmin, hmin};
    const MizHead<T> hd = miz_head(sp, T0[0], h, Df, phi, cell[0].water);
    T Tbm1 = T(0), Tbp1 = T(0);
    exchange_rolled(hd.Tb, halo, i, nx, Tbm1, Tbp1);
    MizState<T> st{Ei, Ew, h, Df, phi};
    T out[N_OUT];
    miz_tail(p, sp, hd, st, Tw, insol, x2, cell[0].glo, cell[0].gdi, cell[0].gup, Tbm1, Tbp1,
             out);
    Ei = st.Ei;
    Ew = st.Ew;
    h = st.h;
    Df = st.Df;
    phi = st.phi;
    const T phi1 = st.phi;

    // -- seasonal store ----------------------------------------------------
#pragma unroll
    for (int j = 0; j < N_OUT; ++j) acc[j] = acc[j] + out[j];
    if (active && (t == w0 || t == s0)) {
      T* snap = t == w0 ? wint : summ;
#pragma unroll
      for (int j = 0; j < N_OUT; ++j) snap[j * plane + idx] = out[j];
      if (t == w0 && t == s0) {
#pragma unroll
        for (int j = 0; j < N_OUT; ++j) summ[j * plane + idx] = out[j];
      }
    }
    if (raw != nullptr && active) {
      T* row = raw + (size_t)t * N_OUT * plane;
#pragma unroll
      for (int j = 0; j < N_OUT; ++j) row[j * plane + idx] = out[j];
    }
    if (NOISY && nz.cross_out != nullptr) {
      // the instantaneous ice area, phi with NaN counted as 0
      const T part = active ? nz.wts[i] * (is_nan(phi1) ? T(0) : phi1) : T(0);
      noise_crossing(ns, part, cross_red, t);
    }
  }
  if (NOISY) noise_end(nz, ns, m, nt);

  if (active) {
    const T carry[N_CARRY] = {Ei, Ew, h, Df, phi, T0[0]};
#pragma unroll
    for (int j = 0; j < N_CARRY; ++j) cout[j * plane + idx] = carry[j];
    // same `sum / nt` arithmetic as the JAX kernel and storage path
    const T ntf = T(nt);
#pragma unroll
    for (int j = 0; j < N_OUT; ++j) avg[j * plane + idx] = acc[j] / ntf;
  }
  if (i == 0) conv[m] = conv_m;
  if (COUNT && i == 0) iters[m] = n_updates;
}

// THE CLUSTER BUILD (1024 < nx <= MAX_WIDE_NX, cluster.cuh): one cluster of
// C blocks of miz_cluster_threads<T>() per member, rank r owning cells
// [r slice, (r + 1) slice); the clusters loop over members m, m + clusters,
// ... Each cell's record (enum ClusterField) lives in its rank's shared
// memory, or, where the records and the rows would not fit there together
// (the C side's plan), in the rank's part of a workspace of device memory;
// the PCR rows, the neighbour exchange, the reduction slots and the crossing
// values always live in the shared memory of the rank that owns the cell,
// read by the other ranks through distributed shared memory. A step is the
// block build's, loop by loop over the thread's cells: the step inputs with
// the first residual's exchange (one cluster barrier), the Jacobian rows into
// the PCR and the cluster max of |r| (one more), each Newton update (the
// solve, ceil(log2 nx) - 1 barriers; the clipped update with the next
// exchange; the rows and the max), Tb's exchange, then miz_tail with the sums
// and the stores; the crossing area is summed by rank 0 in the block
// layout's order. The values are computed by the block build's functions
// (newton.cuh, miz_head, miz_tail), so they are its bits whatever C.
//
// What bounds it: a single run is one member, so its year is the latency of
// its chain, ~24 Newton updates a step in float32 at high resolution, each
// ceil(log2 nx) + 1 cluster barriers with distributed-shared-memory loads
// between them. Nothing of the chain goes through device memory (a block
// per member with the rows in device memory waited out an L2 round trip per
// PCR level), and the cluster's C SMs share each level's rows.
constexpr int MAX_WIDE_NX = 16384;
// a cell's record: the solve's fields (newton.cuh, the carry's T0 and phi
// among them), the rest of the carry, the step's Tw, the sums
enum ClusterField {
  W_EI = N_NEWTON_FIELDS, W_EW, W_H, W_D, W_TW, W_ACC,
  N_CLUSTER_FIELDS = W_ACC + N_OUT
};

// the most threads per block: one cell's step needs ~150 registers in
// float32 and ~190 in float64, which 384 and 256 threads leave
template <typename T>
constexpr int miz_cluster_threads() {
  return sizeof(T) == 8 ? 256 : 384;
}

// words of T of one block's records in the workspace (records in device
// memory only), rounded up to 32 words so every block's part starts aligned
__host__ __device__ inline size_t miz_cluster_words(int nx, int C) {
  return wide_stride((size_t)cluster_slice_cells(nx, C) * N_CLUSTER_FIELDS);
}

// the block's dynamic shared memory, byte offsets: the PCR rows' two
// buffers at 0, the exchange's two buffers, the records (if shared, a row of
// slice values per field, Rec), the
// slots of the cluster max and of the crossing sum, the crossing values, the
// noise rows
struct MizClusterLayout {
  size_t halo, records, keys, cross, vals, noise, total;
};

template <typename T>
__host__ __device__ inline MizClusterLayout miz_cluster_layout(int nx, int C, int threads,
                                                               bool records_shared,
                                                               size_t noise_bytes) {
  const size_t slice = cluster_slice_cells(nx, C);
  MizClusterLayout L;
  L.halo = 2 * slice * sizeof(PcrRow<T>);
  L.records = L.halo + align16(2 * slice * sizeof(Pair<T>));
  L.keys = L.records + (records_shared ? align16(slice * N_CLUSTER_FIELDS * sizeof(T)) : 0);
  L.cross = L.keys + cluster_red_bytes<T>(C, threads);
  L.vals = L.cross + align16(RED_SLOTS * sizeof(T));
  L.noise = L.vals + align16(slice * sizeof(T));
  L.total = L.noise + align16(noise_bytes);
  return L;
}

template <typename T, bool NOISY, bool COUNT>
__global__ void __launch_bounds__(miz_cluster_threads<T>(), 1)
    miz_cluster_kernel(const T* __restrict__ cin, const T* __restrict__ pars,
                       const T* __restrict__ cols, const T* __restrict__ cosv,
                       const T* __restrict__ fyear, T* __restrict__ cout,
                       T* __restrict__ wint, T* __restrict__ summ, T* __restrict__ avg,
                       T* __restrict__ conv, int* __restrict__ iters, T* __restrict__ raw,
                       NoiseArgs<T> nz, T* ws, int records_shared, int K, int nx, int nt, int w0,
                       int s0, int pcr_steps, int max_iter, T dt, T abstol, T reltol,
                       T max_step) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T p[N_SHARED];
  __shared__ int n_updates;  // COUNT: the member's Newton updates, by thread 0
  const ClusterSlice cs = cluster_slice(nx);
  const MizClusterLayout L =
      miz_cluster_layout<T>(nx, cs.C, blockDim.x, records_shared != 0,
                            NOISY ? noise_shared_bytes<T>(nt, nz.ou_mode) : 0);
  PcrRow<T>* rows = reinterpret_cast<PcrRow<T>*>(smem_raw);
  ClusterPcr<T> pcr{{rows, rows + cs.slice}, 0};
  Pair<T>* halo[2] = {reinterpret_cast<Pair<T>*>(smem_raw + L.halo),
                      reinterpret_cast<Pair<T>*>(smem_raw + L.halo) + cs.slice};
  int hturn = 0;  // the exchange buffer written next
  T* fld = records_shared ? reinterpret_cast<T*>(smem_raw + L.records)
                          : ws + (size_t)blockIdx.x * miz_cluster_words(nx, cs.C);
  ClusterRed<T> red{reinterpret_cast<MagnitudeKey<T>*>(smem_raw + L.keys), 0};
  RedSmem<T> cross_red{reinterpret_cast<T*>(smem_raw + L.cross), 0};
  T* xv = reinterpret_cast<T*>(smem_raw + L.vals);
  T* noise_row = reinterpret_cast<T*>(smem_raw + L.noise);
  const T* glo = cols + 2 * nx;
  const T* gdi = cols + 3 * nx;
  const T* gup = cols + 4 * nx;
  // the carry's fields in CARRY_KEYS order
  constexpr int carry_field[N_CARRY] = {W_EI, W_EW, W_H, W_D, F_PHI, F_T0};
  const size_t plane = (size_t)K * nx;
  const bool crossing = NOISY && nz.cross_out != nullptr;
  const int clusters = gridDim.x / cs.C;

  // the record of local cell li, the frozen inputs of its residual, and its
  // neighbours on the rolled grid
  auto rec = [&](int li) { return Rec<T>{fld + li, cs.slice}; };
  auto cell = [&](int li, T insol) {
    const Rec<T> c = rec(li);
    const int i = cs.lo + li;
    return T0Cell<T>{glo[i], gdi[i], gup[i], c[F_PHI], c[F_WATER], c[F_SOLAR], insol, c[F_KH]};
  };
  auto left = [&](int i) { return i == 0 ? nx - 1 : i - 1; };
  auto right = [&](int i) { return i == nx - 1 ? 0 : i + 1; };
  // the write half of the residual's exchange: cell li's (Tb, g) into cur
  auto t0_put = [&](Pair<T>* cur, const T0Par<T>& tp, int li) {
    const Pair<T> v = t0_tb_g(rec(li)[F_T0], cell(li, T(0)), tp);
    store_pair(cur + li, v.a, v.b);
  };
  // the read half, after the cluster barrier that follows every rank's puts:
  // each of the thread's cells' residual and Jacobian row, written as the row
  // of the Newton update's system (jlo, jdi, jup | -r); the largest
  // magnitude key of their |r| (0 for a thread with none). The step's first
  // residual (t >= 0) contracts ai insol, the others (t < 0) add `solar`
  auto t0_rows = [&](Pair<T>* cur, const T0Par<T>& tp, int t) {
    MagnitudeKey<T> key = 0;
    for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x) {
      const int i = cs.lo + li;
      T r, jlo, jdi, jup;
      const Pair<T> own = load_pair(cur + li);
      const Pair<T> m = load_pair(cluster_at(cur, cs, left(i)));
      const Pair<T> q = load_pair(cluster_at(cur, cs, right(i)));
      if (t >= 0)
        t0_row<T, false, true>(rec(li)[F_T0], cell(li, miz_insol(p, cols[i], cols[nx + i],
                                                                 cosv[t])),
                               tp, own, m, q, r, jlo, jdi, jup);
      else
        t0_row<T, false, false>(rec(li)[F_T0], cell(li, T(0)), tp, own, m, q, r, jlo, jdi,
                                jup);
      cluster_pcr_row(pcr, li, jlo, jdi, jup, -r);
      const MagnitudeKey<T> k = magnitude_key(abs_val(r));
      key = k > key ? k : key;
    }
    return key;
  };

  for (int m = blockIdx.x / cs.C; m < K; m += clusters) {
    __syncthreads();  // the last member's reads of p and of the noise row are done
    if (threadIdx.x < N_ROWS) p[threadIdx.x] = pars[(size_t)m * N_ROWS + threadIdx.x];
    if (COUNT && threadIdx.x == 0) n_updates = 0;
    __syncthreads();
    if (threadIdx.x == 0) miz_derive(p);
    __syncthreads();
    for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x) {
      const Rec<T> c = rec(li);
      const size_t idx = (size_t)m * nx + cs.lo + li;
#pragma unroll
      for (int j = 0; j < N_CARRY; ++j) c[carry_field[j]] = cin[j * plane + idx];
      for (int j = 0; j < N_OUT; ++j) c[W_ACC + j] = T(0);
    }
    T conv_m = T(1);
    NoiseState<T> ns;
    if (NOISY) ns = noise_begin(nz, noise_row, m, K, nt);

    for (int t = 0; t < nt; ++t) {
      const T Tm = p[P_TM], A = p[P_A], B = p[P_B], D = p[P_D], cw = p[P_CW];
      T f = fyear[t] + p[P_F];
      if (NOISY) f = noise_forcing(nz, ns, f, t);
      const T0Par<T> tp{p[P_K], Tm, A, B, D, f, p[P_AI]};

      // -- step inputs, and the first residual's exchange ------------------
      Pair<T>* cur = halo[hturn];
      hturn ^= 1;
      for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x) {
        const Rec<T> c = rec(li);
        const int i = cs.lo + li;
        const T insol = miz_insol(p, cols[i], cols[nx + i], cosv[t]);
        const T ph = c[F_PHI];
        const T den = (T(1) - ph) * cw;
        T tw = Tm + (den == T(0) ? T(0) : c[W_EW] / den);
        if (is_nan(tw)) tw = T(0);
        c[W_TW] = tw;
        c[F_WATER] = (T(1) - ph) * tw;
        c[F_SOLAR] = p[P_AI] * insol;
        c[F_KH] = c[W_H] == T(0) ? p[P_HMIN] : c[W_H];
        t0_put(cur, tp, li);
      }
      cluster_sync();

      // -- Newton for T0 (per member); the max's cluster barrier also orders
      // the rows before the solve's first level -----------------------------
      T rnorm = cluster_max_key<T>(t0_rows(cur, tp, t), red, cs);
      const T tol = nan_max(abstol, reltol * rnorm);
      for (int it = 0; it < max_iter && rnorm > tol; ++it) {
        const PcrRow<T>* solved = cluster_pcr_solve<T, true>(pcr, cs, pcr_steps);
        cur = halo[hturn];
        hturn ^= 1;
        for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x) {
          const Rec<T> c = rec(li);
          c[F_T0] = c[F_T0] + clip_step(cluster_pcr_x(solved, li), max_step);
          t0_put(cur, tp, li);
        }
        cluster_sync();
        rnorm = cluster_max_key<T>(t0_rows(cur, tp, -1), red, cs);
        if (COUNT && threadIdx.x == 0) ++n_updates;
      }
      conv_m = nan_min(conv_m, rnorm <= tol ? T(1) : T(0));

      // -- the rest of the step: Tb's exchange, then miz_tail --------------
      const T Lf = p[P_LF], alpha = p[P_ALPHA], Dmin = p[P_DMIN], hmin = p[P_HMIN];
      const MizStep<T> sp{Tm, A, B, D, f, dt, Lf, alpha, Dmin, hmin};
      cur = halo[hturn];
      hturn ^= 1;
      for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x) {
        const Rec<T> c = rec(li);
        cur[li].a = miz_head(sp, c[F_T0], c[W_H], c[W_D], c[F_PHI], c[F_WATER]).Tb;
      }
      cluster_sync();
      // one cell at a time: the step's tail holds the most values of any
      // loop here, and two cells' worth would spill
#pragma unroll 1
      for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x) {
        const Rec<T> c = rec(li);
        const int i = cs.lo + li;
        const MizHead<T> hd = miz_head(sp, c[F_T0], c[W_H], c[W_D], c[F_PHI], c[F_WATER]);
        const T x2 = cols[nx + i];
        const T insol = miz_insol(p, cols[i], x2, cosv[t]);
        MizState<T> st{c[W_EI], c[W_EW], c[W_H], c[W_D], c[F_PHI]};
        T out[N_OUT];
        miz_tail(p, sp, hd, st, c[W_TW], insol, x2, glo[i], gdi[i], gup[i],
                 cluster_at(cur, cs, left(i))->a, cluster_at(cur, cs, right(i))->a, out);
        c[W_EI] = st.Ei;
        c[W_EW] = st.Ew;
        c[W_H] = st.h;
        c[W_D] = st.Df;
        c[F_PHI] = st.phi;

        // -- seasonal store ------------------------------------------------
        for (int j = 0; j < N_OUT; ++j) c[W_ACC + j] = c[W_ACC + j] + out[j];
        const size_t idx = (size_t)m * nx + i;
        if (t == w0 || t == s0) {
          T* snap = t == w0 ? wint : summ;
          for (int j = 0; j < N_OUT; ++j) snap[j * plane + idx] = out[j];
          if (t == w0 && t == s0) {
            for (int j = 0; j < N_OUT; ++j) summ[j * plane + idx] = out[j];
          }
        }
        if (raw != nullptr) {
          T* row = raw + (size_t)t * N_OUT * plane;
          for (int j = 0; j < N_OUT; ++j) row[j * plane + idx] = out[j];
        }
        // the instantaneous ice area, phi with NaN counted as 0
        if (crossing) xv[li] = nz.wts[i] * (is_nan(st.phi) ? T(0) : st.phi);
      }
      if (crossing) {
        cluster_sync();
        if (cs.rank == 0) cluster_noise_crossing(ns, xv, cs, cross_red, t);
      }
    }
    if (NOISY && cs.rank == 0) noise_end(nz, ns, m, nt);

    // same `sum / nt` arithmetic as the JAX kernel and storage path
    const T ntf = T(nt);
    for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x) {
      const Rec<T> c = rec(li);
      const size_t idx = (size_t)m * nx + cs.lo + li;
#pragma unroll
      for (int j = 0; j < N_CARRY; ++j) cout[j * plane + idx] = c[carry_field[j]];
      for (int j = 0; j < N_OUT; ++j) avg[j * plane + idx] = c[W_ACC + j] / ntf;
    }
    if (cs.rank == 0 && threadIdx.x == 0) {
      conv[m] = conv_m;
      if (COUNT) iters[m] = n_updates;
    }
  }
  cluster_sync();  // no block leaves while another rank can read its shared memory
}

// The C side's plan of the cluster build (cluster.cuh::choose_cluster): C,
// the threads, the records in shared memory where they fit beside the rest,
// and the clusters the card keeps resident; an error when it cannot launch.
template <typename T, bool NOISY, bool COUNT>
cudaError_t miz_cluster_plan(int nx, int nt, int K, int ou_mode, int force_c, ClusterPlan& plan) {
  const size_t noise = NOISY ? noise_shared_bytes<T>(nt, ou_mode) : 0;
  return choose_cluster(K, force_c, plan, [&](int C, ClusterPlan& p) {
    p.C = C;
    p.threads = cluster_threads(nx, C, miz_cluster_threads<T>());
    p.records_shared =
        miz_cluster_layout<T>(nx, C, p.threads, true, noise).total <= CLUSTER_SHARED_BUDGET;
    p.shmem = miz_cluster_layout<T>(nx, C, p.threads, p.records_shared != 0, noise).total;
    if (p.shmem > CLUSTER_SHARED_BUDGET) return cudaErrorInvalidValue;
    return cluster_occupancy(miz_cluster_kernel<T, NOISY, COUNT>, p);
  });
}

// the cluster build on min(K, resident) clusters; with the records in device
// memory, each block's at ws + blockIdx.x * miz_cluster_words(nx, C)
template <typename T, bool NOISY, bool COUNT>
int launch_cluster(int K, cudaStream_t stream, const void* cin, const void* pars,
                   const void* cols, const void* cosv, const void* f, void* cout, void* wint,
                   void* summ, void* avg, void* conv, void* iters, void* raw,
                   const NoiseArgs<T>& nz, void* ws, int ws_words, int ws_blocks, int force_c,
                   int nx, int nt, int w0, int s0, int pcr_steps, int max_iter, double dt,
                   double abstol, double reltol, double max_step) {
  ClusterPlan plan;
  const cudaError_t err =
      miz_cluster_plan<T, NOISY, COUNT>(nx, nt, K, nz.ou_mode, force_c, plan);
  if (err != cudaSuccess) return (int)err;
  const int clusters = K < plan.clusters ? K : plan.clusters;
  if (!plan.records_shared &&
      (ws == nullptr || (size_t)ws_words != miz_cluster_words(nx, plan.C) ||
       ws_blocks < clusters * plan.C))
    return (int)cudaErrorInvalidValue;
  return (int)cluster_launch(
      miz_cluster_kernel<T, NOISY, COUNT>, plan, clusters, stream, static_cast<const T*>(cin),
      static_cast<const T*>(pars), static_cast<const T*>(cols), static_cast<const T*>(cosv),
      static_cast<const T*>(f), static_cast<T*>(cout), static_cast<T*>(wint),
      static_cast<T*>(summ), static_cast<T*>(avg), static_cast<T*>(conv),
      static_cast<int*>(iters), static_cast<T*>(raw), nz, static_cast<T*>(ws),
      plan.records_shared, K, nx, nt, w0, s0, pcr_steps, max_iter, T(dt), T(abstol), T(reltol),
      T(max_step));
}

template <typename T, int MAX_THREADS, int MIN_BLOCKS, bool NOISY, bool COUNT>
int launch_block(int K, int threads, size_t shmem, cudaStream_t stream,
                 const void* cin, const void* pars, const void* cols,
                 const void* cosv, const void* f, void* cout, void* wint,
                 void* summ, void* avg, void* conv, void* iters, void* raw,
                 const NoiseArgs<T>& nz, int nx, int nt, int w0, int s0, int pcr_steps,
                 int max_iter, double dt, double abstol, double reltol, double max_step) {
  auto kernel = miz_year_kernel<T, MAX_THREADS, MIN_BLOCKS, NOISY, COUNT>;
  const cudaError_t err = allow_shared(kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<K, threads, shmem, stream>>>(
      static_cast<const T*>(cin), static_cast<const T*>(pars),
      static_cast<const T*>(cols), static_cast<const T*>(cosv),
      static_cast<const T*>(f), static_cast<T*>(cout), static_cast<T*>(wint),
      static_cast<T*>(summ), static_cast<T*>(avg), static_cast<T*>(conv),
      static_cast<int*>(iters), static_cast<T*>(raw), nz, K, nx,
      nt, w0, s0, pcr_steps, max_iter, T(dt), T(abstol), T(reltol), T(max_step));
  return (int)cudaGetLastError();
}

// Blocks of 192 threads (the canonical nx = 180) that share an SM, by the
// registers the build is held to: float32 56 (deterministic, six blocks) and
// 64 (noisy, five), float64 168 (two). The float32 caps spill a few values
// (52 and 164 bytes) and are faster all the same: measured, PERF.md.
template <typename T, bool NOISY>
constexpr int canonical_blocks() {
  return sizeof(T) == 8 ? 2 : (NOISY ? 5 : 6);
}

template <typename T, bool NOISY, bool COUNT>
int launch_threads(int K, int threads, size_t shmem, cudaStream_t st, const void* cin,
                   const void* pars, const void* cols, const void* cosv, const void* f,
                   void* cout, void* wint, void* summ, void* avg, void* conv, void* iters,
                   void* raw, const NoiseArgs<T>& nz, int nx, int nt, int w0, int s0,
                   int pcr_steps, int max_iter, double dt, double abstol, double reltol,
                   double max_step) {
  // three builds by block size: up to 192 threads with the register cap that
  // fills an SM with the canonical grid's blocks, up to 256 with what a
  // block of 256 can have, and up to 1024
  if (threads <= 192)
    return launch_block<T, 192, canonical_blocks<T, NOISY>(), NOISY, COUNT>(
        K, threads, shmem, st, cin, pars, cols, cosv, f, cout, wint, summ, avg, conv, iters,
        raw, nz, nx, nt, w0, s0, pcr_steps, max_iter, dt, abstol, reltol, max_step);
  if (threads <= 256)
    return launch_block<T, 256, 1, NOISY, COUNT>(
        K, threads, shmem, st, cin, pars, cols, cosv, f, cout, wint, summ, avg, conv, iters,
        raw, nz, nx, nt, w0, s0, pcr_steps, max_iter, dt, abstol, reltol, max_step);
  return launch_block<T, 1024, 1, NOISY, COUNT>(
      K, threads, shmem, st, cin, pars, cols, cosv, f, cout, wint, summ, avg, conv, iters,
      raw, nz, nx, nt, w0, s0, pcr_steps, max_iter, dt, abstol, reltol, max_step);
}

template <typename T>
int launch(const void* cin, const void* pars, const void* cols, const void* cosv,
           const void* f, void* cout, void* wint, void* summ, void* avg, void* conv,
           void* iters, void* raw, const void* noise, const void* keys, const void* ou,
           void* eta_out, const void* cross, void* cross_out, const void* wts, void* ws, int K,
           int nx, int nt, int w0, int s0, int pcr_steps, int max_iter, int ou_mode,
           int ou_unroll, int ws_words, int ws_blocks, int force_c, double dt, double abstol,
           double reltol, double max_step, void* stream) {
  if (K < 1 || nx < 1 || nx > MAX_WIDE_NX || nt < 1) return (int)cudaErrorInvalidValue;
  const bool wide = nx > 1024;
  const int threads = ((nx + 31) / 32) * 32;
  const NoiseArgs<T> nz = noise_args<T>(noise, keys, ou, eta_out, cross, cross_out, wts,
                                        ou_mode, ou_unroll);
  const bool noisy = noise != nullptr || keys != nullptr;
  const size_t shmem =
      base_shared_bytes<T>(nx, pcr_steps) + (noisy ? noise_shared_bytes<T>(nt, ou_mode) : 0);
  if (!wide && shmem > MAX_SHARED_BYTES) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the builds: NOISY by the noise inputs, COUNT by the count output
  auto run = [&](auto noisy_c, auto count_c) {
    constexpr bool NOISY = decltype(noisy_c)::value, COUNT = decltype(count_c)::value;
    if (wide)
      return launch_cluster<T, NOISY, COUNT>(K, st, cin, pars, cols, cosv, f, cout, wint, summ,
                                             avg, conv, iters, raw, nz, ws, ws_words, ws_blocks,
                                             force_c, nx, nt, w0, s0, pcr_steps, max_iter, dt,
                                             abstol, reltol, max_step);
    return launch_threads<T, NOISY, COUNT>(
        K, threads, shmem, st, cin, pars, cols, cosv, f, cout, wint, summ, avg, conv, iters,
        raw, nz, nx, nt, w0, s0, pcr_steps, max_iter, dt, abstol, reltol, max_step);
  };
  const std::true_type yes;
  const std::false_type no;
  if (noisy) return iters != nullptr ? run(yes, yes) : run(yes, no);
  return iters != nullptr ? run(no, yes) : run(no, no);
}

// the plan of the cluster build for nx, by the builds' flags: out = {C,
// threads, records in shared memory (1) or in the workspace (0), resident
// clusters, dynamic shared bytes per block}
template <typename T>
int plan(int nx, int nt, int K, int noisy, int ou_mode, int count, int force_c, int* out) {
  if (nx <= 1024 || nx > MAX_WIDE_NX || nt < 1 || K < 1) return (int)cudaErrorInvalidValue;
  ClusterPlan p;
  cudaError_t err;
  if (noisy)
    err = count ? miz_cluster_plan<T, true, true>(nx, nt, K, ou_mode, force_c, p)
                : miz_cluster_plan<T, true, false>(nx, nt, K, ou_mode, force_c, p);
  else
    err = count ? miz_cluster_plan<T, false, true>(nx, nt, K, ou_mode, force_c, p)
                : miz_cluster_plan<T, false, false>(nx, nt, K, ou_mode, force_c, p);
  if (err == cudaSuccess) plan_out(p, out);
  return (int)err;
}

}  // namespace

extern "C" {

int ebm_miz_year_f32(const void* cin, const void* pars, const void* cols,
                     const void* cosv, const void* f, void* cout, void* wint,
                     void* summ, void* avg, void* conv, void* iters, void* raw,
                     const void* noise, const void* keys, const void* ou, void* eta_out,
                     const void* cross, void* cross_out, const void* wts, void* ws, int K,
                     int nx, int nt, int w0, int s0, int pcr_steps, int max_iter, int ou_mode,
                     int ou_unroll, int ws_words, int ws_blocks, int force_c, double dt,
                     double abstol, double reltol, double max_step, void* stream) {
  return launch<float>(cin, pars, cols, cosv, f, cout, wint, summ, avg, conv, iters, raw,
                       noise, keys, ou, eta_out, cross, cross_out, wts, ws, K, nx, nt, w0,
                       s0, pcr_steps, max_iter, ou_mode, ou_unroll, ws_words, ws_blocks, force_c,
                       dt, abstol, reltol, max_step, stream);
}

int ebm_miz_year_f64(const void* cin, const void* pars, const void* cols,
                     const void* cosv, const void* f, void* cout, void* wint,
                     void* summ, void* avg, void* conv, void* iters, void* raw,
                     const void* noise, const void* keys, const void* ou, void* eta_out,
                     const void* cross, void* cross_out, const void* wts, void* ws, int K,
                     int nx, int nt, int w0, int s0, int pcr_steps, int max_iter, int ou_mode,
                     int ou_unroll, int ws_words, int ws_blocks, int force_c, double dt,
                     double abstol, double reltol, double max_step, void* stream) {
  return launch<double>(cin, pars, cols, cosv, f, cout, wint, summ, avg, conv, iters, raw,
                        noise, keys, ou, eta_out, cross, cross_out, wts, ws, K, nx, nt, w0,
                        s0, pcr_steps, max_iter, ou_mode, ou_unroll, ws_words, ws_blocks, force_c,
                        dt, abstol, reltol, max_step, stream);
}

int ebm_miz_year_plan_f32(int nx, int nt, int K, int noisy, int ou_mode, int count,
                          int force_c, int* out) {
  return plan<float>(nx, nt, K, noisy, ou_mode, count, force_c, out);
}

int ebm_miz_year_plan_f64(int nx, int nt, int K, int noisy, int ou_mode, int count,
                          int force_c, int* out) {
  return plan<double>(nx, nt, K, noisy, ou_mode, count, force_c, out);
}

const char* ebm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
