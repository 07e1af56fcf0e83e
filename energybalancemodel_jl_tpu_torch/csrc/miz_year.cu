// One MIZ model year for a (K, nx) ensemble, fused into one launch.
//
// Replaces the two TPU kernels of energybalancemodel_jl_tpu/ops/pallas_year.py
// that compute this function in two layouts the TPU's (8, 128) tiling forced:
//   - pallas_year.py::_kernel_xk  (grid on sublanes, members on lanes; the
//     ensemble path, launched by _miz_year_xk), and
//   - pallas_year.py::_kernel     (members on sublanes, grid on lanes; the
//     single-run 'kx' branch of pallas_miz_year).
// On Hopper one layout serves both: ONE THREAD BLOCK PER MEMBER, one thread
// per grid cell (blockDim = round_up(nx, 32)).
//
// Each thread keeps its cell's carry (Ei, Ew, h, D, phi, T0) and its ten
// annual sums in registers for all nt steps; it writes the winter/summer
// snapshots straight to global memory at ticks w0/s0 and the carry and
// sum/nt at the end. Device memory sees one read of the carry and one write
// of carry + seasonal store per simulated year (the property the TPU kernel
// exists for, pallas_year.py:3-14). A raw-collected year (raw != nullptr)
// also writes every step's ten outputs, raw[t][var][member][cell].
//
// Per step (models/miz.py::step, line for line, same operation order):
//   - insolation (S0 - (S1 x) cos 2pi t) - S2 x^2 and coalbedo a0 - a2 x^2
//     from the member's parameter row, forcing f[t] + F;
//   - warm-started Newton for T0 with tolerance max(abstol, reltol |r0|),
//     iterated while the MEMBER's max |r| exceeds it (a block reduction:
//     warp shuffles, then shared memory). The JAX kernels iterate until the
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
// What bounds it: nothing touches device memory inside the year, so the
// kernel is bound by the latency of the dependent chain of each step: about
// 2 * ceil(log2 nx) + 6 block barriers per Newton iteration, with 192
// threads of a block doing a few flops between them. Enough resident blocks
// per SM (members) hide part of that latency; a wide ensemble fills the card,
// a single run uses one SM.
//
// The COUNT = true instantiation (iters != nullptr) also counts the member's
// Newton updates over the year, thread 0 in shared memory, into iters[m]: the
// work behind the Newton part of the year's operation count. It is a build of
// its own so that the instantiations that run the model keep their registers
// (a counter live across the time loop cost the noisy f32 build 2 registers,
// past the 112 that let 3 blocks of 192 threads share an SM).
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
// step also sums w_i phi_i over the member's cells in cell order (NaN counts
// as 0) and records the first step where sign * (area - thr) > 0. The noise
// work is one row fill and a few operations per step; the year stays bound by
// its barrier chain, and the NOISY build's larger register count (fewer
// resident blocks per SM, PERF.md) costs more than the noise work itself.
// The deterministic year is the NOISY = false instantiation, unchanged.
#include <type_traits>

#include "common.cuh"
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

template <typename T>
struct Shared {
  PcrSmem<T> pcr;  // PCR bands and right-hand side, one entry per grid cell
  T* va;           // neighbour exchange buffers
  T* vb;
  T* red;          // one slot per warp for the block reductions
};

// (v[i-1], v[i+1]) with wraparound, for two fields at once
template <typename T>
__device__ __forceinline__ void exchange2(T va, T vb, const Shared<T>& s, int i,
                                          int nx, bool active, T& am1, T& ap1,
                                          T& bm1, T& bp1) {
  if (active) {
    s.va[i] = va;
    s.vb[i] = vb;
  }
  __syncthreads();
  if (active) {
    const int im = i == 0 ? nx - 1 : i - 1;
    const int ip = i == nx - 1 ? 0 : i + 1;
    am1 = s.va[im];
    ap1 = s.va[ip];
    bm1 = s.vb[im];
    bp1 = s.vb[ip];
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void exchange1(T v, const Shared<T>& s, int i, int nx,
                                          bool active, T& vm1, T& vp1) {
  if (active) s.va[i] = v;
  __syncthreads();
  if (active) {
    vm1 = s.va[i == 0 ? nx - 1 : i - 1];
    vp1 = s.va[i == nx - 1 ? 0 : i + 1];
  }
  __syncthreads();
}

template <typename T>
struct Cell {
  // per-cell geometry and the step's frozen inputs of the T0 residual
  T x, x2, glo, gdi, gup;
  T insol, hp, Tw, phi, f;
};

// T0eq residual and its tridiagonal Jacobian (models/miz.py::_t0_residual,
// ::_t0_bands)
template <typename T>
__device__ __forceinline__ void residual_bands(T T0, const Cell<T>& c, const T* p,
                                               const Shared<T>& s, int i, int nx,
                                               bool active, T& r, T& jlo, T& jdi,
                                               T& jup) {
  const T k = p[P_K], Tm = p[P_TM], A = p[P_A], B = p[P_B], ai = p[P_AI],
          D = p[P_D];
  const T Ti = nan_min(T0, Tm);
  const T Tb = Ti * c.phi + (T(1) - c.phi) * c.Tw;
  const T g = c.phi * (T0 < Tm ? T(1) : T(0));
  T Tbm1 = T(0), Tbp1 = T(0), gm1 = T(0), gp1 = T(0);
  exchange2(Tb, g, s, i, nx, active, Tbm1, Tbp1, gm1, gp1);
  if (!active) return;
  r = k * (Tm - T0) / c.hp;
  r = r + ai * c.insol;
  r = r + ((-A) - B * (T0 - Tm));
  r = r + D * (c.glo * Tbm1 + c.gdi * Tb + c.gup * Tbp1);
  r = r + c.f;
  jlo = D * c.glo * gm1;
  jdi = -k / c.hp - B + D * c.gdi * g;
  jup = D * c.gup * gp1;
}

// MAX_THREADS bounds the block so the compiler keeps the register count a
// block of that size can launch with
template <typename T, int MAX_THREADS, bool NOISY, bool COUNT>
__global__ void __launch_bounds__(MAX_THREADS) miz_year_kernel(const T* __restrict__ cin, const T* __restrict__ pars,
                                const T* __restrict__ cols, const T* __restrict__ cosv,
                                const T* __restrict__ fyear, T* __restrict__ cout,
                                T* __restrict__ wint, T* __restrict__ summ,
                                T* __restrict__ avg, T* __restrict__ conv,
                                int* __restrict__ iters, T* __restrict__ raw,
                                NoiseArgs<T> nz, int K,
                                int nx, int nt, int w0, int s0, int pcr_steps,
                                int max_iter, T dt, T abstol, T reltol, T max_step) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nxp = blockDim.x;
  __shared__ T p[N_ROWS];
  __shared__ int n_updates;  // COUNT: the member's Newton updates, by thread 0
  const Shared<T> s{{sm, sm + nxp, sm + 2 * nxp, sm + 3 * nxp},
                    sm + 4 * nxp, sm + 5 * nxp, sm + 6 * nxp};

  const int m = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < nx;
  const size_t plane = (size_t)K * nx;
  const size_t idx = (size_t)m * nx + (active ? i : 0);

  if (i < N_ROWS) p[i] = pars[(size_t)m * N_ROWS + i];
  if (COUNT && i == 0) n_updates = 0;
  __syncthreads();
  const T Tm = p[P_TM], A = p[P_A], B = p[P_B], ai = p[P_AI], Fb = p[P_FB],
          cw = p[P_CW], m1 = p[P_M1], Lf = p[P_LF], alpha = p[P_ALPHA],
          rl = p[P_RL], Dmin = p[P_DMIN], Dmax = p[P_DMAX], hmin = p[P_HMIN],
          kappa = p[P_KAPPA], D = p[P_D], Tm_pow_m2 = p[P_TM_POW_M2],
          Foff = p[P_F], S0 = p[P_S0], S1 = p[P_S1], S2 = p[P_S2];

  Cell<T> c{};
  T Ei = 0, Ew = 0, h = 0, Df = 0, phi = 0, T0 = 0;
  if (active) {
    c.x = cols[i];
    c.x2 = cols[nx + i];
    c.glo = cols[2 * nx + i];
    c.gdi = cols[3 * nx + i];
    c.gup = cols[4 * nx + i];
    Ei = cin[0 * plane + idx];
    Ew = cin[1 * plane + idx];
    h = cin[2 * plane + idx];
    Df = cin[3 * plane + idx];
    phi = cin[4 * plane + idx];
    T0 = cin[5 * plane + idx];
  }
  const T aw = p[P_A0] - p[P_A2] * c.x2;  // water coalbedo
  const T pi = T(3.14159265358979323846);
  const T lat_melt_coef = T(-3.14159265358979323846 / 2.0);  // -pi/2 (D_t quirk)

  T acc[N_OUT];
#pragma unroll
  for (int j = 0; j < N_OUT; ++j) acc[j] = T(0);
  T conv_m = T(1);
  // the member's per-step noise row (after the PCR, exchange and reduction
  // buffers) and its OU and crossing state
  NoiseState<T> ns;
  if (NOISY) ns = noise_begin(nz, sm + 6 * nxp + 32, m, K, nt);

  for (int t = 0; t < nt; ++t) {
    // -- step inputs ------------------------------------------------------
    c.insol = (S0 - (S1 * c.x) * cosv[t]) - S2 * c.x2;
    c.f = fyear[t] + Foff;
    if (NOISY) c.f = noise_forcing(nz, ns, c.f, t);

    // -- temperatures ------------------------------------------------------
    const T den = (T(1) - phi) * cw;
    T Tw = Tm + (den == T(0) ? T(0) : Ew / den);
    if (is_nan(Tw)) Tw = T(0);
    c.Tw = Tw;
    c.phi = phi;
    c.hp = h == T(0) ? hmin : h;

    // -- Newton for T0 (per member) ---------------------------------------
    T r = T(0), jlo = T(0), jdi = T(1), jup = T(0);
    residual_bands(T0, c, p, s, i, nx, active, r, jlo, jdi, jup);
    T rnorm = block_max(active ? abs_val(r) : T(0), s.red);
    const T tol = nan_max(abstol, reltol * rnorm);
    for (int it = 0; it < max_iter && rnorm > tol; ++it) {
      T lo[1] = {jlo}, di[1] = {jdi}, up[1] = {jup}, delta[1] = {-r};
      pcr_solve<T, 1>(lo, di, up, delta, s.pcr, nx, pcr_steps);
      if (active) T0 = T0 + clip_step(delta[0], max_step);
      residual_bands(T0, c, p, s, i, nx, active, r, jlo, jdi, jup);
      rnorm = block_max(active ? abs_val(r) : T(0), s.red);
      if (COUNT && i == 0) ++n_updates;
    }
    conv_m = nan_min(conv_m, rnorm <= tol ? T(1) : T(0));

    // -- the rest of the step (models/miz.py::step) -----------------------
    T Ti = nan_min(T0, Tm);
    if (h == T(0)) Ti = T(0);
    const bool zeroD = Df == T(0);
    const T n = zeroD ? T(0) : phi / (alpha * (Df * Df));

    const T Tb = Ti * phi + (T(1) - phi) * Tw;
    const T L = A + B * (Tb - Tm);
    T Tbm1 = T(0), Tbp1 = T(0);
    exchange1(Tb, s, i, nx, active, Tbm1, Tbp1);
    const T dTb = D * (c.glo * Tbm1 + c.gdi * Tb + c.gup * Tbp1);
    const T Fvi = ai * c.insol - L + dTb + Fb + c.f;
    const T Fvw = aw * c.insol - L + dTb + Fb + c.f;
    const T wl = m1 * (Tw - Tm_pow_m2);
    const T Flat = zeroD ? T(0) : phi * h * Lf * wl * pi / (alpha * Df);

    const T rEi = Ei + (phi * Fvi + Flat) * dt;
    const T rEw = Ew + ((T(1) - phi) * Fvw - Flat) * dt;
    const T cEi = nan_min(rEi, T(0));
    const T cEw = nan_max(rEw, T(0));
    const T psiEidt = rEi - cEi;
    const T psiEwdt = rEw - cEw;
    T Ei1 = cEi + psiEwdt;
    const T Ew1 = cEw + psiEidt;

    const T Drl = Df + T(2) * rl;
    const T ring = alpha * n * (Drl * Drl - Df * Df);
    const T Al = nan_min(ring, T(1) - phi);
    const T psiEw = psiEwdt / dt;
    const T Ql = phi == T(1) ? T(0) : Al / (T(1) - phi) * psiEw;
    const T Qp = psiEw - Ql;
    const T dn = dt * (-Qp / (Lf * alpha * (Dmin * Dmin) * hmin));

    const T lat_melt = lat_melt_coef * alpha * wl;
    const T lg_den = T(2) * Lf * h * phi;
    T lat_grow = lg_den == T(0) ? T(0) : -Df / lg_den * Ql;
    if (h == T(0)) lat_grow = T(0);
    const T weld = kappa * alpha / T(4) * phi * (Df * (Df * Df));
    const T rD = Df + (lat_melt + lat_grow + weld) * dt;
    const T total = n + dn;
    const bool zero_total = total == T(0);
    T D1 = zero_total ? T(0) : (n * rD + dn * Dmin) / total;
    D1 = nan_min(nan_max(D1, Dmin), Dmax);
    if (Ei1 == T(0)) D1 = T(0);

    const T rh = nan_max(h + (T(-1) / Lf * Fvi) * dt, T(0));
    const T h1 = zero_total ? T(0) : (n * rh + dn * hmin) / total;

    T phi1 = h1 == T(0) ? T(0) : -Ei1 / (Lf * h1);
    if (phi1 > T(1)) phi1 = T(1);

    if (h1 == T(0)) Ei1 = T(0);
    const T E = phi1 * Ei1 + (T(1) - phi1) * Ew1;
    const T Tbar = Ti * phi1 + (T(1) - phi1) * Tw;
    const T Ti_out = Ei1 == T(0) ? quiet_nan<T>() : Ti;
    const T Tw_out = phi1 > T(0.99) ? quiet_nan<T>() : Tw;

    Ei = Ei1;
    Ew = Ew1;
    h = h1;
    Df = D1;
    phi = phi1;

    // -- seasonal store ----------------------------------------------------
    const T out[N_OUT] = {E, Tbar, h1, Ei1, Ew1, Ti_out, Tw_out, D1, phi1, n};
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
      if (active) s.va[i] = nz.wts[i] * (is_nan(phi1) ? T(0) : phi1);
      noise_crossing(ns, s.va, nx, t);
    }
  }
  if (NOISY) noise_end(nz, ns, m, nt);

  if (active) {
    const T carry[N_CARRY] = {Ei, Ew, h, Df, phi, T0};
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

template <typename T, int MAX_THREADS, bool NOISY, bool COUNT>
int launch_block(int K, int threads, size_t shmem, cudaStream_t stream,
                 const void* cin, const void* pars, const void* cols,
                 const void* cosv, const void* f, void* cout, void* wint,
                 void* summ, void* avg, void* conv, void* iters, void* raw,
                 const NoiseArgs<T>& nz, int nx, int nt, int w0, int s0, int pcr_steps,
                 int max_iter, double dt, double abstol, double reltol, double max_step) {
  auto kernel = miz_year_kernel<T, MAX_THREADS, NOISY, COUNT>;
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

template <typename T, bool NOISY, bool COUNT>
int launch_threads(int K, int threads, size_t shmem, cudaStream_t st, const void* cin,
                   const void* pars, const void* cols, const void* cosv, const void* f,
                   void* cout, void* wint, void* summ, void* avg, void* conv, void* iters,
                   void* raw, const NoiseArgs<T>& nz, int nx, int nt, int w0, int s0,
                   int pcr_steps, int max_iter, double dt, double abstol, double reltol,
                   double max_step) {
  // the canonical grid (nx = 180) takes the 256-thread build, which may use
  // more registers per thread than a 1024-thread block allows
  if (threads <= 256)
    return launch_block<T, 256, NOISY, COUNT>(
        K, threads, shmem, st, cin, pars, cols, cosv, f, cout, wint, summ, avg, conv, iters,
        raw, nz, nx, nt, w0, s0, pcr_steps, max_iter, dt, abstol, reltol, max_step);
  return launch_block<T, 1024, NOISY, COUNT>(
      K, threads, shmem, st, cin, pars, cols, cosv, f, cout, wint, summ, avg, conv, iters,
      raw, nz, nx, nt, w0, s0, pcr_steps, max_iter, dt, abstol, reltol, max_step);
}

template <typename T>
int launch(const void* cin, const void* pars, const void* cols, const void* cosv,
           const void* f, void* cout, void* wint, void* summ, void* avg, void* conv,
           void* iters, void* raw, const void* noise, const void* keys, const void* ou,
           void* eta_out, const void* cross, void* cross_out, const void* wts, int K, int nx,
           int nt, int w0, int s0, int pcr_steps, int max_iter, int ou_mode, int ou_unroll,
           double dt, double abstol, double reltol, double max_step, void* stream) {
  if (K < 1 || nx < 1 || nx > 1024 || nt < 1) return (int)cudaErrorInvalidValue;
  const int threads = ((nx + 31) / 32) * 32;
  const NoiseArgs<T> nz = noise_args<T>(noise, keys, ou, eta_out, cross, cross_out, wts,
                                        ou_mode, ou_unroll);
  const bool noisy = noise != nullptr || keys != nullptr;
  const size_t shmem = (size_t)(6 * threads + 32) * sizeof(T) +
                       (noisy ? noise_shared_bytes<T>(nt, ou_mode) : 0);
  if (shmem > MAX_SHARED_BYTES) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the four builds: NOISY by the noise inputs, COUNT by the count output
  auto run = [&](auto noisy_c, auto count_c) {
    return launch_threads<T, decltype(noisy_c)::value, decltype(count_c)::value>(
        K, threads, shmem, st, cin, pars, cols, cosv, f, cout, wint, summ, avg, conv, iters,
        raw, nz, nx, nt, w0, s0, pcr_steps, max_iter, dt, abstol, reltol, max_step);
  };
  const std::true_type yes;
  const std::false_type no;
  if (noisy) return iters != nullptr ? run(yes, yes) : run(yes, no);
  return iters != nullptr ? run(no, yes) : run(no, no);
}

}  // namespace

extern "C" {

int ebm_miz_year_f32(const void* cin, const void* pars, const void* cols,
                     const void* cosv, const void* f, void* cout, void* wint,
                     void* summ, void* avg, void* conv, void* iters, void* raw,
                     const void* noise, const void* keys, const void* ou, void* eta_out,
                     const void* cross, void* cross_out, const void* wts, int K, int nx,
                     int nt, int w0, int s0, int pcr_steps, int max_iter, int ou_mode,
                     int ou_unroll, double dt, double abstol, double reltol,
                     double max_step, void* stream) {
  return launch<float>(cin, pars, cols, cosv, f, cout, wint, summ, avg, conv, iters, raw,
                       noise, keys, ou, eta_out, cross, cross_out, wts, K, nx, nt, w0, s0,
                       pcr_steps, max_iter, ou_mode, ou_unroll, dt, abstol, reltol,
                       max_step, stream);
}

int ebm_miz_year_f64(const void* cin, const void* pars, const void* cols,
                     const void* cosv, const void* f, void* cout, void* wint,
                     void* summ, void* avg, void* conv, void* iters, void* raw,
                     const void* noise, const void* keys, const void* ou, void* eta_out,
                     const void* cross, void* cross_out, const void* wts, int K, int nx,
                     int nt, int w0, int s0, int pcr_steps, int max_iter, int ou_mode,
                     int ou_unroll, double dt, double abstol, double reltol,
                     double max_step, void* stream) {
  return launch<double>(cin, pars, cols, cosv, f, cout, wint, summ, avg, conv, iters, raw,
                        noise, keys, ou, eta_out, cross, cross_out, wts, K, nx, nt, w0, s0,
                        pcr_steps, max_iter, ou_mode, ou_unroll, dt, abstol, reltol,
                        max_step, stream);
}

const char* ebm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
