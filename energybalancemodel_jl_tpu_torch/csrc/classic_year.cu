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
//     per thread);
//   - nx > 4096 (up to 32768, the JAX package's fused single-run reach):
//     the CLUSTER build (classic_cluster_kernel, below), one thread-block
//     cluster per member, each block owning a slice of the cells, the Tg
//     system solved by chunks with only the chunks' interface rows in the
//     cluster PCR, in the owners' shared memory (cluster.cuh).
//
// Each thread of the register builds keeps its cells' carry (E, Tg), their per-member constants
// (insolation factor S0 - S2 x^2, water coalbedo, implicit-matrix bands) and
// the three annual sums in registers for all nt steps (the deterministic
// and the float64 warp builds keep the constants in the warp's shared
// memory). Device memory sees
// one read of the carry and one write of carry + seasonal store per simulated
// year; a raw-collected year (raw != nullptr) also writes every step's three
// outputs, raw[t][var][member][cell].
//
// Per step (models/classic.py::step, line for line, same operation order, the
// fused multiply-adds at its sites as fma_rn; C by the year's first step or not):
//   - insolation rows S_i and the wraparound S_{i+1} rebuilt from
//     (S0 - S2 x^2) - (S1 cos 2pi t) x, forcing f[t] + F;
//   - the albedo switch (zero at E == 0), T0, the three-regime T from the
//     pre-update E, the explicit E update;
//   - the implicit Tg step: the member's bands, kdi masked by the updated E,
//     one row-scaled PCR solve (common.cuh: pcr_solve in shared memory for a
//     block, warp_pcr_solve in registers for a warp; the cluster build's
//     chunked solve, below);
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
#include "cluster.cuh"
#include "common.cuh"
#include "noise.cuh"

namespace {

constexpr int N_OUT = 3;
// member parameter row, ops/classic_year.py ROW_NAMES
enum Row {
  P_CG_TAU, P_DT_TAU, P_DC, P_M, P_KLF, P_DTD, P_CG, P_AI, P_A, P_FB, P_CW, P_LF,
  P_F, P_S0, P_S1, P_S2, P_A0, P_A2, N_ROWS
};

// the member's scalars that a cell's step reads
template <typename T>
struct ClassicMember {
  T cg_tau, dt_tau, dc, M, kLf, ai, A, Fb, cw, Lf;
};

// One cell's step before the implicit solve (models/classic.py::step): from
// the carry (E, Tg) and the cell's constants, the updated E, the step's
// outputs (E, T, h) and the cell's row of the Tg system (di, b; lo and up
// are the member's constant bands). Shared by the block and cluster builds.
template <typename T>
struct ClassicCell {
  T out[N_OUT];  // En, Tc, h
  T di, b;
};

// C = alpha S_i + cg_tau Tg - A + f, with XLA:CPU's contraction: cg_tau Tg
// in a year's first step (`first`, which the JAX package's scan peels),
// alpha S_i in the others (models/classic.py::step)
template <typename T>
__device__ __forceinline__ T classic_C(T alpha, T S_i, T cg_tau, T Tgc, T A, T f, bool first) {
  const T s = first ? fma_rn(cg_tau, Tgc, alpha * S_i) : fma_rn(alpha, S_i, cg_tau * Tgc);
  return s - A + f;
}

template <typename T>
__device__ __forceinline__ ClassicCell<T> classic_cell(const ClassicMember<T>& p, T Ec, T Tgc,
                                                       T xc, T SA, T aw, T kdi0, T s1c, T s1n,
                                                       T f, T dt, bool first) {
  const T pos = Ec > T(0) ? T(1) : T(0);
  const T neg = Ec < T(0) ? T(1) : T(0);
  const T nonneg = Ec >= T(0) ? T(1) : T(0);
  const T alpha = aw * pos + p.ai * neg;  // zero at E == 0
  const T S_i = fma_rn(-s1c, xc, SA);
  const T C = classic_C(alpha, S_i, p.cg_tau, Tgc, p.A, f, first);
  const T T0 = Ec == T(0) ? T(0) : C / (p.M - p.kLf / Ec);
  const T t0neg = T0 < T(0) ? T(1) : T(0);
  const T Tc = Ec / p.cw * nonneg + T0 * (neg * t0neg);  // pre-update E
  const T En = fma_rn(fma_rn(-p.M, Tc, C) + p.Fb, dt, Ec);

  const T negn = En < T(0) ? T(1) : T(0);
  const T nonnegn = En >= T(0) ? T(1) : T(0);
  const T denom = p.M - p.kLf / (En == T(0) ? T(1) : En);
  const T mask = t0neg * negn;
  const T S_ip1 = fma_rn(-s1n, xc, SA);  // the wraparound row S_{i+1}
  ClassicCell<T> r;
  r.di = kdi0 - p.dc / denom * mask;
  r.b = fma_rn(p.dt_tau,
               En / p.cw * nonnegn + (fma_rn(p.ai, S_ip1, -p.A) + f) / denom * mask, Tgc);
  r.out[0] = En;
  r.out[1] = Tc;
  r.out[2] = En < T(0) ? -En / p.Lf : T(0);  // +0 where ice-free, as XLA selects
  return r;
}

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
  const ClassicMember<T> mb{cg_tau, dt_tau, dc, M, kLf, ai, A, Fb, cw, Lf};

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
    SA[c] = fma_rn(-S2, x2, S0);
    aw[c] = fma_rn(-a2, x2, a0);
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
      const ClassicCell<T> r = classic_cell(mb, E[c], Tg[c], x[c], SA[c], aw[c], kdi0[c], s1c,
                                            s1n, f, dt, t == 0);
      lo[c] = klo[c];
      di[c] = r.di;
      up[c] = kup[c];
      b[c] = r.b;
#pragma unroll
      for (int v = 0; v < N_OUT; ++v) out[c][v] = r.out[v];
      E[c] = r.out[0];
    }
    pcr_solve<T, CPT, false>(lo, di, up, b, s, nx, pcr_steps);

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

// THE CLUSTER BUILD (4096 < nx <= MAX_WIDE_NX, cluster.cuh): one cluster of
// C blocks per member, rank r owning cells [r slice, (r + 1) slice), the
// slice ceil(nx / C) rounded up to whole chunks of CHUNK_ROWS cells; the
// clusters loop over members m, m + clusters, ... Each cell's record (its
// carry, constants and three sums) lives in its rank's shared memory, or,
// where the records and the rows would not fit there together (the C side's
// plan), in the rank's part of a workspace of device memory.
//
// The Tg system is solved by chunks (ops/tridiag.py::chunked_solve, the
// hybrid Thomas-PCR scheme): a thread owns whole chunks; for each it runs
// classic_cell on the chunk's cells (their sums, stores and crossing
// values), eliminating each row as it comes (the forward pass) and then
// backward, in registers, down to the chunk's two interface rows. Those go
// to the rank's shared memory as rows 2j, 2j + 1 of the interface system of
// 2 ceil(nx / CHUNK_ROWS) rows, which the cluster PCR solves after one
// cluster barrier (after which rank 0 sums the crossing area in the block
// layout's order); each thread then recovers its chunks' interior rows from
// their two solved interface values, with no division. Chunks are global
// (rows [CHUNK_ROWS j, CHUNK_ROWS j + CHUNK_ROWS), identity rows beyond the
// grid) and never straddle a rank, so every value is the plain version's
// whatever C and the threads.
//
// What bounds it: a single run is one member, so its year is the latency of
// its chain. A step is the chunks' classic_cell and elimination (about nine
// IEEE divisions a cell, each thread's chunk a dependent chain), then
// ceil(log2(2 ceil(nx / CHUNK_ROWS))) PCR levels of two divisions a row
// over a quarter as many rows as cells, a cluster barrier between two levels
// and distributed-shared-memory loads at the levels whose stride leaves the
// rank. A PCR over all nx rows would spend two divisions a cell at each of
// ceil(log2 nx) levels: at nx = 32768 in float64 it took 75% of the year
// (PERF.md §6).
constexpr int MAX_WIDE_NX = 32768;
// a cell's record: the carry, the member's constants for the cell, the sums
enum ClusterField { W_E, W_TG, W_X, W_SA, W_AW, W_KLO, W_KDI0, W_KUP, W_ACC,
                    N_CLUSTER_FIELDS = W_ACC + N_OUT };

// rows per chunk of the Tg solve, ops/tridiag.py CHUNK
constexpr int CHUNK_ROWS = 8;

// the most threads per block: a thread's step (its chunk's cells and rows)
// needs up to 255 registers, which 256 threads leave
template <typename T>
__host__ __device__ constexpr int classic_cluster_threads() {
  return 256;
}

// the most chunks a thread owns: a slice of at most half the widest grid
// (C >= 2) on the most threads; the first in registers, the others in
// local memory (only where C is narrow for the width)
template <typename T>
__host__ __device__ constexpr int classic_chunk_slots() {
  return (MAX_WIDE_NX / 2 / CHUNK_ROWS + classic_cluster_threads<T>() - 1) /
         classic_cluster_threads<T>();
}

// a rank's cells: ceil(nx / C) rounded up to whole chunks
__host__ __device__ inline int classic_cluster_slice(int nx, int C) {
  return (cluster_slice_cells(nx, C) + CHUNK_ROWS - 1) / CHUNK_ROWS * CHUNK_ROWS;
}

// this rank's part [rank slice, rank slice + cnt) of an n-item array cut in
// slices of `slice` (cluster.cuh's ClusterSlice with a given slice)
__device__ __forceinline__ ClusterSlice classic_slice(int n, int slice) {
  const cg::cluster_group cl = cg::this_cluster();
  ClusterSlice s;
  s.n = n;
  s.C = (int)cl.num_blocks();
  s.rank = (int)cl.block_rank();
  s.slice = slice;
  s.lo = s.rank * slice;
  const int left = n - s.lo;
  s.cnt = left < 0 ? 0 : (left < slice ? left : slice);
  s.magic = (unsigned)((0x100000000ull + (unsigned)slice - 1) / (unsigned)slice);
  return s;
}

// words of T of one block's records in the workspace (records in device
// memory only), rounded up to 32 words so every block's part starts aligned
__host__ __device__ inline size_t classic_cluster_words(int nx, int C) {
  return wide_stride((size_t)classic_cluster_slice(nx, C) * N_CLUSTER_FIELDS);
}

// The record of cell k of the rank's chunk j (local cell j CHUNK_ROWS + k):
// a row of slice values per field, chunk-major within it (k chunks + j), so
// the threads of a warp, each at its own chunk, touch consecutive words.
template <typename T>
__device__ __forceinline__ Rec<T> chunk_rec(T* fld, int slice, int j, int k) {
  return Rec<T>{fld + k * (slice / CHUNK_ROWS) + j, slice};
}

// A chunk's rows as the elimination leaves them: row k reads x_k + a[k] x_0
// + c[k] x_{k+1} = d[k] after the forward pass, and, after the backward
// pass, x_k + a[k] x_0 + c[k] x_{M-1} = d[k] for 0 < k < M - 1 and x_0 +
// a[0] x_{-1} + c[0] x_{M-1} = d[0] (M = CHUNK_ROWS; x_{-1} and x_M are the
// neighbouring chunks' last and first unknowns): rows 0 and M - 1 are the
// interface rows. The operations of ops/tridiag.py::chunked_solve, in order.
template <typename T>
struct ChunkRows {
  T a[CHUNK_ROWS], c[CHUNK_ROWS], d[CHUNK_ROWS];
};

// the forward pass's row k, from the row (lo, di, up, b)
template <typename T>
__device__ __forceinline__ void chunk_forward(ChunkRows<T>& q, int k, T lo, T di, T up, T b) {
  if (k < 2) {
    const T r = safe_div(T(1), di);
    q.a[k] = lo * r;
    q.c[k] = up * r;
    q.d[k] = b * r;
    return;
  }
  const T r = safe_div(T(1), fma_rn(-lo, q.c[k - 1], di));
  q.d[k] = r * fma_rn(-lo, q.d[k - 1], b);
  q.a[k] = -(r * lo) * q.a[k - 1];
  q.c[k] = r * up;
}

// the backward pass and row 0's fold of row 1
template <typename T>
__device__ __forceinline__ void chunk_backward(ChunkRows<T>& q) {
#pragma unroll
  for (int k = CHUNK_ROWS - 3; k > 0; --k) {
    q.d[k] = fma_rn(-q.c[k], q.d[k + 1], q.d[k]);
    q.a[k] = fma_rn(-q.c[k], q.a[k + 1], q.a[k]);
    q.c[k] = -(q.c[k] * q.c[k + 1]);
  }
  const T r = safe_div(T(1), fma_rn(-q.c[0], q.a[1], T(1)));
  q.d[0] = r * fma_rn(-q.c[0], q.d[1], q.d[0]);
  q.a[0] = r * q.a[0];
  q.c[0] = -(r * (q.c[0] * q.c[1]));
}

// the block's dynamic shared memory, byte offsets: the interface rows' two
// PCR buffers at 0, the records (if shared, Rec), the slots of the crossing
// sum, the crossing values, the noise rows
struct ClassicClusterLayout {
  size_t records, cross, vals, noise, total;
};

template <typename T>
__host__ __device__ inline ClassicClusterLayout classic_cluster_layout(int nx, int C,
                                                                       bool records_shared,
                                                                       size_t noise_bytes) {
  const size_t slice = classic_cluster_slice(nx, C);
  ClassicClusterLayout L;
  L.records = 2 * (2 * slice / CHUNK_ROWS) * sizeof(PcrRow<T>);
  L.cross = L.records + (records_shared ? align16(slice * N_CLUSTER_FIELDS * sizeof(T)) : 0);
  L.vals = L.cross + align16(RED_SLOTS * sizeof(T));
  L.noise = L.vals + align16(slice * sizeof(T));
  L.total = L.noise + align16(noise_bytes);
  return L;
}

template <typename T, bool NOISY>
__global__ void __launch_bounds__(classic_cluster_threads<T>(), 1)
    classic_cluster_kernel(const T* __restrict__ cin, const T* __restrict__ pars,
                           const T* __restrict__ cols, const T* __restrict__ cosv,
                           const T* __restrict__ fyear, T* __restrict__ cout,
                           T* __restrict__ wint, T* __restrict__ summ, T* __restrict__ avg,
                           T* __restrict__ raw, NoiseArgs<T> nz, T* ws, int records_shared, int K,
                           int nx, int nt, int w0, int s0, int pcr_steps, T dt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T p[N_ROWS];
  const int C = (int)cg::this_cluster().num_blocks();
  // the rank's cells, and its rows of the interface system (two a chunk)
  const ClusterSlice cs = classic_slice(nx, classic_cluster_slice(nx, C));
  const ClusterSlice is =
      classic_slice(2 * ((nx + CHUNK_ROWS - 1) / CHUNK_ROWS), 2 * cs.slice / CHUNK_ROWS);
  const ClassicClusterLayout L = classic_cluster_layout<T>(
      nx, C, records_shared != 0, NOISY ? noise_shared_bytes<T>(nt, nz.ou_mode) : 0);
  PcrRow<T>* rows = reinterpret_cast<PcrRow<T>*>(smem_raw);
  ClusterPcr<T> pcr{{rows, rows + is.slice}, 0};
  T* fld = records_shared ? reinterpret_cast<T*>(smem_raw + L.records)
                          : ws + (size_t)blockIdx.x * classic_cluster_words(nx, C);
  RedSmem<T> cross_red{reinterpret_cast<T*>(smem_raw + L.cross), 0};
  T* xv = reinterpret_cast<T*>(smem_raw + L.vals);
  T* noise_row = reinterpret_cast<T*>(smem_raw + L.noise);
  const size_t plane = (size_t)K * nx;
  const bool crossing = NOISY && nz.cross_out != nullptr;
  const int clusters = gridDim.x / C;
  const int chunks = is.cnt / 2;  // this rank's chunks that hold cells
  // the thread's chunks j = threadIdx.x + q blockDim.x, q < slots, after
  // their elimination: the first R in registers (one; none in the float64
  // noisy build, whose noise state leaves no room), the others in local memory
  const int tid = (int)threadIdx.x, threads = (int)blockDim.x;
  const int slots = tid < chunks ? (chunks - 1 - tid) / threads + 1 : 0;
  constexpr int R = NOISY && sizeof(T) == 8 ? 0 : 1;
  ChunkRows<T> held, more[classic_chunk_slots<T>() - R];

  for (int m = blockIdx.x / C; m < K; m += clusters) {
    __syncthreads();  // the last member's reads of p and of the noise row are done
    if (threadIdx.x < N_ROWS) p[threadIdx.x] = pars[(size_t)m * N_ROWS + threadIdx.x];
    __syncthreads();
    const T dt_tau = p[P_DT_TAU], dtD = p[P_DTD], cg = p[P_CG], S0 = p[P_S0], S2 = p[P_S2],
            a0 = p[P_A0], a2 = p[P_A2];
    for (int j = threadIdx.x; j < chunks; j += blockDim.x) {
      for (int k = 0; k < CHUNK_ROWS && j * CHUNK_ROWS + k < cs.cnt; ++k) {
        const Rec<T> c = chunk_rec(fld, cs.slice, j, k);
        const int i = cs.lo + j * CHUNK_ROWS + k;
        c[W_X] = cols[i];
        const T x2 = cols[nx + i];
        c[W_SA] = fma_rn(-S2, x2, S0);
        c[W_AW] = fma_rn(-a2, x2, a0);
        c[W_KLO] = -dtD * cols[2 * nx + i] / cg;
        c[W_KDI0] = (T(1) + dt_tau) - dtD * cols[3 * nx + i] / cg;
        c[W_KUP] = -dtD * cols[4 * nx + i] / cg;
        c[W_E] = cin[(size_t)m * nx + i];
        c[W_TG] = cin[plane + (size_t)m * nx + i];
        for (int v = 0; v < N_OUT; ++v) c[W_ACC + v] = T(0);
      }
    }

    NoiseState<T> ns;
    if (NOISY) ns = noise_begin(nz, noise_row, m, K, nt);

    for (int t = 0; t < nt; ++t) {
      // the member's scalars, read from shared memory each step: registers
      // are scarce across the solve
      const ClassicMember<T> mb{p[P_CG_TAU], p[P_DT_TAU], p[P_DC], p[P_M], p[P_KLF],
                                p[P_AI],     p[P_A],      p[P_FB], p[P_CW], p[P_LF]};
      const T s1c = p[P_S1] * cosv[t];
      const T s1n = p[P_S1] * cosv[t + 1];  // the wraparound row S_{i+1}
      T f = fyear[t] + p[P_F];
      if (NOISY) f = noise_forcing(nz, ns, f, t);
      // chunk j's cells, then their rows eliminated into e (the cells first:
      // fewer values live at once) and its interface rows written
      auto eliminate = [&](int j, ChunkRows<T>& e) {
        T di[CHUNK_ROWS], b[CHUNK_ROWS];
#pragma unroll
        for (int k = 0; k < CHUNK_ROWS; ++k) {
          const int li = j * CHUNK_ROWS + k;
          di[k] = T(1);  // the identity row beyond the grid
          b[k] = T(0);
          if (li < cs.cnt) {
            const Rec<T> c = chunk_rec(fld, cs.slice, j, k);
            const int i = cs.lo + li;
            const ClassicCell<T> r = classic_cell(mb, c[W_E], c[W_TG], c[W_X], c[W_SA],
                                                  c[W_AW], c[W_KDI0], s1c, s1n, f, dt, t == 0);
            c[W_E] = r.out[0];
            // step 0's outputs seed the sums, as in the plain version
            for (int v = 0; v < N_OUT; ++v)
              c[W_ACC + v] = t == 0 ? r.out[v] : c[W_ACC + v] + r.out[v];
            const size_t idx = (size_t)m * nx + i;
            if (t == w0 || t == s0) {
              T* snap = t == w0 ? wint : summ;
              for (int v = 0; v < N_OUT; ++v) snap[v * plane + idx] = r.out[v];
              if (t == w0 && t == s0) {
                for (int v = 0; v < N_OUT; ++v) summ[v * plane + idx] = r.out[v];
              }
            }
            if (raw != nullptr) {
              T* row = raw + (size_t)t * N_OUT * plane;
              for (int v = 0; v < N_OUT; ++v) row[v * plane + idx] = r.out[v];
            }
            if (crossing) xv[li] = nz.wts[i] * (r.out[0] < T(0) ? T(1) : T(0));
            di[k] = r.di;
            b[k] = r.b;
          }
        }
#pragma unroll
        for (int k = 0; k < CHUNK_ROWS; ++k) {
          const bool cell = j * CHUNK_ROWS + k < cs.cnt;
          const Rec<T> c = chunk_rec(fld, cs.slice, j, k);
          chunk_forward(e, k, cell ? c[W_KLO] : T(0), di[k], cell ? c[W_KUP] : T(0), b[k]);
        }
        chunk_backward(e);
        // the interior rows' right-hand sides wait in their cells' Tg, which
        // their classic_cell has read and the recovery writes: fewer registers
        // across the solve
#pragma unroll
        for (int k = 1; k < CHUNK_ROWS - 1; ++k) chunk_rec(fld, cs.slice, j, k)[W_TG] = e.d[k];
        // the interface rows in the first level's form (cluster_pcr_row of a
        // row whose diagonal is 1: the scale 1 / 1 = 1 changes no bit)
        constexpr int L = CHUNK_ROWS - 1;
        store_row(pcr.buf[pcr.start] + 2 * j, e.a[0], T(1), e.c[0], e.d[0]);
        store_row(pcr.buf[pcr.start] + 2 * j + 1, e.a[L], T(1), e.c[L], e.d[L]);
      };
      // the first chunk last, so that only its rows stay in registers
#pragma unroll 1
      for (int q = slots - 1; q >= R; --q) eliminate(tid + q * threads, more[q - R]);
      if (R > 0 && slots > 0) eliminate(tid, held);
      cluster_sync();  // every rank's interface rows (and crossing values) are written
      if (crossing && cs.rank == 0) cluster_noise_crossing(ns, xv, cs, cross_red, t);
      const PcrRow<T>* solved = cluster_pcr_solve<T, false>(pcr, is, pcr_steps);
      __syncthreads();  // the last level's rows, written by other threads of the rank
      // chunk j's Tg from its interface values, the interior rows by e and
      // their right-hand sides
      auto recover = [&](int j, const ChunkRows<T>& e) {
        const T x0 = cluster_pcr_x(solved, 2 * j), xl = cluster_pcr_x(solved, 2 * j + 1);
#pragma unroll
        for (int k = 0; k < CHUNK_ROWS; ++k) {
          if (j * CHUNK_ROWS + k >= cs.cnt) break;
          T& tg = chunk_rec(fld, cs.slice, j, k)[W_TG];
          tg = k == 0 ? x0
                      : (k == CHUNK_ROWS - 1 ? xl : fma_rn(-e.c[k], xl, fma_rn(-e.a[k], x0, tg)));
        }
      };
      if (R > 0 && slots > 0) recover(tid, held);
#pragma unroll 1
      for (int q = R; q < slots; ++q) recover(tid + q * threads, more[q - R]);
    }
    if (NOISY && cs.rank == 0) noise_end(nz, ns, m, nt);

    // same `sum / nt` arithmetic as the JAX kernel and storage path
    const T ntf = T(nt);
    for (int j = threadIdx.x; j < chunks; j += blockDim.x) {
      for (int k = 0; k < CHUNK_ROWS && j * CHUNK_ROWS + k < cs.cnt; ++k) {
        const Rec<T> c = chunk_rec(fld, cs.slice, j, k);
        const size_t idx = (size_t)m * nx + cs.lo + j * CHUNK_ROWS + k;
        cout[idx] = c[W_E];
        cout[plane + idx] = c[W_TG];
        for (int v = 0; v < N_OUT; ++v) avg[v * plane + idx] = c[W_ACC + v] / ntf;
      }
    }
  }
  cluster_sync();  // no block leaves while another rank can read its shared memory
}

// The C side's plan of the cluster build (cluster.cuh::choose_cluster): C,
// the threads (a chunk each, at most the build's), the records in shared
// memory where they fit beside the rest, and the clusters the card keeps
// resident; an error when it cannot launch.
template <typename T, bool NOISY>
cudaError_t classic_cluster_plan(int nx, int nt, int K, int ou_mode, int force_c,
                                 ClusterPlan& plan) {
  const size_t noise = NOISY ? noise_shared_bytes<T>(nt, ou_mode) : 0;
  return choose_cluster(K, force_c, plan, [&](int C, ClusterPlan& p) {
    p.C = C;
    const int chunks = classic_cluster_slice(nx, C) / CHUNK_ROWS;
    const int t = round_up_32(chunks);
    p.threads = t < classic_cluster_threads<T>() ? t : classic_cluster_threads<T>();
    if ((chunks + p.threads - 1) / p.threads > classic_chunk_slots<T>())
      return cudaErrorInvalidValue;
    p.records_shared = classic_cluster_layout<T>(nx, C, true, noise).total <= CLUSTER_SHARED_BUDGET;
    p.shmem = classic_cluster_layout<T>(nx, C, p.records_shared != 0, noise).total;
    if (p.shmem > CLUSTER_SHARED_BUDGET) return cudaErrorInvalidValue;
    return cluster_occupancy(classic_cluster_kernel<T, NOISY>, p);
  });
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
      SAr[s] = fma_rn(-S2, x2, S0);
      awr[s] = fma_rn(-a2, x2, a0);
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
      const T S_i = fma_rn(-s1c, xc, SA);
      const T C = classic_C(alpha, S_i, cg_tau, Tg[s], A, f, t == 0);
      const T T0 = Ec == T(0) ? T(0) : C / (M - kLf / Ec);
      const T t0neg = T0 < T(0) ? T(1) : T(0);
      const T Tc = Ec / cw * nonneg + T0 * (neg * t0neg);  // pre-update E
      const T En = fma_rn(fma_rn(-M, Tc, C) + Fb, dt, Ec);

      const T negn = En < T(0) ? T(1) : T(0);
      const T nonnegn = En >= T(0) ? T(1) : T(0);
      const T denom = M - kLf / (En == T(0) ? T(1) : En);
      const T mask = t0neg * negn;
      const T S_ip1 = fma_rn(-s1n, xc, SA);  // the wraparound row S_{i+1}
      lo[s] = CONSTS_SHARED ? c[3 * 32 * S] : klor[s];
      di[s] = (CONSTS_SHARED ? c[4 * 32 * S] : kdi0r[s]) - dc / denom * mask;
      up[s] = CONSTS_SHARED ? c[5 * 32 * S] : kupr[s];
      b[s] = fma_rn(dt_tau, En / cw * nonnegn + (fma_rn(ai, S_ip1, -A) + f) / denom * mask,
                    Tg[s]);
      const T out[N_OUT] = {En, Tc, En < T(0) ? -En / Lf : T(0)};
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
    warp_pcr_solve<T, S, false>(lo, di, up, b, nx, pcr_steps, lane);
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

// the cluster build on min(K, resident) clusters; with the records in
// device memory, each block's at ws + blockIdx.x * classic_cluster_words(nx, C)
template <typename T, bool NOISY>
int launch_cluster(cudaStream_t stream, const void* cin, const void* pars, const void* cols,
                   const void* cosv, const void* f, void* cout, void* wint, void* summ, void* avg,
                   void* raw, const NoiseArgs<T>& nz, void* ws, int ws_words, int ws_blocks,
                   int force_c, int K, int nx, int nt, int w0, int s0, int pcr_steps, double dt) {
  ClusterPlan plan;
  const cudaError_t err = classic_cluster_plan<T, NOISY>(nx, nt, K, nz.ou_mode, force_c, plan);
  if (err != cudaSuccess) return (int)err;
  const int clusters = K < plan.clusters ? K : plan.clusters;
  if (!plan.records_shared &&
      (ws == nullptr || (size_t)ws_words != classic_cluster_words(nx, plan.C) ||
       ws_blocks < clusters * plan.C))
    return (int)cudaErrorInvalidValue;
  return (int)cluster_launch(
      classic_cluster_kernel<T, NOISY>, plan, clusters, stream, static_cast<const T*>(cin),
      static_cast<const T*>(pars), static_cast<const T*>(cols), static_cast<const T*>(cosv),
      static_cast<const T*>(f), static_cast<T*>(cout), static_cast<T*>(wint),
      static_cast<T*>(summ), static_cast<T*>(avg), static_cast<T*>(raw), nz,
      static_cast<T*>(ws), plan.records_shared, K, nx, nt, w0, s0, pcr_steps, T(dt));
}

template <typename T, bool NOISY>
int launch_noise(cudaStream_t st, const void* cin, const void* pars, const void* cols,
                 const void* cosv, const void* f, void* cout, void* wint, void* summ,
                 void* avg, void* raw, const NoiseArgs<T>& nz, void* ws, int ws_words,
                 int ws_blocks, int force_c, int K, int nx, int nt, int w0, int s0,
                 int pcr_steps, double dt, int warp_min_k) {
  if (nx > 4096)
    return launch_cluster<T, NOISY>(st, cin, pars, cols, cosv, f, cout, wint, summ, avg, raw,
                                    nz, ws, ws_words, ws_blocks, force_c, K, nx, nt, w0, s0,
                                    pcr_steps, dt);
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
           const void* cross, void* cross_out, const void* wts, void* ws, int K, int nx,
           int nt, int w0, int s0, int pcr_steps, int ou_mode, int ou_unroll, int warp_min_k,
           int ws_words, int ws_blocks, int force_c, double dt, void* stream) {
  if (K < 1 || nx < 1 || nx > MAX_WIDE_NX || nt < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const NoiseArgs<T> nz = noise_args<T>(noise, keys, ou, eta_out, cross, cross_out, wts,
                                        ou_mode, ou_unroll);
  if (noise != nullptr || keys != nullptr)
    return launch_noise<T, true>(st, cin, pars, cols, cosv, f, cout, wint, summ, avg, raw,
                                 nz, ws, ws_words, ws_blocks, force_c, K, nx, nt, w0, s0,
                                 pcr_steps, dt, warp_min_k);
  return launch_noise<T, false>(st, cin, pars, cols, cosv, f, cout, wint, summ, avg, raw,
                                nz, ws, ws_words, ws_blocks, force_c, K, nx, nt, w0, s0,
                                pcr_steps, dt, warp_min_k);
}

// the plan of the cluster build for nx: out = {C, threads, records in shared
// memory (1) or in the workspace (0), resident clusters, dynamic shared
// bytes per block}
template <typename T>
int plan(int nx, int nt, int K, int noisy, int ou_mode, int force_c, int* out) {
  if (nx <= 4096 || nx > MAX_WIDE_NX || nt < 1 || K < 1) return (int)cudaErrorInvalidValue;
  ClusterPlan p;
  const cudaError_t err = noisy ? classic_cluster_plan<T, true>(nx, nt, K, ou_mode, force_c, p)
                                : classic_cluster_plan<T, false>(nx, nt, K, ou_mode, force_c, p);
  if (err == cudaSuccess) plan_out(p, out);
  return (int)err;
}

}  // namespace

extern "C" {

int ebm_classic_year_f32(const void* cin, const void* pars, const void* cols,
                         const void* cosv, const void* f, void* cout, void* wint,
                         void* summ, void* avg, void* raw, const void* noise,
                         const void* keys, const void* ou, void* eta_out, const void* cross,
                         void* cross_out, const void* wts, void* ws, int K, int nx, int nt,
                         int w0, int s0, int pcr_steps, int ou_mode, int ou_unroll,
                         int warp_min_k, int ws_words, int ws_blocks, int force_c, double dt,
                         void* stream) {
  return launch<float>(cin, pars, cols, cosv, f, cout, wint, summ, avg, raw, noise, keys, ou,
                       eta_out, cross, cross_out, wts, ws, K, nx, nt, w0, s0, pcr_steps,
                       ou_mode, ou_unroll, warp_min_k, ws_words, ws_blocks, force_c, dt, stream);
}

int ebm_classic_year_f64(const void* cin, const void* pars, const void* cols,
                         const void* cosv, const void* f, void* cout, void* wint,
                         void* summ, void* avg, void* raw, const void* noise,
                         const void* keys, const void* ou, void* eta_out, const void* cross,
                         void* cross_out, const void* wts, void* ws, int K, int nx, int nt,
                         int w0, int s0, int pcr_steps, int ou_mode, int ou_unroll,
                         int warp_min_k, int ws_words, int ws_blocks, int force_c, double dt,
                         void* stream) {
  return launch<double>(cin, pars, cols, cosv, f, cout, wint, summ, avg, raw, noise, keys, ou,
                        eta_out, cross, cross_out, wts, ws, K, nx, nt, w0, s0, pcr_steps,
                        ou_mode, ou_unroll, warp_min_k, ws_words, ws_blocks, force_c, dt, stream);
}

int ebm_classic_year_plan_f32(int nx, int nt, int K, int noisy, int ou_mode, int force_c,
                              int* out) {
  return plan<float>(nx, nt, K, noisy, ou_mode, force_c, out);
}

int ebm_classic_year_plan_f64(int nx, int nt, int K, int noisy, int ou_mode, int force_c,
                              int* out) {
  return plan<double>(nx, nt, K, noisy, ou_mode, force_c, out);
}

}  // extern "C"
