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
// CLUSTER build (newton_t0_cluster_kernel, cluster.cuh): one thread-block
// cluster of C blocks per member, rank r owning cells [r slice, (r + 1)
// slice), their PCR rows, their exchange values and, where they fit, their
// records (the iterate and the frozen inputs, a row per field) in its shared
// memory, read across ranks through distributed shared memory behind one
// cluster barrier; records that do not fit (the C side's plan) go to the
// rank's part of a workspace of device memory. The clusters solve members
// m, m + clusters, ...
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
#include "cluster.cuh"
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
  const T ai = scal[4], max_step = scal[6];
  const T0Par<T> par{scal[0], scal[1], scal[2], scal[3], D[m], scal[5], ai};

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
    t0_residual_bands<T, CPT, false, true, false>(T0, cell, par, halo, n, r, lo, di, up);
#pragma unroll
    for (int c = 0; c < CPT; ++c) b[c] = -r[c];
    pcr_solve<T, CPT, true>(lo, di, up, b, s, n, steps);
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

// the most threads per block of the cluster build
constexpr int NEWTON_CLUSTER_THREADS = 512;

// words of T of one block's records in the workspace (records in device
// memory only), rounded up to 32 words so every block's part starts aligned
__host__ __device__ inline size_t newton_cluster_words(int n, int C) {
  return wide_stride((size_t)cluster_slice_cells(n, C) * N_NEWTON_FIELDS);
}

// the block's dynamic shared memory, byte offsets: the PCR rows' two
// buffers at 0, the exchange's two buffers, the records (if shared, a row of
// slice values per field, Rec)
struct NewtonClusterLayout {
  size_t halo, records, total;
};

template <typename T>
__host__ __device__ inline NewtonClusterLayout newton_cluster_layout(int n, int C,
                                                                     bool records_shared) {
  const size_t slice = cluster_slice_cells(n, C);
  NewtonClusterLayout L;
  L.halo = 2 * slice * sizeof(PcrRow<T>);
  L.records = L.halo + align16(2 * slice * sizeof(Pair<T>));
  L.total = L.records + (records_shared ? align16(slice * N_NEWTON_FIELDS * sizeof(T)) : 0);
  return L;
}

// An iteration: each rank puts its cells' (Tb, g) into the exchange buffer
// of this turn, one cluster barrier, each cell's residual and Jacobian row
// (neighbours from whichever rank holds them, zero beyond the grid) into the
// PCR as the row of the update's system (jlo, jdi, jup | -r), one cluster
// barrier, the solve (its right-hand side a negation), and each rank's
// update of its own cells. The buffers alternate, so nothing is rewritten
// before every rank's last read of it.
template <typename T>
__global__ void __launch_bounds__(NEWTON_CLUSTER_THREADS, 1)
    newton_t0_cluster_kernel(const T* __restrict__ T0in, const T* __restrict__ hp,
                             const T* __restrict__ Tw, const T* __restrict__ phi,
                             const T* __restrict__ insol, const T* __restrict__ bands,
                             const T* __restrict__ D, const T* __restrict__ scal,
                             T* __restrict__ T0out, T* ws, int records_shared, int K, int n,
                             int iters, int steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ClusterSlice cs = cluster_slice(n);
  const NewtonClusterLayout L = newton_cluster_layout<T>(n, cs.C, records_shared != 0);
  PcrRow<T>* rows = reinterpret_cast<PcrRow<T>*>(smem_raw);
  ClusterPcr<T> pcr{{rows, rows + cs.slice}, 0};
  Pair<T>* halo[2] = {reinterpret_cast<Pair<T>*>(smem_raw + L.halo),
                      reinterpret_cast<Pair<T>*>(smem_raw + L.halo) + cs.slice};
  int hturn = 0;  // the exchange buffer written next
  T* fld = records_shared ? reinterpret_cast<T*>(smem_raw + L.records)
                          : ws + (size_t)blockIdx.x * newton_cluster_words(n, cs.C);
  const T* glo = bands;
  const T* gdi = bands + n;
  const T* gup = bands + 2 * n;
  const T ai = scal[4], max_step = scal[6];
  const int clusters = gridDim.x / cs.C;
  auto rec = [&](int li) { return Rec<T>{fld + li, cs.slice}; };
  auto cell = [&](int li) {
    const Rec<T> c = rec(li);
    const int i = cs.lo + li;
    return T0Cell<T>{glo[i], gdi[i], gup[i], c[F_PHI], c[F_WATER], c[F_SOLAR], T(0), c[F_KH]};
  };
  // (Tb, g) of cell j, zero beyond the grid
  auto neighbour = [&](Pair<T>* cur, int j) {
    return j < 0 || j >= n ? Pair<T>{T(0), T(0)} : load_pair(cluster_at(cur, cs, j));
  };

  for (size_t m = blockIdx.x / cs.C; m < (size_t)K; m += clusters) {
    const T0Par<T> par{scal[0], scal[1], scal[2], scal[3], D[m], scal[5], ai};
    // the iterate and the loop-invariant terms (k/hp, (1 - phi) Tw, ai insol)
    for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x) {
      const Rec<T> c = rec(li);
      const size_t idx = m * n + cs.lo + li;
      c[F_T0] = T0in[idx];
      c[F_KH] = par.k / hp[idx];
      c[F_PHI] = phi[idx];
      c[F_WATER] = (T(1) - c[F_PHI]) * Tw[idx];
      c[F_SOLAR] = ai * insol[idx];
    }
    for (int it = 0; it < iters; ++it) {
      Pair<T>* cur = halo[hturn];
      hturn ^= 1;
      for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x) {
        const Pair<T> v = t0_tb_g(rec(li)[F_T0], cell(li), par);
        store_pair(cur + li, v.a, v.b);
      }
      cluster_sync();
      for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x) {
        const int i = cs.lo + li;
        T r, jlo, jdi, jup;
        t0_row<T, true, false>(rec(li)[F_T0], cell(li), par, load_pair(cur + li),
                               neighbour(cur, i - 1), neighbour(cur, i + 1), r, jlo, jdi, jup);
        cluster_pcr_row(pcr, li, jlo, jdi, jup, -r);
      }
      cluster_sync();
      const PcrRow<T>* solved = cluster_pcr_solve<T, true>(pcr, cs, steps);
      for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x) {
        const Rec<T> c = rec(li);
        c[F_T0] = c[F_T0] + clip_step(cluster_pcr_x(solved, li), max_step);
      }
    }
    for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x)
      T0out[m * n + cs.lo + li] = rec(li)[F_T0];
  }
  cluster_sync();  // no block leaves while another rank can read its shared memory
}

// The C side's plan of the cluster build (cluster.cuh::choose_cluster): C,
// the threads, the records in shared memory where they fit beside the rows
// and the exchange, and the clusters the card keeps resident; an error when
// it cannot launch.
template <typename T>
cudaError_t newton_cluster_plan(int n, int K, int force_c, ClusterPlan& plan) {
  return choose_cluster(K, force_c, plan, [&](int C, ClusterPlan& p) {
    p.C = C;
    p.threads = cluster_threads(n, C, NEWTON_CLUSTER_THREADS);
    p.records_shared = newton_cluster_layout<T>(n, C, true).total <= CLUSTER_SHARED_BUDGET;
    p.shmem = newton_cluster_layout<T>(n, C, p.records_shared != 0).total;
    if (p.shmem > CLUSTER_SHARED_BUDGET) return cudaErrorInvalidValue;
    return cluster_occupancy(newton_t0_cluster_kernel<T>, p);
  });
}

// the cluster build on min(K, resident) clusters; with the records in device
// memory, each block's at ws + blockIdx.x * newton_cluster_words(n, C)
template <typename T>
int launch_cluster(cudaStream_t stream, const void* T0, const void* hp, const void* Tw,
                   const void* phi, const void* insol, const void* bands, const void* D,
                   const void* scal, void* out, void* ws, int K, int n, int iters, int steps,
                   int ws_words, int ws_blocks, int force_c) {
  ClusterPlan plan;
  const cudaError_t err = newton_cluster_plan<T>(n, K, force_c, plan);
  if (err != cudaSuccess) return (int)err;
  const int clusters = K < plan.clusters ? K : plan.clusters;
  if (!plan.records_shared &&
      (ws == nullptr || (size_t)ws_words != newton_cluster_words(n, plan.C) ||
       ws_blocks < clusters * plan.C))
    return (int)cudaErrorInvalidValue;
  return (int)cluster_launch(
      newton_t0_cluster_kernel<T>, plan, clusters, stream, static_cast<const T*>(T0),
      static_cast<const T*>(hp), static_cast<const T*>(Tw), static_cast<const T*>(phi),
      static_cast<const T*>(insol), static_cast<const T*>(bands), static_cast<const T*>(D),
      static_cast<const T*>(scal), static_cast<T*>(out), static_cast<T*>(ws),
      plan.records_shared, K, n, iters, steps);
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
           int force_c, void* stream) {
  if (K < 1 || n < 1 || n > MAX_WIDE_N || iters < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 4096)
    return launch_cluster<T>(st, T0, hp, Tw, phi, insol, bands, D, scal, out, ws, K, n, iters,
                             steps, ws_words, ws_blocks, force_c);
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
                      int ws_blocks, int force_c, void* stream) {
  return launch<float>(T0, hp, Tw, phi, insol, bands, D, scal, out, ws, K, n, iters, steps,
                       ws_words, ws_blocks, force_c, stream);
}

int ebm_newton_t0_f64(const void* T0, const void* hp, const void* Tw, const void* phi,
                      const void* insol, const void* bands, const void* D, const void* scal,
                      void* out, void* ws, int K, int n, int iters, int steps, int ws_words,
                      int ws_blocks, int force_c, void* stream) {
  return launch<double>(T0, hp, Tw, phi, insol, bands, D, scal, out, ws, K, n, iters, steps,
                        ws_words, ws_blocks, force_c, stream);
}

// the cluster build's plan for K members of n cells: out = {C, threads,
// records in shared memory (1) or in the workspace (0), resident clusters,
// shared bytes}
int ebm_newton_t0_plan_f32(int n, int K, int force_c, int* out) {
  if (n <= 4096 || n > MAX_WIDE_N || K < 1) return (int)cudaErrorInvalidValue;
  ClusterPlan p;
  const cudaError_t err = newton_cluster_plan<float>(n, K, force_c, p);
  if (err == cudaSuccess) plan_out(p, out);
  return (int)err;
}

int ebm_newton_t0_plan_f64(int n, int K, int force_c, int* out) {
  if (n <= 4096 || n > MAX_WIDE_N || K < 1) return (int)cudaErrorInvalidValue;
  ClusterPlan p;
  const cudaError_t err = newton_cluster_plan<double>(n, K, force_c, p);
  if (err == cudaSuccess) plan_out(p, out);
  return (int)err;
}

}  // extern "C"
