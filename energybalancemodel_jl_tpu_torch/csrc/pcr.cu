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
//   - n > 4096 (up to 32768): the CLUSTER build (pcr_cluster_kernel,
//     cluster.cuh), one thread-block cluster of C blocks per system, rank r
//     holding rows [r slice, (r + 1) slice) in its shared memory and reading
//     the other ranks' rows through distributed shared memory behind one
//     cluster barrier per level (per pair of levels in float32 where a block
//     holds a row per thread); the clusters solve systems m, m + clusters,
//     ... The C side plans C (ebm_pcr_plan_*).
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
#include "cluster.cuh"

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
  pcr_solve<T, CPT, false>(l, d, u, r, s, n, steps);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < n) x[m * n + i] = r[c];
  }
}

constexpr int MAX_WIDE_N = 32768;

// the most threads per block of the cluster build: 512 leave a thread the
// 128 registers a level's batch of rows takes (1024 spilled)
constexpr int PCR_CLUSTER_THREADS = 512;

// The cluster build: each rank writes its rows of system m to the buffer
// the last solve wrote (each thread read back only its own rows of it),
// one cluster barrier, the solve, and each rank writes its rows' solution.
// The next system's rows follow the same way: the barrier before its solve
// is reached by every rank only after its reads of this one.
template <typename T>
__global__ void __launch_bounds__(PCR_CLUSTER_THREADS, 1)
    pcr_cluster_kernel(const T* __restrict__ lo, const T* __restrict__ di,
                       const T* __restrict__ up, const T* __restrict__ b, T* __restrict__ x,
                       int K, int n, int lo_stride, int di_stride, int up_stride, int steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ClusterSlice cs = cluster_slice(n);
  PcrRow<T>* rows = reinterpret_cast<PcrRow<T>*>(smem_raw);
  ClusterPcr<T> pcr{{rows, rows + cs.slice}, 0};
  const int clusters = gridDim.x / cs.C;
  for (size_t m = blockIdx.x / cs.C; m < (size_t)K; m += clusters) {
    for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x) {
      const int i = cs.lo + li;
      cluster_pcr_row(pcr, li, lo[m * lo_stride + i], di[m * di_stride + i],
                      up[m * up_stride + i], b[m * n + i]);
    }
    cluster_sync();
    const PcrRow<T>* solved = cluster_pcr_solve<T, false>(pcr, cs, steps);
    for (int li = threadIdx.x; li < cs.cnt; li += blockDim.x)
      x[m * n + cs.lo + li] = cluster_pcr_x(solved, li);
  }
  cluster_sync();  // no block leaves while another rank can read its shared memory
}

// The C side's plan of the cluster build (cluster.cuh::choose_cluster): the
// rows' two buffers in every rank's shared memory (no records, no
// workspace); an error when it cannot launch.
template <typename T>
cudaError_t pcr_cluster_plan(int n, int K, int force_c, ClusterPlan& plan) {
  return choose_cluster(K, force_c, plan, [&](int C, ClusterPlan& p) {
    p.C = C;
    p.threads = cluster_threads(n, C, PCR_CLUSTER_THREADS);
    p.records_shared = 1;
    p.shmem = 2 * (size_t)cluster_slice_cells(n, C) * sizeof(PcrRow<T>);
    if (p.shmem > CLUSTER_SHARED_BUDGET) return cudaErrorInvalidValue;
    return cluster_occupancy(pcr_cluster_kernel<T>, p);
  });
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
  warp_pcr_solve<T, S, false>(l, d, u, r, n, steps, lane);
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

// the cluster build on min(K, resident) clusters of the plan
template <typename T>
int launch_cluster(cudaStream_t stream, const void* lo, const void* di, const void* up,
                   const void* b, void* x, int K, int n, int lo_stride, int di_stride,
                   int up_stride, int steps, int force_c) {
  ClusterPlan plan;
  const cudaError_t err = pcr_cluster_plan<T>(n, K, force_c, plan);
  if (err != cudaSuccess) return (int)err;
  return (int)cluster_launch(pcr_cluster_kernel<T>, plan, K < plan.clusters ? K : plan.clusters,
                             stream, static_cast<const T*>(lo), static_cast<const T*>(di),
                             static_cast<const T*>(up), static_cast<const T*>(b),
                             static_cast<T*>(x), K, n, lo_stride, di_stride, up_stride, steps);
}

template <typename T>
int launch(const void* lo, const void* di, const void* up, const void* b, void* x, int K,
           int n, int lo_stride, int di_stride, int up_stride, int steps, int force_c,
           void* stream) {
  if (K < 1 || n < 1 || n > MAX_WIDE_N) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 4096)
    return launch_cluster<T>(st, lo, di, up, b, x, K, n, lo_stride, di_stride, up_stride,
                             steps, force_c);
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

int ebm_pcr_f32(const void* lo, const void* di, const void* up, const void* b, void* x, int K,
                int n, int lo_stride, int di_stride, int up_stride, int steps, int force_c,
                void* stream) {
  return launch<float>(lo, di, up, b, x, K, n, lo_stride, di_stride, up_stride, steps, force_c,
                       stream);
}

int ebm_pcr_f64(const void* lo, const void* di, const void* up, const void* b, void* x, int K,
                int n, int lo_stride, int di_stride, int up_stride, int steps, int force_c,
                void* stream) {
  return launch<double>(lo, di, up, b, x, K, n, lo_stride, di_stride, up_stride, steps, force_c,
                        stream);
}

// the cluster build's plan for K systems of n rows: out = {C, threads,
// records in shared memory (always 1), resident clusters, shared bytes}
int ebm_pcr_plan_f32(int n, int K, int force_c, int* out) {
  if (n <= 4096 || n > MAX_WIDE_N || K < 1) return (int)cudaErrorInvalidValue;
  ClusterPlan p;
  const cudaError_t err = pcr_cluster_plan<float>(n, K, force_c, p);
  if (err == cudaSuccess) plan_out(p, out);
  return (int)err;
}

int ebm_pcr_plan_f64(int n, int K, int force_c, int* out) {
  if (n <= 4096 || n > MAX_WIDE_N || K < 1) return (int)cudaErrorInvalidValue;
  ClusterPlan p;
  const cudaError_t err = pcr_cluster_plan<double>(n, K, force_c, p);
  if (err == cudaSuccess) plan_out(p, out);
  return (int)err;
}

}  // extern "C"
