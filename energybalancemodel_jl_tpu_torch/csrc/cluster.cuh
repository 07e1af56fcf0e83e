// THE CLUSTER BUILDS of the whole-year kernels above their register builds'
// widths (miz_year.cu 1024 < nx <= 16384, classic_year.cu 4096 < nx <=
// 32768): ONE THREAD-BLOCK CLUSTER OF C BLOCKS PER MEMBER, each block (rank)
// owning a contiguous slice of ceil(nx / C) cells, the clusters looping over
// members m, m + clusters, ... (Hopper's clusters: the blocks of one cluster
// run at once on neighbouring SMs and read each other's shared memory).
//
// What moves between cells lives in the shared memory of the rank that owns
// the cell: the PCR rows (two buffers), MIZ's neighbour exchange (two
// buffers), the slots of the reductions and the crossing values. A value of
// another rank's cell is read through distributed shared memory
// (map_shared_rank), and one cluster barrier (barrier.cluster arrive.release
// / wait.acquire) stands where the block builds have a __syncthreads. The
// exchange rule of common.cuh holds at cluster scope: write, ONE cluster
// barrier, read, on buffers written in turn, so no buffer is rewritten
// before every rank's last read of it; a final cluster barrier keeps every
// block resident until no rank can read its shared memory any more.
//
// Every value is computed by the operations of the block builds in their
// order (the PCR row of pcr_level, the max of magnitude keys, the crossing
// sum in ops/_year.py::block_sum's order), so a cluster build is bitwise its
// plain version, whatever C.
#pragma once

#include <cooperative_groups.h>

#include <utility>

#include "common.cuh"
#include "noise.cuh"

namespace {

namespace cg = cooperative_groups;

// the most blocks of a cluster on an H100 (above 8 a launch must allow a
// non-portable size)
constexpr int MAX_CLUSTER = 16;

// this rank's cells [lo, lo + cnt) of an n-cell grid cut in C slices
struct ClusterSlice {
  int n, C, rank, slice, lo, cnt;
  unsigned magic;  // ceil(2^32 / slice): j / slice = umulhi(j, magic) for j < 2^16
};

__host__ __device__ inline int cluster_slice_cells(int n, int C) { return (n + C - 1) / C; }

__device__ __forceinline__ ClusterSlice cluster_slice(int n) {
  const cg::cluster_group cl = cg::this_cluster();
  ClusterSlice s;
  s.n = n;
  s.C = (int)cl.num_blocks();
  s.rank = (int)cl.block_rank();
  s.slice = cluster_slice_cells(n, s.C);
  s.lo = s.rank * s.slice;
  const int left = n - s.lo;
  s.cnt = left < 0 ? 0 : (left < s.slice ? left : s.slice);
  s.magic = (unsigned)((0x100000000ull + (unsigned)s.slice - 1) / (unsigned)s.slice);
  return s;
}

// One barrier of every thread of the cluster, release/acquire at cluster
// scope, so every rank's shared-memory writes before it are seen after it.
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// cell j of the grid in an array that every rank keeps for its own cells at
// the same offset of its shared memory (`local`: this rank's). The rank is
// j / slice by a multiply-high, exact for the grids here (j and slice below
// 2^16: the error of the rounded-up reciprocal stays under 1 / slice).
template <typename V>
__device__ __forceinline__ V* cluster_at(V* local, const ClusterSlice& s, int j) {
  const int owner = (int)__umulhi((unsigned)j, s.magic);
  V* base = owner == s.rank ? local : cg::this_cluster().map_shared_rank(local, owner);
  return base + (j - owner * s.slice);
}

__host__ __device__ inline size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// One cell's record in a rank's records: field f of local cell li at
// base[f * stride + li], a row per field (stride = the slice), so a warp's
// access to one field is conflict-free in shared memory and coalesced in
// device memory.
template <typename T>
struct Rec {
  T* base;  // the cell's first field
  int stride;
  __device__ __forceinline__ T& operator[](int f) const { return base[f * stride]; }
};

// -- the PCR of a cluster: row i of the system at local row i - lo of its
// rank's buffers. The system's rows go to buffer `start`; a level reads one
// buffer (its own row and the rows i -+ st, from whichever rank holds them)
// and writes its rank's rows of the other; a row beyond either end is the
// identity row (lo = up = b = 0, di = 1), the reach clamped onto it as in
// common.cuh's pcr_level with several rows per thread and
// ops/tridiag.py::pcr_solve. The levels
// alternate the buffers, so one cluster barrier between two levels is
// enough; none follows the last (each thread then reads only its own rows,
// which the next system's rows overwrite in the buffer the last level wrote
// and no rank read).
template <typename T>
struct ClusterPcr {
  PcrRow<T>* buf[2];  // this rank's rows of the two buffers
  int start;          // the buffer that takes the next system's rows
};

// local row li of the system, row-scaled as pcr_solve scales it, in the
// first level's form (common.cuh, PcrLevel)
template <typename T>
__device__ __forceinline__ void cluster_pcr_row(const ClusterPcr<T>& p, int li, T lo, T di, T up,
                                                T b) {
  const T inv = T(1) / di;
  store_row(p.buf[p.start] + li, lo * inv, inv, up * inv, b);
}

// row j of buffer cur, or the identity row beyond either end
template <typename T>
__device__ __forceinline__ PcrRow<T> cluster_row(PcrRow<T>* cur, const ClusterSlice& s, int j) {
  return j < 0 || j >= s.n ? PcrRow<T>{T(0), T(1), T(0), T(0)} : load_row(cluster_at(cur, s, j));
}

// One doubling level at stride st; a thread loads ROWS of its rows (with
// their neighbours) before it computes any, so the remote loads overlap.
template <typename T, int KIND>
__device__ __forceinline__ void cluster_pcr_level(PcrRow<T>* cur, PcrRow<T>* next,
                                                  const ClusterSlice& s, int st) {
  constexpr int ROWS = 16 / sizeof(T);
  for (int l0 = threadIdx.x; l0 < s.cnt; l0 += ROWS * blockDim.x) {
    PcrRow<T> o[ROWS], m[ROWS], p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int li = l0 + r * blockDim.x;
      if (li < s.cnt) {
        const int i = s.lo + li;
        o[r] = load_row(cur + li);
        m[r] = cluster_row(cur, s, i - st);
        p[r] = cluster_row(cur, s, i + st);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int li = l0 + r * blockDim.x;
      if (li < s.cnt) {
        const PcrRow<T> q = pcr_row_update<T, KIND>(o[r], m[r], p[r]);
        store_row(next + li, q.lo, q.di, q.up, q.b);
      }
    }
  }
}

// Two doubling levels, at strides st and 2 st, behind one barrier: a row's
// second level reads the first level's rows i - 2 st, i, i + 2 st, so each
// thread computes those three itself from the rows i + d st, |d| <= 3, of
// buffer cur (the same operations on the same values as two levels apart:
// a row beyond either end is the identity row at every level). Taken in
// float32 where a block holds one row per thread, whose levels wait on their
// barriers more than they compute (measured: in float64 the extra rows cost
// more than the barrier saved).
template <typename T, int K1, int K2>
__device__ __forceinline__ void cluster_pcr_two_levels(PcrRow<T>* cur, PcrRow<T>* next,
                                                       const ClusterSlice& s, int st) {
  const PcrRow<T> ident{T(0), T(1), T(0), T(0)};
  for (int li = threadIdx.x; li < s.cnt; li += blockDim.x) {
    const int i = s.lo + li;
    PcrRow<T> r[7];  // rows i + (d - 3) st
#pragma unroll
    for (int d = 0; d < 7; ++d)
      r[d] = d == 3 ? load_row(cur + li) : cluster_row(cur, s, i + (d - 3) * st);
    const PcrRow<T> qm = i - 2 * st < 0 ? ident : pcr_row_update<T, K1>(r[1], r[0], r[2]);
    const PcrRow<T> q0 = pcr_row_update<T, K1>(r[3], r[2], r[4]);
    const PcrRow<T> qp = i + 2 * st >= s.n ? ident : pcr_row_update<T, K1>(r[5], r[4], r[6]);
    const PcrRow<T> q = pcr_row_update<T, K2>(q0, qm, qp);
    store_row(next + li, q.lo, q.di, q.up, q.b);
  }
}

// level `level` (and, with `two`, the next one too) of `steps`, its kinds
// as pcr_level_kind says
template <typename T, bool NEG>
__device__ __forceinline__ void cluster_pcr_step(PcrRow<T>* cur, PcrRow<T>* next,
                                                 const ClusterSlice& s, int st, int level,
                                                 int steps, bool two) {
  constexpr int F = NEG ? PCR_FIRST_NEG : PCR_FIRST;
  const int k1 = pcr_level_kind(level, steps, NEG);
  if (!two) {
    if (k1 == F) cluster_pcr_level<T, F>(cur, next, s, st);
    else if (k1 == PCR_MID) cluster_pcr_level<T, PCR_MID>(cur, next, s, st);
    else cluster_pcr_level<T, PCR_LAST>(cur, next, s, st);
    return;
  }
  const bool last2 = pcr_level_kind(level + 1, steps, NEG) == PCR_LAST;
  if (k1 == F && last2) cluster_pcr_two_levels<T, F, PCR_LAST>(cur, next, s, st);
  else if (k1 == F) cluster_pcr_two_levels<T, F, PCR_MID>(cur, next, s, st);
  else if (last2) cluster_pcr_two_levels<T, PCR_MID, PCR_LAST>(cur, next, s, st);
  else cluster_pcr_two_levels<T, PCR_MID, PCR_MID>(cur, next, s, st);
}

// Solve the system every rank wrote to buffer `start` (cluster_pcr_row),
// after a cluster barrier the caller made: ceil(log2 n) = `steps` levels
// (NEG: the right-hand side is a negation, common.cuh's PcrLevel), one
// cluster barrier between two (between two pairs of levels in float32 where
// a block holds a row per thread, cluster_pcr_two_levels). Returns this
// rank's rows of the reduced system (local row li's solution is its b / di,
// cluster_pcr_x); the next system goes to that buffer. Every thread of every
// rank calls it. At least two levels (n > 2: the cluster builds' widths).
template <typename T, bool NEG>
__device__ __forceinline__ PcrRow<T>* cluster_pcr_solve(ClusterPcr<T>& p, const ClusterSlice& s,
                                                        int steps) {
  const bool pairs = sizeof(T) == 4 && s.slice <= (int)blockDim.x;
  int cur = p.start;
  for (int level = 0, st = 1; level < steps; cur ^= 1) {
    if (level > 0) cluster_sync();
    const bool two = pairs && level + 1 < steps;
    cluster_pcr_step<T, NEG>(p.buf[cur], p.buf[cur ^ 1], s, st, level, steps, two);
    level += two ? 2 : 1;
    st <<= two ? 2 : 1;
  }
  p.start = cur;
  return p.buf[cur];
}

template <typename T>
__device__ __forceinline__ T cluster_pcr_x(const PcrRow<T>* rows, int li) {
  const PcrRow<T> r = load_row(rows + li);
  return r.b / r.di;
}

// -- the max of magnitudes over a cluster (block_max_key over every rank's
// threads): each warp's max goes to its slot in every rank's set (one slot
// per warp of the cluster), one cluster barrier, then every warp reduces
// its own rank's set. A max is the same in any grouping, so every thread of
// every rank gets the block build's value. Two sets of C * warps keys,
// written in turn.
template <typename T>
struct ClusterRed {
  MagnitudeKey<T>* slots;
  int turn;
};

template <typename T>
__host__ __device__ inline size_t cluster_red_bytes(int C, int threads) {
  return align16(sizeof(T) * 2 * (size_t)C * (threads / 32));
}

template <typename T>
__device__ __forceinline__ T cluster_max_key(MagnitudeKey<T> key, ClusterRed<T>& red,
                                             const ClusterSlice& s) {
  using Key = MagnitudeKey<T>;
  key = warp_max_key(key);
  const int warps = blockDim.x >> 5, per_set = s.C * warps;
  Key* set = red.slots + (red.turn ? per_set : 0);
  red.turn ^= 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < s.C) *cg::this_cluster().map_shared_rank(set + s.rank * warps + warp, lane) = key;
  cluster_sync();
  Key k = 0;
  for (int j = lane; j < per_set; j += 32) {
    const Key v = set[j];
    k = v > k ? v : k;
  }
  return key_value(warp_max_key(k));
}

// The crossing area of step t, by rank 0 after a cluster barrier that
// follows every rank's writes of its cells' values (w_i * field_i at
// vals[li]): the order of ops/_year.py::block_sum (the register builds'
// layout, block_layout): virtual thread v of vt adds cells v + c * vt, c <
// cpt, in order (0 beyond the grid), each read from the rank that holds it;
// the lanes of a virtual warp add in noise_crossing's halving tree; thread 0
// adds the virtual warps in order and records a first crossing. Rank 0's
// threads run the virtual threads in rounds, so a virtual warp is one real
// warp. One block barrier (rank 0's); the values' next writes follow a
// cluster barrier that rank 0 reaches after these reads.
template <typename T>
__device__ void cluster_noise_crossing(NoiseState<T>& ns, T* vals, const ClusterSlice& s,
                                       RedSmem<T>& red, int t) {
  const int n = s.n;
  const int cpt = rows_per_thread(n);
  const int vt = round_up_32((n + cpt - 1) / cpt);
  T* slots = red_turn(red);
  for (int base = 0; base < vt; base += blockDim.x) {
    const int v = base + threadIdx.x;
    T part = T(0);
    for (int c = 0; c < cpt; ++c) {
      const int i = v + c * vt;
      const T x = v < vt && i < n ? *cluster_at(vals, s, i) : T(0);
      part = c == 0 ? x : part + x;
    }
    for (int o = 16; o > 0; o >>= 1) part = part + __shfl_xor_sync(0xffffffffu, part, o);
    if ((threadIdx.x & 31) == 0 && v < vt) slots[v >> 5] = part;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T area = slots[0];
    for (int w = 1; w < vt >> 5; ++w) area = area + slots[w];
    if (ns.first < T(0) && ns.sign * (area - ns.thr) > T(0)) ns.first = T(t);
  }
}

// -- host side: what a cluster build of `threads` threads and `shmem` bytes
// of dynamic shared memory per block can launch

// the dynamic shared memory a cluster build may ask for: the block's 227 KB
// less a margin for its static shared memory
constexpr size_t CLUSTER_SHARED_BUDGET = MAX_SHARED_BYTES - 1024;

// the C side's choice of the cluster and of where the records live
struct ClusterPlan {
  int C;               // blocks per cluster (one member)
  int threads;         // per block
  int records_shared;  // 1: each cell's record in its rank's shared memory; 0: in the workspace
  int clusters;        // clusters that stay resident on the card
  size_t shmem;        // dynamic shared memory per block
};

inline cudaLaunchConfig_t cluster_config(int clusters, int C, int threads, size_t shmem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * C));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Ask the card how many clusters of C blocks it keeps resident (after the
// kernel is allowed its shared memory and, above 8, a non-portable cluster
// size); an error, or 0 clusters, means the build cannot launch so.
template <typename... Params>
cudaError_t cluster_occupancy(void (*kernel)(Params...), ClusterPlan& plan) {
  cudaError_t err = allow_shared(kernel, plan.shmem);
  if (err != cudaSuccess) return err;
  if (plan.C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(1, plan.C, plan.threads, plan.shmem, nullptr, &attr);
  plan.clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&plan.clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  return plan.clusters > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// launch `clusters` clusters of the plan; the launch error, if any
template <typename... Params, typename... Args>
cudaError_t cluster_launch(void (*kernel)(Params...), const ClusterPlan& plan, int clusters,
                           cudaStream_t stream, Args&&... args) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(clusters, plan.C, plan.threads, plan.shmem, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the plan as the C entry points return it: out = {C, threads, records in
// shared memory (1) or in the workspace (0), resident clusters, dynamic
// shared bytes per block}
inline void plan_out(const ClusterPlan& p, int* out) {
  out[0] = p.C;
  out[1] = p.threads;
  out[2] = p.records_shared;
  out[3] = p.clusters;
  out[4] = (int)p.shmem;
}

inline bool valid_cluster(int C) { return C >= 2 && C <= MAX_CLUSTER && (C & (C - 1)) == 0; }

// The plan of a cluster build for K members of n cells (plan_for(C, plan)
// fills the plan's threads, records and shared bytes for cluster size C and
// asks the card, cluster_occupancy): C forced (force_c > 0), else the widest
// cluster (16, 8, 4, 2) whose resident clusters run all K members at once,
// and where none does, the narrowest that launches (the most clusters,
// members in the fewest rounds). A block has as many threads as its slice
// has cells, in whole warps, at most the build's: a cluster barrier costs
// more the more warps it waits for.
template <typename PlanFor>
cudaError_t choose_cluster(int K, int force_c, ClusterPlan& plan, PlanFor plan_for) {
  if (force_c > 0) {
    if (!valid_cluster(force_c)) return cudaErrorInvalidValue;
    return plan_for(force_c, plan);
  }
  int narrowest = 0;
  for (int C = MAX_CLUSTER; C >= 2; C /= 2) {
    if (plan_for(C, plan) != cudaSuccess) continue;
    if (K <= plan.clusters) return cudaSuccess;
    narrowest = C;
  }
  // the last plan_for set the kernel's attributes for another C: ask again
  return plan_for(narrowest > 0 ? narrowest : MAX_CLUSTER, plan);
}

inline int cluster_threads(int n, int C, int max_threads) {
  const int t = round_up_32(cluster_slice_cells(n, C));
  return t < max_threads ? t : max_threads;
}

}  // namespace
