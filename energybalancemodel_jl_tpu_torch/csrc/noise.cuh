// The noise modes of the whole-year kernels (miz_year.cu, classic_year.cu),
// shared: the per-member noise row in shared memory, the OU recurrence
// (serial, or the log-depth scan), and the in-year crossing detector.
//
// They stand for the JAX package's pallas_year.py::_kernel_xk /
// _classic_kernel_xk keyword modes (noise=, noise_ou=, noise_keys=,
// ou_assoc=True, crossing=; :552-643, :1686-1762) and follow the plain
// versions of ops/_year.py operation for operation: the recurrence is
// eta = fma(rho, eta, scale * xi) (XLA's contraction of rho * eta + scale * xi),
// the scan y_t = fma(rho^d, y_{t-d}, y_t), p_t = p_t * p_{t-d}, then
// eta_t = fma(p_t, eta0, y_t), and the crossing area is summed in the fixed
// order of ops/_year.py::block_sum.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "prng.cuh"

namespace {

// ou_mode: 0 the row is added as it is, 1 serial OU over the row, 2 the
// row replaced by its log-depth OU path before the time loop
template <typename T>
struct NoiseArgs {
  const T* noise;        // (nt, K) table, or nullptr
  const uint32_t* keys;  // (K, 2) member keys, or nullptr (float only)
  const T* ou;           // (K, 3): rho, scale, eta0, or nullptr
  T* eta_out;            // (K,) year-end OU value, or nullptr
  const T* cross;        // (K, 2): threshold, sign, or nullptr
  T* cross_out;          // (K,) first crossing step (-1: none), or nullptr
  const T* wts;          // (nx,) trapezoid weights of the crossing area
  int ou_mode;
  int ou_unroll;         // a power of two
};

template <typename T>
NoiseArgs<T> noise_args(const void* noise, const void* keys, const void* ou, void* eta_out,
                        const void* cross, void* cross_out, const void* wts, int ou_mode,
                        int ou_unroll) {
  return NoiseArgs<T>{static_cast<const T*>(noise), static_cast<const uint32_t*>(keys),
                      static_cast<const T*>(ou), static_cast<T*>(eta_out),
                      static_cast<const T*>(cross), static_cast<T*>(cross_out),
                      static_cast<const T*>(wts), ou_mode, ou_unroll};
}

// the noise row, plus the scan's three work rows in assoc mode
template <typename T>
__host__ __device__ inline size_t noise_shared_bytes(int nt, int ou_mode) {
  return (size_t)nt * sizeof(T) * (ou_mode == 2 ? 4 : 1);
}

template <typename T>
struct NoiseState {
  T* row;
  T rho, scale, eta;
  T thr, sign, first;  // crossing: first is valid in thread 0
};

// rows[0..nt) <- the OU path over the white row, by a Hillis-Steele scan
// over time with rho^d squared at each level (rows[nt..4 nt) are work space)
template <typename T>
__device__ void assoc_ou_row(T* row, int nt, T rho, T scale, T eta0) {
  T *y = row, *p = row + nt, *y2 = row + 2 * nt, *p2 = row + 3 * nt;
  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    y[t] = scale * y[t];
    p[t] = rho;
  }
  __syncthreads();
  T r = rho;
  for (int d = 1; d < nt; d *= 2) {
    for (int t = threadIdx.x; t < nt; t += blockDim.x) {
      const bool h = t >= d;
      y2[t] = fma_rn(r, h ? y[t - d] : T(0), y[t]);
      p2[t] = p[t] * (h ? p[t - d] : T(1));
    }
    __syncthreads();
    T* sw = y; y = y2; y2 = sw;
    sw = p; p = p2; p2 = sw;
    r = r * r;
  }
  for (int t = threadIdx.x; t < nt; t += blockDim.x) row[t] = fma_rn(p[t], eta0, y[t]);
  __syncthreads();
}

// fill member m's row (drawn from its key, or its column of the table) and
// set up its OU and crossing state; every thread of the block calls it
template <typename T>
__device__ NoiseState<T> noise_begin(const NoiseArgs<T>& nz, T* row, int m, int K, int nt) {
  NoiseState<T> ns;
  ns.row = row;
  if (nz.keys != nullptr) {
    const uint32_t k1 = nz.keys[2 * m], k2 = nz.keys[2 * m + 1];
    for (int t = threadIdx.x; t < nt; t += blockDim.x) row[t] = T(normal_draw(k1, k2, t));
  } else {
    for (int t = threadIdx.x; t < nt; t += blockDim.x) row[t] = nz.noise[(size_t)t * K + m];
  }
  ns.rho = nz.ou != nullptr ? nz.ou[3 * m] : T(0);
  ns.scale = nz.ou != nullptr ? nz.ou[3 * m + 1] : T(0);
  ns.eta = nz.ou != nullptr ? nz.ou[3 * m + 2] : T(0);
  ns.thr = nz.cross != nullptr ? nz.cross[2 * m] : T(0);
  ns.sign = nz.cross != nullptr ? nz.cross[2 * m + 1] : T(0);
  ns.first = T(-1);
  __syncthreads();
  if (nz.ou_mode == 2) assoc_ou_row(row, nt, ns.rho, ns.scale, ns.eta);
  return ns;
}

// step t's forcing (f[t] + F) + offset
template <typename T>
__device__ __forceinline__ T noise_forcing(const NoiseArgs<T>& nz, NoiseState<T>& ns, T f,
                                           int t) {
  if (nz.ou_mode == 1) {
    const T xi = ns.row[t];
    ns.eta = (t & (nz.ou_unroll - 1)) == 0 ? fma_rn(ns.rho, ns.eta, ns.scale * xi)
                                            : fma_rn(ns.scale, xi, ns.rho * ns.eta);
    return f + ns.eta;
  }
  return f + ns.row[t];
}

// The crossing area of step t from each thread's part (w_i * field_i of its
// cells, added in cell order; 0 for a thread with none), in the fixed order
// of ops/_year.py::block_sum: within a warp a halving tree over the lanes
// (lane l adds lane l + 16, then + 8, 4, 2, 1; the shuffle butterfly gives
// lane 0 that sum), then the warps' sums in warp order, by thread 0, which
// records a first crossing. One barrier: the warps' slots are two sets
// written in turn (common.cuh).
template <typename T>
__device__ __forceinline__ void noise_crossing(NoiseState<T>& ns, T part, RedSmem<T>& red,
                                               int t) {
  for (int o = 16; o > 0; o >>= 1) part = part + __shfl_xor_sync(0xffffffffu, part, o);
  T* slots = red_turn(red);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    T area = slots[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) area = area + slots[w];
    if (ns.first < T(0) && ns.sign * (area - ns.thr) > T(0)) ns.first = T(t);
  }
}

// the year-end OU value and the first crossing step of member m
template <typename T>
__device__ __forceinline__ void noise_end(const NoiseArgs<T>& nz, const NoiseState<T>& ns,
                                          int m, int nt) {
  if (threadIdx.x != 0) return;
  if (nz.eta_out != nullptr) nz.eta_out[m] = nz.ou_mode == 1 ? ns.eta : ns.row[nt - 1];
  if (nz.cross_out != nullptr) nz.cross_out[m] = ns.first;
}

// -- the same modes for ONE MEMBER PER WARP (the warp builds of
// classic_year.cu): the member's row in the warp's own shared memory, its 32
// lanes in place of the block's threads, shuffles in place of a barrier.
// Each value is computed by the operations of the block versions above, in
// their order.

// noise_begin for member m in a warp, whose row is nt values of the warp's
// shared memory (classic_year.cu runs the associative OU scan on its block
// build); every lane of the warp calls it
template <typename T>
__device__ NoiseState<T> warp_noise_begin(const NoiseArgs<T>& nz, T* row, int m, int K, int nt,
                                          int lane) {
  NoiseState<T> ns;
  ns.row = row;
  if (nz.keys != nullptr) {
    const uint32_t k1 = nz.keys[2 * m], k2 = nz.keys[2 * m + 1];
    for (int t = lane; t < nt; t += 32) row[t] = T(normal_draw(k1, k2, t));
  } else {
    for (int t = lane; t < nt; t += 32) row[t] = nz.noise[(size_t)t * K + m];
  }
  ns.rho = nz.ou != nullptr ? nz.ou[3 * m] : T(0);
  ns.scale = nz.ou != nullptr ? nz.ou[3 * m + 1] : T(0);
  ns.eta = nz.ou != nullptr ? nz.ou[3 * m + 2] : T(0);
  ns.thr = nz.cross != nullptr ? nz.cross[2 * m] : T(0);
  ns.sign = nz.cross != nullptr ? nz.cross[2 * m + 1] : T(0);
  ns.first = T(-1);
  __syncwarp();
  return ns;
}

// The crossing area of step t from each slot's part (w_i * field_i of cell
// lane + 32 s, 0 beyond the grid): slot s holds cells 32 s ... 32 s + 31,
// the cells of warp s of the block layout, so a butterfly per slot gives
// every lane the halving tree's sum of that warp (each pair of lanes adds
// the same two values), and the slots' sums in slot order are the block's
// warps in warp order (ops/_year.py::block_sum). Every lane records the
// first crossing.
template <typename T, int S>
__device__ __forceinline__ void warp_noise_crossing(NoiseState<T>& ns, const T (&part)[S], int n,
                                                    int t) {
  T area = T(0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    T v = part[s];
    for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
    if (32 * s < n) area = s == 0 ? v : area + v;
  }
  if (ns.first < T(0) && ns.sign * (area - ns.thr) > T(0)) ns.first = T(t);
}

template <typename T>
__device__ __forceinline__ void warp_noise_end(const NoiseArgs<T>& nz, const NoiseState<T>& ns,
                                               int m, int nt, int lane) {
  if (lane != 0) return;
  if (nz.eta_out != nullptr) nz.eta_out[m] = nz.ou_mode == 1 ? ns.eta : ns.row[nt - 1];
  if (nz.cross_out != nullptr) nz.cross_out[m] = ns.first;
}

}  // namespace
