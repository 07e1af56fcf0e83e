// Device code shared by the package's kernels (miz_year.cu, classic_year.cu,
// pcr.cu, newton_t0.cu): NaN-aware helpers, a block-wide max of magnitudes,
// and the row-scaled parallel cyclic reduction of ops/tridiag.py::pcr_solve,
// for one system per block in shared memory (pcr_solve) and for one system
// per warp in registers (warp_pcr_solve); the cluster builds above 4096 rows
// (1024 cells for the MIZ year) have their own, cluster.cuh, on the same
// level update (pcr_row_update).
//
// Every helper performs the same operations in the same order as the plain
// PyTorch code it stands for, so a kernel built with -fmad=false rounds where
// the plain version does; the fused multiply-adds that XLA:CPU makes of the
// JAX package's code, and that the plain version therefore makes
// (utils/numerics.py), are explicit __fmaf_rn / __fma_rn (fma_rn).
//
// How values travel between the threads of a block (block_max_magnitude,
// pcr_solve, noise.cuh's crossing sum and the neighbour exchange of
// newton.cuh): write, ONE barrier, read. Each exchange owns two buffers and
// writes them in turn, so no second barrier protects a buffer from the next
// write. Why no buffer is rewritten before its last reader is done: a thread
// that writes buffer X for use k + 2 of an exchange has passed the barrier of
// use k + 1, and every thread of the block arrives at that barrier only after
// its reads of use k, the last use that wrote X. The turn is kept in the
// exchange's own state across calls, so the argument holds whatever the
// callers do between two uses.
#pragma once

#include <cuda_runtime.h>

namespace {

template <typename T> __device__ __forceinline__ bool is_nan(T v) { return v != v; }

template <typename T> __device__ __forceinline__ bool is_finite(T v) {
  return v - v == T(0);  // false for +-inf and NaN
}

// minimum/maximum that propagate NaN, like torch.minimum and jnp.minimum
template <typename T> __device__ __forceinline__ T nan_min(T a, T b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (b < a ? b : a));
}

template <typename T> __device__ __forceinline__ T nan_max(T a, T b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (a < b ? b : a));
}

template <typename T> __device__ __forceinline__ T abs_val(T v) { return v < T(0) ? -v : v; }

template <typename T> __device__ __forceinline__ T safe_div(T num, T den) {
  return den == T(0) ? T(0) : num / den;
}

// v with a subnormal value flushed to a zero of its sign, every other value
// kept (utils/numerics.py::flush_subnormal: the flush to zero of the JAX
// package's backends, applied where the MIZ step needs it)
template <typename T> __device__ __forceinline__ T smallest_normal();
template <> __device__ __forceinline__ float smallest_normal<float>() { return 1.17549435e-38f; }
template <> __device__ __forceinline__ double smallest_normal<double>() {
  return 2.2250738585072014e-308;
}

template <typename T> __device__ __forceinline__ T flush_subnormal(T v) {
  return abs_val(v) < smallest_normal<T>() ? v * T(0) : v;
}

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// a Newton update clipped to +-max_step (NaN stays NaN), then a non-finite
// update set to 0 (torch.clamp, then torch.where(isfinite))
template <typename T> __device__ __forceinline__ T clip_step(T delta, T max_step) {
  delta = delta < -max_step ? -max_step : (delta > max_step ? max_step : delta);
  return is_finite(delta) ? delta : T(0);
}

// Two sets of one slot per warp for a block reduction, written in turn: one
// barrier per reduction.
template <typename T>
struct RedSmem {
  T* slots;  // 2 x 32
  int turn;
};

constexpr int RED_SLOTS = 64;

template <typename T>
__device__ __forceinline__ T* red_turn(RedSmem<T>& red) {
  T* slots = red.slots + (red.turn ? 32 : 0);
  red.turn ^= 1;
  return slots;
}

// The bits of |v| as an unsigned key whose order is the order of the values:
// v is a magnitude (>= 0, or -0, or NaN), the sign bit is dropped, and NaN
// maps above every number.
__device__ __forceinline__ unsigned magnitude_key(float v) {
  return is_nan(v) ? 0xffffffffu : (__float_as_uint(v) & 0x7fffffffu);
}
__device__ __forceinline__ unsigned long long magnitude_key(double v) {
  return is_nan(v) ? ~0ull : ((unsigned long long)__double_as_longlong(v) & ~(1ull << 63));
}
__device__ __forceinline__ unsigned warp_max_key(unsigned key) {
  return __reduce_max_sync(0xffffffffu, key);
}
__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long key) {
  // the hardware reduces 32-bit words: the high words, then the low words of
  // the lanes that hold the largest high word
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mh = __reduce_max_sync(0xffffffffu, hi);
  const unsigned ml = __reduce_max_sync(0xffffffffu, hi == mh ? lo : 0u);
  return ((unsigned long long)mh << 32) | ml;
}
__device__ __forceinline__ float key_value(unsigned key) {
  return key == 0xffffffffu ? quiet_nan<float>() : __uint_as_float(key);
}
__device__ __forceinline__ double key_value(unsigned long long key) {
  return key == ~0ull ? quiet_nan<double>() : __longlong_as_double((long long)key);
}

// NaN-propagating max over the block of magnitudes (each thread's v is
// >= 0, -0 or NaN: a residual norm's |r|); every thread gets the same value.
// The max of such values is the max of their bit patterns, which the warp
// reduces in one instruction (two in float64) instead of five shuffles with
// a NaN-aware compare each: the same value, NaN for any NaN, +0 for -0 (the
// callers only compare the result). Every thread of the block calls it.
template <typename T> struct KeyOf;
template <> struct KeyOf<float> { using type = unsigned; };
template <> struct KeyOf<double> { using type = unsigned long long; };
template <typename T>
using MagnitudeKey = typename KeyOf<T>::type;

// the same max from each thread's key (the largest of its cells' keys, 0
// for a thread with none: a max is the same in any grouping)
template <typename T>
__device__ __forceinline__ T block_max_key(MagnitudeKey<T> key, RedSmem<T>& red) {
  key = warp_max_key(key);
  using Key = MagnitudeKey<T>;
  static_assert(sizeof(Key) == sizeof(T), "a key fills a slot");
  Key* slots = reinterpret_cast<Key*>(red_turn(red));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) slots[warp] = key;
  __syncthreads();
  key = lane < (int)(blockDim.x >> 5) ? slots[lane] : Key(0);
  return key_value(warp_max_key(key));
}

template <typename T>
__device__ __forceinline__ T block_max_magnitude(T v, RedSmem<T>& red) {
  return block_max_key<T>(magnitude_key(v), red);
}

// One row (lo, di, up, b) of a PCR system in shared memory: 16 bytes in
// float32 (one 128-bit access), 32 in float64 (two).
template <typename T>
struct alignas(16) PcrRow {
  T lo, di, up, b;
};

__device__ __forceinline__ PcrRow<float> load_row(const PcrRow<float>* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ PcrRow<double> load_row(const PcrRow<double>* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  return {a.x, a.y, b.x, b.y};
}
__device__ __forceinline__ void store_row(PcrRow<float>* p, float lo, float di, float up,
                                          float b) {
  *reinterpret_cast<float4*>(p) = make_float4(lo, di, up, b);
}
__device__ __forceinline__ void store_row(PcrRow<double>* p, double lo, double di, double up,
                                          double b) {
  reinterpret_cast<double2*>(p)[0] = make_double2(lo, di);
  reinterpret_cast<double2*>(p)[1] = make_double2(up, b);
}

// The shared memory of a block's PCR solves of n rows. One row per thread
// (n <= 1024): two buffers written level by level in turn, with `pad`
// identity rows (lo = up = b = 0, di = 1) before, between and after them,
// where pad = 2^(steps - 1) is the farthest a level reaches, so a level reads
// rows i - st and i + st with no range test:
//   [pad][buffer 0: n][pad][buffer 1: n][pad]
// Several rows per thread (n > 1024): the padded pair would
// not fit in float64 at n = 4096, so one buffer with one identity row on each
// side, the reach clamped onto it, and a second barrier per level.
template <typename T>
struct PcrSmem {
  PcrRow<T>* rows;  // row 0 of buffer 0
  int stride;       // rows from buffer 0 to buffer 1 (0: one buffer)
  int turn;         // the buffer the next level writes
};

__host__ __device__ inline int pcr_pad(int n, int steps) {
  return n > 1024 ? 1 : (steps > 0 ? 1 << (steps - 1) : 0);
}

template <typename T>
__host__ __device__ inline size_t pcr_shared_bytes(int n, int steps) {
  const int pad = pcr_pad(n, steps);
  return sizeof(PcrRow<T>) * (size_t)(n > 1024 ? n + 2 * pad : 2 * n + 3 * pad);
}

// Lay the buffers out at `base` (16-byte aligned) and write the identity
// rows, once per kernel: no solve writes them. Every thread of the block
// calls it; the first level's barrier orders these writes before any read.
template <typename T>
__device__ __forceinline__ PcrSmem<T> pcr_begin(void* base, int n, int steps) {
  PcrRow<T>* rows = static_cast<PcrRow<T>*>(base);
  const int pad = pcr_pad(n, steps);
  const int regions = n > 1024 ? 2 : 3;
  for (int r = 0; r < regions; ++r)
    for (int j = threadIdx.x; j < pad; j += blockDim.x)
      store_row(rows + r * (n + pad) + j, T(0), T(1), T(0), T(0));
  return PcrSmem<T>{rows + pad, n > 1024 ? 0 : n + pad, 0};
}

// The kinds of doubling level, by the fused multiply-adds XLA:CPU makes of
// the JAX package's PCR (ops/tridiag.py::pcr_solve, utils/numerics.py):
//   - the first level, which reads rows (lo / di, 1 / di, up / di, b): the
//     row-scaled bands, the scale where the diagonal (1) would be, and the
//     unscaled right-hand side, so that each row can form b / di (= b * inv)
//     itself. Its b takes the product b * inv (PCR_FIRST) or, for a
//     right-hand side that is a negation, the Newton update's -r, alpha *
//     b[i - st] (PCR_FIRST_NEG) as the contracted one; it divides nothing
//     (every diagonal is 1, and x / 1 is x);
//   - the levels between: both sums contracted, alpha's product first;
//   - the last level: alpha's products rounded, beta's contracted.
enum PcrLevel { PCR_FIRST, PCR_FIRST_NEG, PCR_MID, PCR_LAST };

template <typename T> __device__ __forceinline__ T fma_rn(T a, T b, T c);
template <> __device__ __forceinline__ float fma_rn<float>(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
template <> __device__ __forceinline__ double fma_rn<double>(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// one row o's update from its neighbours m = i - st and p = i + st; every
// PCR of the package (block, warp, cluster) runs its levels through it
template <typename T, int KIND>
__device__ __forceinline__ PcrRow<T> pcr_row_update(const PcrRow<T>& o, const PcrRow<T>& m,
                                                    const PcrRow<T>& p) {
  if (KIND == PCR_FIRST || KIND == PCR_FIRST_NEG) {
    const T alpha = -o.lo, beta = -o.up;
    const T mb = m.b * m.di;
    const T t = KIND == PCR_FIRST_NEG ? fma_rn(alpha, mb, o.b * o.di)
                                      : fma_rn(o.b, o.di, alpha * mb);
    return {alpha * m.lo, fma_rn(beta, p.lo, fma_rn(alpha, m.up, T(1))), beta * p.up,
            fma_rn(beta, p.b * p.di, t)};
  }
  const T alpha = safe_div(-o.lo, m.di);
  const T beta = safe_div(-o.up, p.di);
  const T b = KIND == PCR_MID ? fma_rn(alpha, m.b, o.b) : o.b + alpha * m.b;
  const T di = KIND == PCR_MID ? fma_rn(alpha, m.up, o.di) : o.di + alpha * m.up;
  return {alpha * m.lo, fma_rn(beta, p.lo, di), beta * p.up, fma_rn(beta, p.b, b)};
}

// the kind of level `level` of `steps`
__host__ __device__ inline int pcr_level_kind(int level, int steps, bool neg) {
  return level == 0 ? (neg ? PCR_FIRST_NEG : PCR_FIRST) : (level + 1 < steps ? PCR_MID : PCR_LAST);
}

// One doubling level at stride st.
template <typename T, int CPT, int KIND>
__device__ __forceinline__ void pcr_level(T (&lo)[CPT], T (&di)[CPT], T (&up)[CPT],
                                          T (&b)[CPT], PcrSmem<T>& s, int n, int st) {
  PcrRow<T>* cur = s.rows + (s.turn ? s.stride : 0);
  s.turn ^= 1;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < n) store_row(cur + i, lo[c], di[c], up[c], b[c]);
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < n) {
      int im = i - st, ip = i + st;
      if (CPT > 1) {  // onto the one identity row on each side
        im = im < -1 ? -1 : im;
        ip = ip > n ? n : ip;
      }
      const PcrRow<T> q = pcr_row_update<T, KIND>(PcrRow<T>{lo[c], di[c], up[c], b[c]},
                                                  load_row(cur + im), load_row(cur + ip));
      lo[c] = q.lo;
      di[c] = q.di;
      up[c] = q.up;
      b[c] = q.b;
    }
  }
  if (CPT > 1) __syncthreads();  // one buffer: reads done before the next write
}

// Row-scaled parallel cyclic reduction of ONE system of n rows per block
// (ops/tridiag.py::pcr_solve): thread t holds rows t + c * blockDim.x,
// c < CPT, in the arrays. ceil(log2 n) = `steps` doubling levels; rows out of
// range are the identity rows of the layout. One barrier per level with one
// row per thread (CPT = 1), two with several. NEG: b is a negation (the
// first level's kind). On return b[c] holds the solution of row c.
template <typename T, int CPT, bool NEG>
__device__ __forceinline__ void pcr_solve(T (&lo)[CPT], T (&di)[CPT], T (&up)[CPT],
                                          T (&b)[CPT], PcrSmem<T>& s, int n, int steps) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const T inv = T(1) / di[c];
    lo[c] = lo[c] * inv;
    up[c] = up[c] * inv;
    di[c] = inv;  // the first level's row (PcrLevel)
  }
  if (steps > 0) pcr_level<T, CPT, NEG ? PCR_FIRST_NEG : PCR_FIRST>(lo, di, up, b, s, n, 1);
  for (int level = 1, st = 2; level < steps; ++level, st <<= 1) {
    if (level + 1 < steps)
      pcr_level<T, CPT, PCR_MID>(lo, di, up, b, s, n, st);
    else
      pcr_level<T, CPT, PCR_LAST>(lo, di, up, b, s, n, st);
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    if (steps == 0) {  // one row: b * inv, over the diagonal 1
      b[c] = b[c] * di[c];
      di[c] = T(1);
    }
    b[c] = b[c] / di[c];
  }
}

// The same row-scaled PCR with ONE system per warp, in registers: row i of
// n <= 32 S rows (S <= 8) at lane i % 32, slot i / 32 of the arrays. Rows at
// or beyond n are identity rows (lo = up = b = 0, di = 1), set on entry and
// never updated, like the block layout's padding, and so are the neighbours
// beyond both ends of the system.
//
// A level at stride st < 32 rotates each slot's four values by st lanes
// (one shuffle each, both ways): row i's neighbour i - st is the rotated
// value of its own slot for lanes >= st and of the slot below otherwise, and
// i + st likewise from the slot above. At st >= 32 the neighbours are in
// the same lane, st / 32 slots away: a register move. Slots are updated in
// order, each from rotations taken before its own update and that of the
// slot above, so every row reads its neighbours' values of the level
// before, as the plain version does. No barrier and no shared memory.
template <typename T>
struct WarpRow {
  T lo, di, up, b;
};

template <typename T>
__device__ __forceinline__ WarpRow<T> identity_row() {
  return {T(0), T(1), T(0), T(0)};
}

template <typename T>
__device__ __forceinline__ WarpRow<T> rotate(T lo, T di, T up, T b, int src) {
  return {__shfl_sync(0xffffffffu, lo, src), __shfl_sync(0xffffffffu, di, src),
          __shfl_sync(0xffffffffu, up, src), __shfl_sync(0xffffffffu, b, src)};
}

// one row's update from its neighbours m = i - st and p = i + st
template <typename T, int KIND>
__device__ __forceinline__ void warp_pcr_row(T& lo, T& di, T& up, T& b, const WarpRow<T>& m,
                                             const WarpRow<T>& p) {
  const PcrRow<T> q = pcr_row_update<T, KIND>(PcrRow<T>{lo, di, up, b},
                                              PcrRow<T>{m.lo, m.di, m.up, m.b},
                                              PcrRow<T>{p.lo, p.di, p.up, p.b});
  lo = q.lo;
  di = q.di;
  up = q.up;
  b = q.b;
}

template <typename T, int S, int KIND, int ST>
__device__ __forceinline__ void warp_pcr_level(T (&lo)[S], T (&di)[S], T (&up)[S], T (&b)[S],
                                               int n, int lane) {
  if (ST < 32) {
    const int src_m = (lane - ST) & 31, src_p = (lane + ST) & 31;
    const bool wrap_m = lane < ST, wrap_p = lane + ST >= 32;
    WarpRow<T> below = identity_row<T>();  // slot s - 1 rotated up
    WarpRow<T> here_p = rotate<T>(lo[0], di[0], up[0], b[0], src_p);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const WarpRow<T> here_m = rotate<T>(lo[s], di[s], up[s], b[s], src_m);
      const int a = s + 1 < S ? s + 1 : s;
      const WarpRow<T> above_p =
          s + 1 < S ? rotate<T>(lo[a], di[a], up[a], b[a], src_p) : identity_row<T>();
      if (lane + 32 * s < n)
        warp_pcr_row<T, KIND>(lo[s], di[s], up[s], b[s], wrap_m ? below : here_m,
                              wrap_p ? above_p : here_p);
      below = here_m;
      here_p = above_p;
    }
  } else {
    constexpr int D = ST / 32;
    WarpRow<T> old[S];
#pragma unroll
    for (int s = 0; s < S; ++s) old[s] = {lo[s], di[s], up[s], b[s]};
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (lane + 32 * s < n)
        warp_pcr_row<T, KIND>(lo[s], di[s], up[s], b[s],
                              s - D >= 0 ? old[s - D >= 0 ? s - D : 0] : identity_row<T>(),
                              s + D < S ? old[s + D < S ? s + D : 0] : identity_row<T>());
  }
}

// level `level` >= 1 at stride ST: the last one or one between
template <typename T, int S, int ST>
__device__ __forceinline__ void warp_pcr_later(T (&lo)[S], T (&di)[S], T (&up)[S], T (&b)[S],
                                               int n, int steps, int level, int lane) {
  if (level + 1 < steps)
    warp_pcr_level<T, S, PCR_MID, ST>(lo, di, up, b, n, lane);
  else
    warp_pcr_level<T, S, PCR_LAST, ST>(lo, di, up, b, n, lane);
}

// Solve the warp's system of n rows (ceil(log2 n) = `steps` levels, as
// pcr_solve, NEG likewise); on return b[s] holds the solution of row
// lane + 32 s. Every lane of the warp calls it.
template <typename T, int S, bool NEG>
__device__ __forceinline__ void warp_pcr_solve(T (&lo)[S], T (&di)[S], T (&up)[S], T (&b)[S],
                                               int n, int steps, int lane) {
  static_assert(S >= 1 && S <= 8, "a warp holds at most 256 rows");
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (lane + 32 * s < n) {
      const T inv = T(1) / di[s];
      lo[s] = lo[s] * inv;
      up[s] = up[s] * inv;
      di[s] = inv;  // the first level's row (PcrLevel)
    } else {
      lo[s] = T(0);
      up[s] = T(0);
      b[s] = T(0);
      di[s] = T(1);
    }
  }
  if (steps > 0) warp_pcr_level<T, S, NEG ? PCR_FIRST_NEG : PCR_FIRST, 1>(lo, di, up, b, n, lane);
  if (steps > 1) warp_pcr_later<T, S, 2>(lo, di, up, b, n, steps, 1, lane);
  if (steps > 2) warp_pcr_later<T, S, 4>(lo, di, up, b, n, steps, 2, lane);
  if (steps > 3) warp_pcr_later<T, S, 8>(lo, di, up, b, n, steps, 3, lane);
  if (steps > 4) warp_pcr_later<T, S, 16>(lo, di, up, b, n, steps, 4, lane);
  if (steps > 5) warp_pcr_later<T, S, 32>(lo, di, up, b, n, steps, 5, lane);
  if (steps > 6) warp_pcr_later<T, S, 64>(lo, di, up, b, n, steps, 6, lane);
  if (steps > 7) warp_pcr_later<T, S, 128>(lo, di, up, b, n, steps, 7, lane);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (steps == 0) {  // one row: b * inv, over the diagonal 1
      b[s] = b[s] * di[s];
      di[s] = T(1);
    }
    b[s] = b[s] / di[s];
  }
}

// the per-block stride of a wide workspace: `words` rounded up to 32 words,
// so every block's buffers start aligned
__host__ __device__ inline size_t wide_stride(size_t words) { return (words + 31) / 32 * 32; }

// rows per thread of a block that strides n rows over at most 1024 threads:
// the least power of two that is enough (1, 2 or 4 up to n = 4096, the
// register builds; more where the cluster builds sum a crossing area in
// their order)
__host__ __device__ inline int rows_per_thread(int n) {
  int cpt = 1;
  while (cpt * 1024 < n) cpt *= 2;
  return cpt;
}

// slots per lane of a warp that holds n <= 256 rows: the builds have 1, 2,
// 4, 6 or 8
inline int warp_slots(int n) {
  const int s = (n + 31) / 32;
  return s <= 2 ? s : (s <= 4 ? 4 : (s <= 6 ? 6 : 8));
}

__host__ __device__ inline int round_up_32(int v) { return ((v + 31) / 32) * 32; }

// the shared memory a block can use on Hopper (232,448 bytes)
constexpr size_t MAX_SHARED_BYTES = 232448;

// the dynamic shared memory a kernel asks for above the default 48 KB
template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the blocks of `threads` threads and `shmem` bytes of dynamic shared memory
// that one SM keeps resident (0: the kernel cannot launch so)
template <typename Kernel>
inline int resident_blocks(Kernel kernel, int threads, size_t shmem) {
  int blocks = 0;
  if (shmem > MAX_SHARED_BYTES || allow_shared(kernel, shmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, shmem) !=
          cudaSuccess)
    return 0;
  return blocks;
}

}  // namespace
