// Device code shared by the package's kernels (miz_year.cu, classic_year.cu,
// pcr.cu, newton_t0.cu): NaN-aware helpers, a block-wide max of magnitudes,
// and the row-scaled parallel cyclic reduction of ops/tridiag.py::pcr_solve,
// for one system per block in shared memory (pcr_solve), for one system per
// warp in registers (warp_pcr_solve), and for one system per block in
// device memory (wide_pcr_solve, K10's and K11's wide builds above 4096
// rows; the year kernels' cluster builds have their own, cluster.cuh).
//
// Every helper performs the same operations in the same order as the plain
// PyTorch code it stands for, so a kernel built with -fmad=false rounds where
// the plain version does.
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
// Several rows per thread (n > 1024, the wide builds): the padded pair would
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

// One doubling level at stride st. FIRST: every diagonal is 1 (the row
// scaling, and the identity rows) and x / 1 is x, so the level divides
// nothing.
template <typename T, int CPT, bool FIRST>
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
      const PcrRow<T> m = load_row(cur + im);
      const PcrRow<T> p = load_row(cur + ip);
      const T alpha = FIRST ? -lo[c] : safe_div(-lo[c], m.di);
      const T beta = FIRST ? -up[c] : safe_div(-up[c], p.di);
      b[c] = b[c] + alpha * m.b + beta * p.b;
      di[c] = di[c] + alpha * m.up + beta * p.lo;
      lo[c] = alpha * m.lo;
      up[c] = beta * p.up;
    }
  }
  if (CPT > 1) __syncthreads();  // one buffer: reads done before the next write
}

// Row-scaled parallel cyclic reduction of ONE system of n rows per block
// (ops/tridiag.py::pcr_solve): thread t holds rows t + c * blockDim.x,
// c < CPT, in the arrays. ceil(log2 n) = `steps` doubling levels; rows out of
// range are the identity rows of the layout. One barrier per level with one
// row per thread (CPT = 1), two in the wide builds. On return b[c] holds the
// solution of row c.
template <typename T, int CPT>
__device__ __forceinline__ void pcr_solve(T (&lo)[CPT], T (&di)[CPT], T (&up)[CPT],
                                          T (&b)[CPT], PcrSmem<T>& s, int n, int steps) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const T inv = T(1) / di[c];
    lo[c] = lo[c] * inv;
    up[c] = up[c] * inv;
    b[c] = b[c] * inv;
    di[c] = T(1);
  }
  if (steps > 0) pcr_level<T, CPT, true>(lo, di, up, b, s, n, 1);
  for (int level = 1, st = 2; level < steps; ++level, st <<= 1)
    pcr_level<T, CPT, false>(lo, di, up, b, s, n, st);
#pragma unroll
  for (int c = 0; c < CPT; ++c) b[c] = b[c] / di[c];
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

template <typename T, bool FIRST>
__device__ __forceinline__ WarpRow<T> rotate(T lo, T di, T up, T b, int src) {
  return {__shfl_sync(0xffffffffu, lo, src), FIRST ? T(1) : __shfl_sync(0xffffffffu, di, src),
          __shfl_sync(0xffffffffu, up, src), __shfl_sync(0xffffffffu, b, src)};
}

// one row's update from its neighbours m = i - st and p = i + st, the
// operations of pcr_level in its order
template <typename T, bool FIRST>
__device__ __forceinline__ void warp_pcr_row(T& lo, T& di, T& up, T& b, const WarpRow<T>& m,
                                             const WarpRow<T>& p) {
  const T alpha = FIRST ? -lo : safe_div(-lo, m.di);
  const T beta = FIRST ? -up : safe_div(-up, p.di);
  b = b + alpha * m.b + beta * p.b;
  di = di + alpha * m.up + beta * p.lo;
  lo = alpha * m.lo;
  up = beta * p.up;
}

template <typename T, int S, bool FIRST, int ST>
__device__ __forceinline__ void warp_pcr_level(T (&lo)[S], T (&di)[S], T (&up)[S], T (&b)[S],
                                               int n, int lane) {
  if (ST < 32) {
    const int src_m = (lane - ST) & 31, src_p = (lane + ST) & 31;
    const bool wrap_m = lane < ST, wrap_p = lane + ST >= 32;
    WarpRow<T> below = identity_row<T>();  // slot s - 1 rotated up
    WarpRow<T> here_p = rotate<T, FIRST>(lo[0], di[0], up[0], b[0], src_p);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const WarpRow<T> here_m = rotate<T, FIRST>(lo[s], di[s], up[s], b[s], src_m);
      const int a = s + 1 < S ? s + 1 : s;
      const WarpRow<T> above_p =
          s + 1 < S ? rotate<T, FIRST>(lo[a], di[a], up[a], b[a], src_p) : identity_row<T>();
      if (lane + 32 * s < n)
        warp_pcr_row<T, FIRST>(lo[s], di[s], up[s], b[s], wrap_m ? below : here_m,
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
        warp_pcr_row<T, FIRST>(lo[s], di[s], up[s], b[s],
                               s - D >= 0 ? old[s - D >= 0 ? s - D : 0] : identity_row<T>(),
                               s + D < S ? old[s + D < S ? s + D : 0] : identity_row<T>());
  }
}

// Solve the warp's system of n rows (ceil(log2 n) = `steps` levels, as
// pcr_solve); on return b[s] holds the solution of row lane + 32 s. Every
// lane of the warp calls it.
template <typename T, int S>
__device__ __forceinline__ void warp_pcr_solve(T (&lo)[S], T (&di)[S], T (&up)[S], T (&b)[S],
                                               int n, int steps, int lane) {
  static_assert(S >= 1 && S <= 8, "a warp holds at most 256 rows");
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (lane + 32 * s < n) {
      const T inv = T(1) / di[s];
      lo[s] = lo[s] * inv;
      up[s] = up[s] * inv;
      b[s] = b[s] * inv;
    } else {
      lo[s] = T(0);
      up[s] = T(0);
      b[s] = T(0);
    }
    di[s] = T(1);
  }
  if (steps > 0) warp_pcr_level<T, S, true, 1>(lo, di, up, b, n, lane);
  if (steps > 1) warp_pcr_level<T, S, false, 2>(lo, di, up, b, n, lane);
  if (steps > 2) warp_pcr_level<T, S, false, 4>(lo, di, up, b, n, lane);
  if (steps > 3) warp_pcr_level<T, S, false, 8>(lo, di, up, b, n, lane);
  if (steps > 4) warp_pcr_level<T, S, false, 16>(lo, di, up, b, n, lane);
  if (steps > 5) warp_pcr_level<T, S, false, 32>(lo, di, up, b, n, lane);
  if (steps > 6) warp_pcr_level<T, S, false, 64>(lo, di, up, b, n, lane);
  if (steps > 7) warp_pcr_level<T, S, false, 128>(lo, di, up, b, n, lane);
#pragma unroll
  for (int s = 0; s < S; ++s) b[s] = b[s] / di[s];
}

// -- THE WIDE BUILDS of K10 and K11 (pcr.cu, newton_t0.cu above n = 4096):
// one block of WIDE_THREADS threads per system, rows strided over them (row
// i at thread i % WIDE_THREADS), and every per-row value in a workspace of
// device memory that the block owns (the state of 32768 rows does not fit
// an SM's registers and shared memory). 512 threads leave a thread 128
// registers. A block loops over systems m, m + gridDim.x, ..., so the
// workspace scales with the blocks launched, not with K. The workspace is
// read and written through plain pointers: a load through the read-only
// path (const __restrict__, ld.global.nc) is not coherent with the block's
// own writes. A __syncthreads() orders the block's global writes before its
// reads as it orders shared ones. (The year kernels' wide grids run on
// thread-block clusters instead, cluster.cuh.)
//
// The PCR of a wide block: two buffers of rows in the workspace, each with
// one identity row on each side, written level by level in turn:
//   [I][buffer 0: n][I] [I][buffer 1: n][I]
// A level reads its row and the rows at i -+ st of one buffer, the reach
// clamped onto the identity rows (the semantics of pcr_level's CPT > 1
// branch, and of ops/tridiag.py::pcr_solve's fills), and writes the next
// buffer: one barrier per level (write, ONE barrier, read, as above).
constexpr int WIDE_THREADS = 512;

template <typename T>
struct WidePcr {
  PcrRow<T>* rows;  // row 0 of buffer 0; buffer 1 is n + 2 rows on
  int n;
};

// words of T the two buffers take
__host__ __device__ inline size_t wide_pcr_words(int n) { return 8 * (size_t)(n + 2); }

// Lay the buffers out at the start of the block's workspace (aligned to a
// row) and write the identity rows, once per kernel: no level writes them.
// The barrier before a solve's first level orders them before any read.
template <typename T>
__device__ __forceinline__ WidePcr<T> wide_pcr_begin(T* ws, int n) {
  PcrRow<T>* rows = reinterpret_cast<PcrRow<T>*>(ws) + 1;
  if (threadIdx.x < 4) {  // rows -1 and n of both buffers
    PcrRow<T>* buf = rows + (threadIdx.x >> 1) * (n + 2);
    store_row(buf + ((threadIdx.x & 1) ? n : -1), T(0), T(1), T(0), T(0));
  }
  return WidePcr<T>{rows, n};
}

// row i of the system into buffer 0, row-scaled as pcr_solve scales it
template <typename T>
__device__ __forceinline__ void wide_pcr_row(const WidePcr<T>& s, int i, T lo, T di, T up,
                                             T b) {
  const T inv = T(1) / di;
  store_row(s.rows + i, lo * inv, T(1), up * inv, b * inv);
}

// One doubling level at stride st, the operations of pcr_level in its
// order. A thread loads ROWS of its rows (each with its two neighbours)
// before it computes and stores any: the compiler cannot move a load past
// a store to the other buffer, so one row at a time would wait out a
// device-memory round trip per row.
template <typename T, bool FIRST>
__device__ __forceinline__ void wide_pcr_level(const PcrRow<T>* cur, PcrRow<T>* next, int n,
                                               int st) {
  constexpr int ROWS = 16 / sizeof(T);
  for (int i0 = threadIdx.x; i0 < n; i0 += ROWS * blockDim.x) {
    PcrRow<T> o[ROWS], m[ROWS], p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r * blockDim.x;
      if (i < n) {
        o[r] = load_row(cur + i);
        m[r] = load_row(cur + (i - st < -1 ? -1 : i - st));
        p[r] = load_row(cur + (i + st > n ? n : i + st));
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r * blockDim.x;
      if (i < n) {
        const T alpha = FIRST ? -o[r].lo : safe_div(-o[r].lo, m[r].di);
        const T beta = FIRST ? -o[r].up : safe_div(-o[r].up, p[r].di);
        const T b = o[r].b + alpha * m[r].b + beta * p[r].b;
        const T di = o[r].di + alpha * m[r].up + beta * p[r].lo;
        store_row(next + i, alpha * m[r].lo, di, beta * p[r].up, b);
      }
    }
  }
  __syncthreads();
}

// Solve the system whose rows every thread wrote to buffer 0
// (wide_pcr_row): ceil(log2 n) = `steps` levels, one barrier before the
// first and one after each. Returns the buffer of the reduced rows: row i's
// solution is its b / di (wide_pcr_x). Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ const PcrRow<T>* wide_pcr_solve(const WidePcr<T>& s, int steps) {
  PcrRow<T>* cur = s.rows;
  PcrRow<T>* next = s.rows + (s.n + 2);
  __syncthreads();
  for (int level = 0, st = 1; level < steps; ++level, st <<= 1) {
    if (level == 0)
      wide_pcr_level<T, true>(cur, next, s.n, st);
    else
      wide_pcr_level<T, false>(cur, next, s.n, st);
    PcrRow<T>* sw = cur;
    cur = next;
    next = sw;
  }
  return cur;
}

template <typename T>
__device__ __forceinline__ T wide_pcr_x(const PcrRow<T>* rows, int i) {
  const PcrRow<T> r = load_row(rows + i);
  return r.b / r.di;
}

// the per-block stride of a wide workspace: `words` rounded up to 32 words,
// so every block's buffers start aligned
__host__ __device__ inline size_t wide_stride(size_t words) { return (words + 31) / 32 * 32; }

// rows per thread of a block that strides n rows over at most 1024 threads:
// the least power of two that is enough (1, 2 or 4 up to n = 4096, the
// register builds; more in the wide builds)
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
