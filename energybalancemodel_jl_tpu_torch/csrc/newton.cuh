// The T0eq residual of the MIZ ice surface temperature with its tridiagonal
// Jacobian, and the neighbour exchange it needs: shared by the whole-year
// kernel (miz_year.cu, models/miz.py::_t0_residual and ::_t0_bands) and the
// stand-alone fixed-iteration Newton kernel (newton_t0.cu,
// ops/newton_t0.py::newton_t0_reference). The two plain versions differ in
// two places, both template flags here:
//   - WRAP: what a cell at the end of the grid sees beyond it. The year
//     kernel rolls like torch.roll (the wrapped value meets a zero band of
//     the stencil, but a NaN there still counts); the stand-alone kernel
//     sees zero.
//   - KH: the conduction term. The year kernel computes k (Tm - T0) / hp and
//     -k / hp as models/miz.py writes them; the stand-alone kernel takes
//     kh = k / hp hoisted out of its iteration, kh (Tm - T0) and -kh.
// Everything else is one sequence of operations, so each kernel rounds
// where its plain version does.
#pragma once

#include "common.cuh"

namespace {

// Two values of one cell, exchanged together: 8 bytes in float32, 16 in
// float64, one access either way.
template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T a, b;
};

__device__ __forceinline__ Pair<float> load_pair(const Pair<float>* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return {v.x, v.y};
}
__device__ __forceinline__ Pair<double> load_pair(const Pair<double>* p) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  return {v.x, v.y};
}
__device__ __forceinline__ void store_pair(Pair<float>* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(Pair<double>* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// The neighbour exchange of an n-cell grid: two buffers of n cells written
// in turn (one barrier per exchange, common.cuh), each with one cell before
// and one after it for what lies beyond the grid:
//   [1][buffer 0: n][1] [1][buffer 1: n][1]
// With WRAP the end cells write their value there at every exchange (cell 0
// after the last, the last before cell 0), so a read of i - 1 and i + 1 needs
// no index test; without it the outer cells hold zero, written once. A grid
// of more than 1024 cells (several per thread, newton_t0.cu only) has one
// buffer and a second barrier per exchange, as the PCR has there: the pair
// would not fit beside the PCR rows in float64 at n = 4096.
template <typename T>
struct Halo {
  Pair<T>* cells;  // cell 0 of buffer 0
  int stride;      // n + 2, or 0: one buffer
  int turn;
};

template <typename T>
__host__ __device__ inline size_t halo_shared_bytes(int n) {
  return sizeof(Pair<T>) * (n > 1024 ? 1 : 2) * (size_t)(n + 2);
}

template <typename T, bool WRAP>
__device__ __forceinline__ Halo<T> halo_begin(void* base, int n) {
  Pair<T>* cells = static_cast<Pair<T>*>(base) + 1;
  if (!WRAP && threadIdx.x == 0) {
    for (int buf = 0; buf < (n > 1024 ? 1 : 2); ++buf) {
      store_pair(cells + buf * (n + 2) - 1, T(0), T(0));
      store_pair(cells + buf * (n + 2) + n, T(0), T(0));
    }
  }
  return Halo<T>{cells, n > 1024 ? 0 : n + 2, 0};
}

// the buffer of this exchange; the next one takes the other
template <typename T>
__device__ __forceinline__ Pair<T>* halo_turn(Halo<T>& h) {
  Pair<T>* cur = h.cells + (h.turn ? h.stride : 0);
  h.turn ^= 1;
  return cur;
}

// (v[i-1], v[i+1]) of one field, rolled at the ends; one barrier
template <typename T>
__device__ __forceinline__ void exchange_rolled(T v, Halo<T>& h, int i, int n, T& vm1,
                                                T& vp1) {
  Pair<T>* cur = halo_turn(h);
  if (i < n) {
    cur[i].a = v;
    if (i == 0) cur[n].a = v;
    if (i == n - 1) cur[-1].a = v;
  }
  __syncthreads();
  if (i < n) {
    vm1 = cur[i - 1].a;
    vp1 = cur[i + 1].a;
  }
}

// the frozen inputs of one cell's residual
template <typename T>
struct T0Cell {
  T glo, gdi, gup;  // stencil bands
  T phi;            // ice concentration
  T water;          // (1 - phi) Tw
  T solar;          // ai insol
  T kh;             // KH: k / hp, else hp
};

template <typename T>
struct T0Par {
  T k, Tm, A, B, D, f;
};

// (Tb, g) of one cell at the iterate T0: the values the residual exchanges
template <typename T>
__device__ __forceinline__ Pair<T> t0_tb_g(T T0, const T0Cell<T>& e, const T0Par<T>& p) {
  const T Ti = nan_min(T0, p.Tm);
  return {Ti * e.phi + e.water, e.phi * (T0 < p.Tm ? T(1) : T(0))};
}

// r and the Jacobian row of one cell from its own (Tb, g) and its
// neighbours' m (cell i - 1) and q (cell i + 1)
template <typename T, bool KH>
__device__ __forceinline__ void t0_row(T T0, const T0Cell<T>& e, const T0Par<T>& p,
                                       const Pair<T>& own, const Pair<T>& m, const Pair<T>& q,
                                       T& r, T& jlo, T& jdi, T& jup) {
  T res = KH ? e.kh * (p.Tm - T0) : p.k * (p.Tm - T0) / e.kh;
  res = res + e.solar;
  res = res + ((-p.A) - p.B * (T0 - p.Tm));
  res = res + p.D * (e.glo * m.a + e.gdi * own.a + e.gup * q.a);
  res = res + p.f;
  r = res;
  jlo = p.D * e.glo * m.b;
  jdi = (KH ? -e.kh : -p.k / e.kh) - p.B + p.D * e.gdi * own.b;
  jup = p.D * e.gup * q.b;
}

// r[c] and the Jacobian bands of the cells this thread holds (rows
// t + c * blockDim.x); a thread's cells beyond the grid keep what the arrays
// held. One barrier (two with several cells per thread).
template <typename T, int CPT, bool WRAP, bool KH>
__device__ __forceinline__ void t0_residual_bands(const T (&T0)[CPT],
                                                  const T0Cell<T> (&cell)[CPT],
                                                  const T0Par<T>& p, Halo<T>& h, int n,
                                                  T (&r)[CPT], T (&jlo)[CPT], T (&jdi)[CPT],
                                                  T (&jup)[CPT]) {
  Pair<T>* cur = halo_turn(h);
  Pair<T> own[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    own[c] = t0_tb_g(T0[c], cell[c], p);
    if (i < n) {
      store_pair(cur + i, own[c].a, own[c].b);
      if (WRAP) {
        if (i == 0) store_pair(cur + n, own[c].a, own[c].b);
        if (i == n - 1) store_pair(cur - 1, own[c].a, own[c].b);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i >= n) continue;
    t0_row<T, KH>(T0[c], cell[c], p, own[c], load_pair(cur + i - 1), load_pair(cur + i + 1),
                  r[c], jlo[c], jdi[c], jup[c]);
  }
  if (CPT > 1) __syncthreads();  // one buffer: reads done before the next write
}

// -- the wide builds (common.cuh): the exchange's two buffers in the
// block's workspace, after its PCR rows, and every cell's inputs, iterate
// and residual in its record

// words of T the exchange's two buffers take
__host__ __device__ inline size_t wide_halo_words(int n) { return 4 * (size_t)(n + 2); }

template <typename T, bool WRAP>
__device__ __forceinline__ Halo<T> wide_halo_begin(T* ws, int n) {
  Pair<T>* cells = reinterpret_cast<Pair<T>*>(ws) + 1;
  if (!WRAP && threadIdx.x < 4) {  // the zero cells -1 and n of both buffers
    Pair<T>* buf = cells + (threadIdx.x >> 1) * (n + 2);
    store_pair(buf + ((threadIdx.x & 1) ? n : -1), T(0), T(0));
  }
  return Halo<T>{cells, n + 2, 0};
}

// A wide block's per-cell fields are one record of NF values per cell
// (cell i's at fld + i * NF, so a thread reaches all of a cell's fields from
// one address), the solve's fields first, in this order; the kernels append
// their own.
enum NewtonField {
  F_T0,                           // the iterate
  F_PHI, F_WATER, F_SOLAR, F_KH,  // frozen for the solve
  N_NEWTON_FIELDS
};

template <typename T, int NF>
struct WideCells {
  const T* glo;  // stencil bands (kernel inputs, never written)
  const T* gdi;
  const T* gup;
  T* fld;  // the records

  __device__ __forceinline__ T* at(int i) const { return fld + (size_t)i * NF; }
  __device__ __forceinline__ T0Cell<T> cell(int i) const {
    const T* c = at(i);
    return {glo[i], gdi[i], gup[i], c[F_PHI], c[F_WATER], c[F_SOLAR], c[F_KH]};
  }
};

// the write half of the residual's exchange for cell i: its (Tb, g) into
// buffer cur (halo_turn), rolled at the ends with WRAP
template <typename T, int NF, bool WRAP>
__device__ __forceinline__ void wide_t0_put(const WideCells<T, NF>& w, const T0Par<T>& p,
                                            Pair<T>* cur, int i, int n) {
  const Pair<T> v = t0_tb_g(w.at(i)[F_T0], w.cell(i), p);
  store_pair(cur + i, v.a, v.b);
  if (WRAP) {
    if (i == 0) store_pair(cur + n, v.a, v.b);
    if (i == n - 1) store_pair(cur - 1, v.a, v.b);
  }
}

// The read half, after the barrier that follows every thread's puts: each
// of this thread's cells' residual and Jacobian row, written as the row of
// the Newton update's system (jlo, jdi, jup | -r) into the PCR's buffer 0
// (wide_pcr_row; a caller that takes no update leaves it unread). Returns
// the largest magnitude key of the cells' |r| (0 for a thread with none),
// for block_max_key.
template <typename T, int NF, bool KH>
__device__ __forceinline__ MagnitudeKey<T> wide_t0_rows(const WideCells<T, NF>& w,
                                                        const T0Par<T>& p, const Pair<T>* cur,
                                                        const WidePcr<T>& pcr, int n) {
  MagnitudeKey<T> key = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    T r, jlo, jdi, jup;
    t0_row<T, KH>(w.at(i)[F_T0], w.cell(i), p, load_pair(cur + i), load_pair(cur + i - 1),
                  load_pair(cur + i + 1), r, jlo, jdi, jup);
    wide_pcr_row(pcr, i, jlo, jdi, jup, -r);
    const MagnitudeKey<T> k = magnitude_key(abs_val(r));
    key = k > key ? k : key;
  }
  return key;
}

}  // namespace
