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
//   - R0 (the year kernel's first residual of a step): ai insol contracted
//     into the conduction term; every other residual adds the rounded
//     product `solar` (models/miz.py::_t0_residual).
// Everything else is one sequence of operations, with the fused
// multiply-adds of models/miz.py (utils/numerics.py), so each kernel rounds
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
  T insol;          // R0: the insolation
  T kh;             // KH: k / hp, else hp
};

template <typename T>
struct T0Par {
  T k, Tm, A, B, D, f, ai;
};

// (Tb, g) of one cell at the iterate T0: the values the residual exchanges
template <typename T>
__device__ __forceinline__ Pair<T> t0_tb_g(T T0, const T0Cell<T>& e, const T0Par<T>& p) {
  const T Ti = nan_min(T0, p.Tm);
  return {fma_rn(Ti, e.phi, e.water), e.phi * (T0 < p.Tm ? T(1) : T(0))};
}

// r and the Jacobian row of one cell from its own (Tb, g) and its
// neighbours' m (cell i - 1) and q (cell i + 1)
template <typename T, bool KH, bool R0>
__device__ __forceinline__ void t0_row(T T0, const T0Cell<T>& e, const T0Par<T>& p,
                                       const Pair<T>& own, const Pair<T>& m, const Pair<T>& q,
                                       T& r, T& jlo, T& jdi, T& jup) {
  T res = KH ? e.kh * (p.Tm - T0) : p.k * (p.Tm - T0) / e.kh;
  res = R0 ? fma_rn(p.ai, e.insol, res) : res + e.solar;
  res = res + fma_rn(-p.B, T0 - p.Tm, -p.A);
  res = fma_rn(p.D, fma_rn(e.gup, q.a, fma_rn(e.glo, m.a, e.gdi * own.a)), res);
  res = res + p.f;
  r = res;
  jlo = p.D * e.glo * m.b;
  jdi = fma_rn(p.D * e.gdi, own.b, (KH ? -e.kh : -p.k / e.kh) - p.B);
  jup = p.D * e.gup * q.b;
}

// r[c] and the Jacobian bands of the cells this thread holds (rows
// t + c * blockDim.x); a thread's cells beyond the grid keep what the arrays
// held. One barrier (two with several cells per thread).
template <typename T, int CPT, bool WRAP, bool KH, bool R0>
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
    t0_row<T, KH, R0>(T0[c], cell[c], p, own[c], load_pair(cur + i - 1),
                      load_pair(cur + i + 1), r[c], jlo[c], jdi[c], jup[c]);
  }
  if (CPT > 1) __syncthreads();  // one buffer: reads done before the next write
}

// A cluster build's per-cell fields (miz_year.cu, newton_t0.cu), the solve's
// first, in this order; the year kernel appends its own.
enum NewtonField {
  F_T0,                           // the iterate
  F_PHI, F_WATER, F_SOLAR, F_KH,  // frozen for the solve
  N_NEWTON_FIELDS
};

}  // namespace
