// The weather draws of the noise-forced engines as device functions:
// bit for bit jax.random.normal(key, (nt,), float32) under the partitionable
// threefry layout, as ops/prng.py computes them in plain PyTorch.
//
// Replaces the in-kernel generator of the TPU kernels,
// energybalancemodel_jl_tpu/ops/pallas_year.py::_gen_noise_xk (which calls
// energybalancemodel_jl_tpu/ops/prng.py). Draw t of a member with key
// (k1, k2) is the threefry-2x32 cipher of counter words (0, t), its two output
// words xor-ed, mapped to U(lo, 1) by the mantissa fill and then to a normal
// by sqrt(2) * erfinv (the Giles polynomial pair, with the log1p XLA:CPU emits
// for float32).
//
// JAX's values come from XLA, which contracts each a * b + c of the pipeline
// into one fused multiply-add. The package builds with -fmad=false, so
// __fmaf_rn stands at exactly those places and every other operation is a
// plain IEEE operation; the square root is the correctly rounded __fsqrt_rn.
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// threefry-2x32, 20 rounds in 5 groups of 4, a key injection after each
// group (JAX's unrolled lowering, ops/prng.py::threefry2x32)
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2, uint32_t x1,
                                             uint32_t x2, uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = x1 + ks[0], y0 = x2 + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 = x0 + y0;
      y0 = x0 ^ rotl32(y0, rot[g % 2][r]);
    }
    x0 = x0 + ks[(g + 1) % 3];
    y0 = y0 + ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
  o0 = x0;
  o1 = y0;
}

// log1p(x) as XLA:CPU emits it for float32: a rational P/Q for
// |x| < sqrt(2) - 1, else the Cephes logf of 1 + x
__device__ __forceinline__ float log1p_xla(float x) {
  float q = 1.0f;
  q = __fmaf_rn(q, x, 1.5062909e+01f);
  q = __fmaf_rn(q, x, 8.304757e+01f);
  q = __fmaf_rn(q, x, 2.217624e+02f);
  q = __fmaf_rn(q, x, 3.0909872e+02f);
  q = __fmaf_rn(q, x, 2.1642789e+02f);
  q = __fmaf_rn(q, x, 6.011866e+01f);
  float p = 4.527e-05f;
  p = __fmaf_rn(p, x, 4.9854103e-01f);
  p = __fmaf_rn(p, x, 6.5787325e+00f);
  p = __fmaf_rn(p, x, 2.9911919e+01f);
  p = __fmaf_rn(p, x, 6.094967e+01f);
  p = __fmaf_rn(p, x, 5.7112965e+01f);
  p = __fmaf_rn(p, x, 2.0039553e+01f);
  const float xx2 = x * x;
  float s = (x * xx2) * (p / q);
  s = __fmaf_rn(xx2, -0.5f, s);
  const float small = x + s;

  const float y = x + 1.0f;
  const float yc = y > 1.17549435e-38f ? y : 1.17549435e-38f;  // 2^-126
  const uint32_t bits = __float_as_uint(yc);
  const float e = (float)((int)(bits >> 23) - 127) + 1.0f;
  const float m = __uint_as_float((bits & 0x7FFFFFu) | 0x3F000000u);
  const bool lo_m = m < 7.0710677e-01f;
  const float xx = lo_m ? (m - 1.0f) + m : m - 1.0f;
  const float k = lo_m ? e - 1.0f : e;
  const float z = xx * xx;
  const float z3 = z * xx;
  const float p0 = __fmaf_rn(__fmaf_rn(xx, 7.0376836e-02f, -1.151461e-01f), xx, 1.16769984e-01f);
  const float p1 = __fmaf_rn(__fmaf_rn(xx, -1.2420141e-01f, 1.4249323e-01f), xx, -1.6668057e-01f);
  const float p2 = __fmaf_rn(__fmaf_rn(xx, 2.0000714e-01f, -2.4999994e-01f), xx, 3.333333e-01f);
  const float t = __fmaf_rn(__fmaf_rn(__fmaf_rn(p0, z3, p1), z3, p2), z3, k * -2.1219444e-04f);
  float r = __fmaf_rn(-z, 0.5f, xx);
  r = __fmaf_rn(k, 6.933594e-01f, r + t);
  if (y < 0.0f) r = __int_as_float(0x7fc00000);
  if (y == 0.0f) r = -__int_as_float(0x7f800000);
  if (y == __int_as_float(0x7f800000)) r = y;
  return fabsf(x) < 4.1421357e-01f ? small : r;
}

// erfinv(u), |u| < 1: the Giles single-precision pair, branch on w < 5
__device__ __forceinline__ float erfinv_xla(float u) {
  const float w = -log1p_xla(-(u * u));
  const float w1 = w - 2.5f;
  const float w2 = __fsqrt_rn(w) - 3.0f;
  float p1 = 2.8102264e-08f;
  p1 = __fmaf_rn(p1, w1, 3.4327394e-07f);
  p1 = __fmaf_rn(p1, w1, -3.5233877e-06f);
  p1 = __fmaf_rn(p1, w1, -4.3915065e-06f);
  p1 = __fmaf_rn(p1, w1, 2.1858087e-04f);
  p1 = __fmaf_rn(p1, w1, -1.253725e-03f);
  p1 = __fmaf_rn(p1, w1, -4.1776816e-03f);
  p1 = __fmaf_rn(p1, w1, 2.4664073e-01f);
  p1 = __fmaf_rn(p1, w1, 1.5014094e+00f);
  float p2 = -2.0021426e-04f;
  p2 = __fmaf_rn(p2, w2, 1.0095056e-04f);
  p2 = __fmaf_rn(p2, w2, 1.3493432e-03f);
  p2 = __fmaf_rn(p2, w2, -3.6734284e-03f);
  p2 = __fmaf_rn(p2, w2, 5.7395077e-03f);
  p2 = __fmaf_rn(p2, w2, -7.6224613e-03f);
  p2 = __fmaf_rn(p2, w2, 9.4388705e-03f);
  p2 = __fmaf_rn(p2, w2, 1.001674e+00f);
  p2 = __fmaf_rn(p2, w2, 2.8329768e+00f);
  return (w < 5.0f ? p1 : p2) * u;
}

// 32 random bits -> a float32 standard normal draw: U(lo, 1) by the mantissa
// fill, lo = nextafter(-1, 0), then sqrt(2) * erfinv
__device__ __forceinline__ float normal_from_bits(uint32_t bits) {
  const float lo = -9.9999994e-01f;
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float v = __fmaf_rn(f, 2.0f, lo);
  const float u = v < lo ? lo : v;
  return 1.4142135e+00f * erfinv_xla(u);
}

// draw t of the member keyed (k1, k2): counter words (0, t), output o0 ^ o1
__device__ __forceinline__ float normal_draw(uint32_t k1, uint32_t k2, uint32_t t) {
  uint32_t o0, o1;
  threefry2x32(k1, k2, 0u, t, o0, o1);
  return normal_from_bits(o0 ^ o1);
}

}  // namespace
