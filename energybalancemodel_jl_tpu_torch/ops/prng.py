"""The weather draws of the noise-forced engines, bit for bit JAX's.

Port of the JAX package's ``ops/prng.py``: member ``k``'s white draws in
model year ``y`` are ``jax.random.normal(fold_in(fold_in(PRNGKey(seed), k),
y), (nt,), dtype)``, so the same seed gives the same weather in both
packages, and a run split into chunks or across calls draws what one run
draws (JAX ``stochastic.py:40-47``).

- Host keying (numpy ``uint32``): :func:`prng_key`, :func:`fold_in`,
  :func:`threefry2x32` give ``jax.random.key_data`` bitwise.
- The float32 draw pipeline (:func:`normal_from_bits`, :func:`normal_table`)
  in plain PyTorch, on any device: the threefry-2x32 cipher on 32-bit words
  held in int64, the mantissa fill to U(lo, 1), then ``sqrt(2) * erfinv``
  by the Giles polynomial with the ``log1p`` that XLA:CPU emits for float32.
  JAX's reference values come from XLA, which contracts each ``a * b + c``
  of the pipeline into one fused multiply-add; every such place is written
  here as :func:`fma_f32`, a single rounding, and nowhere else. The CUDA
  draw kernel (``csrc/prng.cuh``, :mod:`.normal_table`) uses ``__fmaf_rn``
  at the same places.
- :func:`normal_table_f64`: the float64 table of the f64 engines, plain
  PyTorch only (JAX builds it in XLA, outside any kernel), with XLA's own
  float64 ``erfinv`` (:func:`erfinv_f64`, :func:`log1p_f64`,
  :func:`sqrt_f64`).

Only the partitionable threefry layout is reproduced (JAX's default since
0.4.30): element ``t`` of a length-``nt`` draw uses counter words ``(0, t)``.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

__all__ = [
    "prng_key", "fold_in", "member_year_keys", "threefry2x32", "fma_f32",
    "fma_f64", "log1p_f32", "erfinv_f32", "log1p_f64", "sqrt_f64", "erfinv_f64",
    "normal_from_bits",
    "normal_table", "normal_table_f64",
]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _f(hexbits: str) -> float:
    """The double whose IEEE bits are ``hexbits`` (every constant below is a
    float32 value, written as the hex of its double)."""
    return struct.unpack(">d", bytes.fromhex(hexbits))[0]


# the Giles (2012) single-precision erfinv pair chlo.erf_inv lowers to
# (JAX ops/prng.py:55-62), branch on w < 5
ERFINV_P1 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
ERFINV_P2 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)
# XLA:CPU's float32 log1p: a rational P/Q for |x| < sqrt(2) - 1, else the
# Cephes logf of 1 + x
LOG1P_SMALL = _f("3FDA8279A0000000")
LOG1P_Q = tuple(_f(h) for h in ("402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
                                "4073519460000000", "406B0DB140000000", "404E0F3040000000"))
LOG1P_P0 = _f("3F07BC0960000000")
LOG1P_P = tuple(_f(h) for h in ("3FDFE818A0000000", "401A509F40000000", "403DE97380000000",
                                "404E798EC0000000", "404C8E75A0000000", "40340A2020000000"))
LOGF_SQRTHF = _f("3FE6A09E60000000")
LOGF_C = tuple(_f(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",   # p0
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",   # p1
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000",   # p2
))
LOGF_LN2_LO = _f("BF2BD01060000000")
LOGF_LN2_HI = _f("3FE6300000000000")
# XLA:CPU's float64 log1p: the same rational with float64 coefficients for
# |x| < sqrt(2) - 1, else the C library's log of 1 + x
LOG1P64_SMALL = _f("3FDA827999FCEF32")
LOG1P64_Q = tuple(_f(h) for h in ("402E20359E903E37", "4054C30B52213498", "406BB86590FCFB56",
                                  "407351945DC908A5", "406B0DB13E48E066", "404E0F304466448E"))
LOG1P64_P0 = _f("3F07BC0962B395CA")
LOG1P64_P = tuple(_f(h) for h in ("3FDFE818A0FE1A83", "401A509F46F4FA53", "403DE9738B8CB9C9",
                                  "404E798EB86C3351", "404C8E7597479A10", "40340A202D99830A"))
# the double-precision erfinv that chlo.erf_inv lowers to: three polynomials,
# in w - 3.125 for w < 6.25, in sqrt(w) - 3.25 for w < 16, else in
# sqrt(w) - 5 (leading coefficient first), w = -log1p(-u^2)
ERFINV64_P1 = (
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.333171662854621e-16, 2.0972767875968562e-17,
    6.637638134358324e-15, -4.054566272975207e-14, -8.151934197605472e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11, -5.415412054294628e-11,
    1.0512122733215323e-09, -4.112633980346984e-09, -2.9070369957882005e-08,
    4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.006033670871430149,
    0.24015818242558962, 1.6536545626831027,
)
ERFINV64_P2 = (
    2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
    6.828485145957318e-05, 2.4031110387097894e-05, -0.0003550375203628475,
    0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851,
    -0.003751208507569241, 0.005370914553590064, 1.0052589676941592, 3.0838856104922208,
)
ERFINV64_P3 = (
    -2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.914795345090108e-08, -6.771199775845234e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
    7.599527703001776e-05, -0.00021503011930044477, -0.00013871931833623122,
    1.0103004648645344, 4.849906401408584,
)
# U(lo, 1): lo = nextafter(-1, 0); hi - lo rounds to 2.0 in float32
UNIFORM_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32))
UNIFORM_SPAN = float(np.float32(1.0) - np.float32(UNIFORM_LO))
SQRT2_F32 = float(np.float32(np.sqrt(2)))


# -- host keying (numpy) ------------------------------------------------------

def _threefry_np(k1, k2, x1, x2):
    k1, k2, x1, x2 = (np.asarray(v, np.uint32) for v in (k1, k2, x1, x2))
    with np.errstate(over="ignore"):
        return _threefry_words(k1, k2, x1, x2, lambda v: v, lambda v, d: (v << np.uint32(d)) | (
            v >> np.uint32(32 - d)), np.uint32)


def _threefry_words(k1, k2, x1, x2, wrap, rotl, const):
    """The threefry-2x32 block cipher, op for op JAX's unrolled lowering
    (20 rounds in 5 groups of 4, a key injection after each group), on words
    that ``wrap`` reduces modulo 2^32."""
    ks = (k1, k2, k1 ^ k2 ^ const(0x1BD11BDA))
    x = [wrap(x1 + ks[0]), wrap(x2 + ks[1])]
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = wrap(x[0] + x[1])
            x = [x0, x0 ^ rotl(x[1], r)]
        x = [wrap(x[0] + ks[(g + 1) % 3]), wrap(x[1] + ks[(g + 2) % 3] + const(g + 1))]
    return x[0], x[1]


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 cipher on broadcastable 32-bit words: numpy
    ``uint32`` arrays, or torch int64 tensors holding values in
    ``[0, 2^32)``. Returns the two output words in the input's kind."""
    if not torch.is_tensor(x1):
        return _threefry_np(k1, k2, x1, x2)
    return _threefry_words(
        k1, k2, x1, x2, lambda v: v & _MASK,
        lambda v, d: ((v << d) & _MASK) | (v >> (32 - d)), lambda c: c)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.PRNGKey(seed))``: the 64-bit seed as
    two uint32 words, high word first."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & _MASK], np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in`` on key data: ``key`` is ``(2,)`` or ``(..., 2)``
    uint32; ``data`` an integer or an array broadcasting against
    ``key[..., 0]``, taken modulo 2^32."""
    key = np.asarray(key, np.uint32)
    data = np.asarray(np.asarray(data, np.int64) & _MASK, np.uint32)
    o0, o1 = _threefry_np(key[..., 0], key[..., 1], np.zeros_like(data), data)
    return np.stack(np.broadcast_arrays(o0, o1), axis=-1)


def member_year_keys(seed: int, members: int, year: int) -> np.ndarray:
    """``(members, 2)`` uint32: ``fold_in(fold_in(PRNGKey(seed), k), year)``
    for every member ``k`` (JAX ``stochastic.py:967-969, :383-385``)."""
    keys = fold_in(prng_key(seed), np.arange(members))
    return fold_in(keys, year)


# -- the float32 pipeline (plain PyTorch) ---------------------------------------

def fma_f32(a, b, c):
    """``a * b + c`` in float32 with ONE rounding, as XLA contracts it and as
    ``__fmaf_rn`` computes it, on any device. The product of two float32
    values is exact in float64; the float64 sum is made round-to-odd (its
    error, from a TwoSum, nudges an even last bit away from a tie), so the
    final rounding to float32 is the single rounding of the exact value.
    Finite operands only."""
    dt = torch.float64
    a, b, c = (torch.as_tensor(v).to(dt) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    odd = torch.nextafter(s, torch.where(err > 0, torch.full_like(s, np.inf),
                                         torch.full_like(s, -np.inf)))
    s = torch.where((err != 0) & even, odd, s)
    return s.to(torch.float32)


def fma_f64(a, b, c):
    """``a * b + c`` in float64 with one rounding (``torch.addcmul``, which
    matches XLA's contracted float64 ``a * b + c``)."""
    return torch.addcmul(c, a, b)


def _bits_f32(v):
    """The IEEE bits of a float32 tensor as int64."""
    return v.view(torch.int32).to(torch.int64) & _MASK


def _from_bits_f32(bits):
    """int64 tensor of 32-bit words -> float32 with those bits."""
    return (bits - ((bits >> 31) << 32)).to(torch.int32).view(torch.float32)


def log1p_f32(x, y=None):
    """``log1p`` of a float32 tensor, bitwise the function XLA:CPU emits
    for ``jnp.log1p`` in float32 (on the draw pipeline's domain,
    ``-1 < x <= 0``, and wherever its formula holds). ``y`` is ``1 + x`` as
    the caller rounded it (default ``x + 1``): inside the draw pipeline XLA
    computes it as one fused ``1 - u * u``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    f32 = lambda v: torch.full_like(x, v)
    # |x| < sqrt(2) - 1: x + (x^3 P(x)/Q(x) - x^2/2)
    q = torch.ones_like(x)
    for c in LOG1P_Q:
        q = fma_f32(q, x, f32(c))
    p = f32(LOG1P_P0)
    for c in LOG1P_P:
        p = fma_f32(p, x, f32(c))
    xx2 = x * x
    s = (x * xx2) * (p / q)
    s = fma_f32(xx2, f32(-0.5), s)
    small = x + s
    # otherwise: Cephes logf of y = 1 + x
    y = x + 1.0 if y is None else y
    yc = torch.maximum(y, f32(2.0 ** -126))
    bits = _bits_f32(yc)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = _from_bits_f32((bits & 0x7FFFFF) | 0x3F000000)
    lo_m = m < LOGF_SQRTHF
    xx = torch.where(lo_m, (m - 1.0) + m, m - 1.0)
    k = torch.where(lo_m, e - 1.0, e)
    z = xx * xx
    z3 = z * xx
    c = LOGF_C
    p0 = fma_f32(fma_f32(xx, f32(c[0]), f32(c[1])), xx, f32(c[2]))
    p1 = fma_f32(fma_f32(xx, f32(c[3]), f32(c[4])), xx, f32(c[5]))
    p2 = fma_f32(fma_f32(xx, f32(c[6]), f32(c[7])), xx, f32(c[8]))
    t = fma_f32(fma_f32(fma_f32(p0, z3, p1), z3, p2), z3, k * LOGF_LN2_LO)
    r = fma_f32(-z, f32(0.5), xx)
    r = fma_f32(k, f32(LOGF_LN2_HI), r + t)
    r = torch.where(y < 0, f32(np.nan), r)
    r = torch.where(y == 0, f32(-np.inf), r)
    r = torch.where(y == np.inf, f32(np.inf), r)
    return torch.where(x.abs() < LOG1P_SMALL, small, r)


def erfinv_f32(u):
    """``erfinv`` of a float32 tensor, ``|u| < 1``: the Giles polynomial
    pair, each Horner step one fused multiply-add, as XLA evaluates
    ``lax.erf_inv`` (JAX ``ops/prng.py:99-113``)."""
    w = -log1p_f32(-(u * u))
    w1 = w - 2.5
    # PyTorch's float32 sqrt on the CPU is not correctly rounded (measured);
    # the float64 root rounded once to float32 is, on every device
    w2 = torch.sqrt(w.double()).float() - 3.0
    p1 = torch.full_like(u, ERFINV_P1[0])
    for c in ERFINV_P1[1:]:
        p1 = fma_f32(p1, w1, torch.full_like(u, c))
    p2 = torch.full_like(u, ERFINV_P2[0])
    for c in ERFINV_P2[1:]:
        p2 = fma_f32(p2, w2, torch.full_like(u, c))
    return torch.where(w < 5.0, p1, p2) * u


def normal_from_bits(bits):
    """32-bit random words (an int64 tensor) -> float32 standard normal
    draws: the mantissa fill to U(lo, 1) then ``sqrt(2) * erfinv``
    (JAX ``ops/prng.py:116-125``)."""
    f = _from_bits_f32((bits >> 9) | 0x3F800000) - 1.0
    lo = torch.full_like(f, UNIFORM_LO)
    u = torch.maximum(lo, fma_f32(f, torch.full_like(f, UNIFORM_SPAN), lo))
    return SQRT2_F32 * erfinv_f32(u)


def _key_words(keys, device):
    keys = np.asarray(keys, np.uint32) if not torch.is_tensor(keys) else keys
    if tuple(keys.shape[1:]) != (2,) or keys.ndim != 2:
        raise ValueError(f"keys must be (K, 2) uint32 key data, got shape {tuple(keys.shape)}")
    if torch.is_tensor(keys):
        k = keys.to(device=device).to(torch.int64) & _MASK
    else:
        k = torch.as_tensor(keys.astype(np.int64), device=device)
    return k[:, 0], k[:, 1]


def _cipher_table(keys, nt: int, device):
    """``(nt, K)`` pairs of cipher words for counters ``(0, t)``."""
    k1, k2 = _key_words(keys, device)
    t = torch.arange(nt, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros_like(t)
    return threefry2x32(k1[None, :], k2[None, :], zero, t)


def normal_table(keys, nt: int, device=None):
    """The ``(nt, K)`` float32 white-noise table of ``(K, 2)`` uint32 member
    keys, bitwise ``jax.vmap(lambda k: jax.random.normal(k, (nt,),
    jnp.float32), out_axes=1)(keys)``: member ``k``'s element ``t`` is drawn
    from the cipher output ``o0 ^ o1`` of counter words ``(0, t)``. ``keys``
    is numpy uint32 or a tensor (then ``device`` defaults to its own)."""
    if device is None:
        device = keys.device if torch.is_tensor(keys) else "cpu"
    o0, o1 = _cipher_table(keys, nt, device)
    return normal_from_bits(o0 ^ o1)


def log1p_f64(x):
    """``log1p`` of a float64 tensor as XLA:CPU emits it for float64, on
    ``-1 < x <= 0``: the rational ``x + (x^3 P(x)/Q(x) - x^2/2)`` for
    ``|x| < sqrt(2) - 1`` (every Horner step one fused multiply-add), else
    the logarithm of ``1 + x``. XLA calls the C library's ``log`` there and
    this calls ``torch.log``: the two may round differently (ROADMAP Queue
    3)."""
    f64 = lambda v: torch.full_like(x, v)
    q = x + LOG1P64_Q[0]
    for c in LOG1P64_Q[1:]:
        q = fma_f64(q, x, f64(c))
    p = f64(LOG1P64_P0)
    for c in LOG1P64_P:
        p = fma_f64(p, x, f64(c))
    xx2 = x * x
    s = (x * xx2) * (p / q)
    s = fma_f64(xx2, f64(-0.5), s)
    return torch.where(x.abs() < LOG1P64_SMALL, x + s, torch.log(x + 1.0))


def sqrt_f64(w):
    """The correctly rounded float64 square root on any device. PyTorch's
    float64 ``sqrt`` on the CPU is not always correctly rounded (measured: 5
    of 10^6 draws moved); one Newton correction from the exact residual
    ``w - r^2`` (a fused multiply-add) settles the last bit."""
    r = torch.sqrt(w)
    fixed = r + fma_f64(-r, r, w) / (2.0 * r)
    return torch.where(r > 0, fixed, r)


def erfinv_f64(u):
    """``erfinv`` of a float64 tensor, ``|u| < 1``, as XLA:CPU evaluates
    ``lax.erf_inv`` in float64: ``w = -log1p(-u^2)`` (here ``1 - u^2`` is a
    product and a sum, two roundings, unlike the float32 pipeline), then one
    of three polynomials in a shifted ``w`` or ``sqrt(w)``, each Horner step
    one fused multiply-add, times ``u``."""
    w = -log1p_f64(u * -u)
    root = sqrt_f64(w)
    branches = []
    for coefs, arg in ((ERFINV64_P1, w - 3.125), (ERFINV64_P2, root - 3.25),
                       (ERFINV64_P3, root - 5.0)):
        p = torch.full_like(u, coefs[0])
        for c in coefs[1:]:
            p = fma_f64(p, arg, torch.full_like(u, c))
        branches.append(p)
    p = torch.where(w < 6.25, branches[0], torch.where(w < 16.0, branches[1], branches[2]))
    return p * u


def normal_table_f64(keys, nt: int, device=None):
    """The float64 ``(nt, K)`` table of the f64 engines, drawn as
    ``jax.random.normal(key, (nt,), float64)`` draws: 64-bit words
    ``(o0 << 32) | o1``, a 52-bit mantissa fill to U(lo, 1), then
    ``sqrt(2) * erfinv`` in float64 (:func:`erfinv_f64`, XLA's own
    polynomial). The words and the uniforms are JAX's bit for bit; a draw
    whose ``log1p`` takes the logarithm may differ from JAX's in its last
    bits where ``torch.log`` and the C library's ``log`` round differently
    (ROADMAP Queue 3)."""
    if device is None:
        device = keys.device if torch.is_tensor(keys) else "cpu"
    o0, o1 = _cipher_table(keys, nt, device)
    mant = (o0 << 20) | (o1 >> 12)                         # top 52 bits
    one = 0x3FF0000000000000
    f = (mant | one).view(torch.float64) - 1.0
    lo = float(np.nextafter(-1.0, 0.0))
    span = 1.0 - lo                                        # rounds to 2.0
    u = torch.maximum(torch.full_like(f, lo), fma_f64(f, torch.full_like(f, span),
                                                     torch.full_like(f, lo)))
    return float(np.sqrt(2.0)) * erfinv_f64(u)
