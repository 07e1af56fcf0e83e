"""The weather of the noise-forced years, bit for bit JAX's draws: member
``k``'s white draws in model year ``y`` are ``jax.random.normal(fold_in(
fold_in(PRNGKey(seed), k), y), (nt,), float32)``, and the forcing offset is
their Ornstein-Uhlenbeck path ``eta_t = rho eta_{t-1} + scale xi_t``.

A frozen copy, made for the benchmark, of the keying (threefry-2x32 on
numpy words), the float32 draw pipeline (the mantissa fill to U(lo, 1), then
``sqrt(2) erfinv`` by the Giles polynomials with the float32 ``log1p`` that
XLA:CPU emits; every ``a * b + c`` that XLA contracts is one fused
multiply-add) and the serial recurrence (one fused multiply-add a step)."""
from __future__ import annotations

import struct

import numpy as np
import torch

from .common import fma

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _f(hexbits: str) -> float:
    return struct.unpack(">d", bytes.fromhex(hexbits))[0]


ERFINV_P1 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
             0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERFINV_P2 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
             0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
LOG1P_SMALL = _f("3FDA8279A0000000")
LOG1P_Q = tuple(_f(h) for h in ("402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
                                "4073519460000000", "406B0DB140000000", "404E0F3040000000"))
LOG1P_P0 = _f("3F07BC0960000000")
LOG1P_P = tuple(_f(h) for h in ("3FDFE818A0000000", "401A509F40000000", "403DE97380000000",
                                "404E798EC0000000", "404C8E75A0000000", "40340A2020000000"))
LOGF_SQRTHF = _f("3FE6A09E60000000")
LOGF_C = tuple(_f(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000"))
LOGF_LN2_LO = _f("BF2BD01060000000")
LOGF_LN2_HI = _f("3FE6300000000000")
UNIFORM_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32))
UNIFORM_SPAN = float(np.float32(1.0) - np.float32(UNIFORM_LO))
SQRT2_F32 = float(np.float32(np.sqrt(2)))


def _threefry(k1, k2, x1, x2, wrap, rotl, const):
    """The threefry-2x32 block cipher: 20 rounds in 5 groups of 4, a key
    injection after each group, on words that ``wrap`` reduces mod 2^32."""
    ks = (k1, k2, k1 ^ k2 ^ const(0x1BD11BDA))
    x = [wrap(x1 + ks[0]), wrap(x2 + ks[1])]
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = wrap(x[0] + x[1])
            x = [x0, x0 ^ rotl(x[1], r)]
        x = [wrap(x[0] + ks[(g + 1) % 3]), wrap(x[1] + ks[(g + 2) % 3] + const(g + 1))]
    return x[0], x[1]


def _threefry_np(k1, k2, x1, x2):
    k1, k2, x1, x2 = (np.asarray(v, np.uint32) for v in (k1, k2, x1, x2))
    with np.errstate(over="ignore"):
        return _threefry(k1, k2, x1, x2, lambda v: v,
                         lambda v, d: (v << np.uint32(d)) | (v >> np.uint32(32 - d)), np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``PRNGKey(seed)``'s data: the 64-bit seed as two words, high first."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & _MASK], np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``fold_in`` on ``(..., 2)`` uint32 key data; ``data`` mod 2^32."""
    key = np.asarray(key, np.uint32)
    data = np.asarray(np.asarray(data, np.int64) & _MASK, np.uint32)
    o0, o1 = _threefry_np(key[..., 0], key[..., 1], np.zeros_like(data), data)
    return np.stack(np.broadcast_arrays(o0, o1), axis=-1)


def _bits(v):
    return v.view(torch.int32).to(torch.int64) & _MASK


def _from_bits(bits):
    return (bits - ((bits >> 31) << 32)).to(torch.int32).view(torch.float32)


def _log1p(x):
    """float32 ``log1p`` on ``-1 < x <= 0`` as XLA:CPU evaluates it."""
    f32 = lambda v: torch.full_like(x, v)
    q = torch.ones_like(x)
    for c in LOG1P_Q:
        q = fma(q, x, f32(c))
    p = f32(LOG1P_P0)
    for c in LOG1P_P:
        p = fma(p, x, f32(c))
    xx2 = x * x
    s = fma(xx2, f32(-0.5), (x * xx2) * (p / q))
    small = x + s
    y = x + 1.0
    bits = _bits(torch.maximum(y, f32(2.0 ** -126)))
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = _from_bits((bits & 0x7FFFFF) | 0x3F000000)
    lo_m = m < LOGF_SQRTHF
    xx = torch.where(lo_m, (m - 1.0) + m, m - 1.0)
    k = torch.where(lo_m, e - 1.0, e)
    z = xx * xx
    z3 = z * xx
    c = LOGF_C
    p0 = fma(fma(xx, f32(c[0]), f32(c[1])), xx, f32(c[2]))
    p1 = fma(fma(xx, f32(c[3]), f32(c[4])), xx, f32(c[5]))
    p2 = fma(fma(xx, f32(c[6]), f32(c[7])), xx, f32(c[8]))
    t = fma(fma(fma(p0, z3, p1), z3, p2), z3, k * LOGF_LN2_LO)
    r = fma(-z, f32(0.5), xx)
    r = fma(k, f32(LOGF_LN2_HI), r + t)
    r = torch.where(y == 0, f32(-np.inf), r)
    return torch.where(x.abs() < LOG1P_SMALL, small, r)


def _erfinv(u):
    w = -_log1p(-(u * u))
    w1 = w - 2.5
    w2 = torch.sqrt(w.double()).float() - 3.0
    p1 = torch.full_like(u, ERFINV_P1[0])
    for c in ERFINV_P1[1:]:
        p1 = fma(p1, w1, torch.full_like(u, c))
    p2 = torch.full_like(u, ERFINV_P2[0])
    for c in ERFINV_P2[1:]:
        p2 = fma(p2, w2, torch.full_like(u, c))
    return torch.where(w < 5.0, p1, p2) * u


def normal_table(keys, nt: int, device) -> torch.Tensor:
    """The ``(nt, K)`` float32 white draws of ``(K, 2)`` uint32 keys: element
    ``t`` of member ``k`` from the cipher words of counter ``(0, t)``."""
    k = torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64), device=device)
    t = torch.arange(nt, dtype=torch.int64, device=device)[:, None]
    o0, o1 = _threefry(k[None, :, 0], k[None, :, 1], torch.zeros_like(t), t,
                       lambda v: v & _MASK, lambda v, d: ((v << d) & _MASK) | (v >> (32 - d)),
                       lambda c: c)
    bits = o0 ^ o1
    f = _from_bits((bits >> 9) | 0x3F800000) - 1.0
    lo = torch.full_like(f, UNIFORM_LO)
    u = torch.maximum(lo, fma(f, torch.full_like(f, UNIFORM_SPAN), lo))
    return SQRT2_F32 * _erfinv(u)


def ou_path(xi, rho, scale, eta0) -> torch.Tensor:
    """The serial recurrence ``eta_t = fma(rho, eta_{t-1}, scale xi_t)`` over
    the rows of an ``(nt, K)`` table from ``eta0``; ``rho``, ``scale``,
    ``eta0`` are ``(K,)``."""
    eta, rows = eta0, []
    for t in range(xi.shape[0]):
        eta = fma(rho, eta, scale * xi[t])
        rows.append(eta)
    return torch.stack(rows)
