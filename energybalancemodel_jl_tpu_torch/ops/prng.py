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
  :func:`sqrt_f64`) and the C library's ``log`` that XLA:CPU calls
  (:func:`log_f64`): bitwise ``jax.random.normal(..., float64)``.

Only the partitionable threefry layout is reproduced (JAX's default since
0.4.30): element ``t`` of a length-``nt`` draw uses counter words ``(0, t)``.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..utils.numerics import fma_f32, fma_f64

__all__ = [
    "prng_key", "fold_in", "member_year_keys", "threefry2x32", "fma_f32",
    "fma_f64", "log1p_f32", "erfinv_f32", "log_f64", "log1p_f64", "sqrt_f64", "erfinv_f64",
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
# The C library's float64 log, which XLA:CPU calls for the logarithm branch
# of its float64 log1p: glibc 2.36 sysdeps/ieee754/dbl-64/e_log_data.c (from
# ARM's optimized-routines), the struct __log_data as the library holds it.
# Read from a glibc 2.36 libm.so.6 (x86-64), found by its leading ln2hi, ln2lo
# pair; its layout is ln2hi, ln2lo, poly[5], poly1[11], tab[128] of (invc,
# logc), tab2[128]. Only the table path of log's FMA build is used here.
GLIBC_LOG_LN2HI = float.fromhex("0x1.62e42fefa3800p-1")
GLIBC_LOG_LN2LO = float.fromhex("0x1.ef35793c76730p-45")
GLIBC_LOG_POLY = tuple(float.fromhex(h) for h in (
    "-0x1.0000000000001p-1", "0x1.555555551305bp-2", "-0x1.fffffffeb4590p-3",
    "0x1.999b324f10111p-3", "-0x1.55575e506c89fp-3"))
# (invc, logc) of the 128 subintervals of [0x1.6p-1, 0x1.6p+0)
GLIBC_LOG_TAB = tuple((float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.734f0c3e0de9fp+0", "-0x1.7cc7f79e69000p-2"), ("0x1.713786a2ce91fp+0", "-0x1.76feec20d0000p-2"),
    ("0x1.6f26008fab5a0p+0", "-0x1.713e31351e000p-2"), ("0x1.6d1a61f138c7dp+0", "-0x1.6b85b38287800p-2"),
    ("0x1.6b1490bc5b4d1p+0", "-0x1.65d5590807800p-2"), ("0x1.69147332f0cbap+0", "-0x1.602d076180000p-2"),
    ("0x1.6719f18224223p+0", "-0x1.5a8ca86909000p-2"), ("0x1.6524f99a51ed9p+0", "-0x1.54f4356035000p-2"),
    ("0x1.63356aa8f24c4p+0", "-0x1.4f637c36b4000p-2"), ("0x1.614b36b9ddc14p+0", "-0x1.49da7fda85000p-2"),
    ("0x1.5f66452c65c4cp+0", "-0x1.445923989a800p-2"), ("0x1.5d867b5912c4fp+0", "-0x1.3edf439b0b800p-2"),
    ("0x1.5babccb5b90dep+0", "-0x1.396ce448f7000p-2"), ("0x1.59d61f2d91a78p+0", "-0x1.3401e17bda000p-2"),
    ("0x1.5805612465687p+0", "-0x1.2e9e2ef468000p-2"), ("0x1.56397cee76bd3p+0", "-0x1.2941b3830e000p-2"),
    ("0x1.54725e2a77f93p+0", "-0x1.23ec58cda8800p-2"), ("0x1.52aff42064583p+0", "-0x1.1e9e129279000p-2"),
    ("0x1.50f22dbb2bddfp+0", "-0x1.1956d2b48f800p-2"), ("0x1.4f38f4734ded7p+0", "-0x1.141679ab9f800p-2"),
    ("0x1.4d843cfde2840p+0", "-0x1.0edd094ef9800p-2"), ("0x1.4bd3ec078a3c8p+0", "-0x1.09aa518db1000p-2"),
    ("0x1.4a27fc3e0258ap+0", "-0x1.047e65263b800p-2"), ("0x1.4880524d48434p+0", "-0x1.feb224586f000p-3"),
    ("0x1.46dce1b192d0bp+0", "-0x1.f474a7517b000p-3"), ("0x1.453d9d3391854p+0", "-0x1.ea4443d103000p-3"),
    ("0x1.43a2744b4845ap+0", "-0x1.e020d44e9b000p-3"), ("0x1.420b54115f8fbp+0", "-0x1.d60a22977f000p-3"),
    ("0x1.40782da3ef4b1p+0", "-0x1.cc00104959000p-3"), ("0x1.3ee8f5d57fe8fp+0", "-0x1.c202956891000p-3"),
    ("0x1.3d5d9a00b4ce9p+0", "-0x1.b81178d811000p-3"), ("0x1.3bd60c010c12bp+0", "-0x1.ae2c9ccd3d000p-3"),
    ("0x1.3a5242b75dab8p+0", "-0x1.a45402e129000p-3"), ("0x1.38d22cd9fd002p+0", "-0x1.9a877681df000p-3"),
    ("0x1.3755bc5847a1cp+0", "-0x1.90c6d69483000p-3"), ("0x1.35dce49ad36e2p+0", "-0x1.87120a645c000p-3"),
    ("0x1.34679984dd440p+0", "-0x1.7d68fb4143000p-3"), ("0x1.32f5cceffcb24p+0", "-0x1.73cb83c627000p-3"),
    ("0x1.3187775a10d49p+0", "-0x1.6a39a9b376000p-3"), ("0x1.301c8373e3990p+0", "-0x1.60b3154b7a000p-3"),
    ("0x1.2eb4ebb95f841p+0", "-0x1.5737d76243000p-3"), ("0x1.2d50a0219a9d1p+0", "-0x1.4dc7b8fc23000p-3"),
    ("0x1.2bef9a8b7fd2ap+0", "-0x1.4462c51d20000p-3"), ("0x1.2a91c7a0c1babp+0", "-0x1.3b08abc830000p-3"),
    ("0x1.293726014b530p+0", "-0x1.31b996b490000p-3"), ("0x1.27dfa5757a1f5p+0", "-0x1.2875490a44000p-3"),
    ("0x1.268b39b1d3bbfp+0", "-0x1.1f3b9f879a000p-3"), ("0x1.2539d838ff5bdp+0", "-0x1.160c8252ca000p-3"),
    ("0x1.23eb7aac9083bp+0", "-0x1.0ce7f57f72000p-3"), ("0x1.22a012ba940b6p+0", "-0x1.03cdc49fea000p-3"),
    ("0x1.2157996cc4132p+0", "-0x1.f57bdbc4b8000p-4"), ("0x1.201201dd2fc9bp+0", "-0x1.e370896404000p-4"),
    ("0x1.1ecf4494d480bp+0", "-0x1.d17983ef94000p-4"), ("0x1.1d8f5528f6569p+0", "-0x1.bf9674ed8a000p-4"),
    ("0x1.1c52311577e7cp+0", "-0x1.adc79202f6000p-4"), ("0x1.1b17c74cb26e9p+0", "-0x1.9c0c3e7288000p-4"),
    ("0x1.19e010c2c1ab6p+0", "-0x1.8a646b372c000p-4"), ("0x1.18ab07bb670bdp+0", "-0x1.78d01b3ac0000p-4"),
    ("0x1.1778a25efbcb6p+0", "-0x1.674f145380000p-4"), ("0x1.1648d354c31dap+0", "-0x1.55e0e6d878000p-4"),
    ("0x1.151b990275fddp+0", "-0x1.4485cdea1e000p-4"), ("0x1.13f0ea432d24cp+0", "-0x1.333d94d6aa000p-4"),
    ("0x1.12c8b7210f9dap+0", "-0x1.22079f8c56000p-4"), ("0x1.11a3028ecb531p+0", "-0x1.10e4698622000p-4"),
    ("0x1.107fbda8434afp+0", "-0x1.ffa6c6ad20000p-5"), ("0x1.0f5ee0f4e6bb3p+0", "-0x1.dda8d4a774000p-5"),
    ("0x1.0e4065d2a9fcep+0", "-0x1.bbcece4850000p-5"), ("0x1.0d244632ca521p+0", "-0x1.9a1894012c000p-5"),
    ("0x1.0c0a77ce2981ap+0", "-0x1.788583302c000p-5"), ("0x1.0af2f83c636d1p+0", "-0x1.5715e67d68000p-5"),
    ("0x1.09ddb98a01339p+0", "-0x1.35c8a49658000p-5"), ("0x1.08cabaf52e7dfp+0", "-0x1.149e364154000p-5"),
    ("0x1.07b9f2f4e28fbp+0", "-0x1.e72c082eb8000p-6"), ("0x1.06ab58c358f19p+0", "-0x1.a55f152528000p-6"),
    ("0x1.059eea5ecf92cp+0", "-0x1.63d62cf818000p-6"), ("0x1.04949cdd12c90p+0", "-0x1.228fb8caa0000p-6"),
    ("0x1.038c6c6f0ada9p+0", "-0x1.c317b20f90000p-7"), ("0x1.02865137932a9p+0", "-0x1.419355daa0000p-7"),
    ("0x1.0182427ea7348p+0", "-0x1.81203c2ec0000p-8"), ("0x1.008040614b195p+0", "-0x1.0040979240000p-9"),
    ("0x1.fe01ff726fa1ap-1", "0x1.feff384900000p-9"), ("0x1.fa11cc261ea74p-1", "0x1.7dc41353d0000p-7"),
    ("0x1.f6310b081992ep-1", "0x1.3cea3c4c28000p-6"), ("0x1.f25f63ceeadcdp-1", "0x1.b9fc114890000p-6"),
    ("0x1.ee9c8039113e7p-1", "0x1.1b0d8ce110000p-5"), ("0x1.eae8078cbb1abp-1", "0x1.58a5bd001c000p-5"),
    ("0x1.e741aa29d0c9bp-1", "0x1.95c8340d88000p-5"), ("0x1.e3a91830a99b5p-1", "0x1.d276aef578000p-5"),
    ("0x1.e01e009609a56p-1", "0x1.07598e598c000p-4"), ("0x1.dca01e577bb98p-1", "0x1.253f5e30d2000p-4"),
    ("0x1.d92f20b7c9103p-1", "0x1.42edd8b380000p-4"), ("0x1.d5cac66fb5ccep-1", "0x1.606598757c000p-4"),
    ("0x1.d272caa5ede9dp-1", "0x1.7da76356a0000p-4"), ("0x1.cf26e3e6b2ccdp-1", "0x1.9ab434e1c6000p-4"),
    ("0x1.cbe6da2a77902p-1", "0x1.b78c7bb0d6000p-4"), ("0x1.c8b266d37086dp-1", "0x1.d431332e72000p-4"),
    ("0x1.c5894bd5d5804p-1", "0x1.f0a3171de6000p-4"), ("0x1.c26b533bb9f8cp-1", "0x1.067152b914000p-3"),
    ("0x1.bf583eeece73fp-1", "0x1.147858292b000p-3"), ("0x1.bc4fd75db96c1p-1", "0x1.2266ecdca3000p-3"),
    ("0x1.b951e0c864a28p-1", "0x1.303d7a6c55000p-3"), ("0x1.b65e2c5ef3e2cp-1", "0x1.3dfc33c331000p-3"),
    ("0x1.b374867c9888bp-1", "0x1.4ba366b7a8000p-3"), ("0x1.b094b211d304ap-1", "0x1.5933928d1f000p-3"),
    ("0x1.adbe885f2ef7ep-1", "0x1.66acd2418f000p-3"), ("0x1.aaf1d31603da2p-1", "0x1.740f8ec669000p-3"),
    ("0x1.a82e63fd358a7p-1", "0x1.815c0f51af000p-3"), ("0x1.a5740ef09738bp-1", "0x1.8e92954f68000p-3"),
    ("0x1.a2c2a90ab4b27p-1", "0x1.9bb3602f84000p-3"), ("0x1.a01a01393f2d1p-1", "0x1.a8bed1c2c0000p-3"),
    ("0x1.9d79f24db3c1bp-1", "0x1.b5b515c01d000p-3"), ("0x1.9ae2505c7b190p-1", "0x1.c2967ccbcc000p-3"),
    ("0x1.9852ef297ce2fp-1", "0x1.cf635d5486000p-3"), ("0x1.95cbaeea44b75p-1", "0x1.dc1bd3446c000p-3"),
    ("0x1.934c69de74838p-1", "0x1.e8c01b8cfe000p-3"), ("0x1.90d4f2f6752e6p-1", "0x1.f5509c0179000p-3"),
    ("0x1.8e6528effd79dp-1", "0x1.00e6c121fb800p-2"), ("0x1.8bfce9fcc007cp-1", "0x1.071b80e93d000p-2"),
    ("0x1.899c0dabec30ep-1", "0x1.0d46b9e867000p-2"), ("0x1.87427aa2317fbp-1", "0x1.13687334bd000p-2"),
    ("0x1.84f00acb39a08p-1", "0x1.1980d67234800p-2"), ("0x1.82a49e8653e55p-1", "0x1.1f8ffe0cc8000p-2"),
    ("0x1.8060195f40260p-1", "0x1.2595fd7636800p-2"), ("0x1.7e22563e0a329p-1", "0x1.2b9300914a800p-2"),
    ("0x1.7beb377dcb5adp-1", "0x1.3187210436000p-2"), ("0x1.79baa679725c2p-1", "0x1.377266dec1800p-2"),
    ("0x1.77907f2170657p-1", "0x1.3d54ffbaf3000p-2"), ("0x1.756cadbd6130cp-1", "0x1.432eee32fe000p-2"),
))
GLIBC_LOG_OFF = 0x3FE6000000000000
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


def log_f64(y):
    """The natural logarithm of a float64 tensor, bitwise the C library's
    ``log`` (glibc 2.36, the build with fused multiply-adds), on the draw
    pipeline's domain: normal values in (0, 0.586]. There glibc takes its
    table path, never the one near 1: ``y = 2^k z`` with ``z`` in
    ``[0x1.6p-1, 0x1.6p+0)`` and the subinterval ``i`` of ``z`` read from the
    bits, ``r = fma(z, invc_i, -1)`` (one rounding), then
    ``w = k ln2hi + logc_i``, ``hi = w + r``,
    ``lo = w - hi + r + k ln2lo`` and
    ``lo + r^2 A0 + r r^2 (A1 + r A2 + r^2 (A3 + r A4)) + hi``, each operation
    rounded in that order. Subnormals, zero, negative values and the
    neighbourhood of 1 are outside the domain."""
    ix = y.view(torch.int64)
    tmp = ix - GLIBC_LOG_OFF
    i = (tmp >> 45) & 127
    kd = (tmp >> 52).to(torch.float64)                     # arithmetic shift
    z = (ix - (tmp & -(1 << 52))).view(torch.float64)
    tab = torch.tensor(GLIBC_LOG_TAB, dtype=torch.float64, device=y.device)
    invc, logc = tab[i, 0], tab[i, 1]
    r = fma_f64(z, invc, torch.full_like(z, -1.0))
    w = kd * GLIBC_LOG_LN2HI + logc
    hi = w + r
    lo = w - hi + r + kd * GLIBC_LOG_LN2LO
    r2 = r * r
    a = GLIBC_LOG_POLY
    return lo + r2 * a[0] + r * r2 * (a[1] + r * a[2] + r2 * (a[3] + r * a[4])) + hi


def log1p_f64(x):
    """``log1p`` of a float64 tensor as XLA:CPU emits it for float64, on
    ``-1 < x <= 0``: the rational ``x + (x^3 P(x)/Q(x) - x^2/2)`` for
    ``|x| < sqrt(2) - 1`` (every Horner step one fused multiply-add), else
    the C library's logarithm of ``1 + x`` (:func:`log_f64`)."""
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
    return torch.where(x.abs() < LOG1P64_SMALL, x + s, log_f64(x + 1.0))


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
    polynomial, with the C library's ``log``): bit for bit JAX's draws."""
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
