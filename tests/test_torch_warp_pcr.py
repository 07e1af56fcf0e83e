"""The warp layout of the kernels' PCR (``csrc/common.cuh::warp_pcr_solve``)
and of the Classic crossing sum (``csrc/noise.cuh::warp_noise_crossing``),
emulated on the CPU against the plain versions the kernels are held to.

One system of ``n <= 32 S`` rows lives in one warp: row ``i`` at lane
``i % 32``, slot ``i // 32``; rows at or beyond ``n`` are identity rows that
no level updates. A level at stride ``st < 32`` rotates each slot by ``st``
lanes and takes a row's neighbour from its own slot or the slot below /
above; at ``st >= 32`` the neighbour sits ``st / 32`` slots away in the same
lane. Bars, all bitwise:

- ``tridiag.pcr_solve`` of a system padded with identity rows to ``32 S``
  rows equals the unpadded solve on the rows ``< n`` (the padding changes no
  real row), for ``S = 1 ... 8``;
- the emulated warp solve, slot by slot in the kernel's order, equals
  ``tridiag.pcr_solve``, in float32 and float64, at every slot count a build
  has for ``n``;
- a butterfly per slot, then the slots' sums in slot order, is
  ``_year.block_sum``, and every lane ends with the same bits.
"""
import numpy as np
import pytest
import torch

from energybalancemodel_jl_tpu_torch.ops import _year
from energybalancemodel_jl_tpu_torch.ops.tridiag import pcr_solve, pcr_steps
from energybalancemodel_jl_tpu_torch.utils.numerics import fma as fma_t

NS = [1, 2, 31, 32, 33, 180, 255, 256]
LANES = np.arange(32)


def warp_slots(n):
    """The slots of the build that holds an ``n``-row system
    (``csrc/common.cuh::warp_slots``): 1, 2, 4, 6 or 8."""
    s = -(-n // 32)
    return s if s <= 2 else (4 if s <= 4 else (6 if s <= 6 else 8))


def system(n, K, dtype, seed):
    """``K`` seeded diagonally dominant systems of ``n`` rows, signs mixed."""
    rng = np.random.default_rng(seed)
    lo, up = rng.normal(size=(K, n)), rng.normal(size=(K, n))
    di = (np.abs(lo) + np.abs(up) + rng.uniform(0.5, 2.0, (K, n))) * rng.choice([-1.0, 1.0],
                                                                             (K, n))
    return [v.astype(dtype) for v in (lo, di, up, rng.normal(size=(K, n)))]


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def safe_div(num, den):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(den == 0, num.dtype.type(0), num / np.where(den == 0, 1, den))


def fma(a, b, c):
    """``a * b + c`` with one rounding, on numpy arrays of one dtype."""
    a, b, c = (torch.from_numpy(np.ascontiguousarray(np.broadcast_to(v, np.shape(a))))
               for v in (a, b, c))
    return fma_t(a, b, c).numpy()


def warp_row(lo, di, up, b, m, p, kind):
    """``common.cuh::pcr_row_update`` (through ``warp_pcr_row``) on whole
    slots (numpy arrays of one dtype, each operation rounded to it, the
    fused multiply-adds of ``tridiag.pcr_solve`` made once); ``m`` and ``p``
    are the neighbours' (lo, di, up, b), ``kind`` the level's: "first"
    (rows (lo / di, 1 / di, up / di, b)), "mid" or "last". Returns the row's
    new (lo, di, up, b)."""
    t = lo.dtype.type
    if kind == "first":
        alpha, beta = -lo, -up
        return (alpha * m[0], fma(beta, p[0], fma(alpha, m[2], t(1))), beta * p[2],
                fma(beta, p[3] * p[1], fma(b, di, alpha * (m[3] * m[1]))))
    alpha = safe_div(-lo, m[1])
    beta = safe_div(-up, p[1])
    bb = fma(alpha, m[3], b) if kind == "mid" else b + alpha * m[3]
    dd = fma(alpha, m[2], di) if kind == "mid" else di + alpha * m[2]
    return alpha * m[0], fma(beta, p[0], dd), beta * p[2], fma(beta, p[3], bb)


def emulate_warp_pcr(lo, di, up, b, n, S):
    """One system's solve as one warp computes it: ``(S, 32)`` arrays of
    (lo, di, up, b), levels and slots in the kernel's order."""
    t = lo.dtype.type
    ident = [np.full(32, t(v)) for v in (0, 1, 0, 0)]  # lo, di, up, b
    rows = np.zeros((4, S, 32), lo.dtype)
    rows[1] = 1
    for k, band in enumerate((lo, di, up, b)):
        rows[k].reshape(-1)[:n] = band
    live = (LANES[None, :] + 32 * np.arange(S)[:, None]) < n
    # row scaling, the first level's rows (lo / di, 1 / di, up / di, b);
    # identity rows stay as they are
    inv = t(1) / rows[1]
    rows[0], rows[2], rows[1] = rows[0] * inv, rows[2] * inv, inv
    steps = pcr_steps(n)
    for level in range(steps):
        st = 1 << level
        kind = "first" if level == 0 else ("mid" if level + 1 < steps else "last")
        old = rows.copy()
        for s in range(S):
            if st < 32:
                # the kernel's rotations: lane l reads lane (l -+ st) & 31
                rot_m = lambda q: old[:, q, (LANES - st) & 31]
                rot_p = lambda q: old[:, q, (LANES + st) & 31]
                wrap_m, wrap_p = LANES < st, LANES + st >= 32
                below = rot_m(s - 1) if s > 0 else np.stack(ident)
                above = rot_p(s + 1) if s + 1 < S else np.stack(ident)
                m = np.where(wrap_m, below, rot_m(s))
                p = np.where(wrap_p, above, rot_p(s))
            else:
                d = st // 32
                m = old[:, s - d] if s - d >= 0 else np.stack(ident)
                p = old[:, s + d] if s + d < S else np.stack(ident)
            # every neighbour holds the level before's values (old), which
            # the kernel's slot order guarantees
            new_lo, new_di, new_up, new_b = warp_row(old[0, s], old[1, s], old[2, s], old[3, s],
                                                     [m[0], m[1], m[2], m[3]],
                                                     [p[0], p[1], p[2], p[3]], kind)
            for k, v in enumerate((new_lo, new_di, new_up, new_b)):
                rows[k, s] = np.where(live[s], v, rows[k, s])
    if steps == 0:  # one row: b * inv over the diagonal 1
        rows[3], rows[1] = rows[3] * rows[1], t(1)
    return (rows[3] / rows[1]).reshape(-1)[:n]


def test_warp_row_is_pcr_level_order():
    """``warp_row`` keeps ``pcr_level``'s operand order and fused
    multiply-adds: between the first and the last level fma(beta, p.b,
    fma(alpha, m.b, b)) and fma(beta, p.lo, fma(alpha, m.up, di)); at the
    last, alpha's products rounded; then the new bands."""
    one = lambda v: np.array([v], np.float64)
    f = lambda a, b, c: fma(one(a), one(b), one(c))[0]
    lo, di, up, b = one(0.3), one(1.0), one(-0.2), one(0.7)
    m = [one(0.1), one(1.5), one(0.4), one(2.0)]  # lo, di, up, b
    p = [one(-0.5), one(0.8), one(0.9), one(-1.0)]
    alpha, beta = -0.3 / 1.5, 0.2 / 0.8
    got = warp_row(lo, di, up, b, m, p, "mid")
    want = (alpha * 0.1, f(beta, -0.5, f(alpha, 0.4, 1.0)), beta * 0.9,
            f(beta, -1.0, f(alpha, 2.0, 0.7)))
    assert all(bits_equal(g, one(w)) for g, w in zip(got, want))
    got = warp_row(lo, di, up, b, m, p, "last")
    want = (alpha * 0.1, f(beta, -0.5, 1.0 + alpha * 0.4), beta * 0.9,
            f(beta, -1.0, 0.7 + alpha * 2.0))
    assert all(bits_equal(g, one(w)) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("S,n", [(S, n) for S in range(1, 9) for n in NS if n <= 32 * S])
def test_identity_padding_to_the_warp_changes_no_row(S, n, dtype):
    lo, di, up, b = (torch.as_tensor(v) for v in system(n, 6, dtype, 10 * S + n))
    pad = 32 * S - n
    grow = lambda v, fill: torch.cat([v, torch.full((v.shape[0], pad), fill, dtype=v.dtype)], 1)
    padded = pcr_solve(grow(lo, 0.0), grow(di, 1.0), grow(up, 0.0), grow(b, 0.0))
    assert bits_equal(padded[:, :n].numpy(), pcr_solve(lo, di, up, b).numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("S,n", sorted({(warp_slots(n), n) for n in NS}
                                       | {(8, 1), (8, 33), (4, 33), (8, 180)}))
def test_warp_emulation_is_pcr_solve_bitwise(S, n, dtype):
    lo, di, up, b = system(n, 4, dtype, 100 + n)
    want = pcr_solve(*(torch.as_tensor(v) for v in (lo, di, up, b))).numpy()
    got = np.stack([emulate_warp_pcr(lo[k], di[k], up[k], b[k], n, S) for k in range(4)])
    assert bits_equal(got, want)


@pytest.mark.parametrize("n", NS)
def test_warp_slots_hold_every_width(n):
    below = {1: 0, 2: 1, 4: 2, 6: 4, 8: 6}  # the next smaller build
    S = warp_slots(n)
    assert S in below and 32 * below[S] < n <= 32 * S


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", NS + [100, 150, 200])
def test_warp_crossing_order_is_block_sum(n, dtype):
    rng = np.random.default_rng(n)
    v = (rng.uniform(0.0, 1.0, (3, n)) * (rng.uniform(size=(3, n)) < 0.6)).astype(dtype)
    S = warp_slots(n)
    for k in range(3):
        part = np.zeros((S, 32), dtype)
        part.reshape(-1)[:n] = v[k]
        area = None
        for s in range(S):
            x = part[s]
            for o in (16, 8, 4, 2, 1):
                x = x + x[LANES ^ o]
            assert bits_equal(x, np.full(32, x[0]))  # every lane the same bits
            if 32 * s < n:
                area = x if s == 0 else area + x
        want = _year.block_sum(torch.as_tensor(v[k:k + 1])).numpy()
        assert bits_equal(area[:1], want)
