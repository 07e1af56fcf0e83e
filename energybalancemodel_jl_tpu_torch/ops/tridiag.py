"""Tridiagonal linear solvers on tensors.

The reference's native solves (UMFPACK in the classic implicit step, the
TrustRegion inner solves of the MIZ model, EnergyBalanceModel.jl
``src/miz.jl:55-60``) act on strictly tridiagonal systems. Two solvers:

- :func:`thomas_solve` — the sequential Thomas algorithm along the last
  axis, vectorised over any leading batch axes. O(n) sequential depth.
- :func:`pcr_solve` — parallel cyclic reduction: ``ceil(log2(n))``
  vectorised elimination sweeps, O(n log n) work and O(log n) depth. The
  CUDA kernels run the same scheme in shared memory (``csrc/common.cuh``);
  ``method='pcr_fused'`` solves a batch of systems in one launch of
  ``csrc/pcr.cu`` (:mod:`.pcr_fused`).
- :func:`chunked_solve` — the hybrid Thomas-PCR partition solve (Laszlo,
  Giles & Appleyard, ACM TOMS 42(4), 2016): chunks of :data:`CHUNK` rows
  each reduced by a forward and a backward pass to two interface rows,
  :func:`pcr_solve` over the ``2 ceil(n / CHUNK)`` interface rows, and the
  interior rows recovered from them with no division. O(n) work, O(CHUNK +
  log n) depth. The Classic year kernel's cluster build
  (``csrc/classic_year.cu``, above 4096 cells) solves its Tg system so,
  operation for operation.

All three are stable for the diagonally dominant systems that arise here.
"""
from __future__ import annotations

import math

import torch

from ..utils.numerics import fma

__all__ = ["thomas_solve", "pcr_solve", "pcr_steps", "chunked_solve", "chunk_count", "CHUNK",
           "tridiag_solve", "tridiag_matvec"]


def tridiag_matvec(lo, di, up, x):
    """``A @ x`` for bands ``(lo, di, up)`` with lo[0] = up[-1] = 0, along
    the last axis (JAX ``ops/tridiag.py::tridiag_matvec``): the rolled
    neighbours meet the zero band ends."""
    return lo * torch.roll(x, 1, dims=-1) + di * x + up * torch.roll(x, -1, dims=-1)


def thomas_solve(lo, di, up, b):
    """Solve the tridiagonal system with the Thomas algorithm.

    Bands: ``lo[i] x[i-1] + di[i] x[i] + up[i] x[i+1] = b[i]`` with
    ``lo[0] = up[-1] = 0``, along the last axis; leading axes are a batch.
    """
    lo, di, up, b = torch.broadcast_tensors(lo, di, up, b)
    n = b.shape[-1]
    zero = torch.zeros_like(b[..., 0])
    cp_prev, dp_prev = zero, zero
    cps, dps = [], []
    for i in range(n):
        l = lo[..., i]
        denom = di[..., i] - l * cp_prev
        cp_prev = up[..., i] / denom
        dp_prev = (b[..., i] - l * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    xs = [None] * n
    x_next = zero
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


def _shift(v, s: int, axis: int = -1, fill: float = 0.0):
    """Shift ``v`` by ``s`` along ``axis``, filling with ``fill``.

    ``s > 0`` moves entries toward higher indices (out[i] = v[i-s]).
    """
    axis = axis % v.ndim
    n = v.shape[axis]
    if s == 0:
        return v
    if abs(s) >= n:
        return torch.full_like(v, fill)
    if axis == v.ndim - 1:
        # one pad of the kept part: fewer operations on the eager paths
        kept = v.narrow(axis, 0, n - s) if s > 0 else v.narrow(axis, -s, n + s)
        return torch.nn.functional.pad(kept, (s, 0) if s > 0 else (0, -s), value=fill)
    out = torch.full_like(v, fill)
    if s > 0:
        out.narrow(axis, s, n - s).copy_(v.narrow(axis, 0, n - s))
    else:
        out.narrow(axis, 0, n + s).copy_(v.narrow(axis, -s, n + s))
    return out


def _safe_div(num, den):
    """``num / den``, and 0 where ``den`` is 0: reduced diagonals never
    vanish for diagonally dominant systems in exact arithmetic; the guard
    stops a float32-cancelled zero pivot from injecting inf/NaN (a no-op in
    healthy lanes)."""
    zero = den == 0
    return torch.where(zero, 0.0, num / torch.where(zero, 1.0, den))


def pcr_steps(n: int) -> int:
    """The number of PCR doubling levels of an ``n``-row system."""
    return max(1, math.ceil(math.log2(n))) if n > 1 else 0


def pcr_solve(lo, di, up, b, axis: int = -1, negated: bool = False):
    """Solve a tridiagonal system by parallel cyclic reduction.

    At stride ``s`` every equation eliminates its ``±s`` neighbors:

        alpha_i = -lo_i / di_{i-s}          beta_i = -up_i / di_{i+s}
        lo'_i = alpha_i lo_{i-s}            up'_i = beta_i up_{i+s}
        di'_i = di_i + alpha_i up_{i-s} + beta_i lo_{i+s}
        b'_i  = b_i + alpha_i b_{i-s} + beta_i b_{i+s}

    After ``ceil(log2(n))`` doublings the system is diagonal: ``x = b / di``.
    Out-of-range neighbors are identity rows (di = 1, off-diagonals and rhs
    0), realized by zero-filled shifts of the bands and a ones-filled shift
    of the diagonal. ``axis`` selects the system axis (default last).

    Each sum is the fused multiply-adds XLA:CPU makes of the JAX package's
    solve (:mod:`..utils.numerics`): ``b' = fma(beta, b_{i+s}, fma(alpha,
    b_{i-s}, b))`` and ``di'`` likewise; the first level contracts the row
    scaling's ``b * inv`` and rounds ``alpha b_{i-s}`` (``negated``: the
    right-hand side is a negation, as the Newton update's ``-r``, and XLA
    contracts ``alpha b_{i-s}`` there and rounds ``b * inv``); the last
    level rounds ``alpha``'s products.
    """
    if axis not in (-1, b.ndim - 1):
        for name, band in (("lo", lo), ("di", di), ("up", up)):
            if band.ndim != b.ndim:
                # lower-rank bands broadcast against the trailing axes, which
                # is only the system axis when axis == -1
                raise ValueError(
                    f"pcr_solve with axis={axis} needs full-rank bands; "
                    f"{name} has ndim {band.ndim} vs rhs ndim {b.ndim}"
                )
    steps = pcr_steps(b.shape[axis])

    # Row-scale by the diagonal: improves float32 conditioning materially
    # (the systems here mix O(1e4) conduction terms with O(1) couplings).
    inv = 1.0 / di
    lo = lo * inv
    up = up * inv
    di = torch.ones_like(di)

    s = 1
    for level in range(steps):
        di_m = _shift(di, s, axis, fill=1.0)
        di_p = _shift(di, -s, axis, fill=1.0)
        alpha = _safe_div(-lo, di_m)
        beta = _safe_div(-up, di_p)
        if level == 0:
            b_s = b * inv
            if negated:
                t = fma(alpha, _shift(b_s, s, axis), b_s)
            else:
                t = fma(b, inv, alpha * _shift(b_s, s, axis))
            b = fma(beta, _shift(b_s, -s, axis), t)
        elif level < steps - 1:
            b = fma(beta, _shift(b, -s, axis), fma(alpha, _shift(b, s, axis), b))
        else:
            b = fma(beta, _shift(b, -s, axis), b + alpha * _shift(b, s, axis))
        if level < steps - 1 or steps == 1:
            di = fma(beta, _shift(lo, -s, axis), fma(alpha, _shift(up, s, axis), di))
        else:
            di = fma(beta, _shift(lo, -s, axis), di + alpha * _shift(up, s, axis))
        lo = alpha * _shift(lo, s, axis)
        up = beta * _shift(up, -s, axis)
        s *= 2
    if steps == 0:
        return (b * inv) / di
    return b / di


# rows per chunk of :func:`chunked_solve`, csrc/classic_year.cu CHUNK_ROWS:
# of 4, 8 and 16, the fastest Classic cluster year at nx = 32768 on an H100
# (PERF.md)
CHUNK = 8


def chunk_count(n: int) -> int:
    """The chunks of an ``n``-row system in :func:`chunked_solve`: its
    interface system has twice as many rows."""
    return -(-n // CHUNK)


def chunked_solve(lo, di, up, b):
    """Solve the tridiagonal system by chunks (the hybrid Thomas-PCR scheme).

    Bands as :func:`thomas_solve`, along the last axis. The rows are cut
    into ``chunk_count(n)`` chunks of :data:`CHUNK` rows ``[M j, M j + M)``,
    the last filled with identity rows (di = 1, off-diagonals and rhs 0).
    In each chunk (local rows k, unknowns x_k, x_{-1} and x_M its
    neighbours' last and first):

    - rows 0 and 1 are scaled by ``r = 1 / di``: ``a = lo r``, ``c = up
      r``, ``d = b r`` (row 1's ``a`` couples it to x_0);
    - forward, k = 2 .. M-1: ``r = 1 / fma(-lo, c[k-1], di)``, ``d = r
      fma(-lo, d[k-1], b)``, ``a = -(r lo) a[k-1]``, ``c = r up``: row k
      reads ``x_k + a x_0 + c x_{k+1} = d``;
    - backward, k = M-3 .. 1: ``d = fma(-c, d[k+1], d)``, ``a = fma(-c,
      a[k+1], a)``, ``c = -(c c[k+1])``: row k reads ``x_k + a x_0 + c
      x_{M-1} = d``;
    - row 0 takes row 1 in: ``r = 1 / fma(-c[0], a[1], 1)``, ``d = r
      fma(-c[0], d[1], d)``, ``a = r a``, ``c = -(r (c[0] c[1]))``.

    A zero pivot takes ``r = 0``. Rows 0 and M-1 of chunk j are rows 2j and
    2j + 1 of the interface system (lo = a, di = 1, up = c, rhs d), which
    :func:`pcr_solve` solves; then ``x_k = fma(-c, x_{M-1}, fma(-a, x_0,
    d))``. Vectorised over the chunks and any leading batch axes.
    """
    lo, di, up, b = torch.broadcast_tensors(lo, di, up, b)
    n = b.shape[-1]
    M = CHUNK
    nc = chunk_count(n)
    pad = nc * M - n

    def chunks(v, fill):
        if pad:
            v = torch.nn.functional.pad(v, (0, pad), value=fill)
        return v.reshape(*v.shape[:-1], nc, M).unbind(-1)

    lo, di, up, b = chunks(lo, 0.0), chunks(di, 1.0), chunks(up, 0.0), chunks(b, 0.0)
    a, c, d = [None] * M, [None] * M, [None] * M
    for k in (0, 1):
        r = _safe_div(1.0, di[k])
        a[k], c[k], d[k] = lo[k] * r, up[k] * r, b[k] * r
    for k in range(2, M):
        r = _safe_div(1.0, fma(-lo[k], c[k - 1], di[k]))
        d[k] = r * fma(-lo[k], d[k - 1], b[k])
        a[k] = -(r * lo[k]) * a[k - 1]
        c[k] = r * up[k]
    for k in range(M - 3, 0, -1):
        d[k] = fma(-c[k], d[k + 1], d[k])
        a[k] = fma(-c[k], a[k + 1], a[k])
        c[k] = -(c[k] * c[k + 1])
    r = _safe_div(1.0, fma(-c[0], a[1], torch.ones_like(c[0])))
    d[0] = r * fma(-c[0], d[1], d[0])
    a[0] = r * a[0]
    c[0] = -(r * (c[0] * c[1]))

    def interface(v):  # rows 0 and M-1 of each chunk, in the system's order
        return torch.stack([v[0], v[M - 1]], dim=-1).flatten(-2)

    ia = interface(a)
    x = pcr_solve(ia, torch.ones_like(ia), interface(c), interface(d))
    x0, xl = x[..., 0::2], x[..., 1::2]
    xs = [x0] + [fma(-c[k], xl, fma(-a[k], x0, d[k])) for k in range(1, M - 1)] + [xl]
    return torch.stack(xs, dim=-1).flatten(-2)[..., :n]


def tridiag_solve(lo, di, up, b, method: str = "pcr", axis_name: str = None,
                  axis: int = -1, negated: bool = False):
    """Dispatch between :func:`pcr_solve` (default), :func:`thomas_solve`
    (``method='thomas'``, last axis only), the one-launch batched PCR
    (``method='pcr_fused'``: a 2-D ``(K, n)`` system goes to
    :func:`.pcr_fused.pcr_fused`, any other rank to :func:`pcr_solve`, as in
    the JAX package) and the distributed :func:`.spike.spike_tridiag_solve`
    (``method='spike'``: the grid sharded over the mesh axis ``axis_name``,
    inside :func:`..parallel.mesh.shard_map`), and :func:`chunked_solve`
    (``method='chunked'``, last axis only). ``axis`` (PCR only) selects
    the system axis; ``negated`` (PCR only) says that ``b`` is a negation,
    as the Newton update's ``-r`` is, which changes XLA:CPU's first
    contraction (:func:`pcr_solve`)."""
    if axis not in (-1, b.ndim - 1) and method != "pcr":
        raise ValueError(f"method {method!r} only solves along the last axis")
    if method == "spike":
        if axis_name is None:
            raise ValueError(
                "method 'spike' solves a grid sharded over a mesh axis: pass its "
                "axis_name (inside parallel.mesh.shard_map)")
        from .spike import spike_tridiag_solve

        return spike_tridiag_solve(lo, di, up, b, axis_name)
    if method == "pcr_fused":
        if b.ndim == 2:
            # imported here: pcr_fused.py imports this module
            from .pcr_fused import pcr_fused

            return pcr_fused(lo, di, up, b)
        return pcr_solve(lo, di, up, b, negated=negated)
    if method == "thomas":
        return thomas_solve(lo, di, up, b)
    if method == "chunked":
        return chunked_solve(lo, di, up, b)
    if method == "pcr":
        return pcr_solve(lo, di, up, b, axis=axis, negated=negated)
    raise ValueError(f"Unknown tridiagonal solver {method!r}")
