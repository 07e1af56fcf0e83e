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

Both are stable for the diagonally dominant systems that arise here.
"""
from __future__ import annotations

import math

import torch

from ..utils.numerics import fma

__all__ = ["thomas_solve", "pcr_solve", "pcr_steps", "tridiag_solve", "tridiag_matvec"]


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

    def safe_div(num, den):
        # reduced diagonals never vanish for diagonally dominant systems in
        # exact arithmetic; the guard stops a float32-cancelled zero pivot
        # from injecting inf/NaN (a no-op in healthy lanes)
        zero = den == 0
        return torch.where(zero, 0.0, num / torch.where(zero, 1.0, den))

    s = 1
    for level in range(steps):
        di_m = _shift(di, s, axis, fill=1.0)
        di_p = _shift(di, -s, axis, fill=1.0)
        alpha = safe_div(-lo, di_m)
        beta = safe_div(-up, di_p)
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


def tridiag_solve(lo, di, up, b, method: str = "pcr", axis_name: str = None,
                  axis: int = -1, negated: bool = False):
    """Dispatch between :func:`pcr_solve` (default), :func:`thomas_solve`
    (``method='thomas'``, last axis only), the one-launch batched PCR
    (``method='pcr_fused'``: a 2-D ``(K, n)`` system goes to
    :func:`.pcr_fused.pcr_fused`, any other rank to :func:`pcr_solve`, as in
    the JAX package) and the distributed :func:`.spike.spike_tridiag_solve`
    (``method='spike'``: the grid sharded over the mesh axis ``axis_name``,
    inside :func:`..parallel.mesh.shard_map`). ``axis`` (PCR only) selects
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
    if method == "pcr":
        return pcr_solve(lo, di, up, b, axis=axis, negated=negated)
    raise ValueError(f"Unknown tridiagonal solver {method!r}")
