"""Newton solver for nonlinear systems with tridiagonal Jacobians.

Replacement for the reference's ``NonlinearSolve.TrustRegion`` inner solver
(EnergyBalanceModel.jl ``src/miz.jl:55-60``). The MIZ ice-surface
temperature residual couples neighbors only through the 3-point diffusion
stencil, so its Jacobian is analytically tridiagonal; a warm-started Newton
iteration with an exact tridiagonal solve per step converges in a handful of
iterations.

The loop runs in lockstep over the whole batch, as the JAX package's
``lax.while_loop`` does: it continues while ANY lane is above its tolerance,
a condition the host reads once per iteration. Inside
:func:`..parallel.mesh.shard_map` the norm and the condition reduce over the
mesh axes named (JAX ``ops/newton.py:30-99``).
"""
from __future__ import annotations

import torch

from .tridiag import tridiag_solve

__all__ = ["newton_tridiag"]


def newton_tridiag(
    residual_and_bands,
    x0: torch.Tensor,
    abstol: float = 1e-8,
    reltol: float = 1e-6,
    max_iter: int = 30,
    method: str = "pcr",
    max_step: float = None,
    axis_name: str = None,
    cond_axis_name: str = None,
    axis: int = -1,
    initial=None,
):
    """Solve ``r(x) = 0`` where ``J = dr/dx`` is tridiagonal.

    ``residual_and_bands`` maps ``x -> (r, (lo, di, up))``. Convergence is on
    the residual inf-norm along ``axis``:
    ``||r||_inf <= max(abstol, reltol * ||r0||_inf)`` per lane. ``max_step``
    optionally caps each Newton update elementwise (float32 safeguard); a
    non-finite update freezes its entry instead of poisoning it. ``initial``
    (default ``residual_and_bands``) evaluates the warm start ``x0``: the
    JAX package's loop body and its first evaluation round differently.

    ``axis_name`` (the grid sharded over that mesh axis): the norm is the
    ``pmax`` over the shards, so every shard decides alike, and the update
    solves by SPIKE when ``method='spike'``. ``cond_axis_name``: a further
    mesh axis the loop CONDITION is OR-reduced over (a member axis), so
    every shard runs the same trip count, the unsharded batch's; per-lane
    norms, tolerances and flags are untouched.

    Returns ``(x, converged, iterations)`` — the solution, the per-lane bool
    convergence flags, and the iteration count actually used (an int).
    """
    if axis_name is not None or cond_axis_name is not None:
        from ..parallel.mesh import pmax

    def norm(r):
        # NaN-propagating, like jnp.max
        n = torch.amax(torch.abs(r), dim=axis)
        return n if axis_name is None else pmax(n, axis_name)

    def go():
        g = bool(torch.any(rnorm > tol))
        return g if cond_axis_name is None else pmax(g, cond_axis_name)

    r, bands = (initial or residual_and_bands)(x0)
    rnorm = norm(r)
    tol = torch.maximum(
        torch.as_tensor(abstol, dtype=x0.dtype, device=x0.device), reltol * rnorm
    )
    x = x0
    it = 0
    # one residual evaluation per iteration: the residual and Jacobian of
    # the current iterate are carried from the previous iteration
    while it < max_iter and go():
        lo, di, up = bands
        delta = tridiag_solve(lo, di, up, -r, method=method, axis_name=axis_name, axis=axis,
                              negated=True)
        if max_step is not None:
            delta = torch.clamp(delta, -max_step, max_step)
        # a non-finite update (singular float32 Jacobian) freezes the lane
        # instead of poisoning it; the convergence flag reports the failure
        delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
        x = x + delta
        r, bands = residual_and_bands(x)
        rnorm = norm(r)
        it += 1
    return x, rnorm <= tol, it
