"""Fixed-iteration Newton solve of the MIZ ice surface temperature for a
batch: the wrapper of the CUDA kernel ``csrc/newton_t0.cu`` and its plain
PyTorch version.

Port of the JAX package's ``ops/pallas_newton.py::pallas_solve_T0``, the
``solver='pallas'`` path of :func:`..models.miz.solve_T0` on the batched
engine: ``iters`` Newton iterations on the ``T0eq`` residual (reference
``src/miz.jl:33-45``) with its analytic tridiagonal Jacobian, each solved by
row-scaled PCR, the update clipped to ``±max_step`` and a non-finite update
set to 0. There is no convergence test: a converged cell takes steps of ~0.

:func:`newton_t0` dispatches on the device of ``T0``: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs :func:`newton_t0_reference`.
"""
from __future__ import annotations

import torch

from . import _build
from ._year import FORCE_CLUSTER, WIDE, check_width, cluster_plan, refuse_grad, workspace
from ..utils.numerics import fma
from .tridiag import _shift, pcr_solve, pcr_steps

__all__ = ["newton_t0", "newton_t0_reference", "MAX_N"]

# up to 4096 cells in registers (at most 4 per thread of 1024), above that
# the cluster build (each member's cells across a thread-block cluster)
MAX_N = WIDE["newton_t0"]["max"]


def _check_args(T0, fields, bands):
    if T0.ndim != 2:
        raise ValueError(f"newton_t0 takes a (K, nx) state, got shape {tuple(T0.shape)}")
    for name, v in fields.items():
        if v.shape != T0.shape or v.dtype != T0.dtype or v.device != T0.device:
            raise ValueError(
                f"{name} is {v.dtype} {tuple(v.shape)} on {v.device}; expected "
                f"{T0.dtype} {tuple(T0.shape)} on {T0.device}"
            )
    for name, v in bands.items():
        if tuple(v.shape) != (T0.shape[1],):
            raise ValueError(f"band {name} must have shape ({T0.shape[1]},), "
                             f"got {tuple(v.shape)}")


def _scalars(dtype, device, **values):
    """0-dim tensors of the run's dtype on its device; a leaf that is not a
    scalar raises (the kernel takes one value per call)."""
    out = {}
    for name, v in values.items():
        v = torch.as_tensor(v, dtype=dtype, device=device)
        if v.ndim != 0:
            raise ValueError(f"newton_t0 takes a scalar {name}, got shape {tuple(v.shape)}")
        out[name] = v
    return out


def newton_t0(T0, hp, Tw, phi, insol, glo, gdi, gup, D, k, Tm, A, B, ai, f,
              max_step=50.0, iters: int = 6):
    """``iters`` Newton iterations for the ice surface temperature of a batch,
    with the arguments and semantics of JAX ``pallas_solve_T0``: ``T0, hp,
    Tw, phi, insol`` of shape ``(K, nx)``; stencil bands ``glo, gdi, gup`` of
    shape ``(nx,)``; ``D`` per member ``(K,)`` or shared; scalars ``k, Tm,
    A, B, ai, f`` and ``max_step``. Returns the updated ``(K, nx)`` ``T0``.

    On a CUDA device this launches the kernel (counted in
    ``newton_t0.launches``; above nx = 4096 its cluster build as the C side
    plans it, up to ``MAX_N`` cells) and raises if it cannot; on the CPU it
    runs :func:`newton_t0_reference`."""
    dtype, device = T0.dtype, T0.device
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    glo, gdi, gup = as_t(glo), as_t(gdi), as_t(gup)
    _check_args(T0, dict(hp=hp, Tw=Tw, phi=phi, insol=insol), dict(glo=glo, gdi=gdi, gup=gup))
    if device.type == "cpu":
        return newton_t0_reference(T0, hp, Tw, phi, insol, glo, gdi, gup, D, k, Tm, A, B,
                                   ai, f, max_step, iters)
    if device.type != "cuda":
        raise ValueError(f"newton_t0 has no kernel for device {device}")
    refuse_grad("newton_t0", T0, hp, Tw, phi, insol, glo, gdi, gup, D, k, Tm, A, B, ai, f)
    K, n = T0.shape
    check_width("newton_t0", n)
    s = _scalars(dtype, device, k=k, Tm=Tm, A=A, B=B, ai=ai, f=f, max_step=max_step)
    scal = torch.stack([s[name] for name in ("k", "Tm", "A", "B", "ai", "f", "max_step")])
    D = as_t(D).reshape(-1).expand(K).contiguous()
    bands = torch.stack([glo, gdi, gup])
    inputs = [v.contiguous() for v in (T0, hp, Tw, phi, insol)]
    out = torch.empty_like(inputs[0])
    # above the register builds' width, the cluster build as the C side
    # plans it (it launches with the same plan), with a workspace only where
    # its records stay in device memory
    plan = (cluster_plan("newton_t0", n, 1, K, dtype, device)
            if n > WIDE["newton_t0"]["narrow"] else None)
    ws, ws_ptr, ws_words, ws_blocks = workspace("newton_t0", n, K, dtype, device, plan)
    _build.launch("ebm_newton_t0", dtype, device, *(v.data_ptr() for v in inputs),
                  bands.data_ptr(), D.data_ptr(), scal.data_ptr(), out.data_ptr(), ws_ptr, K, n,
                  int(iters), pcr_steps(n), ws_words, ws_blocks, FORCE_CLUSTER["newton_t0"])
    _build.count(newton_t0)
    return out


newton_t0.launches = 0


def newton_t0_reference(T0, hp, Tw, phi, insol, glo, gdi, gup, D, k, Tm, A, B, ai, f,
                        max_step=50.0, iters: int = 6):
    """The plain PyTorch version of :func:`newton_t0` on any device: the
    fixed-iteration loop of JAX ``pallas_newton.py:104-134``, with
    ``k / hp``, ``(1 - phi) Tw`` and ``ai insol`` hoisted out of the loop,
    neighbour values zero outside the grid, :func:`.tridiag.pcr_solve` for
    the Jacobian, and the fused multiply-adds of the MIZ step's residual
    (``models/miz.py::_t0_residual``), which the kernel shares."""
    dtype, device = T0.dtype, T0.device
    s = _scalars(dtype, device, k=k, Tm=Tm, A=A, B=B, ai=ai, f=f, max_step=max_step)
    k, Tm, A, B, ai, f, max_step = (s[name] for name in
                                    ("k", "Tm", "A", "B", "ai", "f", "max_step"))
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    D = as_t(D).reshape(-1, 1)
    glo, gdi, gup = as_t(glo), as_t(gdi), as_t(gup)
    k_over_h = k / hp
    one_m_phi_Tw = (1.0 - phi) * Tw
    solar_ice = ai * insol
    for _ in range(iters):
        Ti = torch.minimum(T0, Tm)
        Tb = fma(Ti, phi, one_m_phi_Tw)
        lap = fma(gup, _shift(Tb, -1), fma(glo, _shift(Tb, 1), gdi * Tb))
        r = k_over_h * (Tm - T0) + solar_ice
        r = fma(D, lap, r + fma(-B, T0 - Tm, -A)) + f
        g = phi * (T0 < Tm).to(dtype)
        jlo = D * glo * _shift(g, 1)
        jdi = fma(D * gdi, g, -k_over_h - B)
        jup = D * gup * _shift(g, -1)
        delta = pcr_solve(jlo, jdi, jup, -r, negated=True)
        delta = torch.clamp(delta, -max_step, max_step)
        delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
        T0 = T0 + delta
    return T0
