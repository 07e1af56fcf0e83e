"""Numeric helpers (port of the JAX package's ``utils/numerics.py``, a
rebuild of EnergyBalanceModel.jl ``src/utilities.jl:389-403``). Each takes
torch tensors, and returns numpy for numpy input.

It also holds the fused multiply-add of XLA:CPU (:func:`fma`) and the
``cos`` of XLA's constant folding (:func:`host_cos`). XLA:CPU contracts a
multiply into the add or subtract that reads it when both sit in one fused
loop and the product has no other use there (LLVM's fusion of ``fmul`` and
``fadd`` under ``contract``, not the aggressive kind: a product with two
uses in the loop is rounded); of a sum of two products, the one that LLVM's
operand ranking puts first. The JAX package's results therefore carry a
single rounding at exactly these sites of the scan engine's first step
(its fused loops read from the optimized HLO of
``jax.jit(integrate.make_year_fn(...))``, and held bitwise by
``tests/test_torch_fma.py``), which the port makes with :func:`fma` and its
kernels with ``__fmaf_rn``/``__fma_rn``:

- ``models/miz.py``: the insolation ``fma(-S2, x^2, fma(-S1 x, cos, S0))``
  and coalbedo ``fma(-a2, x^2, a0)``; ``Tb = fma(Ti, phi, (1 - phi) Tw)``;
  the stencil ``fma(gup, v+, fma(glo, v-, gdi v))``; in the T0 residual
  ``fma(ai, insol, k (Tm - T0) / hp)`` at the warm start (inside the Newton
  loop ``ai insol`` is a rounded loop invariant), ``fma(-B, T0 - Tm, -A)``,
  ``fma(D, stencil, r)``, and ``jdi = fma(D gdi, g, -k / hp - B)``;
  ``L = fma(B, Tb - Tm, A)``; the fluxes ``fma(ai, insol, -L)`` and
  ``fma(aw, insol, -L)``, with ``D stencil`` contracted into them where one
  loop reads a single flux (``h``, the floe-size update) and rounded where
  it reads both (the enthalpies); ``fma(fma(phi, Fvi, Flat), dt, Ei)``,
  ``fma(fma(1 - phi, Fvw, -Flat), dt, Ew)``, ``fma(Drl, Drl, -Df^2)``,
  ``fma(fma(weld, Df^3, fma(lat_melt, wl, lat_grow)), dt, Df)``,
  ``total = fma(q, dt, n)`` with ``dn = q dt``, the numerators
  ``fma(q, Dmin dt, n rD)`` and ``fma(q, hmin dt, n rh)``,
  ``fma(-1/Lf Fvi, dt, h)``, ``E = fma(phi, Ei, (1 - phi) Ew)`` and
  ``T = fma(Ti, phi, (1 - phi) Tw)``. XLA also rewrites ``psiEwdt / dt`` as
  ``psiEwdt * (1 / dt)`` and ``dn Dmin`` as ``q (Dmin dt)``;
- ``models/classic.py``: ``S0 - S2 x^2``, ``a0 - a2 x^2``, the insolation
  rows ``fma(-S1 cos, x, SA)``, ``C`` (``cg_tau Tg`` contracted in a
  year's first step, ``alpha S`` in the others), ``E_new = fma(fma(-M, T,
  C) + Fb, dt, E)``, ``fma(ai, S, -A)`` and ``rhs = fma(dt_tau, ..., Tg)``;
- ``ops/tridiag.py::pcr_solve``: each level's ``b`` and ``di`` as two
  fused multiply-adds, alpha's first; the first level contracts ``b * inv``
  of the row scaling (or, for a negated right-hand side such as the Newton
  update's ``-r``, ``alpha b[i - s]``); the last level rounds alpha's
  products;
- ``ops/newton_t0.py``: the MIZ residual's sites (the K10 kernel shares the
  device code).

Where XLA's vectorised loop leaves a scalar tail, its code may differ
(``tests/test_torch_fma.py`` pins one such case: the insolation table)."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["crossmean", "hemispheric_mean", "condset", "zeroref", "nan_to_zero",
           "np_hemispheric_mean", "flush_subnormal", "fma", "fma_f32", "fma_f64", "host_cos"]


def crossmean(stack):
    """Mean across the leading (time) axis of a stacked solution array;
    NaNs propagate (reference ``crossmean``, ``utilities.jl:390-395``)."""
    if torch.is_tensor(stack):
        return torch.mean(stack, dim=0)
    return np.mean(np.asarray(stack), axis=0)


def hemispheric_mean(vec, x):
    """Trapezoid integral of ``vec`` over the grid ``x``, over the last
    axis: ``sum_i (v_i + v_{i+1}) (x_{i+1} - x_i) / 2`` (reference
    ``utilities.jl:397-403``). A tensor ``vec`` keeps its dtype and device
    (``x`` is cast to them)."""
    if torch.is_tensor(vec):
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                            dtype=vec.dtype, device=vec.device)
        return torch.sum((vec[..., :-1] + vec[..., 1:]) * (x[1:] - x[:-1]) / 2.0, dim=-1)
    vec, x = np.asarray(vec), np.asarray(x)
    return np.sum((vec[..., :-1] + vec[..., 1:]) * (x[1:] - x[:-1]) / 2.0, axis=-1)


def condset(to, value, mask):
    """Pure analog of ``condset!`` (reference ``utilities.jl:406-412``):
    ``to`` with ``value`` where ``mask`` is true."""
    if torch.is_tensor(to):
        return torch.where(torch.as_tensor(mask, device=to.device),
                           torch.as_tensor(value, dtype=to.dtype, device=to.device), to)
    return np.where(mask, value, to)


def zeroref(v, ref):
    """Pure analog of ``zeroref!`` (reference ``utilities.jl:415``): ``v``
    zeroed where ``ref == 0``."""
    if torch.is_tensor(v):
        return torch.where(torch.as_tensor(ref, device=v.device) == 0, torch.zeros_like(v), v)
    return np.where(np.asarray(ref) == 0, np.zeros_like(v), v)


def nan_to_zero(v):
    """``condset!(v, 0.0, isnan)``, the MIZ step's water-temperature clean-up
    (reference ``src/miz.jl:157``)."""
    if torch.is_tensor(v):
        return torch.where(torch.isnan(v), torch.zeros_like(v), v)
    v = np.asarray(v)
    return np.where(np.isnan(v), np.zeros_like(v), v)


def np_hemispheric_mean(vec, x) -> float:
    """NumPy twin of :func:`hemispheric_mean` for one ``(nx,)`` row, as a
    Python float (the host-side plotting paths)."""
    vec, x = np.asarray(vec), np.asarray(x)
    return float(np.sum((vec[:-1] + vec[1:]) * (x[1:] - x[:-1]) / 2.0))


def flush_subnormal(x):
    """``x`` with each subnormal value replaced by a zero of its sign, every
    other value (NaN and infinities too) kept: the flush to zero that XLA's
    CPU backend and the TPU apply to every result, and with which the JAX
    package computes. The MIZ step applies it where a value that decays
    geometrically would otherwise reach a zero test or a division as a
    subnormal (``models/miz.py::step``). The derivative is 1 everywhere but
    at a flushed value, so an exact zero (an ice-free cell's ``Ei``) keeps
    its gradient, as under the backends' flush."""
    return x * ((torch.abs(x) >= torch.finfo(x.dtype).tiny) | (x == 0))


def _fma_f32_emulated(a, b, c):
    """``a * b + c`` in float32 with ONE rounding from float64 arithmetic:
    the product of two float32 values is exact in float64; the float64 sum
    is made round-to-odd (its error, from a TwoSum, nudges an even last bit
    away from a tie), so the final rounding to float32 is the single
    rounding of the exact value. Finite operands only."""
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


@functools.lru_cache(maxsize=None)
def addcmul_is_fma(device_type: str) -> bool:
    """Whether ``torch.addcmul`` of float32 tensors on this kind of device
    rounds once (a fused multiply-add: the CPU's vector and scalar paths
    with FMA instructions, the CUDA kernel), checked once against
    :func:`_fma_f32_emulated` on seeded operands and on a case that two
    roundings get wrong."""
    dev = torch.device(device_type)
    g = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(4099, generator=g, dtype=torch.float32) for _ in range(3))
    a[0] = b[0] = 1.0 + 2.0 ** -12  # a b = 1 + 2^-11 + 2^-24, exactly
    c[0] = -1.0
    got = torch.addcmul(c.to(dev), a.to(dev), b.to(dev)).cpu()
    return bool(torch.equal(got, _fma_f32_emulated(a, b, c)))


def fma_f32(a, b, c):
    """``a * b + c`` in float32 with ONE rounding, as XLA contracts it and as
    ``__fmaf_rn`` computes it, on any device: ``torch.addcmul`` where the
    device's kernel rounds once (:func:`addcmul_is_fma`), else the float64
    emulation. Finite operands only; differentiable as ``a * b + c``."""
    ref = next(v for v in (a, b, c) if torch.is_tensor(v))
    if addcmul_is_fma(ref.device.type):
        a, b, c = (v if torch.is_tensor(v) and v.dtype == torch.float32 else
                   torch.as_tensor(v, dtype=torch.float32, device=ref.device) for v in (a, b, c))
        return torch.addcmul(c, a, b)
    grad = any(torch.is_tensor(v) and v.requires_grad for v in (a, b, c))
    if grad and torch.is_grad_enabled():
        with torch.no_grad():
            exact = _fma_f32_emulated(a, b, c)
        two = a * b + c
        return two + (exact - two.detach())
    return _fma_f32_emulated(a, b, c)


def fma_f64(a, b, c):
    """``a * b + c`` in float64 with one rounding (``torch.addcmul``, which
    matches XLA's contracted float64 ``a * b + c``)."""
    a, b, c = (v if torch.is_tensor(v) else torch.as_tensor(v, dtype=torch.float64)
               for v in (a, b, c))
    return torch.addcmul(c, a, b)


def fma(a, b, c):
    """``a * b + c`` with one rounding, in the dtype of the tensor operands
    (:func:`fma_f32` or :func:`fma_f64`): the contraction XLA:CPU makes of
    the JAX package's ``a * b + c`` where product and sum share a fusion."""
    dt = next(v.dtype for v in (a, b, c) if torch.is_tensor(v) and v.is_floating_point())
    return (fma_f32 if dt == torch.float32 else fma_f64)(a, b, c)


def host_cos(x: torch.Tensor) -> torch.Tensor:
    """``cos`` of a host tensor as XLA folds a constant ``jnp.cos``: the C
    library's double ``cos``, rounded to float32 for a float32 ``x``.
    ``torch.cos`` (a vectorised polynomial) differs from it in the last bit
    on ~0.2% of float64 and ~5% of float32 arguments."""
    vals = [math.cos(v) for v in x.detach().cpu().double().reshape(-1).tolist()]
    return torch.tensor(vals, dtype=torch.float64).reshape(x.shape).to(x.dtype)
