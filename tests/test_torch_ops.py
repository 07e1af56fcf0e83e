"""Operators of the PyTorch port against the JAX package, float64 on CPU.

Bars (ROADMAP "held against the reference"):
- ``diffusion_bands`` is exact (the same numpy code);
- the tridiagonal solves agree to <= 1e-13 relative on random, batched,
  diagonally dominant bands;
- Newton on the MIZ residual matches JAX's iterates to 1e-12 (normwise
  relative: max |difference| over max |JAX iterate|) and its iteration
  counts exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.models import miz as jmiz
from energybalancemodel_jl_tpu.ops.diffusion import apply_diffusion as j_apply_diffusion
from energybalancemodel_jl_tpu.ops.diffusion import diffusion_bands as j_diffusion_bands
from energybalancemodel_jl_tpu.ops import newton as jnewton
from energybalancemodel_jl_tpu.ops import tridiag as jtri
from energybalancemodel_jl_tpu_torch.models import miz as tmiz
from energybalancemodel_jl_tpu_torch.ops.diffusion import apply_diffusion, diffusion_bands, neighbor_cells
from energybalancemodel_jl_tpu_torch.ops import newton as tnewton
from energybalancemodel_jl_tpu_torch.ops import tridiag as ttri

torch.set_num_threads(1)
T64 = torch.float64


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=T64)


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def random_bands(rng, shape):
    """Diagonally dominant bands with zero boundary couplings."""
    lo = rng.normal(size=shape)
    up = rng.normal(size=shape)
    lo[..., 0] = 0.0
    up[..., -1] = 0.0
    di = (np.abs(lo) + np.abs(up) + rng.uniform(0.5, 2.0, size=shape)) * rng.choice([-1, 1], size=shape)
    b = rng.normal(size=shape)
    return lo, di, up, b


@pytest.mark.parametrize("grid,nx", [("sin", 180), ("identity", 37), ("sin", 1)])
def test_diffusion_bands_exact(grid, nx):
    st = getattr(ebt.SpaceTime, grid)(nx, 100, 1)
    a, b = j_diffusion_bands(st), diffusion_bands(st)
    for name in ("lo", "di", "up"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def test_apply_diffusion_and_neighbors(rng):
    st = ebt.SpaceTime.sin(50, 100, 1)
    T = rng.normal(size=(3, 50))
    ref = np.asarray(j_apply_diffusion(jnp.asarray(T), j_diffusion_bands(st), 0.6))
    got = apply_diffusion(t(T), diffusion_bands(st), 0.6).numpy()
    assert rel_err(got, ref) <= 1e-13
    m1, p1 = neighbor_cells(t(T), axis=0)
    np.testing.assert_array_equal(m1.numpy(), np.roll(T, 1, axis=0))
    np.testing.assert_array_equal(p1.numpy(), np.roll(T, -1, axis=0))


@pytest.mark.parametrize("n", [1, 2, 7, 40, 65, 180])
def test_pcr_solve_matches_jax(n, rng):
    lo, di, up, b = random_bands(rng, (5, n))
    ref = np.asarray(jtri.pcr_solve(*(jnp.asarray(v) for v in (lo, di, up, b))))
    got = ttri.pcr_solve(t(lo), t(di), t(up), t(b)).numpy()
    assert rel_err(got, ref) <= 1e-13
    # the system axis can also lead (bands full rank): solve along axis 0
    got0 = ttri.pcr_solve(t(lo.T), t(di.T), t(up.T), t(b.T), axis=0).numpy()
    ref0 = np.asarray(jtri.pcr_solve(*(jnp.asarray(v.T) for v in (lo, di, up, b)), axis=0))
    assert rel_err(got0, ref0) <= 1e-13
    np.testing.assert_array_equal(got0, got.T)


def test_pcr_solve_axis_needs_full_rank_bands(rng):
    lo, di, up, b = random_bands(rng, (6, 4))
    with pytest.raises(ValueError, match="full-rank"):
        ttri.pcr_solve(t(lo[:, 0]), t(di), t(up), t(b), axis=0)


@pytest.mark.parametrize("shape", [(12,), (3, 40)])
def test_thomas_solve_matches_jax(shape, rng):
    lo, di, up, b = random_bands(rng, shape)
    ref = np.asarray(jtri.tridiag_solve(*(jnp.asarray(v) for v in (lo, di, up, b)), method="thomas"))
    got = ttri.tridiag_solve(t(lo), t(di), t(up), t(b), method="thomas").numpy()
    assert rel_err(got, ref) <= 1e-13
    # and it solves the system
    resid = lo * np.roll(got, 1, axis=-1) + di * got + up * np.roll(got, -1, axis=-1) - b
    assert np.max(np.abs(resid)) <= 1e-12


@pytest.mark.parametrize("method,item", [("pcr_fused", "no kernel for device meta"),
                                         ("spike", "axis_name"), ("lu", "Unknown")],
                         ids=["pcr_fused-K11", "spike-M14", "lu-Unknown"])
def test_tridiag_solve_unported_methods_raise(method, item, rng):
    """An unknown method raises; 'spike' (the grid-sharded solve, ported
    with M14: tests/test_torch_spatial.py) raises without the mesh axis it
    solves over; 'pcr_fused' is ported (tests/test_torch_solvers.py) and
    raises only on a device that has neither its kernel nor its plain
    version."""
    lo, di, up, b = (t(v) for v in random_bands(rng, (2, 8)))
    if method == "pcr_fused":
        lo, di, up, b = (v.to("meta") for v in (lo, di, up, b))
    with pytest.raises(ValueError, match=item):
        ttri.tridiag_solve(lo, di, up, b, method=method)


def miz_newton_problem(rng, K=6, nx=60):
    """A warm-started T0 solve on a random MIZ state (both packages' inputs)."""
    st = ebt.SpaceTime.sin(nx, 200, 1)
    par = ebt.default_parameters("MIZ")
    geom = diffusion_bands(st)
    x = st.x
    insol = (par["S0"] - par["S1"] * x * np.cos(2 * np.pi * 0.3)) - par["S2"] * x**2
    hp = np.abs(rng.normal(1.0, 0.5, (K, nx))) + par["hmin"]
    Tw = rng.normal(0.0, 3.0, (K, nx))
    phi = rng.uniform(0.0, 1.0, (K, nx))
    f = np.zeros(())
    T0 = rng.normal(-5.0, 5.0, (K, nx))
    args = [np.tile(insol, (K, 1)), hp, Tw, phi, f, geom.lo, geom.di, geom.up,
            par["k"], par["Tm"], par["A"], par["B"], par["ai"], np.linspace(0.5, 0.7, K)[:, None]]
    return T0, args


@pytest.mark.parametrize("max_iter", [1, 2, 3, 30])
def test_newton_matches_jax_iterates_and_counts(max_iter, rng):
    T0, args = miz_newton_problem(rng)
    jargs = tuple(jnp.asarray(a) for a in args)
    targs = tuple(t(a) for a in args)
    kw = dict(abstol=1e-11, reltol=1e-9, max_iter=max_iter, method="pcr")
    xj, cj, itj = jnewton.newton_tridiag(
        lambda v: (jmiz._t0_residual(v, jargs), jmiz._t0_bands(v, jargs)), jnp.asarray(T0), **kw)
    xt, ct, itt = tnewton.newton_tridiag(
        lambda v: (tmiz._t0_residual(v, targs), tmiz._t0_bands(v, targs)), t(T0), **kw)
    assert int(itj) == itt
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    assert rel_err(xt.numpy(), xj) <= 1e-12
    if max_iter == 30:
        assert ct.all() and 2 <= itt < 30


def test_newton_step_clip_and_nonfinite_freeze(rng):
    """max_step clips the update; a NaN update freezes its lane in both
    packages, and the flags report the failure."""
    T0, args = miz_newton_problem(rng, K=3, nx=20)
    args[3] = args[3].copy()
    args[1] = args[1].copy()
    args[1][1, 5] = np.nan  # a NaN thickness poisons lane 1's residual
    jargs = tuple(jnp.asarray(a) for a in args)
    targs = tuple(t(a) for a in args)
    kw = dict(abstol=1e-11, reltol=1e-9, max_iter=4, method="pcr", max_step=0.5)
    xj, cj, itj = jnewton.newton_tridiag(
        lambda v: (jmiz._t0_residual(v, jargs), jmiz._t0_bands(v, jargs)), jnp.asarray(T0), **kw)
    xt, ct, itt = tnewton.newton_tridiag(
        lambda v: (tmiz._t0_residual(v, targs), tmiz._t0_bands(v, targs)), t(T0), **kw)
    assert int(itj) == itt
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    assert not bool(ct[1])
    assert rel_err(xt.numpy(), xj) <= 1e-12
    assert np.max(np.abs(xt.numpy() - T0)) <= 0.5 * itt + 1e-12
