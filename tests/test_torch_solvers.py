"""The batched engine's stand-alone solvers of the PyTorch port — the
one-launch PCR (``ops/pcr_fused.py``, ``solver='pcr_fused'``) and the
fixed-iteration Newton for T0 (``ops/newton_t0.py``, ``solver='pallas'``) —
against the JAX package's Pallas kernels, float64 on CPU.

On a CPU tensor each wrapper runs its plain version; the JAX side runs
``pallas_pcr_solve`` and ``pallas_solve_T0`` with ``interpret=True``, as the
JAX package's own tests do off-TPU. Bars:
- ``pcr_fused`` against ``pallas_pcr_solve``: 1e-12 relative, with shared
  ``(n,)`` and per-system ``(K, n)`` bands; and against a dense solve;
- the plain Newton against ``pallas_solve_T0`` at nx=40, K=9: 1e-10
  (normwise relative);
- one nx=40/nt=200 MIZ year of ``ensemble_integrate(engine='batched',
  solver='pallas')`` against the JAX package's same call: 1e-8.
The CUDA kernels are held bitwise against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.ops.pallas_newton import pallas_solve_T0
from energybalancemodel_jl_tpu.ops.pallas_tridiag import pallas_pcr_solve
from energybalancemodel_jl_tpu.parallel.ensemble import ensemble_integrate as jax_ensemble
from energybalancemodel_jl_tpu_torch.models import miz as tmiz
from energybalancemodel_jl_tpu_torch.models.base import default_step_config
from energybalancemodel_jl_tpu_torch.ops import newton_t0 as tnt
from energybalancemodel_jl_tpu_torch.ops import pcr_fused as tpf
from energybalancemodel_jl_tpu_torch.ops.diffusion import diffusion_bands
from energybalancemodel_jl_tpu_torch.ops.tridiag import tridiag_solve

torch.set_num_threads(1)
T64 = torch.float64


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=T64)


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def random_system(rng, K, n, shared):
    """Diagonally dominant bands, ``(n,)`` when ``shared``, and a (K, n) rhs."""
    shape = (n,) if shared else (K, n)
    lo, up = rng.normal(size=shape), rng.normal(size=shape)
    di = np.abs(lo) + np.abs(up) + rng.uniform(0.5, 2.0, size=shape)
    di = di * rng.choice([-1, 1], size=shape)
    return lo, di, up, rng.normal(size=(K, n))


def dense_solve(lo, di, up, b):
    K, n = b.shape
    lo, di, up = (np.broadcast_to(v, (K, n)) for v in (lo, di, up))
    out = np.empty_like(b)
    for m in range(K):
        A = np.diag(di[m]) + np.diag(lo[m, 1:], -1) + np.diag(up[m, :-1], 1)
        out[m] = np.linalg.solve(A, b[m])
    return out


@pytest.mark.parametrize("n", [1, 7, 40, 180, 300])
@pytest.mark.parametrize("shared", [True, False], ids=["shared-bands", "per-system-bands"])
def test_pcr_fused_matches_jax_kernel_and_dense_solve(n, shared, rng):
    lo, di, up, b = random_system(rng, 6, n, shared)
    ref = np.asarray(pallas_pcr_solve(*(jnp.asarray(v) for v in (lo, di, up, b)),
                                      interpret=True))
    before = tpf.pcr_fused.launches
    got = tridiag_solve(t(lo), t(di), t(up), t(b), method="pcr_fused").numpy()
    assert tpf.pcr_fused.launches == before  # the CPU runs the plain version
    assert got.shape == b.shape
    assert rel_err(got, ref) <= 1e-12
    # the boundary couplings lo[0] and up[-1] are outside the system
    lo0, up0 = np.array(lo, copy=True), np.array(up, copy=True)
    lo0[..., 0] = 0.0
    up0[..., -1] = 0.0
    assert rel_err(got, dense_solve(lo0, di, up0, b)) <= 1e-12
    # a 1-D system solves by pcr_solve, as in the JAX package: system 0 alone
    row0 = lambda v: t(v).reshape(-1, n)[0]
    one = tridiag_solve(row0(lo), row0(di), row0(up), t(b[0]), method="pcr_fused")
    np.testing.assert_array_equal(one.numpy(), got[0])


def test_pcr_fused_argument_checks():
    z = torch.zeros((2, 8), dtype=T64)
    with pytest.raises(ValueError, match=r"\(K, n\) systems"):
        tpf.pcr_fused(z[0], z[0], z[0], torch.zeros((2, 2, 8), dtype=T64))
    meta = torch.empty((2, 8), dtype=T64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tpf.pcr_fused(meta, meta, meta, meta)


def newton_problem(rng, K=9, nx=40):
    """A T0 solve on a random MIZ batch: both packages' inputs."""
    st = ebt.SpaceTime.sin(nx, 200, 1)
    par = ebt.default_parameters("MIZ")
    geom = diffusion_bands(st)
    x = st.x
    insol = (par["S0"] - par["S1"] * x * np.cos(2 * np.pi * 0.3)) - par["S2"] * x**2
    hp = np.abs(rng.normal(1.0, 0.5, (K, nx))) + par["hmin"]
    Tw = rng.normal(0.0, 3.0, (K, nx))
    phi = rng.uniform(0.0, 1.0, (K, nx))
    T0 = rng.normal(-5.0, 5.0, (K, nx))
    arrays = [T0, hp, Tw, phi, np.tile(insol, (K, 1)), geom.lo, geom.di, geom.up,
              np.linspace(0.5, 0.7, K)]
    scalars = [par["k"], par["Tm"], par["A"], par["B"], par["ai"], 0.7]
    return arrays, scalars


@pytest.mark.parametrize("iters,max_step", [(6, 50.0), (3, 0.5)])
def test_newton_t0_matches_jax_kernel(iters, max_step, rng):
    arrays, scalars = newton_problem(rng)
    ref = np.asarray(pallas_solve_T0(*(jnp.asarray(v) for v in arrays), *scalars,
                                     max_step=max_step, iters=iters, interpret=True))
    before = tnt.newton_t0.launches
    got = tnt.newton_t0(*(t(v) for v in arrays), *scalars, max_step=max_step,
                        iters=iters).numpy()
    assert tnt.newton_t0.launches == before
    assert rel_err(got, ref) <= 1e-10
    if max_step == 0.5:  # the clip binds
        assert np.max(np.abs(got - arrays[0])) <= iters * 0.5 + 1e-12


def test_newton_t0_nonfinite_step_freezes_the_cell(rng):
    arrays, scalars = newton_problem(rng, K=3, nx=20)
    arrays[1] = arrays[1].copy()
    arrays[1][1, 5] = np.nan  # a NaN thickness poisons member 1's solve
    ref = np.asarray(pallas_solve_T0(*(jnp.asarray(v) for v in arrays), *scalars, iters=4,
                                     interpret=True))
    got = tnt.newton_t0(*(t(v) for v in arrays), *scalars, iters=4).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert rel_err(np.nan_to_num(got), np.nan_to_num(ref)) <= 1e-10


def test_newton_t0_argument_checks(rng):
    arrays, scalars = newton_problem(rng, K=2, nx=8)
    args = [t(v) for v in arrays]
    with pytest.raises(ValueError, match="scalar k"):
        tnt.newton_t0(*args, np.ones(2), *scalars[1:])
    with pytest.raises(ValueError, match=r"\(K, nx\) state"):
        tnt.newton_t0(args[0][0], *args[1:], *scalars)
    with pytest.raises(ValueError, match="hp is"):
        tnt.newton_t0(args[0], args[1][:1], *args[2:], *scalars)
    with pytest.raises(ValueError, match="band glo"):
        tnt.newton_t0(*args[:5], args[5][:-1], *args[6:], *scalars)


def test_solver_pallas_routes_batches_to_the_kernel_and_single_runs_to_newton():
    """A (K, nx) state takes the fixed-iteration kernel (on a GPU its launch
    counter rises; on the CPU its plain version runs) and reports the JAX
    package's diagnostic; a single run's (nx,) state keeps the adaptive
    Newton (JAX models/miz.py:208); swept k or a per-member forcing raises."""
    st = ebt.SpaceTime.sin(16, 100, 1)
    par = ebt.from_numpy(ebt.default_parameters("MIZ"))
    stat = tmiz.statics(st, par, T64, torch.device("cpu"))
    cfg = default_step_config("float64", solver="pallas")
    insol = tmiz.insolation(stat, 3)
    K = 3
    z = torch.zeros((K, st.nx), dtype=T64)
    h = torch.full((K, st.nx), 0.5, dtype=T64)
    phi = torch.full((K, st.nx), 0.6, dtype=T64)
    T0, conv, its = tmiz.solve_T0(z, insol, h, z, phi, torch.zeros((), dtype=T64), stat, par,
                                  cfg)
    assert its == 6 and T0.shape == (K, st.nx) and conv.shape == (K,) and bool(conv.all())
    T0_1, conv_1, its_1 = tmiz.solve_T0(z[0], insol, h[0], z[0], phi[0],
                                        torch.zeros((), dtype=T64), stat, par, cfg)
    assert its_1 != 6 and bool(conv_1)
    np.testing.assert_allclose(T0_1.numpy(), T0[0].numpy(), rtol=1e-9, atol=1e-9)
    swept = dict(par, k=torch.full((K, 1), 2.0, dtype=T64))
    with pytest.raises(ValueError, match="requires a scalar parameter 'k'"):
        tmiz.solve_T0(z, insol, h, z, phi, torch.zeros((), dtype=T64), stat, swept, cfg)
    with pytest.raises(ValueError, match="per-member F"):
        tmiz.solve_T0(z, insol, h, z, phi, torch.zeros((K, 1), dtype=T64), stat, par, cfg)


def test_batched_year_with_solver_pallas_matches_jax():
    st = ebt.SpaceTime.sin(40, 200, 1)
    par = ebt.default_parameters("MIZ")
    par["D"] = np.linspace(0.55, 0.65, 4)
    j = jax_ensemble("MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st), engine="batched",
                     solver="pallas", progress=False)
    t_ = ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                                dtype="float64", engine="batched", solver="pallas",
                                progress=False, device="cpu")
    for name in ("winter", "summer", "avg"):
        for k, a in getattr(j.seasonal, name).items():
            b = getattr(t_.seasonal, name)[k]
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{name}.{k}")
            np.testing.assert_allclose(np.nan_to_num(b), np.nan_to_num(a), rtol=1e-8, atol=1e-8,
                                       err_msg=f"{name}.{k}")
    assert np.nanmax(t_.seasonal.avg["phi"]) > 0.1  # ice forms: the T0 solve matters
