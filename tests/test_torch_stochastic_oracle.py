"""The trajectory oracle of ``tests/test_stochastic_oracle.py`` (part a) for
the PyTorch port, float64 on the CPU: ``transitions`` on Classic against the
independent NumPy stepper ``tests/ref_impl.py::ClassicRef`` fed the same
noisy forcing, an OU path recomputed in plain NumPy from JAX's draws (the
keying contract of ``stochastic.py``: member key = fold_in(seed key,
member), the year's draws = normal(fold_in(member key, absolute year), nt)).

The attractor states come from 3-year ``equilibrate`` runs (the JAX test
equilibrates up to 120 Classic years; the eager year takes ~1 s here, and
trajectory parity needs any state, not a converged one). Bars, the JAX
test's: the final OU value bitwise, the tracked hemispheric means to 1e-7,
the ice areas to 1e-10. The Arrhenius escape-rate test (part b) runs 300
Classic years per member on the card: ``tests/test_torch_cuda_equilibrium.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from ref_impl import ClassicRef

torch.set_num_threads(1)


def numpy_ou_path(seed, member, years, nt, sigma, tau):
    base = jax.random.PRNGKey(seed)
    mkey = jax.random.fold_in(base, member)
    rho = float(np.exp(-(1.0 / nt) / tau))
    scale = sigma * float(np.sqrt(max(0.0, 1.0 - rho * rho)))
    eta, path = 0.0, []
    for y in range(years):
        for z in np.asarray(jax.random.normal(jax.random.fold_in(mkey, y), (nt,), jnp.float64)):
            eta = rho * eta + scale * float(z)
            path.append(eta)
    return np.asarray(path)


def test_noisy_classic_matches_ref_impl():
    nx = 8
    st = ebt.SpaceTime.sin(nx, 1000, 1)
    par = ebt.Collection(ebt.default_parameters("Classic"))
    mk = lambda e: ebt.Collection(E=np.full(nx, e), Tg=np.full(nx, e) / float(par["cw"]))
    F, sigma, tau, years, seed = 10.0, 4.0, 0.05, 2, 11
    kw = dict(dtype="float64", device="cpu")
    a = ebt.equilibrate("Classic", st, F, par, mk(30.0), max_years=3, tol=2.0, **kw)
    b = ebt.equilibrate("Classic", st, F, par, mk(-30.0), max_years=3, tol=2.0, **kw)
    res = ebt.transitions("Classic", st, F, par, a, b, sigma=sigma, tau=tau, years=years, K=1,
                          seed=seed, track=("E", "T"), **kw)
    path = numpy_ou_path(seed, 0, years, st.nt, sigma, tau)
    np.testing.assert_array_equal(res.eta, path[-1:])

    ref = ClassicRef(st.nx, st.nt, st.grid, dict(par))
    E = np.array(a.state["E"], dtype=np.float64)
    Tg = np.array(a.state["Tg"], dtype=np.float64)
    x = np.asarray(st.x)
    hemi = lambda v: float(np.sum((v[:-1] + v[1:]) * (x[1:] - x[:-1]) / 2.0))
    for y in range(years):
        Es, Ts = [], []
        for j in range(st.nt):
            E, Tg, T, _ = ref.step(E, Tg, j, F + path[y * st.nt + j])
            Es.append(E.copy())
            Ts.append(T.copy())
        E_avg, T_avg = np.mean(Es, axis=0), np.mean(Ts, axis=0)
        assert abs(res.tracked["E"][y, 0] - hemi(E_avg)) < 1e-7, y
        assert abs(res.tracked["T"][y, 0] - hemi(T_avg)) < 1e-7, y
        area = 2.0 * np.pi * hemi((E_avg < 0.0).astype(np.float64))
        assert res.areas[y, 0] == pytest.approx(area, abs=1e-10)
