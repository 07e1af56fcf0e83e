"""The WE15 Classic model of the PyTorch port against the JAX package,
float64 on CPU.

Bars:
- one step on a random state with exact zeros in E: 1e-13, normwise
  relative per field;
- statics, insolation rows and the uniform-grid bands: 1e-15 relative;
- ``integrate`` raw steps over the first 300 steps at nx=50/nt=1000, identity
  and sin grids, PCR and Thomas: rtol = atol = 1e-8, the JAX package's bar
  against its NumPy oracle (``tests/test_classic.py:50``);
- a full year at nx=40/nt=1000, every step: rtol = atol = 1e-8;
- the reference quirks of ``tests/test_quirks.py:78-111`` and the albedo hole
  of ``tests/test_classic.py:55-68``, at those tests' own bars;
- ``ensemble_integrate`` with D, S1 and F swept against the JAX package (its
  'vmap' engine: the JAX batched engine cannot sweep S1): 1e-8.

The measured maxima sit near 1e-12 (PCR vs PCR, Thomas vs Thomas).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.integrate import make_year_fn as jax_year_fn
from energybalancemodel_jl_tpu.models import classic as jcl
from energybalancemodel_jl_tpu.models.base import default_step_config as jcfg
from energybalancemodel_jl_tpu.parallel.ensemble import ensemble_integrate as jax_ensemble
from energybalancemodel_jl_tpu_torch.integrate import make_year_fn
from energybalancemodel_jl_tpu_torch.models import classic as tcl
from energybalancemodel_jl_tpu_torch.models.base import default_step_config

torch.set_num_threads(1)
T64 = torch.float64
CPU = torch.device("cpu")
BAR = 1e-8


def both_pars(par):
    jpar = ebm.Collection({k: jnp.asarray(v, jnp.float64) for k, v in par.items()})
    return jpar, ebt.from_numpy(par)


def warm_init(nx, par, E=30.0):
    """The warm start ``E0, Tg = E0/cw`` (bench.py:108-112): from zeros the
    model lands in the snowball state."""
    E0 = np.full(nx, E)
    return ebt.Collection(E=E0, Tg=E0 / par["cw"])


def assert_same_nans_close(a, b, rtol, atol, what):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{what}: NaN positions")
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=rtol, atol=atol,
                               err_msg=what)


def test_registry_defaults_and_zeros_init():
    spec = ebt.integrate.__globals__["get_model"]("classic")
    assert spec.name == "Classic" and spec.solution_vars == ("E", "T", "h")
    assert spec.init_vars == ("E", "Tg")
    st = ebt.SpaceTime.sin(12, 1000, 1)
    a, b = ebm.zeros_init(st, "Classic"), ebt.zeros_init(st, "Classic")
    assert sorted(a) == sorted(b) == ["E", "Tg"]
    assert dict(ebm.default_parameters("Classic")) == dict(ebt.default_parameters("Classic"))


@pytest.mark.parametrize("grid", ["sin", "identity"])
def test_statics_match_jax(grid):
    st = getattr(ebt.SpaceTime, grid)(30, 1000, 1)
    par = ebt.default_parameters("Classic")
    par["D"] = np.linspace(0.5, 0.7, 3)[:, None]
    par["S1"] = 330.0  # the JAX package's table takes a scalar S1
    jpar, tpar = both_pars(par)
    # as the scan engine computes them: inside jit, from traced parameters
    js = jax.jit(lambda p: jcl.statics(st, p, jnp.float64))(jpar)
    ts = tcl.statics(st, tpar, T64, CPU)
    for k in ("cg_tau", "dt_tau", "dc", "M", "kLf", "aw", "klo", "kdi", "kup"):
        a, b = np.asarray(js[k]), ts[k].numpy()
        assert a.shape == b.shape, k
        np.testing.assert_allclose(b, a, rtol=1e-15, atol=0, err_msg=k)
    assert float(ts.dt) == js.dt
    # the insolation rows are built per step; the JAX package's table has
    # the wraparound row S[nt] == S[0]
    for t in (0, 417, st.nt - 1):
        xs = tcl.step_inputs(ts, torch.zeros(st.nt, dtype=T64), t)
        np.testing.assert_allclose(xs["S_i"].numpy(), np.asarray(js.S[t]), rtol=1e-15)
        np.testing.assert_allclose(xs["S_ip1"].numpy(), np.asarray(js.S[t + 1]), rtol=1e-15)


def test_one_step_matches_jax(rng):
    K, nx = 5, 48
    st = ebt.SpaceTime.sin(nx, 1000, 1)
    par = ebt.default_parameters("Classic")
    par["D"] = np.linspace(0.5, 0.7, K)[:, None]
    jpar, tpar = both_pars(par)
    E = rng.normal(5.0, 40.0, (K, nx))
    E[rng.uniform(size=(K, nx)) < 0.15] = 0.0  # the albedo hole and guarded divisions
    carry = dict(E=E, Tg=rng.normal(0.0, 6.0, (K, nx)))
    f = rng.normal(0.0, 1.0, (K, 1))
    js = jcl.statics(st, jpar, jnp.float64)
    ts = tcl.statics(st, tpar, T64, CPU)
    for solver in ("pcr", "thomas"):
        jxs = dict(S_i=js.S[57], S_ip1=js.S[58], f=jnp.asarray(f))
        txs = dict(tcl.step_inputs(ts, torch.zeros(st.nt, dtype=T64), 57), f=torch.as_tensor(f))
        jc, jo = jcl.step(ebm.Collection({k: jnp.asarray(v) for k, v in carry.items()}), jxs,
                          js, jpar, jcfg("float64", solver=solver))
        tc, to = tcl.step(ebt.from_numpy(carry), txs, ts, tpar,
                          default_step_config("float64", solver=solver))
        for name, a, b in [("carry", jc, tc), ("out", jo, to)]:
            assert sorted(a) == sorted(b)
            for k in a:
                x, y = np.asarray(a[k]), b[k].numpy()
                scale = max(np.max(np.abs(x)), 1e-300)
                assert np.max(np.abs(x - y)) <= 1e-13 * scale, f"{solver} {name}.{k}"
        assert "newton_converged" not in to


@functools.lru_cache(maxsize=None)
def jax_window(grid, solver):
    st = getattr(ebm.SpaceTime, grid)(50, 1000, 1)
    rng = np.random.default_rng(11)
    init = ebm.Collection(E=rng.normal(20.0, 30.0, 50), Tg=rng.normal(0.0, 5.0, 50))
    sol = ebm.integrate("Classic", st, ebm.Forcing(0.0), ebm.default_parameters("Classic"),
                        init, lastonly=False, progress=False, solver=solver, engine="scan")
    return init, sol


@pytest.mark.parametrize("grid", ["identity", "sin"])
@pytest.mark.parametrize("solver", ["thomas", "pcr"])
def test_integrate_300_steps_match_jax(grid, solver):
    """From a mix of ice (E < 0) and water states, as the JAX package's own
    oracle test starts (nt sits above the scheme's stability limit)."""
    init, j = jax_window(grid, solver)
    st = getattr(ebt.SpaceTime, grid)(50, 1000, 1)
    t = ebt.integrate("Classic", st, ebt.Forcing(0.0), ebt.default_parameters("Classic"),
                      dict(init), lastonly=False, progress=False, solver=solver,
                      dtype="float64", device="cpu",
                      verbose=True)  # verbose: no Newton flag to warn on
    for k in ("E", "T", "h"):
        assert t.raw[k].shape == (st.nt, st.nx)
        np.testing.assert_allclose(t.raw[k][:300], j.raw[k][:300], rtol=BAR, atol=BAR,
                                   err_msg=f"{k} ({grid}, {solver})")


def test_full_year_nx40_matches_jax_every_step():
    st = ebt.SpaceTime.sin(40, 1000, 1)
    par = ebt.default_parameters("Classic")
    jpar, tpar = both_pars(par)
    init = warm_init(st.nx, par)
    fyear = np.random.default_rng(5).normal(0.0, 0.5, st.nt)
    jfn = jax.jit(jax_year_fn("Classic", st, jcfg("float64"), "float64", True))
    jc, jseas, jconv, jraw = jfn(jcl.init_carry(init, st, jnp.float64), jpar, fyear)
    tfn = make_year_fn("Classic", st, default_step_config("float64"), True)
    tc, tseas, tconv, traw = tfn(tcl.init_carry(init, st, T64, CPU), tpar, fyear)
    assert tconv is None
    for k in jraw:
        assert traw[k].shape == (st.nt, st.nx)
        assert_same_nans_close(traw[k].numpy(), jraw[k], BAR, BAR, f"raw {k}")
    for k in jc:
        assert_same_nans_close(tc[k].numpy(), jc[k], BAR, BAR, f"carry {k}")
    for name, a, b in zip(("winter", "summer", "avg"), jseas, tseas):
        for k in a:
            assert_same_nans_close(b[k].numpy(), a[k], BAR, BAR, f"{name} {k}")
    # the year is not trivial: ice forms at the pole, water stays at the equator
    assert traw["E"].numpy()[-1, -1] < 0 < traw["E"].numpy()[-1, 0]


def test_stored_T_uses_pre_update_E():
    """``vars.T`` is computed from the pre-update enthalpy (classic.jl:51
    before :53), as ``tests/test_quirks.py:78-94`` holds the JAX package."""
    nx = 10
    st = ebt.SpaceTime.identity(nx, 1000, 1)
    par = ebt.default_parameters("Classic")
    tpar = ebt.from_numpy(par)
    stat = tcl.statics(st, tpar, T64, CPU)
    E0 = np.full(nx, 98.0)
    carry = ebt.from_numpy(dict(E=E0, Tg=E0 / par.cw))
    xs = tcl.step_inputs(stat, torch.zeros(st.nt, dtype=T64), 0)
    new_carry, out = tcl.step(carry, xs, stat, tpar, default_step_config("float64"))
    np.testing.assert_allclose(out["T"].numpy(), E0 / par.cw, rtol=1e-12)
    assert not np.allclose(new_carry["E"].numpy(), E0)  # E did change


def test_uniform_diffop_on_sin_grid():
    """The implicit matrix uses the uniform-grid operator on any grid
    (classic.jl:21), as ``tests/test_quirks.py:97-111`` holds the JAX
    package."""
    st = ebt.SpaceTime.sin(24, 100, 1)
    par = ebt.default_parameters("Classic")
    stat = tcl.statics(st, ebt.from_numpy(par), T64, CPU)
    uni = tcl.uniform_bands(st.nx)
    expected_klo = -(st.dt * par.D) * uni.lo / par.cg
    np.testing.assert_allclose(stat.klo.numpy(), expected_klo, rtol=1e-12)
    j = jcl.uniform_bands(st.nx)
    for name in ("lo", "di", "up"):
        np.testing.assert_array_equal(getattr(uni, name), getattr(j, name))


def test_albedo_hole_at_E_zero():
    """E == 0 gives zero co-albedo (classic.jl:47): from a zero state step 1
    absorbs no solar, ``E = (Fb - A) dt`` uniformly (``tests/test_classic.py:
    55-68``); the first five steps match the JAX package."""
    st = ebt.SpaceTime.identity(20, 50, 1)
    par = ebt.default_parameters("Classic")
    init = ebt.zeros_init(st, "Classic")
    t = ebt.integrate("Classic", st, ebt.Forcing(0.0), par, init, lastonly=False,
                      progress=False, dtype="float64", device="cpu")
    j = ebm.integrate("Classic", st, ebm.Forcing(0.0), par, ebm.zeros_init(st, "Classic"),
                      lastonly=False, progress=False)
    np.testing.assert_allclose(t.raw["E"][:5], j.raw["E"][:5], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(t.raw["E"][0], (par.Fb - par.A) * st.dt, rtol=1e-12)


def ensemble_par():
    par = ebt.default_parameters("Classic")
    par["D"] = np.linspace(0.55, 0.65, 4)
    par["S1"] = np.linspace(320.0, 350.0, 4)
    par["F"] = np.linspace(-2.0, 2.0, 4)
    return par


@functools.lru_cache(maxsize=None)
def jax_ensemble_run(st):
    par = ensemble_par()
    return jax_ensemble("Classic", st, ebm.Forcing(0.0), par, warm_init(st.nx, par),
                        engine="vmap", raw_mode="last", progress=False)


@pytest.mark.parametrize("engine", ["batched", "fused"])
def test_ensemble_matches_jax(engine):
    """D, S1 (a table parameter) and the virtual forcing offset F swept over
    two years, the last raw-collected; on the CPU the fused engine runs the
    kernel's plain version."""
    st = ebt.SpaceTime.sin(40, 1000, 2)
    par = ensemble_par()
    j = jax_ensemble_run(st)
    t = ebt.ensemble_integrate("Classic", st, ebt.Forcing(0.0), par, warm_init(st.nx, par),
                               dtype="float64", engine=engine, raw_mode="last",
                               progress=False, device="cpu")
    assert t.n_members == 4 and t.seasonal.avg["E"].shape == (4, st.dur, st.nx)
    assert sorted(t.swept) == ["D", "F", "S1"]
    for name in ("winter", "summer", "avg"):
        for k in ("E", "T", "h"):
            assert_same_nans_close(getattr(t.seasonal, name)[k], getattr(j.seasonal, name)[k],
                                   BAR, BAR, f"{name}.{k}")
    for k in ("E", "T", "h"):
        assert t.raw[k].shape == (4, st.nt, st.nx)
        assert_same_nans_close(t.raw[k], j.raw[k], BAR, BAR, f"raw.{k}")
    # the sweep reaches the result: members differ
    assert not np.allclose(t.seasonal.avg["E"][0], t.seasonal.avg["E"][-1])
