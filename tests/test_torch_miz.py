"""The MIZ step of the PyTorch port against the JAX package, float64 on CPU.

Bars (ROADMAP "held against the reference"):
- one step on a random state: 1e-12, normwise relative per field;
- the first 80 steps of the canonical configuration
  (``SpaceTime.sin(180, 2000, 1)``, zero init) point by point at
  rtol 1.5e-8 / atol 1e-12 with equal NaN positions (beyond ~step 82 any two
  implementations part by round-off amplification);
- a full year at nx=40/nt=200, every step: rtol 1e-8 / atol 1e-8, equal NaN
  positions (~2e-10 measured between implementations there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.integrate import make_year_fn as jax_year_fn
from energybalancemodel_jl_tpu.models import miz as jmiz
from energybalancemodel_jl_tpu.models.base import default_step_config as jcfg
from energybalancemodel_jl_tpu_torch.integrate import make_year_fn
from energybalancemodel_jl_tpu_torch.models import miz as tmiz
from energybalancemodel_jl_tpu_torch.models.base import default_step_config

torch.set_num_threads(1)
T64 = torch.float64
CPU = torch.device("cpu")


def assert_same_nans_close(a, b, rtol, atol, what):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{what}: NaN positions")
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=rtol, atol=atol,
                               err_msg=what)


def both_pars(par):
    jpar = ebm.Collection({k: jnp.asarray(v, jnp.float64) for k, v in par.items()})
    return jpar, ebt.from_numpy(par)


def test_statics_and_init_carry_match_jax():
    st = ebt.SpaceTime.sin(30, 100, 1)
    par = ebt.default_parameters("MIZ")
    par["S1"] = 300.0
    jpar, tpar = both_pars(par)
    js = jmiz.statics(st, jpar, jnp.float64)
    ts = tmiz.statics(st, tpar, T64, CPU)
    for k in ("aw", "glo", "gdi", "gup", "Tm_pow_m2"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-15, atol=1e-12,
                                   err_msg=k)
    # the port builds the insolation row of each step at use
    insol = torch.stack([tmiz.insolation(ts, t) for t in range(st.nt)])
    np.testing.assert_allclose(insol.numpy(), np.asarray(js.insol), rtol=1e-15, atol=1e-12)
    assert ts.dt == js.dt
    init = ebt.zeros_init(st)
    init["Ei"] = np.linspace(-3, 0, st.nx)
    jc, tc = jmiz.init_carry(init, st, jnp.float64), tmiz.init_carry(init, st, T64, CPU)
    for k in jc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)


def test_one_step_matches_jax(rng):
    K, nx = 5, 48
    st = ebt.SpaceTime.sin(nx, 200, 1)
    par = ebt.default_parameters("MIZ")
    par["D"] = np.linspace(0.5, 0.7, K)[:, None]
    jpar, tpar = both_pars(par)
    h = np.abs(rng.normal(1.0, 0.6, (K, nx))) * (rng.uniform(size=(K, nx)) > 0.2)
    phi = np.where(h > 0, rng.uniform(0.1, 1.0, (K, nx)), 0.0)
    carry = dict(
        Ei=-9.5 * h * phi, Ew=np.abs(rng.normal(0, 20, (K, nx))), h=h,
        D=np.where(h > 0, rng.uniform(1.0, 150.0, (K, nx)), 0.0), phi=phi,
        T0=rng.normal(-5, 4, (K, nx)),
    )
    f = rng.normal(0, 1, (K, 1))
    js = jmiz.statics(st, jpar, jnp.float64)
    ts = tmiz.statics(st, tpar, T64, CPU)
    jc, jo = jmiz.step(ebm.Collection({k: jnp.asarray(v) for k, v in carry.items()}),
                       dict(insol=js.insol[57], f=jnp.asarray(f)), js, jpar, jcfg("float64"))
    tc, to = tmiz.step(ebt.from_numpy(carry), dict(insol=tmiz.insolation(ts, 57), f=torch.as_tensor(f)),
                       ts, tpar, default_step_config("float64"))
    for name, a, b in [("carry", jc, tc), ("out", jo, to)]:
        for k in a:
            x, y = np.asarray(a[k]), b[k].numpy()
            np.testing.assert_array_equal(np.isnan(x), np.isnan(y), err_msg=f"{name}.{k}")
            x, y = np.nan_to_num(x), np.nan_to_num(y)
            scale = max(np.max(np.abs(x)), 1e-300)
            assert np.max(np.abs(x - y)) <= 1e-12 * scale, f"{name}.{k}"
    assert float(to["newton_converged"]) == 1.0


def test_solver_pallas_raises():
    """``solver='pallas'`` (the fixed-iteration kernel, tests/test_torch_
    solvers.py) takes one value of k, Tm, A, B, ai per call: a swept one
    raises, as in the JAX package (its models/miz.py:226-234)."""
    st = ebt.SpaceTime.sin(8, 100, 1)
    par = ebt.from_numpy(ebt.default_parameters("MIZ"))
    stat = tmiz.statics(st, par, T64, CPU)
    z = torch.zeros((2, 8), dtype=T64)
    swept = dict(par, Tm=torch.zeros((2, 1), dtype=T64))
    with pytest.raises(ValueError, match="scalar parameter 'Tm'"):
        tmiz.solve_T0(z, tmiz.insolation(stat, 0), z, z, z, 0.0, stat, swept,
                      default_step_config("float64", solver="pallas"))


def test_canonical_first_80_steps_match_jax():
    """The golden configuration point by point over its parity window."""
    n_steps = 80
    st = ebt.SpaceTime.sin(180, 2000, 1)
    par = ebt.default_parameters("MIZ")
    jpar, tpar = both_pars(par)
    init = ebt.zeros_init(st)

    cfg = jcfg("float64")

    @jax.jit
    def jax_steps(carry, p):
        # the scan engine's graph (integrate.make_year_fn) cut to the window:
        # statics from the traced parameters, the first step peeled
        js = jmiz.statics(st, p, jnp.float64)
        xs = dict(insol=js.insol[:n_steps], f=jnp.zeros(n_steps))
        carry, out0 = jmiz.step(carry, jax.tree_util.tree_map(lambda v: v[0], xs), js, p, cfg)
        carry, outs = lax.scan(lambda c, x: jmiz.step(c, x, js, p, cfg), carry,
                               jax.tree_util.tree_map(lambda v: v[1:], xs))
        return carry, jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a[None], b]),
                                             out0, outs)

    jcarry, jouts = jax_steps(jmiz.init_carry(init, st, jnp.float64), jpar)

    ts = tmiz.statics(st, tpar, T64, CPU)
    tcfg = default_step_config("float64")
    carry = tmiz.init_carry(init, st, T64, CPU)
    zero = torch.zeros((), dtype=T64)
    for i in range(n_steps):
        carry, out = tmiz.step(carry, tmiz.step_inputs(ts, zero.expand(st.nt), i), ts, tpar, tcfg)
        for k in out:
            assert_same_nans_close(out[k].numpy(), np.asarray(jouts[k][i]), 1.5e-8, 1e-12,
                                   f"step {i + 1} {k}")
    for k in carry:
        assert_same_nans_close(carry[k].numpy(), np.asarray(jcarry[k]), 1.5e-8, 1e-12,
                               f"carry {k}")


def test_full_year_nx40_matches_jax_every_step():
    st = ebt.SpaceTime.sin(40, 200, 1)
    par = ebt.default_parameters("MIZ")
    jpar, tpar = both_pars(par)
    init = ebt.zeros_init(st)
    fyear = np.zeros(st.nt)

    jfn = jax.jit(jax_year_fn("MIZ", st, jcfg("float64"), "float64", True))
    jc, jseas, jconv, jraw = jfn(jmiz.init_carry(init, st, jnp.float64), jpar, fyear)
    tfn = make_year_fn("MIZ", st, default_step_config("float64"), True)
    tc, tseas, tconv, traw = tfn(tmiz.init_carry(init, st, T64, CPU), tpar, fyear)

    assert float(jconv.min()) == float(tconv) == 1.0
    for k in jraw:
        assert traw[k].shape == (st.nt, st.nx)
        assert_same_nans_close(traw[k].numpy(), jraw[k], 1e-8, 1e-8, f"raw {k}")
    for k in jc:
        assert_same_nans_close(tc[k].numpy(), jc[k], 1e-8, 1e-8, f"carry {k}")
    for name, a, b in zip(("winter", "summer", "avg"), jseas, tseas):
        for k in a:
            assert_same_nans_close(b[k].numpy(), a[k], 1e-8, 1e-8, f"{name} {k}")
    # the year is not trivial: ice forms and the NaN masks are exercised
    assert np.nanmax(traw["phi"].numpy()) > 0.5
    assert np.isnan(traw["Ti"].numpy()).any() and np.isnan(traw["Tw"].numpy()).any()
