"""``lyapunov`` of the PyTorch port against the JAX package, float64 on the
CPU. Both packages draw the same tangent block (``np.random.default_rng``
leaf by leaf in carry order) and run the same Benettin/QR recursion, so the
growth history agrees year by year.

Bars:
- ``history`` equal to JAX's at rel 1e-8 over 2-3 years: MIZ
  (``SpaceTime.sin(8, 50)``, forcing +4, a 40-year state with open water and
  fully ice-covered cells) with ``n_modes`` 1 and 2, with and without
  ``project=("Ew", "phi")``; Classic (``SpaceTime.sin(8, 500)``, ice-free at
  forcing 45) with ``n_modes`` 1 and 2; final states at 1e-10;
- at the ice-free Classic equilibrium (the JAX tests' ``_icefree_setup`` at
  nt=500; the model is linear there) the exponent equals ``log`` of
  ``stability``'s growth at 1e-6, the tangent started on the right mode;
- ensemble members against solo runs at 1e-10 (the eager MIZ year iterates
  Newton in lockstep over the batch); ``years_per_dispatch`` chunking
  bitwise; ``member_chunk``: one slab bitwise the unchunked run, two slabs at
  1e-10, the trajectory bitwise either way;
- every ``ValueError`` of ``tests/test_lyapunov.py``; ``mesh=`` takes the
  port's ``Mesh`` (sharded runs: ``tests/test_torch_parallel.py``).
"""
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt

torch.set_num_threads(1)
KW = dict(dtype="float64", device="cpu")
BAR = 1e-8
NX, NT, F = 8, 50, 4.0


@pytest.fixture(scope="module")
def miz_state():
    st = ebm.SpaceTime.sin(NX, NT, 40)
    sol = ebm.integrate("MIZ", st, ebm.Forcing(F), ebm.default_parameters("MIZ"),
                        ebm.zeros_init(st))
    s = {k: np.array(sol.raw[k][-1]) for k in ("Ei", "Ew", "h", "D", "phi")}
    assert (s["phi"] >= 0.99).any() and (s["phi"] == 0.0).any()
    return s


def icefree(mod, nt=500):
    par = mod.Collection(mod.default_parameters("Classic"))
    E0 = np.full(8, 100.0)
    return mod.SpaceTime.sin(8, nt, 1), par, mod.Collection(E=E0, Tg=E0 / float(par["cw"]))


def both(model, grid, forcing, par, init, **kw):
    j = ebm.lyapunov(model, ebm.SpaceTime.sin(*grid, 1), ebm.Forcing(forcing),
                     ebm.Collection(par), init, **kw)
    t = ebt.lyapunov(model, ebt.SpaceTime.sin(*grid, 1), ebt.Forcing(forcing),
                     ebt.Collection(par), init, **kw, **KW)
    return j, t


def assert_matches(t, j, record_property):
    rel = float(np.max(np.abs(t.history - j.history) / np.abs(j.history)))
    record_property("max_rel_history", rel)
    assert t.history.shape == j.history.shape
    np.testing.assert_allclose(t.history, j.history, rtol=BAR)
    np.testing.assert_allclose(t.exponents, j.exponents, rtol=BAR)
    for k in j.state:
        np.testing.assert_allclose(t.state[k], j.state[k], rtol=0, atol=1e-10, err_msg=k)
    m = t.n_modes
    for k in j.modes:  # each mode up to its sign
        a = np.asarray(t.modes[k]).reshape(m, -1) if m > 1 else np.asarray(t.modes[k])[None]
        b = np.asarray(j.modes[k]).reshape(m, -1) if m > 1 else np.asarray(j.modes[k])[None]
        for i in range(m):
            s = 1.0 if np.dot(a[i], b[i]) >= 0 else -1.0
            np.testing.assert_allclose(s * a[i], b[i], rtol=0, atol=BAR, err_msg=k)


@pytest.mark.parametrize("n_modes,project", [(1, ()), (2, ()), (2, ("Ew", "phi"))])
def test_miz_history_matches_jax(miz_state, n_modes, project, record_property):
    j, t = both("MIZ", (NX, NT), F, ebm.default_parameters("MIZ"), miz_state, years=3,
                n_modes=n_modes, project=project, transient=1)
    assert_matches(t, j, record_property)
    assert t.exponents.shape == (n_modes,) and t.history.shape == (3, n_modes)
    assert "lambda_1" in repr(t) and "2 counted years" in repr(t)
    assert t.running().shape == (2, n_modes) and np.isfinite(t.sem).all()


@pytest.mark.parametrize("n_modes", [1, 2])
def test_classic_history_matches_jax(n_modes, record_property):
    st, par, init = icefree(ebm)
    j, t = both("Classic", (8, 500), 45.0, par, init, years=2, n_modes=n_modes, seed=4)
    assert_matches(t, j, record_property)


def test_icefree_equilibrium_matches_stability(record_property):
    """The year map is linear at the ice-free equilibrium: started on the
    right mode of a converged ``stability``, every year's growth is
    ``log |lambda_1|``."""
    st, par, init = icefree(ebm)
    eq = ebm.equilibrate("Classic", st, ebm.Forcing(45.0), par, init, tol=1e-9, max_years=400)
    assert eq.converged and float(np.min(eq.seasonal.winter["E"])) > 0.0
    ref = ebm.stability("Classic", st, ebm.Forcing(45.0), par, eq.state, n_iter=40, side="right")
    assert ref.converged
    stt, part, _ = icefree(ebt)
    lya = ebt.lyapunov("Classic", stt, ebt.Forcing(45.0), part, eq.state, years=3, transient=1,
                       v0=ref.mode, **KW)
    stab = ebt.stability("Classic", stt, ebt.Forcing(45.0), part, eq.state, n_iter=2,
                         side="right", v0=ref.mode, **KW)
    record_property("exponent_minus_log_growth", float(lya.exponents[0] - np.log(stab.growth)))
    assert float(lya.exponents[0]) == pytest.approx(float(np.log(stab.growth)), abs=1e-6)
    assert float(lya.exponents[0]) == pytest.approx(float(np.log(ref.growth)), abs=1e-6)
    assert float(np.std(lya.history[1:, 0])) < 1e-10


def test_members_equal_solo_and_chunking(miz_state):
    Fs = np.array([3.0, 4.0, 5.0])
    par = ebt.Collection(ebt.default_parameters("MIZ"), F=Fs)
    st = ebt.SpaceTime.sin(NX, NT, 1)
    ens = ebt.lyapunov("MIZ", st, 0.0, par, miz_state, years=2, seed=3, **KW)
    assert ens.exponents.shape == (3, 1) and ens.history.shape == (2, 3, 1)
    g = np.random.default_rng(3)
    draws = {k: g.standard_normal((3, NX)) for k in ("Ei", "Ew", "h", "D", "phi", "T0")}
    for i, f in enumerate(Fs):
        solo = ebt.lyapunov("MIZ", st, f, ebt.default_parameters("MIZ"), miz_state, years=2,
                            v0=ebt.Collection({k: d[i] for k, d in draws.items()}), **KW)
        np.testing.assert_allclose(ens.history[:, i], solo.history, rtol=0, atol=1e-10)
    # chunking the years between host reads changes nothing
    one = ebt.lyapunov("MIZ", st, 0.0, par, miz_state, years=2, seed=3, years_per_dispatch=1,
                       **KW)
    np.testing.assert_array_equal(one.history, ens.history)
    for k in ens.state:
        np.testing.assert_array_equal(one.state[k], ens.state[k])


def test_member_chunk(miz_state, record_property):
    par = ebt.Collection(ebt.default_parameters("MIZ"), F=np.linspace(3.0, 5.0, 4))
    st = ebt.SpaceTime.sin(NX, NT, 1)
    kw = dict(years=2, n_modes=2, **KW)
    full = ebt.lyapunov("MIZ", st, 0.0, par, miz_state, **kw)
    one = ebt.lyapunov("MIZ", st, 0.0, par, miz_state, member_chunk=4, **kw)
    two = ebt.lyapunov("MIZ", st, 0.0, par, miz_state, member_chunk=2, **kw)
    np.testing.assert_array_equal(one.history, full.history)
    record_property("two_slabs_max_abs", float(np.max(np.abs(two.history - full.history))))
    np.testing.assert_allclose(two.history, full.history, rtol=0, atol=1e-10)
    for k in full.state:
        np.testing.assert_array_equal(one.state[k], full.state[k])
        np.testing.assert_array_equal(two.state[k], full.state[k])
        np.testing.assert_array_equal(one.modes[k], full.modes[k])


def test_validation_errors(miz_state):
    st, par, init = icefree(ebt, nt=200)
    ly = lambda **kw: ebt.lyapunov("Classic", st, kw.pop("forcing", 45.0), kw.pop("par", par),
                                   init, **{**dict(years=2), **kw}, **KW)
    with pytest.raises(ValueError, match="years"):
        ly(years=0)
    with pytest.raises(ValueError, match="transient"):
        ly(years=5, transient=5)
    with pytest.raises(ValueError, match="constant"):
        ly(forcing=ebt.Forcing(0.0, 1.0, 0.0, (0, 0), (1.0, -1.0)))
    with pytest.raises(ValueError, match="phi"):
        ly(project=("Tg",))
    with pytest.raises(ValueError, match="not in the Classic carry"):
        ly(project=("Ew",))
    with pytest.raises(ValueError, match="n_modes"):
        ly(n_modes=0)
    with pytest.raises(ValueError, match="n_modes"):
        ly(n_modes=17)
    with pytest.raises(ValueError, match="v0"):
        ly(v0=ebt.Collection({"E": np.zeros(st.nx)}))
    with pytest.raises(ValueError, match="years_per_dispatch"):
        ly(years_per_dispatch=0)
    with pytest.raises(ValueError, match="inconsistent ensemble sizes"):
        ly(par=ebt.Collection(par, D=np.ones(2), A=np.ones(3)))
    with pytest.raises(ValueError, match="divide"):
        ly(par=ebt.Collection(par, F=np.zeros(4)), member_chunk=3)
    with pytest.raises(ValueError, match="ensemble|member-batched"):
        ly(member_chunk=2)
    with pytest.raises(TypeError, match="Mesh"):
        ly(mesh=object())
