"""``equilibrate`` of the PyTorch port against the JAX package, float64 on
the CPU (the port's ``'auto'`` engine is the eager
year there, JAX's the XLA scan).

Bars:
- MIZ (``SpaceTime.sin(8, 50)``, forcing +4, an active ice edge): ``years``
  and ``member_years`` equal to JAX's, Picard, Anderson and ``check_every``
  alike; fixed points within the ``tests/test_oracle_equilibrium.py`` MIZ
  bar, max |dE| of the annual mean 0.0054 (Anderson acceleration, Classic
  and ``continuation``: ``tests/test_torch_equilibrium_paths.py``);
- at equal year counts the port's ``equilibrate`` is its own ``integrate``
  bitwise; ensemble members equal solo runs bitwise for Classic, and for
  MIZ on the eager year, whose Newton loop runs in lockstep over the batch,
  to 1e-10 (the JAX package's own members-vs-solo bar is 1e-10,
  ``tests/test_parallel.py:41``; on a CUDA device the kernel makes them
  bitwise: ``tests/test_torch_cuda_equilibrium.py``);
- a JAX ``EquilibriumResult.state`` as the port's ``init`` and the reverse
  reach the same fixed point within the bars above;
- every ``ValueError`` the JAX tests check for these drivers.
"""
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt

torch.set_num_threads(1)
BAR_MIZ = 0.0054
BAR_CLASSIC = 1.53
NX, NT, F = 8, 50, 4.0
KW = dict(dtype="float64", device="cpu")


def miz(mod, **over):
    st = mod.SpaceTime.sin(NX, NT, 1)
    par = mod.Collection(mod.default_parameters("MIZ"))
    par.update(over)
    return st, par, mod.zeros_init(st)


def classic(mod, nx=8):
    st = mod.SpaceTime.sin(nx, 1000, 1)
    par = mod.Collection(mod.default_parameters("Classic"))
    E0 = np.full(nx, 40.0)
    return st, par, mod.Collection(E=E0, Tg=E0 / float(par["cw"]))


def dE(a, b):
    return float(np.max(np.abs(np.nan_to_num(np.asarray(a.seasonal.avg["E"]))
                               - np.nan_to_num(np.asarray(b.seasonal.avg["E"])))))


@pytest.fixture(scope="module")
def miz_pair():
    """The solo MIZ fixed point at tol 1e-3, both packages."""
    kw = dict(tol=1e-3, max_years=300)
    st, par, init = miz(ebm)
    j = ebm.equilibrate("MIZ", st, ebm.Forcing(F), par, init, **kw)
    st, par, init = miz(ebt)
    t = ebt.equilibrate("MIZ", st, ebt.Forcing(F), par, init, **kw, **KW)
    return j, t


def test_miz_picard_matches_jax(miz_pair, record_property):
    j, t = miz_pair
    record_property("dE_vs_jax", dE(t, j))
    assert t.converged and j.converged and t.newton_ok
    assert t.years == j.years
    assert dE(t, j) <= BAR_MIZ
    assert t.resid <= 1e-3
    assert sorted(t.state) == sorted(j.state)
    assert "converged" in repr(t)


def test_miz_at_equal_years_is_integrate_bitwise(miz_pair):
    _, t = miz_pair
    st, par, init = miz(ebt)
    sol = ebt.integrate("MIZ", ebt.SpaceTime.sin(NX, NT, t.years), ebt.Forcing(F), par, init,
                        raw_mode="none", progress=False, **KW)
    for k, v in t.seasonal.avg.items():
        np.testing.assert_array_equal(v, sol.seasonal.avg[k][-1], err_msg=k)


def test_states_cross_between_the_packages(miz_pair):
    """A JAX state (with its Newton warm start T0) as the port's init, and
    the port's as JAX's: both re-converge at once to the same fixed point."""
    j, t = miz_pair
    st, par, _ = miz(ebt)
    from_jax = ebt.equilibrate("MIZ", st, ebt.Forcing(F), par, j.state, tol=1e-3,
                               max_years=300, **KW)
    st_j, par_j, _ = miz(ebm)
    from_port = ebm.equilibrate("MIZ", st_j, ebm.Forcing(F), par_j, t.state, tol=1e-3,
                                max_years=300)
    assert from_jax.converged and from_port.converged
    assert from_jax.years <= 3 and from_port.years <= 3
    assert dE(from_jax, j) <= BAR_MIZ and dE(from_port, t) <= BAR_MIZ
    assert dE(from_jax, from_port) <= BAR_MIZ


def test_miz_ensemble_F_sweep_matches_jax_and_solo(miz_pair, record_property):
    j_solo, t_solo = miz_pair
    kw = dict(tol=1e-3, max_years=300)
    st, par, init = miz(ebm, F=np.array([0.0, F]))
    j = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par, init, **kw)
    st, par, init = miz(ebt, F=np.array([0.0, F]))
    t = ebt.equilibrate("MIZ", st, ebt.Forcing(0.0), par, init, **kw, **KW)
    np.testing.assert_array_equal(t.member_years, j.member_years)
    assert t.years == j.years and t.converged.all()
    record_property("dE_vs_jax", dE(t, j))
    assert dE(t, j) <= BAR_MIZ
    assert "members" in repr(t)
    # member 1 against its solo run, at the same year count
    st, par, init = miz(ebt)
    solo = ebt.equilibrate("MIZ", st, ebt.Forcing(F), par, init, tol=0.0,
                           max_years=t.years, **KW)
    record_property("member_vs_solo_max_abs", max(float(np.max(np.abs(t.state[k][1] - v)))
                                                  for k, v in solo.state.items()))
    for k, v in solo.state.items():
        np.testing.assert_allclose(t.state[k][1], v, rtol=1e-10, atol=1e-12, err_msg=k)
    assert t.member_years[1] == t_solo.years


def test_miz_check_every_matches_jax(record_property):
    kw = dict(tol=1e-3, max_years=300, check_every=4)
    st, par, init = miz(ebm, F=np.array([0.0, F]))
    j = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par, init, **kw)
    st, par, init = miz(ebt, F=np.array([0.0, F]))
    t = ebt.equilibrate("MIZ", st, ebt.Forcing(0.0), par, init, **kw, **KW)
    assert t.years == j.years and t.years % 4 == 1
    np.testing.assert_array_equal(t.member_years, j.member_years)
    record_property("dE_vs_jax", dE(t, j))
    assert dE(t, j) <= BAR_MIZ


def test_fused_engine_on_the_cpu_is_the_batched_year():
    """On the CPU ``engine='fused'`` runs the kernel wrappers' plain versions:
    the same year, bitwise here for Classic and to 1e-12 for MIZ (per-member
    parameter columns)."""
    st, par, init = classic(ebt)
    a, b = (ebt.equilibrate("Classic", st, 2.0, par, init, tol=0.0, max_years=1, engine=e,
                            **KW) for e in ("fused", "batched"))
    np.testing.assert_array_equal(a.state["E"], b.state["E"])
    st, par, init = miz(ebt)
    a, b = (ebt.equilibrate("MIZ", st, F, par, init, tol=0.0, max_years=2, engine=e, **KW)
            for e in ("fused", "batched"))
    for k in b.state:
        np.testing.assert_allclose(a.state[k], b.state[k], rtol=1e-12, atol=1e-12, err_msg=k)


def test_scalar_F_max_years_and_float_forcing():
    st, par, init = miz(ebt)
    a = ebt.equilibrate("MIZ", st, 0.0, ebt.Collection(par, F=2.0), init, tol=0.0,
                        max_years=3, **KW)
    b = ebt.equilibrate("MIZ", st, ebt.Forcing(2.0), par, init, tol=0.0, max_years=3, **KW)
    np.testing.assert_array_equal(a.seasonal.avg["E"], b.seasonal.avg["E"])
    assert a.years == 3 and not a.converged and "NOT converged" in repr(a)


def test_equilibrate_validation(tmp_path):
    st, par, init = classic(ebt)
    ramp = ebt.Forcing(0.0, 2.0, -2.0, (1, 1), (1.0, -1.0))
    with pytest.raises(ValueError, match="constant"):
        ebt.equilibrate("Classic", st, ramp, par, init, **KW)
    with pytest.raises(ValueError, match="metric"):
        ebt.equilibrate("Classic", st, 0.0, par, init, metric=("nope",), **KW)
    with pytest.raises(ValueError, match="anderson"):
        ebt.equilibrate("Classic", st, 0.0, par, init, anderson=-1, **KW)
    with pytest.raises(ValueError, match="check_every"):
        ebt.equilibrate("Classic", st, 0.0, par, init, check_every=0, **KW)
    with pytest.raises(ValueError, match="does not compose with anderson"):
        ebt.equilibrate("Classic", st, 0.0, par, init, check_every=2, anderson=2, **KW)
    with pytest.raises(ValueError, match="unknown engine"):
        ebt.equilibrate("Classic", st, 0.0, par, init, engine="nope", **KW)
    with pytest.raises(ValueError, match="years_per_dispatch"):
        ebt.equilibrate("Classic", st, 0.0, par, init, years_per_dispatch=0, **KW)
    with pytest.raises(ValueError, match="Cannot infer ensemble size"):
        ebt.equilibrate("Classic", st, 0.0, ebt.Collection(par, D=np.ones(2), A=np.ones(3)),
                        init, **KW)
    # mesh= (ported with M14: tests/test_torch_parallel.py) takes a port Mesh
    with pytest.raises(TypeError, match="Mesh"):
        ebt.equilibrate("Classic", st, 0.0, par, init, mesh=object(), **KW)
    with pytest.raises(ValueError, match="needs checkpoint"):
        ebt.equilibrate("Classic", st, 0.0, par, init, resume=True, **KW)
    # a checkpointed run writes its final state; resuming it returns that
    # state without a year more (resumes mid-run: tests/test_torch_checkpoint.py)
    ck = str(tmp_path / "eq.h5")
    mst, mpar, minit = miz(ebt)
    first = ebt.equilibrate("MIZ", mst, F, mpar, minit, tol=0.0, max_years=2, checkpoint=ck,
                            **KW)
    again = ebt.equilibrate("MIZ", mst, F, mpar, minit, tol=0.0, max_years=2, checkpoint=ck,
                            resume=True, **KW)
    assert again.years == first.years == 2
    for k in first.state:
        np.testing.assert_array_equal(again.state[k], first.state[k])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            ebt.equilibrate("Classic", st, 0.0, par, init, dtype="float64")


def test_progress_bar_runs(capsys):
    st, par, init = miz(ebt)
    res = ebt.equilibrate("MIZ", st, 0.0, par, init, tol=0.0, max_years=2, progress=True,
                          **KW)
    assert res.years == 2
