"""``equilibrate`` (Anderson acceleration, Classic) and ``continuation`` of
the PyTorch port against the JAX package, float64 on the CPU; the bars of
``tests/test_torch_equilibrium.py``:

- MIZ (``SpaceTime.sin(8, 50)``): ``years`` and ``member_years`` equal to
  JAX's under Anderson acceleration (forcing 0 and +8 as two members) and
  along a continuation (forcing 0 and +4), fixed points within the
  ``tests/test_oracle_equilibrium.py`` MIZ bar, max |dE| 0.0054; ice areas
  to 1e-3;
- Classic (``SpaceTime.sin(8, 1000)``, the warm init, ``tol=2.0``, the
  arrival tolerance of ``tests/test_stochastic_oracle.py``): ``years``
  within one of JAX's, fixed points within the Classic bar 1.53; at equal
  year counts bitwise the port's ``integrate``; ensemble members bitwise
  their solo runs;
- every ``ValueError`` the JAX tests check for ``continuation``.
"""
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from test_torch_equilibrium import BAR_CLASSIC, BAR_MIZ, F, KW, classic, dE, miz

torch.set_num_threads(1)


def test_miz_anderson_matches_jax(record_property):
    """Anderson acceleration, per member: forcing 0 and +8 as two members
    (Picard needs 129 and 88 years to 1e-6 there, AA about 45)."""
    kw = dict(tol=1e-6, max_years=200, anderson=3)
    st, par, init = miz(ebm, F=np.array([0.0, 8.0]))
    j = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par, init, **kw)
    st, par, init = miz(ebt, F=np.array([0.0, 8.0]))
    t = ebt.equilibrate("MIZ", st, ebt.Forcing(0.0), par, init, **kw, **KW)
    assert t.converged.all() and j.converged.all()
    assert t.years == j.years < 100
    np.testing.assert_array_equal(t.member_years, j.member_years)
    record_property("dE_vs_jax", dE(t, j))
    assert dE(t, j) <= BAR_MIZ
    # AA reports the last state the year map produced: all fields in range
    assert np.all((t.state["phi"] >= 0.0) & (t.state["phi"] <= 1.0))


def test_classic_matches_jax_integrate_and_solo(record_property):
    kw = dict(tol=2.0, max_years=60)
    st, par, init = classic(ebm)
    j = ebm.equilibrate("Classic", st, ebm.Forcing(0.0), par, init, **kw)
    st, par, init = classic(ebt)
    t = ebt.equilibrate("Classic", st, ebt.Forcing(0.0), par, init, **kw, **KW)
    record_property("years_port_jax", f"{t.years} {j.years}")
    record_property("dE_vs_jax", dE(t, j))
    assert t.converged and abs(t.years - j.years) <= 1
    assert dE(t, j) <= BAR_CLASSIC
    # at equal year counts the loop is integrate's state, bitwise
    short = ebt.equilibrate("Classic", st, ebt.Forcing(0.0), par, init, tol=0.0, max_years=2,
                            **KW)
    sol = ebt.integrate("Classic", ebt.SpaceTime.sin(8, 1000, 2), ebt.Forcing(0.0), par,
                        init, raw_mode="none", progress=False, **KW)
    np.testing.assert_array_equal(short.seasonal.avg["E"], sol.seasonal.avg["E"][-1])
    # a two-member ensemble (D swept) at a fixed year count: members are
    # their solo runs bitwise (the Classic step has no Newton loop)
    ens_par = ebt.Collection(par, D=np.array([0.6, 0.55]))
    ens = ebt.equilibrate("Classic", st, ebt.Forcing(0.0), ens_par, init, tol=0.0,
                          max_years=2, **KW)
    for i, D in enumerate((0.6, 0.55)):
        solo = ebt.equilibrate("Classic", st, ebt.Forcing(0.0), ebt.Collection(par, D=D), init,
                               tol=0.0, max_years=2, **KW)
        for k in solo.state:
            np.testing.assert_array_equal(ens.state[k][i], solo.state[k], err_msg=k)



# -- continuation -----------------------------------------------------------

def test_continuation_round_trip_matches_jax(record_property):
    kw = dict(tol=1e-2, max_years=200, round_trip=True)
    st, par, init = miz(ebm)
    j = ebm.continuation("MIZ", st, [0.0, F], par, init, **kw)
    st, par, init = miz(ebt)
    t = ebt.continuation("MIZ", st, [0.0, F], par, init, **kw, **KW)
    np.testing.assert_array_equal(t.values, [0.0, F, 0.0])
    np.testing.assert_array_equal(t.direction, [1, 1, -1])
    np.testing.assert_array_equal(t.years, j.years)
    assert t.converged.all()
    record_property("dE_vs_jax", max(dE(a, b) for a, b in zip(t.results, j.results)))
    for a, b in zip(t.results, j.results):
        assert dE(a, b) <= BAR_MIZ
    np.testing.assert_allclose(t.ice_area(), j.ice_area(), atol=1e-3)
    np.testing.assert_allclose(t.mean("E"), j.mean("E"), atol=BAR_MIZ)
    vals, gap = t.hysteresis_gap()
    np.testing.assert_array_equal(vals, [0.0])
    np.testing.assert_allclose(gap, j.hysteresis_gap()[1], atol=1e-3)
    assert "round trip" in repr(t)


def test_continuation_parameter_path_and_validation(tmp_path, monkeypatch):
    st, par, init = classic(ebt)
    ck = str(tmp_path / "cont.h5")
    res = ebt.continuation("Classic", st, [0.6, 0.55], par, init, vary="D", tol=0.0,
                           max_years=2, checkpoint=ck, **KW)
    assert res.vary == "D" and res.years.tolist() == [2, 2]
    with pytest.raises(ValueError, match="round_trip"):
        res.hysteresis_gap()
    with pytest.raises(ValueError, match="non-empty"):
        ebt.continuation("Classic", st, [], par, init, **KW)
    with pytest.raises(ValueError, match="not in par"):
        ebt.continuation("Classic", st, [1.0], par, init, vary="nope", **KW)
    with pytest.raises(ValueError, match="constant base forcing"):
        ebt.continuation("Classic", st, [1.0], par, init,
                         forcing=ebt.Forcing(0.0, 1.0, -1.0, (2, 2), (0.5, -0.5)), **KW)
    with pytest.raises(ValueError, match="needs checkpoint"):
        ebt.continuation("Classic", st, [1.0], par, init, resume=True, **KW)
    # every level is on file: the resume solves none and returns them
    from energybalancemodel_jl_tpu_torch import equilibrium as eqmod

    def boom(*a, **k):
        raise AssertionError("equilibrate called on a complete resume")

    monkeypatch.setattr(eqmod, "equilibrate", boom)
    back = ebt.continuation("Classic", st, [0.6, 0.55], par, init, vary="D", tol=0.0,
                            max_years=2, checkpoint=ck, resume=True, **KW)
    assert back.years.tolist() == [2, 2]
    for r0, r1 in zip(res.results, back.results):
        np.testing.assert_array_equal(r1.state["E"], r0.state["E"])
    monkeypatch.undo()
    bare = ebt.ContinuationResult(values=res.values, direction=res.direction,
                                  results=res.results, vary="D", spacetime=st)
    with pytest.raises(ValueError, match="model/par/forcing"):
        bare.stability()
