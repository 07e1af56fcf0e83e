"""``fold`` of the PyTorch port against the JAX package, float64 on the CPU
(the port's ``equilibrate`` runs its eager year there, JAX its XLA scan).

Configuration: the JAX tests' ``tracked`` fold (``tests/test_fold.py``:
Classic ``SpaceTime.sin(8, 1000)``, the warm init, D in {0.45, 0.75},
``lo=-10``, ``hi=20``, 4 steps, ``tol=0.5``) with ``max_years`` capped at 40
to keep the eager Classic years (~0.55 s each here) few. The anchor converges
in 21 years; JAX's uncapped run (``max_years=120``, every probe converged)
makes the same decisions as the capped one, which this file checks.

Bars: the decisions are the test. ``survived`` and ``probe_converged`` equal
JAX's, step for step, and ``lo``/``hi``/``history`` equal JAX's bitwise (the
brackets are host arithmetic on equal decisions). Fixed points themselves
differ from JAX's by up to ``BAR_CLASSIC`` in E (the albedo hole wobbles,
``tests/test_torch_equilibrium.py``), so a probe within round-off of the
classification boundary could flip; the capped probes that have not
converged carry the same flag in both packages, and JAX's uncapped run, in
which every probe converged, makes the same decisions. Also: a
reused JAX anchor with the default classifier (the ``hi`` re-probe) and with
a custom predicate, lockstep members against a solo run of one member, every
``ValueError`` of ``tests/test_fold.py``, and the tracked fold's checkpoint,
which resumes to the search as it ran.
"""
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.fold import seasonal_ice_area as jax_area
from energybalancemodel_jl_tpu_torch.equilibrium import EquilibriumResult
from energybalancemodel_jl_tpu_torch.fold import seasonal_ice_area as torch_area

torch.set_num_threads(1)
KW = dict(dtype="float64", device="cpu")
D_VALS = np.array([0.45, 0.75])
LO, HI, STEPS, TOL, CAP = -10.0, 20.0, 4, 0.5, 40


def setup(mod, D=D_VALS):
    st = mod.SpaceTime.sin(8, 1000, 1)
    par = mod.Collection(mod.default_parameters("Classic"))
    par["D"] = D
    E0 = np.full(8, 40.0)
    return st, par, mod.Collection(E=E0, Tg=E0 / float(par["cw"]))


def assert_same_decisions(t, j):
    np.testing.assert_array_equal(t.survived, j.survived)
    np.testing.assert_array_equal(t.probe_converged, j.probe_converged)
    np.testing.assert_array_equal(t.history, j.history)
    np.testing.assert_array_equal(t.lo, j.lo)
    np.testing.assert_array_equal(t.hi, j.hi)


@pytest.fixture(scope="module")
def fold_ckpt(tmp_path_factory):
    return str(tmp_path_factory.mktemp("fold") / "fold.h5")


@pytest.fixture(scope="module")
def tracked(fold_ckpt):
    kw = dict(lo=LO, hi=HI, steps=STEPS, tol=TOL, max_years=CAP)
    st, par, init = setup(ebm)
    j = ebm.fold("Classic", st, par, init, **kw)
    uncapped = ebm.fold("Classic", st, par, init, lo=LO, hi=HI, steps=STEPS, tol=TOL,
                        max_years=120)
    st, par, init = setup(ebt)
    t = ebt.fold("Classic", st, par, init, **kw, **KW, checkpoint=fold_ckpt)
    return j, t, uncapped


def test_tracked_decisions_match_jax(tracked, record_property):
    j, t, uncapped = tracked
    assert_same_decisions(t, j)
    # capping the probes at 40 years changes no decision of JAX's
    np.testing.assert_array_equal(uncapped.survived, j.survived)
    assert uncapped.ok.all() and not j.ok.all()
    record_property("values", t.values.tolist())
    assert t.vary == "F" and isinstance(t.anchor, EquilibriumResult)
    assert np.allclose(t.width, (HI - LO) / 2 ** STEPS)
    assert np.all(t.lo < t.values) and np.all(t.values < t.hi)
    assert t.values[0] < t.values[1]  # the fold moves with diffusivity
    assert t.anchor.years == j.anchor.years and np.all(t.anchor.converged)
    area = torch_area(t.anchor.seasonal.avg, ebt.SpaceTime.sin(8, 1000, 1))
    np.testing.assert_allclose(
        area, jax_area(j.anchor.seasonal.avg, ebm.SpaceTime.sin(8, 1000, 1)), atol=1e-12)
    np.testing.assert_array_equal(t.par["D"], D_VALS)
    assert "F*" in repr(t) and "0/2" in repr(t)


def test_history_is_the_bisection(tracked):
    _, t, _ = tracked
    lo, hi = np.full(2, LO), np.full(2, HI)
    for s in range(STEPS):
        mid = 0.5 * (lo + hi)
        hi = np.where(t.survived[s], mid, hi)
        lo = np.where(t.survived[s], lo, mid)
        np.testing.assert_array_equal(t.history[s], [lo, hi])


def test_reused_jax_anchor_reprobes_hi(tracked):
    """The default classifier with a reused anchor (here JAX's, numpy
    leaves): ``hi`` is re-probed for the on-branch reference, ``lo`` checked,
    then one step (10 years at most each: the lo probe's ice area has
    jumped past jump_tol by then)."""
    j, t, _ = tracked
    kw = dict(lo=LO, hi=HI, steps=1, tol=TOL, max_years=10)
    st, par, _ = setup(ebm)
    jr = ebm.fold("Classic", st, par, None, anchor=j.anchor, **kw)
    st, par, _ = setup(ebt)
    tr = ebt.fold("Classic", st, par, None, anchor=j.anchor, **kw, **KW)
    assert_same_decisions(tr, jr)
    assert tr.anchor is j.anchor


def test_custom_predicate_and_lockstep_matches_solo(tracked):
    """A custom predicate (warm branch: little ice) from JAX's anchor, two
    members in lockstep against JAX's, and member 1 alone against them (10
    years at most per probe; the step's probe reads 1.05 against the
    predicate's pi/2): the solo run stops each probe at its own year
    count, the decisions stay."""
    j, _, _ = tracked
    st_j = ebm.SpaceTime.sin(8, 1000, 1)
    st_t = ebt.SpaceTime.sin(8, 1000, 1)
    kw = dict(lo=LO, hi=HI, steps=1, tol=TOL, max_years=10)
    jr = ebm.fold("Classic", st_j, setup(ebm)[1], None, anchor=j.anchor,
                  predicate=lambda p, a: jax_area(p.seasonal.avg, st_j) < np.pi / 2, **kw)
    pred = lambda p, a: torch_area(p.seasonal.avg, st_t) < np.pi / 2
    tr = ebt.fold("Classic", st_t, setup(ebt)[1], None, anchor=j.anchor, predicate=pred, **kw,
                  **KW)
    assert_same_decisions(tr, jr)
    a1 = EquilibriumResult(
        state=ebt.Collection({k: np.asarray(v)[1] for k, v in j.anchor.state.items()}),
        seasonal=None, years=j.anchor.years, resid=float(j.anchor.resid[1]), converged=True,
        member_years=None, newton_ok=True, tol=TOL)
    solo = ebt.fold("Classic", st_t, setup(ebt, D=float(D_VALS[1]))[1], None, anchor=a1,
                    predicate=pred, **kw, **KW)
    np.testing.assert_array_equal(solo.survived[:, 0], tr.survived[:, 1])
    np.testing.assert_array_equal(solo.history[:, :, 0], tr.history[:, :, 1])


def test_validation_errors(tracked, fold_ckpt):
    _, t, _ = tracked
    st, par, init = setup(ebt, D=0.6)
    fold = lambda **kw: ebt.fold("Classic", st, kw.pop("par", par), kw.pop("init", init),
                                 **{**dict(lo=LO, hi=HI, steps=1, tol=TOL, max_years=CAP), **kw},
                                 **KW)
    with pytest.raises(ValueError, match="not in par"):
        fold(vary="nope")
    with pytest.raises(ValueError, match="member-swept"):
        fold(par=ebt.Collection(par, F=np.array([0.0, 1.0])))
    with pytest.raises(ValueError, match="must differ"):
        fold(lo=1.0, hi=1.0)
    with pytest.raises(ValueError, match="steps"):
        fold(steps=0)
    with pytest.raises(ValueError, match="init"):
        fold(init=None)
    with pytest.raises(ValueError, match="constant"):
        fold(forcing=ebt.Forcing(0.0, 5.0, -5.0, (10, 10), (0.5, -0.5)))
    with pytest.raises(ValueError, match="check_lo"):
        fold(check_lo=False)
    with pytest.raises(ValueError, match="anchor"):
        fold(tol=1e-12, max_years=1)
    with pytest.raises(ValueError, match="members"):
        fold(par=ebt.Collection(par, D=np.array([0.4, 0.6, 0.8])), anchor=t.anchor)
    # both bracket ends on the warm branch (from the converged anchor)
    with pytest.raises(ValueError, match="jump_tol"):
        fold(par=ebt.Collection(par, D=D_VALS), lo=19.0, anchor=t.anchor)
    with pytest.raises(ValueError, match="survives at lo"):
        fold(par=ebt.Collection(par, D=D_VALS), lo=19.0, anchor=t.anchor,
             predicate=lambda p, a: np.asarray(p.seasonal.avg["E"]).min(-1) > -50.0)
    with pytest.raises(ValueError, match="needs checkpoint"):
        fold(resume=True)
    # the tracked search's checkpoint resumes: all its steps are on file, so
    # the resume solves nothing; fewer steps report the file's first ones
    sp = setup(ebt)
    for steps in (STEPS, 2):
        back = ebt.fold("Classic", *sp, lo=LO, hi=HI, steps=steps, tol=TOL, max_years=CAP,
                        checkpoint=fold_ckpt, resume=True, **KW)
        np.testing.assert_array_equal(back.history, t.history[:steps])
        np.testing.assert_array_equal(back.survived, t.survived[:steps])
    np.testing.assert_array_equal(back.anchor.state["E"], t.anchor.state["E"])
