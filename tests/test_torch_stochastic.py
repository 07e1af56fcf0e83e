"""The port's ``transitions`` (``stochastic.py``) against the JAX package's,
on the CPU, on the fixtures of ``tests/test_stochastic.py``: the Classic
model at nx=8/nt=1000 with its warm and snowball attractors from the JAX
``equilibrate`` (passed as numpy).

Bars:
- scan engine, float64: areas within 1e-10 relative, equal labels and first
  passages (the float64 draws differ from JAX's in their last bits, ROADMAP
  Queue 3);
- fused engine, float32 (the plain year on the CPU) against JAX's fused
  engine (interpret mode): the year-end OU values bitwise, equal labels,
  areas and tracked means at the engine-parity level of JAX
  ``TestFusedEngine`` (atol 5e-3 on areas), crossing steps equal up to a few
  steps where the areas graze the threshold;
- chunking (``years_per_dispatch``) and the ``year0`` resume: bitwise;
- the argument checks raise JAX's ``ValueError``s.
"""
import types
import warnings

import numpy as np
import pytest

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.stochastic import transitions as jax_transitions
from energybalancemodel_jl_tpu_torch.stochastic import (TransitionResult, _first_passage,
                                                        transitions)

F = 5.5  # near the warm branch's end: strong noise escapes within years
RAMP = (10.0, 11.0, -5.0, (1, 1), (1.0, -1.0))


def as_numpy(res):
    """A JAX equilibrate result as plain numpy ``.state`` / ``.seasonal``."""
    return types.SimpleNamespace(
        state=ebt.Collection({k: np.asarray(v) for k, v in res.state.items()}),
        seasonal=ebt.Seasonal(*(ebt.Collection({k: np.asarray(v) for k, v in c.items()})
                                for c in res.seasonal)))


@pytest.fixture(scope="module")
def attractors():
    st = ebm.SpaceTime.sin(8, 1000, 1)
    par = ebm.Collection(ebm.default_parameters("Classic"))
    cw = float(par["cw"])
    mk = lambda e: ebm.Collection({"E": np.full(8, e), "Tg": np.full(8, e) / cw})
    a = ebm.equilibrate("Classic", st, F, par, mk(30.0), max_years=120, tol=2.0)
    b = ebm.equilibrate("Classic", st, F, par, mk(-30.0), max_years=120, tol=2.0)
    assert a.converged and b.converged
    return st, par, a, b, ebt.SpaceTime.sin(8, 1000, 1), as_numpy(a), as_numpy(b)


def run_both(attractors, forcing, **kw):
    st, par, a, b, tst, ta, tb = attractors
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jax_transitions("Classic", st, ebm.Forcing(*forcing), par, a, b, **kw)
        t = transitions("Classic", tst, ebt.Forcing(*forcing), dict(par), ta, tb,
                        device="cpu", **kw)
    return j, t


def test_scan_f64_matches_jax(attractors):
    j, t = run_both(attractors, (F,), sigma=48.0, tau=0.05, years=5, K=6, seed=0,
                    engine="scan", dtype="float64", track=("E",))
    assert t.engine == "scan" and t.areas.shape == (5, 6)
    print(f"[scan f64] areas max rel {float(np.max(np.abs(t.areas - j.areas) / j.areas)):.3e}, "
          f"tracked E max abs {float(np.max(np.abs(t.tracked['E'] - j.tracked['E']))):.3e}, "
          f"escaped {int(t.escaped.sum())}/6")
    np.testing.assert_allclose(t.areas, j.areas, rtol=1e-10, atol=0)
    np.testing.assert_allclose(t.tracked["E"], j.tracked["E"], rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.first_passage, j.first_passage)
    np.testing.assert_array_equal(t.finite, j.finite)
    np.testing.assert_allclose(t.area_a, j.area_a, rtol=1e-10)
    np.testing.assert_allclose(t.eta, j.eta, rtol=1e-10, atol=1e-10)
    assert t.escaped.any() and t.escape_fraction() == j.escape_fraction()
    assert t.escape_rate() == pytest.approx(j.escape_rate())


def test_fused_f32_with_subyear_matches_jax_fused(attractors):
    j, t = run_both(attractors, (F,), sigma=12.0, tau=0.05, years=3, K=4, seed=2,
                    engine="fused", dtype="float32", subyear=True, track=("E",))
    assert t.engine == "fused" and t.nt == 1000
    print(f"[fused f32] areas max abs {float(np.max(np.abs(t.areas - j.areas))):.3e}, tracked E "
          f"max abs {float(np.max(np.abs(t.tracked['E'] - j.tracked['E']))):.3e}, crossing "
          f"steps max diff {float(np.max(np.abs(t.crossing_step - j.crossing_step))):g}")
    np.testing.assert_array_equal(t.eta, j.eta)
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_allclose(t.areas, j.areas, atol=5e-3)
    np.testing.assert_allclose(t.tracked["E"], j.tracked["E"], atol=1e-3)
    assert t.crossing_step.shape == (3, 4)
    np.testing.assert_allclose(t.crossing_step, j.crossing_step, atol=3)
    fps = t.first_passage_subyear()
    esc = t.escaped
    assert (fps[esc] <= t.first_passage[esc]).all()


def test_ramped_scan_f64_and_subyear_match_jax(attractors):
    j, t = run_both(attractors, RAMP, sigma=8.0, tau=0.05, years=3, K=2, seed=4,
                    engine="scan", dtype="float64")
    assert t.ramped and t.area_a.shape == (3,) and t.ref_state is not None
    print(f"[ramped scan f64] areas max abs {float(np.max(np.abs(t.areas - j.areas))):.3e}, "
          f"area_a max abs {float(np.max(np.abs(t.area_a - j.area_a))):.3e}")
    np.testing.assert_allclose(t.area_a, j.area_a, rtol=1e-10)
    np.testing.assert_allclose(t.area_b, j.area_b, rtol=1e-10)
    np.testing.assert_allclose(t.areas, j.areas, rtol=1e-10)
    for k in j.ref_state[0]:
        np.testing.assert_allclose(t.ref_state[0][k], np.asarray(j.ref_state[0][k]),
                                   rtol=1e-10, atol=1e-10)
    j, t = run_both(attractors, RAMP, sigma=8.0, tau=0.05, years=2, K=2, seed=4,
                    engine="fused", dtype="float32", subyear=True)
    np.testing.assert_array_equal(t.eta, j.eta)
    np.testing.assert_allclose(t.crossing_step, j.crossing_step, atol=3)


def test_chunking_and_year0_resume_are_bitwise(attractors):
    *_, tst, ta, tb = attractors
    par = dict(ebt.default_parameters("Classic"))
    kw = dict(sigma=8.0, tau=0.05, K=2, seed=1, device="cpu", dtype="float32",
              engine="fused", subyear=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for forcing in (ebt.Forcing(F), ebt.Forcing(*RAMP)):
            full = transitions("Classic", tst, forcing, par, ta, tb, years=3, **kw)
            chunked = transitions("Classic", tst, forcing, par, ta, tb, years=3,
                                  years_per_dispatch=2, **kw)
            head = transitions("Classic", tst, forcing, par, ta, tb, years=1, **kw)
            tail = transitions("Classic", tst, forcing, par, ta, tb, years=2, year0=1,
                               init=head.state, eta0=head.eta, ref_init=head.ref_state,
                               ref_area0=((head.area_a[-1], head.area_b[-1])
                                          if head.ramped else None), **kw)
            np.testing.assert_array_equal(chunked.areas, full.areas)
            np.testing.assert_array_equal(chunked.eta, full.eta)
            np.testing.assert_array_equal(chunked.crossing_step, full.crossing_step)
            np.testing.assert_array_equal(np.concatenate([head.areas, tail.areas]), full.areas)
            np.testing.assert_array_equal(tail.eta, full.eta)
            np.testing.assert_array_equal(
                np.concatenate([head.crossing_step, tail.crossing_step]), full.crossing_step)
            for k in full.state:
                np.testing.assert_array_equal(tail.state[k], full.state[k])


def test_sigma_zero_members_ride_the_reference(attractors):
    *_, tst, ta, tb = attractors
    par = dict(ebt.default_parameters("Classic"))
    res = transitions("Classic", tst, ebt.Forcing(F), par, ta, tb, sigma=0.0, years=3, K=3,
                      seed=7, device="cpu", dtype="float64")
    for k in range(1, 3):
        np.testing.assert_array_equal(res.areas[:, 0], res.areas[:, k])
    assert not res.escaped.any() and (res.labels == 0).all()
    assert res.eta.shape == (3,) and not res.eta.any()


def test_first_passage_label_cases():
    labels = np.array([[0, 0, -1, 0, 0, 1], [0, 0, -1, 1, 0, 1],
                       [0, 1, 0, -1, -1, 1], [0, 1, 1, -1, -1, 1]], dtype=np.int8)
    fp, finite = _first_passage(labels, start_label=0)
    np.testing.assert_array_equal(fp, [np.nan, 3.0, np.nan, 2.0, np.nan, 1.0])
    np.testing.assert_array_equal(finite, [True, True, False, True, False, True])


@pytest.mark.parametrize("kw,match", [
    (dict(start="c"), "start must be"),
    (dict(sigma=[[1.0]]), "scalar or a"),
    (dict(sigma=-1.0), ">= 0"),
    (dict(tau=-1.0), "tau must be"),
    (dict(years=0), "years must be"),
    (dict(year0=-1), "year0 must be"),
    (dict(season="spring"), "season must be"),
    (dict(K=3, sigma=np.ones(2)), "conflicts"),
    (dict(engine="warp"), "engine must be"),
    (dict(ou_impl="tree"), "ou_impl must be"),
    (dict(engine="scan", ou_impl="assoc"), "fused-kernel mode"),
    (dict(engine="fused", ou_impl="assoc", dtype="float64"), "float32"),
    (dict(engine="scan", subyear=True), "fused"),
    (dict(engine="fused", subyear=True, dtype="float64"), "float32"),
    (dict(ref_area0=(1.0, 2.0), engine="fused", subyear=True), "RAMPED"),
    (dict(ref_init=({}, {})), "ramped forcing only"),
    (dict(track=("Ei",)), "track names"),
    (dict(eta0=np.zeros(5)), "eta0 must be"),
    (dict(years_per_dispatch=0), "years_per_dispatch"),
])
def test_argument_errors(attractors, kw, match):
    *_, tst, ta, tb = attractors
    args = dict(sigma=1.0, years=1, K=2, device="cpu")
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        transitions("Classic", tst, F, dict(ebt.default_parameters("Classic")), ta, tb, **args)


def test_unported_options_raise(attractors, tmp_path):
    *_, tst, ta, tb = attractors
    par = dict(ebt.default_parameters("Classic"))
    # mesh= is ported (M14: tests/test_torch_parallel.py) and takes a port Mesh
    with pytest.raises(TypeError, match="Mesh"):
        transitions("Classic", tst, F, par, ta, tb, sigma=1.0, device="cpu", mesh=object())
    swept = dict(par, D=np.array([0.5, 0.6]))
    with pytest.raises(ValueError, match="EquilibriumResults"):
        transitions("Classic", tst, F, swept, ta.state, tb.state, sigma=1.0, device="cpu")
    with pytest.raises(ValueError, match="cannot sweep"):
        transitions("Classic", tst, ebt.Forcing(*RAMP), swept, ta, tb, sigma=1.0, device="cpu")
    res = transitions("Classic", tst, F, par, ta.state, tb.state, sigma=0.0, years=1, K=1,
                      device="cpu", dtype="float64")
    assert isinstance(res, TransitionResult) and "0/1 members escaped" in repr(res)
    # saved, loaded and drawn by the module-level functions, as in JAX (the
    # class has no methods of its own for them)
    assert not any(hasattr(TransitionResult, m) for m in ("save", "load", "plot"))
    path = str(tmp_path / "tr.h5")
    ebt.save(res, path)
    for back in (ebt.load(path), ebm.load(path)):
        np.testing.assert_array_equal(back.areas, res.areas)
        np.testing.assert_array_equal(back.first_passage, res.first_passage)
        assert back.years == res.years and back.engine == res.engine
    assert len(ebt.plot_transitions(ebt.load(path)).axes) >= 1
    with pytest.raises(ValueError, match="subyear=True"):
        res.first_passage_subyear()
