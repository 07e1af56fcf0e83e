"""``basins``, ``edge`` and their helpers of the PyTorch port against the JAX
package, float64 on the CPU (the port's ``equilibrate`` runs its eager year
there).

Configuration: the JAX tests' bistable Classic window (``tests/test_basins.py``:
``SpaceTime.sin(8, 1000)``, forcing 10, the warm and cold inits), started from
the two attractors JAX converges them to (a JAX ``EquilibriumResult.state``
as the port's init), at the arrival tolerance 2.0 of
``tests/test_torch_equilibrium_paths.py`` and at most 40 years per solve, to
keep the eager Classic years (~0.55 s each here) few.

Bars: ``stack_states``, ``blend_states``, ``_cluster_1d`` and
``_finite_members`` equal JAX's bitwise; ``basins`` labels, counts and areas
equal JAX's (the ice area is a count of ``E < 0`` cells) and centroids to
1e-12; ``edge``'s ``in_a``, ``probe_finite`` and ``probe_converged``
histories equal JAX's step for step and its brackets bitwise (host arithmetic
on equal decisions), from the endpoint states of a JAX ``EdgeResult``, with a
per-member forcing; ``EdgeResult.states()`` and ``.refine()`` slice what
JAX's slice; every ``ValueError`` of ``tests/test_basins.py`` for these
drivers; the tracked ``edge`` writes a checkpoint, and resuming it returns
the search as it ran. Fixed points differ from JAX's by up to ``BAR_CLASSIC``
in E (``tests/test_torch_equilibrium.py``), so a decision within round-off
of the classification boundary could flip: every decision here is an
attractor's ice area against the other's (1.054 against 5.637).
"""
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.basins import _cluster_1d as jax_cluster
from energybalancemodel_jl_tpu.basins import _finite_members as jax_finite
from energybalancemodel_jl_tpu_torch.basins import _cluster_1d, _finite_members

torch.set_num_threads(1)
KW = dict(dtype="float64", device="cpu")
F, TOL, CAP = 10.0, 2.0, 40
W6 = np.linspace(0.0, 1.0, 6)


def st_par(mod):
    return mod.SpaceTime.sin(8, 1000, 1), mod.Collection(mod.default_parameters("Classic"))


def state(E0):
    E = np.full(8, float(E0))
    return ebm.Collection(E=E, Tg=E / float(ebm.default_parameters("Classic")["cw"]))


WARM, COLD = state(40.0), state(-300.0)


@pytest.fixture(scope="module")
def attractors():
    st, par = st_par(ebm)
    res = ebm.equilibrate("Classic", st, F, par, ebm.stack_states([WARM, COLD]), tol=0.5,
                          max_years=200)
    assert np.all(res.converged)
    return tuple(ebm.Collection({k: np.asarray(v)[i] for k, v in res.state.items()})
                 for i in (0, 1))


@pytest.fixture(scope="module")
def mapped(attractors):
    a, b = attractors
    kw = dict(forcing=F, tol=TOL, max_years=CAP)
    st, par = st_par(ebm)
    j = ebm.basins("Classic", st, par, ebm.blend_states(a, b, W6), **kw)
    st, par = st_par(ebt)
    t = ebt.basins("Classic", st, par, [ebt.blend_states(a, b, w) for w in W6], **kw, **KW)
    return j, t


@pytest.fixture(scope="module")
def edge_ckpt(tmp_path_factory):
    return str(tmp_path_factory.mktemp("edge") / "edge.h5")


@pytest.fixture(scope="module")
def tracked(attractors, edge_ckpt):
    """``edge`` with a per-member forcing (F = 8, 12), from the endpoint
    states of a JAX ``EdgeResult``; the port's search writes a
    checkpoint."""
    a, b = attractors
    kw = dict(forcing=0.0, steps=3, tol=TOL, max_years=CAP)
    st, par = st_par(ebm)
    j0 = ebm.edge("Classic", st, par, a, b, forcing=F, steps=1, tol=TOL, max_years=CAP)
    ja, jb = j0.result_a.state, j0.result_b.state
    par["F"] = np.array([8.0, 12.0])
    j = ebm.edge("Classic", st, par, ja, jb, **kw)
    st, par = st_par(ebt)
    par["F"] = np.array([8.0, 12.0])
    t = ebt.edge("Classic", st, par, ja, jb, **kw, **KW, checkpoint=edge_ckpt)
    return j, t


def test_helpers_equal_jax():
    w = np.array([0.0, 0.25, 1.0])
    batched = (ebm.stack_states([WARM, WARM, COLD]), ebm.stack_states([COLD, COLD, WARM]))
    for args in ((WARM, COLD, 0.5), (WARM, COLD, w), (*batched, w)):
        j, t = ebm.blend_states(*args), ebt.blend_states(*args)
        assert sorted(j) == sorted(t)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
    j, t = ebm.stack_states([WARM, COLD]), ebt.stack_states([WARM, COLD])
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
    assert ebt.blend_states(WARM, COLD, w)["E"].shape == (3, 8)
    vals = np.array([5.6, 1.0, 1.2, 5.7, 3.0, 1.1])
    for gap in (np.pi / 4, 0.15, 10.0):
        for x, y in zip(_cluster_1d(vals, gap), jax_cluster(vals, gap)):
            np.testing.assert_array_equal(x, y)
    good = np.ones((3, 8))
    bad = good.copy()
    bad[1, 2] = np.nan
    for res, K in ((SimpleNamespace(state={"E": bad, "Tg": good}, member_years=np.zeros(3)), 3),
                   (SimpleNamespace(state={"E": good, "Tg": np.full(8, np.nan)},
                                    member_years=np.zeros(3)), 3),
                   (SimpleNamespace(state={"E": np.ones(8)}, member_years=None), 1),
                   (SimpleNamespace(state={"E": np.full(8, np.nan)}, member_years=None), 1)):
        np.testing.assert_array_equal(_finite_members(res, K), jax_finite(res, K))
    with pytest.raises(ValueError, match="different variables"):
        ebt.stack_states([WARM, ebt.Collection(E=WARM["E"])])
    with pytest.raises(ValueError, match="different variables"):
        ebt.blend_states(WARM, ebt.Collection(E=COLD["E"]), 0.5)
    with pytest.raises(ValueError, match="at least one"):
        ebt.stack_states([])


def test_basins_matches_jax(mapped, record_property):
    j, t = mapped
    record_property("labels", t.labels.tolist())
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.counts, j.counts)
    np.testing.assert_array_equal(t.areas, j.areas)
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=1e-12)
    assert t.n_basins == 2 and (t.labels < 0).any()  # one member still on its way at 40 years
    assert t.centroids[0] < np.pi < t.centroids[1]
    np.testing.assert_allclose(t.fractions, j.fractions)
    np.testing.assert_array_equal(t.members(1), j.members(1))
    assert repr(t) == repr(j) and "unconverged" in repr(t)
    assert t.result.member_years is not None and t.season == "avg"
    # a gap wider than the warm/snowball separation merges everything
    labels, cent, counts = _cluster_1d(t.areas, gap=10.0)
    assert len(cent) == 1 and counts[0] == 6


def test_edge_matches_jax(tracked, record_property):
    j, t = tracked
    record_property("values", t.values.tolist())
    for name in ("in_a", "probe_finite", "probe_converged", "history", "wa", "wb"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    np.testing.assert_allclose(t.area_a, j.area_a, rtol=1e-12)
    np.testing.assert_allclose(t.area_b, j.area_b, rtol=1e-12)
    assert np.all(np.abs(t.area_a - t.area_b) > np.pi / 2)
    assert np.allclose(t.width, 2.0 ** -3) and t.ok.all()
    wa, wb = np.zeros(2), np.ones(2)
    for s in range(3):  # the history is the bisection
        mid = 0.5 * (wa + wb)
        wa = np.where(t.in_a[s], mid, wa)
        wb = np.where(t.in_a[s], wb, mid)
        np.testing.assert_array_equal(t.history[s], [wa, wb])
    assert "w* =" in repr(t)


def test_edge_states_and_refine_slice_as_jax(tracked, monkeypatch):
    j, t = tracked
    js, ts = j.states(), t.states()
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])
    assert ts["E"].shape == (2, 8)
    seen = {}

    def capture(tag):
        def fake(model, st, par, a, b, forcing=0.0, **kw):
            seen[tag] = (par, a, b, forcing, kw)
        return fake

    monkeypatch.setattr(sys.modules["energybalancemodel_jl_tpu.basins"], "edge_state",
                        capture("jax"))
    monkeypatch.setattr(sys.modules["energybalancemodel_jl_tpu_torch.basins"], "edge_state",
                        capture("torch"))
    j.refine("Classic", forcing=0.0, member=1, stages=2)
    t.refine("Classic", forcing=0.0, member=1, stages=2)
    (jp, ja, jb, jf, jkw), (tp, ta, tb, tf, tkw) = seen["jax"], seen["torch"]
    assert sorted(jp) == sorted(tp) and all(float(jp[k]) == float(tp[k]) for k in jp)
    assert float(tp["F"]) == 12.0 and jf == tf
    for x, y in ((ta, ja), (tb, jb)):
        for k in y:
            np.testing.assert_array_equal(x[k], y[k])
    assert tkw.keys() == jkw.keys()
    np.testing.assert_allclose(tkw["refs"], jkw["refs"], rtol=1e-12)
    assert tkw["season"] == "avg" and tkw["stages"] == 2
    with pytest.raises(ValueError, match="member"):
        t.refine("Classic", member=5)


def test_starved_probes_flag_unconverged(attractors):
    a, b = attractors
    kw = dict(forcing=F, steps=3, tol=TOL, max_years=4)
    st, par = st_par(ebm)
    j = ebm.edge("Classic", st, par, a, b, **kw)
    st, par = st_par(ebt)
    t = ebt.edge("Classic", st, par, a, b, **kw, **KW)
    assert not t.ok.any() and t.probe_finite.all()
    for name in ("in_a", "probe_finite", "probe_converged", "history"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)


def test_validation_errors(attractors, tracked, edge_ckpt):
    a, _ = attractors
    st, par = st_par(ebt)
    edge = lambda **kw: ebt.edge("Classic", st, par, kw.pop("a", WARM), kw.pop("b", COLD),
                                 **{**dict(forcing=F, steps=2, tol=TOL, max_years=CAP), **kw},
                                 **KW)
    with pytest.raises(ValueError, match="same basin|jump_tol"):
        edge(a=a, b=ebt.blend_states(a, a, 0.5))
    with pytest.raises(ValueError, match="different variables"):
        edge(b=ebt.Collection(E=COLD["E"]))
    with pytest.raises(ValueError, match="constant"):
        edge(forcing=ebt.Forcing(0.0, 5.0, -5.0, (10, 10), (0.5, -0.5)))
    with pytest.raises(ValueError, match="steps"):
        edge(steps=0)
    with pytest.raises(ValueError, match="season"):
        edge(season="sumer")
    with pytest.raises(ValueError, match="season"):
        ebt.basins("Classic", st, par, [WARM, COLD], forcing=F, season="sumer", **KW)
    with pytest.raises(ValueError, match="did not converge"):
        edge(a=WARM, max_years=1)
    with pytest.raises(ValueError, match="needs checkpoint"):
        edge(resume=True)
    # the tracked search's checkpoint resumes: all its steps are on file, so
    # the resume solves nothing and returns the search as it ran
    _, t = tracked
    ja, jb = t.a, t.b
    par_f = ebt.Collection(par, F=np.array([8.0, 12.0]))
    back = ebt.edge("Classic", st, par_f, ja, jb, forcing=0.0, steps=3, tol=TOL, max_years=CAP,
                    checkpoint=edge_ckpt, resume=True, **KW)
    for name in ("wa", "wb", "history", "in_a", "probe_converged", "probe_finite",
                 "area_a", "area_b"):
        np.testing.assert_array_equal(getattr(back, name), getattr(t, name), err_msg=name)
    np.testing.assert_array_equal(back.result_a.state["E"], t.result_a.state["E"])
