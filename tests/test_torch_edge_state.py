"""The edge-state machinery of the PyTorch port against the JAX package,
float64 on the CPU: the dense polish (``basins._residual_fns``,
``_polish_fixed_point``), ``unstable_branch`` and ``edge_state``'s tracker.

Bars:
- the polish's dense Jacobian (one forward graph of the eager year over the
  state repeated as members, one backward) equal to JAX's ``jax.jacrev`` of
  its residual to 1e-10 relative to the largest entry, Classic
  (``SpaceTime.sin(8, 200)``, forcing 10, near the saddle) and MIZ
  (``SpaceTime.sin(8, 50)``, forcing +4, a 40-year state with an ice edge);
  the residual ``year(x) - x`` to 1e-12 relative to its largest entry; the
  starting point bitwise;
- one TRF polish of 5 residual evaluations from the JAX tests' Classic
  saddle guess (``SpaceTime.sin(8, 1000)``, forcing 10): the same
  evaluation count as JAX's, the residual within 1% of JAX's;
- two levels (F = 10, 10.5) of ``unstable_branch`` from a JAX-polished
  saddle, 4 evaluations each: the converged flags and ice areas equal
  JAX's, the residuals within 1% of JAX's;
- ``edge_state``'s tracker on MIZ (the JAX tests' ``test_miz_carry_has_no_E_leaf``
  configuration, ``polish=False``): stages, flown years and separations equal
  to JAX's, drift and residual to 1e-8 relative;
- ``test_polish_scale_guard``'s refusal, and every ``ValueError`` of
  ``tests/test_basins.py`` for ``edge_state`` and ``unstable_branch``.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.integrate import make_year_fn as jax_year_fn
from energybalancemodel_jl_tpu.models.base import default_step_config as jax_cfg
from energybalancemodel_jl_tpu.models.base import get_model as jax_model
from energybalancemodel_jl_tpu_torch.basins import _polish_fixed_point, _residual_fns

torch.set_num_threads(1)
KW = dict(dtype="float64", device="cpu")
jax_basins = sys.modules["energybalancemodel_jl_tpu.basins"]
# the warm-boundary saddle guess of tests/test_basins.py at sin(8, 1000), F=10
SADDLE = dict(E=np.array([93.6, 72.2, 18.8, -5.9, -15.2, -38.6, -58.5, -75.0]),
              Tg=np.array([8.86, 6.67, 1.29, -12.1, -25.7, -38.8, -50.7, -61.3]))


def jax_residual(model, st, forcing, par, state):
    """JAX's polish residual (``basins.py:755-767``) at ``state``: ``(x0,
    f(x0), jacrev(f)(x0))``."""
    spec = jax_model(model)
    carry = spec.init_carry(state, st, jnp.float64)
    keys = tuple(sorted(carry))
    widths = [carry[k].shape[-1] for k in keys]
    par_j = ebm.Collection({k: jnp.asarray(v, jnp.float64) for k, v in par.items()})
    frow = jnp.asarray(forcing.table(st)[0])
    year = jax_year_fn(model, st, jax_cfg("float64"), "float64", False)

    def from_mat(x):
        out, i = {}, 0
        for k, w in zip(keys, widths):
            out[k] = x[..., i:i + w]
            i += w
        return ebm.Collection(out)

    def res(x):
        nxt = year(from_mat(x), par_j, frow)[0]
        return jnp.concatenate([nxt[k] for k in keys], -1) - x

    x0 = np.concatenate([np.asarray(carry[k]) for k in keys])
    return x0, np.asarray(jax.jit(res)(x0)), np.asarray(jax.jit(jax.jacrev(res))(x0))


@pytest.fixture(scope="module")
def miz_state():
    st = ebm.SpaceTime.sin(8, 50, 40)
    sol = ebm.integrate("MIZ", st, ebm.Forcing(4.0), ebm.default_parameters("MIZ"),
                        ebm.zeros_init(st))
    s = {k: np.array(sol.raw[k][-1]) for k in ("Ei", "Ew", "h", "D", "phi")}
    assert (s["phi"] >= 0.99).any() and (s["phi"] == 0.0).any()
    return s


@pytest.mark.parametrize("model", ["Classic", "MIZ"])
def test_dense_jacobian_and_residual_match_jax(model, miz_state, record_property):
    grid, F, state = (((8, 200), 10.0, SADDLE) if model == "Classic"
                      else ((8, 50), 4.0, miz_state))
    x0j, fj, Jj = jax_residual(model, ebm.SpaceTime.sin(*grid, 1), ebm.Forcing(F),
                               ebm.default_parameters(model), state)
    x0, f, jac, from_mat, dim = _residual_fns(model, ebt.SpaceTime.sin(*grid, 1), ebt.Forcing(F),
                                              ebt.default_parameters(model), state,
                                              torch.float64, torch.device("cpu"))
    np.testing.assert_array_equal(x0, x0j)
    assert dim == x0.size == (16 if model == "Classic" else 48)
    ft, Jt = f(x0), jac(x0)
    rel_f = float(np.max(np.abs(ft - fj)) / np.max(np.abs(fj)))
    rel_J = float(np.max(np.abs(Jt - Jj)) / np.max(np.abs(Jj)))
    record_property("rel_residual", rel_f)
    record_property("rel_jacobian", rel_J)
    assert rel_f <= 1e-12 and rel_J <= 1e-10
    assert sorted(from_mat(x0)) == sorted(jax_model(model).init_carry(state, ebm.SpaceTime.sin(
        *grid, 1), jnp.float64))


def test_trf_polish_matches_jax(record_property):
    st_j, st_t = ebm.SpaceTime.sin(8, 1000, 1), ebt.SpaceTime.sin(8, 1000, 1)
    js, jr, jn = jax_basins._polish_fixed_point(
        "Classic", st_j, ebm.Forcing(10.0), ebm.default_parameters("Classic"), SADDLE,
        "float64", 5)
    ts, tr, tn = _polish_fixed_point("Classic", st_t, ebt.Forcing(10.0),
                                     ebt.default_parameters("Classic"), SADDLE, "float64", 5,
                                     device="cpu")
    record_property("resid_port_jax", f"{tr} {jr}")
    assert tn == jn == 5
    assert abs(tr - jr) <= 1e-2 * jr
    assert sorted(ts) == sorted(js)
    # max_nfev=0 is the residual at the start, one forward year (the guess
    # already sits at this floor: TRF keeps it)
    _, r0, n0 = _polish_fixed_point("Classic", st_t, ebt.Forcing(10.0),
                                    ebt.default_parameters("Classic"), SADDLE, "float64", 0,
                                    device="cpu")
    assert n0 == 0 and r0 >= tr


def test_unstable_branch_from_a_jax_saddle(record_property):
    st_j = ebm.SpaceTime.sin(8, 1000, 1)
    saddle, _, _ = jax_basins._polish_fixed_point(
        "Classic", st_j, ebm.Forcing(10.0), ebm.default_parameters("Classic"), SADDLE,
        "float64", 40)
    saddle = {k: np.asarray(v) for k, v in saddle.items()}
    kw = dict(vary="F", forcing=0.0, polish_max_nfev=4, dtype="float64")
    j = ebm.unstable_branch("Classic", st_j, [10.0, 10.5], ebm.default_parameters("Classic"),
                            saddle, **kw)
    t = ebt.unstable_branch("Classic", ebt.SpaceTime.sin(8, 1000, 1), [10.0, 10.5],
                            ebt.default_parameters("Classic"), saddle, device="cpu", **kw)
    record_property("resid_port_jax", [(a.resid, b.resid) for a, b in zip(t.results, j.results)])
    np.testing.assert_array_equal(t.converged, j.converged)
    np.testing.assert_array_equal(t.ice_area(), j.ice_area())
    np.testing.assert_array_equal(t.years, j.years)
    for a, b in zip(t.results, j.results):
        assert abs(a.resid - b.resid) <= 1e-2 * b.resid
        assert a.member_years is None and sorted(a.state) == sorted(b.state)
    assert isinstance(t, ebt.ContinuationResult) and t.mean("E").shape == (2,)


def test_edge_state_tracker_on_miz(record_property):
    """The tracker's mechanics (fake attractor references; only the
    bisection and flight moves are on trial) and the default drift metric
    over every carry leaf (the MIZ carry has no ``E``)."""
    kw = dict(forcing=0.0, stages=2, probes=2, rounds=1, flight_years=2, flight_chunk=1,
              commit_years=3, commit_tol=100.0, refs=(0.0, 5.0), polish=False,
              stability_check=False)
    out = []
    for mod, extra in ((ebm, {}), (ebt, KW)):
        st = mod.SpaceTime.sin(8, 200, 1)
        a = mod.zeros_init(st)
        b = mod.Collection({k: np.asarray(v) * 0.5 for k, v in a.items()})
        b["h"], b["phi"], b["Ei"] = np.full(8, 2.0), np.full(8, 1.0), np.full(8, -20.0)
        out.append(mod.edge_state("MIZ", st, mod.default_parameters("MIZ"), a, b, **kw, **extra))
    j, t = out
    record_property("drift_port_jax", [t.drift.tolist(), j.drift.tolist()])
    assert t.stages_run == j.stages_run == 2 and np.isfinite(t.drift[1])
    np.testing.assert_array_equal(t.tracked_years, j.tracked_years)
    np.testing.assert_allclose(t.separation, j.separation, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(t.drift, j.drift, rtol=1e-8)
    np.testing.assert_allclose(t.resid, j.resid, rtol=1e-8)
    assert t.polish_nfev == 0 and t.stability is None and not t.converged
    assert "NOT converged" in repr(t)
    with pytest.raises(ValueError, match="metric leaves"):
        ebt.edge_state("MIZ", st, ebt.default_parameters("MIZ"), a, b, metric=("E",), **kw, **KW)


def test_polish_scale_guard():
    st = ebt.SpaceTime.sin(128, 500, 1)  # nt*nx*dim = 4.9e7 > the 3e7 cap
    par = ebt.default_parameters("MIZ")
    with pytest.raises(ValueError, match="practical envelope"):
        _polish_fixed_point("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st), None, 200,
                            device="cpu")
    # the residual alone (max_nfev=0) is one forward year at any size
    _, resid, nfev = _polish_fixed_point("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                                         None, 0, device="cpu")
    assert nfev == 0 and np.isfinite(resid)


def test_validation_errors():
    st, par = ebt.SpaceTime.sin(8, 1000, 1), ebt.default_parameters("Classic")
    warm = dict(E=np.full(8, 40.0), Tg=np.full(8, 40.0) / par["cw"])
    cold = dict(E=np.full(8, -300.0), Tg=np.full(8, -300.0) / par["cw"])
    es = lambda **kw: ebt.edge_state("Classic", st, kw.pop("par", par), kw.pop("a", warm), cold,
                                     **{**dict(forcing=10.0), **kw}, **KW)
    with pytest.raises(ValueError, match="ONE member"):
        es(par=ebt.Collection(par, F=np.array([5.0, 15.0])), forcing=0.0)
    with pytest.raises(ValueError, match="member-batched"):
        es(a=ebt.stack_states([warm, cold]))
    with pytest.raises(ValueError, match="same basin|jump_tol"):
        es(refs=(1.0, 1.2))
    with pytest.raises(ValueError, match="season"):
        es(season="sumer")
    with pytest.raises(ValueError, match="constant"):
        es(forcing=ebt.Forcing(0.0, 5.0, -5.0, (10, 10), (0.5, -0.5)))
    with pytest.raises(ValueError, match="flight_years"):
        es(flight_years=2, flight_chunk=4)
    with pytest.raises(ValueError, match="stages"):
        es(probes=0)
    ub = lambda values=(10.0,), **kw: ebt.unstable_branch(
        "Classic", st, values, kw.pop("par", par), kw.pop("saddle", SADDLE), device="cpu", **kw)
    with pytest.raises(ValueError, match="vary"):
        ub(vary="nope")
    with pytest.raises(ValueError, match="constant"):
        ub(forcing=ebt.Forcing(0.0, 1.0, 0.0, (0, 0), (1.0, -1.0)))
    with pytest.raises(ValueError, match="solo-only"):
        ub(par=ebt.Collection(par, D=np.array([0.5, 0.6])))
    with pytest.raises(ValueError, match="member-batched"):
        ub(saddle=ebt.stack_states([SADDLE, SADDLE]))
    with pytest.raises(ValueError, match="values"):
        ub(values=[])
    with pytest.raises(ValueError, match="polish_max_nfev"):
        ub(polish_max_nfev=0)
