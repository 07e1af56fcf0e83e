"""``stability`` of the PyTorch port against the JAX package, float64 on
the CPU, linearized at one MIZ state (``SpaceTime.sin(8, 50)``, forcing +4,
40 years from zero init: open water and fully ice-covered cells).

Bars:
- ``history`` (hence ``growth``) and ``eigenvalues`` equal to JAX's at rel
  1e-6 for ``n_modes`` 1 and 2, ``side`` adjoint and right, with and without
  ``project``; modes equal up to sign at 1e-6. Both packages start from the
  same seeded draws (``np.random.default_rng(seed)``, leaf by leaf in carry
  order), so the iterations agree step by step;
- ``J v`` and ``J^T v`` (the products the iteration applies) equal to the
  dense Jacobian (``torch.autograd.functional.jacobian``) to 1e-10;
- an ensemble's members equal their solo runs at 1e-10; every
  ``ValueError`` the JAX tests check.
"""
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.equilibrium import _Linearization
from energybalancemodel_jl_tpu_torch.integrate import make_year_fn
from energybalancemodel_jl_tpu_torch.models.base import default_step_config, get_model

torch.set_num_threads(1)
NX, NT, F = 8, 50, 4.0
BAR = 1e-6
KW = dict(dtype="float64", device="cpu")


@pytest.fixture(scope="module")
def state():
    st = ebt.SpaceTime.sin(NX, NT, 40)
    sol = ebt.integrate("MIZ", st, ebt.Forcing(F), ebt.default_parameters("MIZ"),
                        ebt.zeros_init(st), raw_mode="last", progress=False, **KW)
    s = ebt.Collection({k: np.array(sol.raw[k][-1]) for k in ("Ei", "Ew", "h", "D", "phi")})
    assert (s["phi"] >= 0.99).any() and (s["phi"] == 0.0).any()
    return s


def both(state, **kw):
    j = ebm.stability("MIZ", ebm.SpaceTime.sin(NX, NT, 1), ebm.Forcing(F),
                      ebm.default_parameters("MIZ"), state, **kw)
    t = ebt.stability("MIZ", ebt.SpaceTime.sin(NX, NT, 1), ebt.Forcing(F),
                      ebt.default_parameters("MIZ"), state, **kw, **KW)
    return j, t


@pytest.mark.parametrize("n_modes,side,project", [
    (1, "adjoint", ()),
    (2, "adjoint", ("Ew", "phi")),
    (1, "right", ("Ew", "phi")),
    (2, "right", ("Ew", "phi")),
])
def test_stability_matches_jax(state, n_modes, side, project, record_property):
    j, t = both(state, n_iter=8, n_modes=n_modes, side=side, project=project)
    record_property("max_rel_history", float(np.max(np.abs(t.history - j.history)
                                                    / np.abs(j.history))))
    record_property("max_rel_eigenvalues", float(np.max(np.abs(t.eigenvalues - j.eigenvalues)
                                                        / np.abs(j.eigenvalues))))
    assert t.history.shape == j.history.shape
    np.testing.assert_allclose(t.history, j.history, rtol=BAR)
    np.testing.assert_allclose(t.growth, j.growth, rtol=BAR)
    np.testing.assert_allclose(t.eigenvalues, j.eigenvalues, rtol=BAR)
    assert t.side == side and t.n_modes == n_modes
    for k in j.mode:
        a, b = np.asarray(t.mode[k]), np.asarray(j.mode[k])
        assert a.shape == b.shape
        if n_modes == 1:
            a, b = a[None], b[None]
        for i in range(n_modes):  # each mode up to its sign
            s = 1.0 if np.dot(a[i].ravel(), b[i].ravel()) >= 0 else -1.0
            np.testing.assert_allclose(s * a[i], b[i], rtol=BAR, atol=BAR, err_msg=k)
    if project:
        frozen = state["phi"] >= 0.99
        for k in project:
            assert np.all(np.asarray(t.mode[k])[..., frozen] == 0.0)
    assert "StabilityResult" in repr(t)


def test_products_equal_the_dense_jacobian(state, record_property):
    st = ebt.SpaceTime.sin(NX, NT, 1)
    spec = get_model("MIZ")
    year = make_year_fn("MIZ", st, default_step_config("float64"), False)
    par = ebt.Collection({k: torch.tensor(float(v), dtype=torch.float64)
                          for k, v in ebt.default_parameters("MIZ").items()})
    frow = torch.full((NT,), F, dtype=torch.float64)
    carry = spec.init_carry(state, st, torch.float64, "cpu")
    keys = tuple(carry.keys())
    sizes = [carry[k].numel() for k in keys]

    def flat_map(x):
        c = ebt.Collection(zip(keys, torch.split(x, sizes)))
        out = year(c, par, frow)[0]
        return torch.cat([out[k] for k in keys])

    J = torch.autograd.functional.jacobian(flat_map, torch.cat([carry[k] for k in keys]))
    v = torch.tensor(np.random.default_rng(9).normal(size=sum(sizes)))
    vc = ebt.Collection(zip(keys, torch.split(v, sizes)))
    for side, dense in (("right", J @ v), ("adjoint", J.T @ v)):
        lin = _Linearization(year, carry, par, frow, keys, side)
        got = torch.cat([lin.apply(vc)[k] for k in keys])
        record_property(f"max_abs_{side}", float((got - dense).abs().max()))
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-10, atol=1e-10,
                                   err_msg=side)


def test_ensemble_members_equal_solo_and_F_sweep(state):
    st = ebt.SpaceTime.sin(NX, NT, 1)
    par = ebt.Collection(ebt.default_parameters("MIZ"), F=np.array([F, F + 1.0]))
    init = ebt.Collection({k: np.stack([v, v]) for k, v in state.items()})
    ens = ebt.stability("MIZ", st, 0.0, par, init, n_iter=4, seed=3, **KW)
    assert ens.growth.shape == (2,) and ens.history.shape == (4, 2)
    assert "members" in repr(ens)
    for i, f in enumerate((F, F + 1.0)):
        # the solo run's seeded draw is member i's share of the ensemble's
        g = np.random.default_rng(3)
        draws = {k: g.standard_normal((2, v.shape[-1])) for k, v in
                 get_model("MIZ").init_carry(state, st, torch.float64, "cpu").items()}
        solo = ebt.stability("MIZ", st, f, ebt.default_parameters("MIZ"), state, n_iter=4,
                             v0=ebt.Collection({k: d[i] for k, d in draws.items()}), **KW)
        np.testing.assert_allclose(ens.history[:, i], solo.history, rtol=1e-10)


def test_stability_validation(state):
    st = ebt.SpaceTime.sin(NX, NT, 1)
    par = ebt.default_parameters("MIZ")
    cst = ebt.SpaceTime.sin(8, 1000, 1)
    cpar = ebt.default_parameters("Classic")
    cinit = ebt.Collection(E=np.full(8, 40.0), Tg=np.full(8, 40.0) / cpar["cw"])
    with pytest.raises(ValueError, match="constant forcing"):
        ebt.stability("MIZ", st, ebt.Forcing(0.0, 1.0, -1.0, (2, 2), (0.5, -0.5)), par, state,
                      **KW)
    with pytest.raises(ValueError, match="n_iter"):
        ebt.stability("MIZ", st, 0.0, par, state, n_iter=1, **KW)
    with pytest.raises(ValueError, match="not in the Classic carry"):
        ebt.stability("Classic", cst, 0.0, cpar, cinit, project=("Ew",), **KW)
    with pytest.raises(ValueError, match="side"):
        ebt.stability("MIZ", st, 0.0, par, state, side="left", **KW)
    with pytest.raises(ValueError, match="n_modes"):
        ebt.stability("MIZ", st, 0.0, par, state, n_modes=0, **KW)
    with pytest.raises(ValueError, match="n_modes"):
        ebt.stability("MIZ", st, 0.0, par, state, n_modes=10_000, **KW)
    with pytest.raises(ValueError, match="inconsistent ensemble sizes"):
        ebt.stability("MIZ", st, 0.0, ebt.Collection(par, D=np.ones(2), A=np.ones(3)), state,
                      **KW)
    with pytest.raises(ValueError, match="v0 leaves"):
        ebt.stability("MIZ", st, 0.0, par, state, v0={"Ei": np.zeros(3)}, **KW)
    # mesh= (ported with M14: tests/test_torch_parallel.py) takes a port Mesh
    with pytest.raises(TypeError, match="Mesh"):
        ebt.stability("MIZ", st, 0.0, par, state, mesh=object(), **KW)
