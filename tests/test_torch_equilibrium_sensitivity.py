"""``sensitivity`` of the PyTorch port held against the port's own
differentiable fixed point (``make_equilibrium_seasonal_fn``) plus the
objective, float64 on the CPU (``tests/test_torch_sensitivity.py`` holds a
run with JAX's defaults against the JAX package).

``SpaceTime.sin(8, 50)``, forcing +4, started from that forcing's fixed
point (so each solve takes a few years), the adjoint's Picard loop capped
at 40 iterations here (``sensitivity`` has no cap of its own: its 500 would
take minutes on this CPU; the cap and the loop are held against JAX in
``tests/test_torch_equilibrium_adjoint.py``). Bars: ``sensitivity`` equals the
fixed point's gradient by hand bitwise (the same computation), for
``of="ice_area"`` and ``of="mean"``; a scalar ``"F"`` in ``par`` equals the
forcing folded into the base at rel 1e-10 (JAX
``tests/test_sensitivity.py:97-103``); ``wrt`` keeps the named leaves;
every ``ValueError`` of ``tests/test_sensitivity.py``.
"""
import importlib
import math

import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch import equilibrium
from energybalancemodel_jl_tpu_torch.models.base import default_step_config, get_model

torch.set_num_threads(1)
NX, NT, F = 8, 50, 4.0
ST = ebt.SpaceTime.sin(NX, NT, 1)
KW = dict(dtype="float64", device="cpu")
CAP = 40


def capped_fn(*args, **kw):
    return UNCAPPED(*args, **dict(kw, bwd_max_iters=CAP))


UNCAPPED = equilibrium.make_equilibrium_seasonal_fn
# the module (the package exports the function under the same name)
SENSITIVITY = importlib.import_module("energybalancemodel_jl_tpu_torch.sensitivity")


@pytest.fixture(scope="module", autouse=True)
def cap_the_adjoint():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SENSITIVITY, "make_equilibrium_seasonal_fn", capped_fn)
        yield


@pytest.fixture(scope="module")
def eq_state():
    eq = ebt.equilibrate("MIZ", ST, F, ebt.default_parameters("MIZ"), ebt.zeros_init(ST),
                         tol=1e-9, max_years=500, **KW)
    assert eq.converged
    return eq.state


def by_hand(state, objectives):
    """Value and gradients of each objective through the fixed point,
    written out: the parameters and the forcing row as leaves."""
    fn = capped_fn("MIZ", ST, default_step_config("float64"), "float64")
    par = ebt.Collection({k: torch.tensor(float(v), dtype=torch.float64, requires_grad=True)
                          for k, v in ebt.default_parameters("MIZ").items()})
    frow = torch.full((NT,), F, dtype=torch.float64, requires_grad=True)
    carry = get_model("MIZ").init_carry(state, ST, torch.float64, "cpu")
    s = fn(par, frow, carry).avg
    out = []
    for objective in objectives:
        value = objective(s)
        g = torch.autograd.grad(value, list(par.values()) + [frow], retain_graph=True)
        grads = {k: float(x) for k, x in zip(par, g[:-1])}
        grads["F"] = float(g[-1].numpy().sum())
        out.append((float(value.detach()), grads))
    return out


@pytest.fixture(scope="module")
def area_result(cap_the_adjoint, eq_state):
    return ebt.sensitivity("MIZ", ST, F, ebt.default_parameters("MIZ"), eq_state, **KW)


def test_matches_the_fixed_point_by_hand(eq_state, area_result):
    x = torch.as_tensor(ST.x, dtype=torch.float64)
    area = lambda s: 2.0 * math.pi * ebt.hemispheric_mean(torch.nan_to_num(s["phi"]), ST.x)
    mean_E = lambda s: ebt.hemispheric_mean(torch.nan_to_num(s["E"]), x) / (x[-1] - x[0])
    hand = by_hand(eq_state, (area, mean_E))
    mean = ebt.sensitivity("MIZ", ST, F, ebt.default_parameters("MIZ"), eq_state, of="mean",
                           var="E", **KW)
    for (value, grads), res in zip(hand, (area_result, mean)):
        assert res.value == value
        assert dict(res.grads) == grads
    assert area_result.of == "ice_area" and mean.of == "mean(E)"
    res = mean
    assert grads["F"] > 0  # warming raises the mean enthalpy
    rows = res.top(5)
    mags = [abs(e) for _, _, e in rows]
    assert mags == sorted(mags, reverse=True)


def test_scalar_F_folds_into_forcing_and_wrt(eq_state, area_result):
    par = ebt.Collection(ebt.default_parameters("MIZ"), F=1.0)
    folded = ebt.sensitivity("MIZ", ST, F - 1.0, par, eq_state, wrt=("A", "D", "F"), **KW)
    assert sorted(folded.grads) == ["A", "D", "F"]
    np.testing.assert_allclose(folded.value, area_result.value, rtol=1e-10)
    for k in folded.grads:
        np.testing.assert_allclose(folded.grads[k], area_result.grads[k], rtol=1e-10, err_msg=k)
    assert folded.par["F"] == F


def test_sensitivity_validation():
    par, init = ebt.default_parameters("MIZ"), ebt.zeros_init(ST)
    ramp = ebt.Forcing(0.0, 5.0, -5.0, (10, 10), (0.5, -0.5))
    with pytest.raises(ValueError, match="constant"):
        ebt.sensitivity("MIZ", ST, ramp, par, init, **KW)
    with pytest.raises(ValueError, match="inconsistent"):
        ebt.sensitivity("MIZ", ST, 0.0, ebt.Collection(par, D=np.array([0.5, 0.6]),
                                                      A=np.array([193.0, 195.0, 197.0])),
                        init, **KW)
    cpar = ebt.default_parameters("Classic")
    cinit = ebt.Collection(E=np.full(NX, 40.0), Tg=np.full(NX, 40.0) / cpar["cw"])
    with pytest.raises(ValueError, match="zero gradient"):
        ebt.sensitivity("Classic", ST, 2.0, cpar, cinit, **KW)
    with pytest.raises(ValueError, match="var="):
        ebt.sensitivity("MIZ", ST, 0.0, par, init, of="mean", **KW)
    with pytest.raises(ValueError, match="unknown objective"):
        ebt.sensitivity("MIZ", ST, 0.0, par, init, of="nope", **KW)
    with pytest.raises(ValueError, match="wrt"):
        ebt.sensitivity("MIZ", ST, 0.0, par, init, wrt=("nope",), **KW)
    with pytest.warns(UserWarning, match="float32"):
        with pytest.raises(ValueError, match="wrt"):
            ebt.sensitivity("MIZ", ST, 0.0, par, init, wrt=("nope",), dtype="float32",
                            device="cpu")
