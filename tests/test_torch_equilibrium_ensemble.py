"""``sensitivity`` of a lockstep ensemble in the PyTorch port: each member
equals its solo run, float64 on the CPU, at the bars of JAX
``tests/test_sensitivity.py:78-95`` (value rel 1e-10, ``dg/dA`` rel 1e-7,
``dg/dF`` rel 1e-6). The JAX package gets this by ``vmap``; the port runs
the members as one ``(K, nx)`` batch whose fixed-point and adjoint loops
stop each member where its solo run stops.

``SpaceTime.sin(8, 50)``, forcing offsets +4 and +4.5 as the virtual ``"F"``
parameter, both members started from the +4 fixed point, the adjoint capped
at 40 iterations as in ``tests/test_torch_equilibrium_sensitivity.py``.
"""
import importlib

import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch import equilibrium

torch.set_num_threads(1)
ST = ebt.SpaceTime.sin(8, 50, 1)
KW = dict(dtype="float64", device="cpu")
UNCAPPED = equilibrium.make_equilibrium_seasonal_fn
# the module (the package exports the function under the same name)
SENSITIVITY = importlib.import_module("energybalancemodel_jl_tpu_torch.sensitivity")


@pytest.fixture(autouse=True)
def cap_the_adjoint(monkeypatch):
    monkeypatch.setattr(SENSITIVITY, "make_equilibrium_seasonal_fn",
                        lambda *a, **kw: UNCAPPED(*a, **dict(kw, bwd_max_iters=40)))


def test_ensemble_members_match_solo_runs():
    par = ebt.default_parameters("MIZ")
    state = ebt.equilibrate("MIZ", ST, 4.0, par, ebt.zeros_init(ST), tol=1e-9, max_years=500,
                            **KW).state
    offsets = (4.0, 4.5)
    ens = ebt.sensitivity("MIZ", ST, 0.0, ebt.Collection(par, F=np.array(offsets)), state,
                          **KW)
    assert np.asarray(ens.value).shape == (2,)
    assert np.asarray(ens.grads["A"]).shape == (2,)
    for i, F in enumerate(offsets):
        solo = ebt.sensitivity("MIZ", ST, F, par, state, **KW)
        np.testing.assert_allclose(ens.value[i], solo.value, rtol=1e-10)
        np.testing.assert_allclose(ens.grads["A"][i], solo.grads["A"], rtol=1e-7)
        np.testing.assert_allclose(ens.grads["F"][i], solo.grads["F"], rtol=1e-6)
        for k in solo.grads:  # every leaf, at the loosest of those bars
            np.testing.assert_allclose(ens.grads[k][i], solo.grads[k], rtol=1e-6, atol=1e-15,
                                       err_msg=k)
    assert len(ens.top(3)) == 3
    assert "members" in repr(ens)
