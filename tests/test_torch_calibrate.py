"""``calibrate`` of the PyTorch port against the JAX package (scan mode:
backprop through every year), float64 on the CPU, ``torch.optim.Adam``
against ``optax.adam``.

MIZ on ``SpaceTime.sin(8, 50, 1)`` from zero init, fitting ``D`` and ``A``
to a target annual-mean ``E`` (the default run's, plus 1), five Adam steps,
one start and two starts (``theta0``). Bars: losses, fitted values and the
final gradients at rel 1e-6. The default loss's NaN rules and every
``ValueError`` of ``tests/test_calibrate.py`` are held too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.calibrate import _default_loss as jax_default_loss
from energybalancemodel_jl_tpu_torch.calibrate import _default_loss

torch.set_num_threads(1)
REL = 1e-6
KW = dict(dtype="float64", device="cpu")


def setup(mod):
    st = mod.SpaceTime.sin(8, 50, 1)
    return st, mod.Collection(mod.default_parameters("MIZ"), D=0.58), mod.zeros_init(st)


@pytest.fixture(scope="module")
def target():
    st = ebt.SpaceTime.sin(8, 50, 1)
    sol = ebt.integrate("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                        ebt.zeros_init(st), raw_mode="none", progress=False, **KW)
    return {"E": np.nan_to_num(sol.seasonal.avg["E"][-1]) + 1.0}


def assert_same(t, j, multi=False):
    np.testing.assert_allclose(t.losses, j.losses, rtol=REL)
    for k in j.params:
        np.testing.assert_allclose(t.params[k], j.params[k], rtol=REL, err_msg=k)
        np.testing.assert_allclose(t.grads[k], j.grads[k], rtol=REL, err_msg=k)
    if multi:
        assert t.best == j.best
        np.testing.assert_allclose(t.start_losses, j.start_losses, rtol=REL)
        for k in j.start_params:
            np.testing.assert_allclose(t.start_params[k], j.start_params[k], rtol=REL)


@pytest.mark.parametrize("starts", [None, {"D": [0.58, 0.6], "A": [193.0, 192.0]}])
def test_scan_mode_matches_optax(target, starts, record_property):
    kw = dict(target=target, vary=("D", "A"), steps=5, learning_rate=1e-3, theta0=starts)
    st, par, init = setup(ebm)
    j = ebm.calibrate("MIZ", st, ebm.Forcing(0.0), par, init, **kw)
    st, par, init = setup(ebt)
    t = ebt.calibrate("MIZ", st, ebt.Forcing(0.0), par, init, **kw, **KW)
    assert t.losses.shape == (5,)
    assert t.losses[-1] < t.losses[0]
    record_property("max_rel_losses", float(np.max(np.abs(t.losses - j.losses)
                                                   / np.abs(j.losses))))
    assert_same(t, j, multi=starts is not None)
    assert "CalibrationResult" in repr(t)


def test_custom_loss_and_optimizer():
    """A callable objective on the final year's store (here as in JAX's
    test, the mean enthalpy driven toward 45) and a custom optimizer."""
    st, par, init = setup(ebt)
    res = ebt.calibrate("MIZ", st, ebt.Forcing(0.0), par, init,
                        loss=lambda s: (torch.mean(s.avg["E"]) - 45.0) ** 2, vary=("A",),
                        steps=3, learning_rate=0.5, **KW)
    st_j, par_j, init_j = setup(ebm)
    j = ebm.calibrate("MIZ", st_j, ebm.Forcing(0.0), par_j, init_j,
                      loss=lambda s: (jnp.mean(s.avg["E"]) - 45.0) ** 2, vary=("A",),
                      steps=3, learning_rate=0.5)
    assert_same(res, j)
    loss = lambda s: (torch.mean(s.avg["E"]) - 45.0) ** 2
    start = ebt.calibrate("MIZ", st, ebt.Forcing(0.0), par, init, loss=loss, vary=("A",),
                          steps=0, **KW)  # its grads: the gradient at the start
    sgd = ebt.calibrate("MIZ", st, ebt.Forcing(0.0), par, init, loss=loss, vary=("A",),
                        steps=1, optimizer=lambda p: torch.optim.SGD(p, lr=1e-3), **KW)
    np.testing.assert_allclose(float(sgd.params["A"]),
                               float(par["A"]) - 1e-3 * float(start.grads["A"]), rtol=1e-14)


@pytest.mark.parametrize("case", ["nan_target", "one_sided", "diverged", "presentation"])
def test_default_loss_matches_jax(case):
    pred = {"nan_target": [5.0, 2.0, 3.0], "one_sided": [5.0, 2.0, 3.0],
            "diverged": [np.nan, 2.0, 3.0], "presentation": [np.nan, 2.0, 3.0]}[case]
    tgt = {"nan_target": [np.nan] * 3, "one_sided": [np.nan, 2.0, 3.0],
           "diverged": [1.0, 2.0, 3.0], "presentation": [1.0, 2.0, 3.0]}[case]
    var = "Ti" if case == "presentation" else "E"
    mk = lambda mod, arr: mod.solutions.Seasonal(*(mod.Collection({var: arr}),) * 3)
    got = _default_loss({var: np.array(tgt)}, nan_ok=("Ti", "Tw"))(
        mk(ebt, torch.tensor(pred, dtype=torch.float64)))
    want = jax_default_loss({var: np.array(tgt)}, nan_ok=("Ti", "Tw"))(
        mk(ebm, jnp.array(pred)))
    assert float(got) == float(want)


def test_steps_zero_warning_and_validation(target):
    st, par, init = setup(ebt)
    res = ebt.calibrate("MIZ", st, ebt.Forcing(0.0), par, init, target=target, vary=("A",),
                        steps=0, **KW)
    assert "0 steps" in repr(res) and float(res.params["A"]) == float(par["A"])
    saved = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float32)
        with pytest.warns(UserWarning, match="float32"):
            ebt.calibrate("MIZ", st, ebt.Forcing(0.0), par, init, target=target, vary=("A",),
                          steps=0, device="cpu")
    finally:
        torch.set_default_dtype(saved)
    t = {"E": np.zeros(st.nx)}
    cases = [
        (dict(), "exactly one"),
        (dict(target=t, vary=("bogus",)), "not in par"),
        (dict(target={"nope": np.zeros(st.nx)}, vary=("A",)), "target variables"),
        (dict(target=t, vary=("A",), n_starts=0), "n_starts must be"),
        (dict(target=t, vary=("A", "B"), theta0={"A": np.array([1.0])}), "missing varied names"),
        (dict(target=t, vary=("A", "B"), theta0={"A": np.array([1.0, 2.0]),
                                                 "B": np.array([1.0, 2.0, 3.0])}),
         "share one length"),
        (dict(target=t, vary=("A",), n_starts=3, theta0={"A": np.array([1.0, 2.0])}),
         "conflicts with theta0"),
        (dict(target=t, vary=("A",), equilibrium=True,
              forcing=ebt.Forcing(0.0, 1.0, -1.0, (2, 2), (0.5, -0.5))), "constant"),
    ]
    for kw, match in cases:
        forcing = kw.pop("forcing", ebt.Forcing(0.0))
        with pytest.raises(ValueError, match=match):
            ebt.calibrate("MIZ", st, forcing, par, init, **kw, **KW)
