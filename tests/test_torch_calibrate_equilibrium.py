"""``calibrate(equilibrium=True)`` of the PyTorch port against the JAX
package (the fixed point's implicit-function gradient under Adam), float64
on the CPU: one Adam step.

MIZ on ``SpaceTime.sin(8, 50, 1)`` at forcing +4, both packages started from
the port's fixed point there (so the solve takes a few years), fitting ``A``
to an annual-mean ``phi`` target (the fixed point's, plus 0.01; the
adjoint of this objective meets its tolerance in well under its 500-iteration
cap). Bars: the loss after the step, the fitted ``A`` and the gradient at rel
1e-6.
"""
import numpy as np
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt

torch.set_num_threads(1)


def test_one_equilibrium_step_matches_optax(record_property):
    st = ebt.SpaceTime.sin(8, 50, 1)
    par = ebt.default_parameters("MIZ")
    eq = ebt.equilibrate("MIZ", st, 4.0, par, ebt.zeros_init(st), tol=1e-9, max_years=500,
                         dtype="float64", device="cpu")
    target = {"phi": np.asarray(eq.seasonal.avg["phi"]) + 0.01}
    kw = dict(target=target, vary=("A",), steps=1, learning_rate=0.3, equilibrium=True,
              equilibrium_tol=1e-9, equilibrium_max_years=500)
    j = ebm.calibrate("MIZ", ebm.SpaceTime.sin(8, 50, 1), ebm.Forcing(4.0),
                      ebm.default_parameters("MIZ"), eq.state, **kw)
    t = ebt.calibrate("MIZ", st, ebt.Forcing(4.0), par, eq.state, dtype="float64",
                      device="cpu", **kw)
    assert t.losses.shape == (1,) and np.isfinite(t.losses).all()
    record_property("rel_loss", float(abs(t.losses[0] - j.losses[0]) / abs(j.losses[0])))
    record_property("rel_grad", float(abs(t.grads["A"] - j.grads["A"]) / abs(j.grads["A"])))
    np.testing.assert_allclose(t.losses, j.losses, rtol=1e-6)
    np.testing.assert_allclose(t.params["A"], j.params["A"], rtol=1e-6)
    np.testing.assert_allclose(t.grads["A"], j.grads["A"], rtol=1e-6)
    assert float(t.params["A"]) != float(par["A"]) and abs(float(t.grads["A"])) > 0
