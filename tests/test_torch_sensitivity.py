"""``sensitivity`` of the PyTorch port against the JAX package with JAX's
own defaults (``of="ice_area"``, ``tol=1e-9``, ``max_years=500``, the
adjoint's 500-iteration cap), float64 on the CPU, on ``SpaceTime.sin(8,
50)`` at forcing +4 from zero init: an ice edge whose area moves with the
parameters (at forcing 0 this grid's attractor is locally flat, every
gradient exactly 0).

Bars: the value at rel 1e-10; every gradient, ``"F"`` included, at rel 1e-6
on top of an absolute 1e-15 for leaves that are zero up to round-off in both
(``Dmax`` and ``alpha`` read 1e-19..1e-17 here).
"""
import numpy as np
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt

torch.set_num_threads(1)
NX, NT, F = 8, 50, 4.0


def test_sensitivity_with_jax_defaults_matches_jax(record_property):
    st_j = ebm.SpaceTime.sin(NX, NT, 1)
    j = ebm.sensitivity("MIZ", st_j, ebm.Forcing(F), ebm.default_parameters("MIZ"),
                        ebm.zeros_init(st_j))
    st = ebt.SpaceTime.sin(NX, NT, 1)
    t = ebt.sensitivity("MIZ", st, ebt.Forcing(F), ebt.default_parameters("MIZ"),
                        ebt.zeros_init(st), dtype="float64", device="cpu")
    assert t.of == j.of == "ice_area"
    np.testing.assert_allclose(t.value, j.value, rtol=1e-10)
    assert sorted(t.grads) == sorted(j.grads)
    record_property("max_rel_grads_above_1e-12", max(
        abs(float(t.grads[k]) - float(j.grads[k])) / abs(float(j.grads[k]))
        for k in j.grads if abs(float(j.grads[k])) > 1e-12))
    for k in j.grads:
        a, b = float(t.grads[k]), float(j.grads[k])
        assert abs(a - b) <= 1e-6 * abs(b) + 1e-15, (k, a, b)
    assert sum(abs(float(g)) > 1e-6 for g in t.grads.values()) >= 10  # gradient-alive
    assert [r[0] for r in t.top(5)] == [r[0] for r in j.top(5)]
    assert "SensitivityResult" in repr(t)
