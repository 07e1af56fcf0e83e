"""The differentiable fixed point (``make_equilibrium_seasonal_fn``) of the
PyTorch port against the JAX package, float64 on the CPU.

``SpaceTime.sin(8, 50)``, forcing +4 (an ice edge whose area moves with the
parameters), zero init, the fixed point solved to 1e-9 within 500 years, the
adjoint's Picard loop capped at ``bwd_max_iters=40`` in both packages, so
that its per-leaf freezing and the cap itself decide the returned values.

Bars: the value at rel 1e-10; every parameter leaf's gradient and the
forcing row's cotangent at rel 1e-6, on top of an absolute 1e-15 for leaves
that are zero up to round-off in both (``Dmax`` and ``alpha`` here read
1e-19..1e-17); the initial carry's cotangent zero, as JAX returns it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.equilibrium import make_equilibrium_seasonal_fn as jax_eq_fn
from energybalancemodel_jl_tpu.models.base import default_step_config as jax_cfg
from energybalancemodel_jl_tpu.models.base import get_model as jax_model
from energybalancemodel_jl_tpu.utils.numerics import hemispheric_mean as jax_hemi
from energybalancemodel_jl_tpu_torch.equilibrium import make_equilibrium_seasonal_fn
from energybalancemodel_jl_tpu_torch.models.base import default_step_config, get_model

torch.set_num_threads(1)
NX, NT, F = 8, 50, 4.0
CAP = dict(tol=1e-9, max_years=500, bwd_max_iters=40)
REL, ABS = 1e-6, 1e-15


def assert_close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.all(np.abs(a - b) <= REL * np.abs(b) + ABS), (what, a, b)


def test_fixed_point_gradient_matches_jax(record_property):
    base = ebt.default_parameters("MIZ")
    st_j = ebm.SpaceTime.sin(NX, NT, 1)
    fn_j = jax_eq_fn("MIZ", st_j, jax_cfg("float64"), "float64", **CAP)
    carry_j = jax_model("MIZ").init_carry(ebm.zeros_init(st_j), st_j, jnp.float64)

    def area_j(p, f):
        s = fn_j(p, f, carry_j)
        return 2.0 * jnp.pi * jax_hemi(jnp.nan_to_num(s.avg["phi"]), jnp.asarray(st_j.x))

    vj, (pj, fj) = jax.value_and_grad(area_j, argnums=(0, 1))(
        {k: jnp.float64(v) for k, v in base.items()}, jnp.full(NT, F))

    st = ebt.SpaceTime.sin(NX, NT, 1)
    fn = make_equilibrium_seasonal_fn("MIZ", st, default_step_config("float64"), "float64", **CAP)
    par = ebt.Collection({k: torch.tensor(float(v), dtype=torch.float64, requires_grad=True)
                          for k, v in base.items()})
    frow = torch.full((NT,), F, dtype=torch.float64, requires_grad=True)
    carry = get_model("MIZ").init_carry(ebt.zeros_init(st), st, torch.float64, "cpu")
    carry = ebt.Collection({k: v.requires_grad_(True) for k, v in carry.items()})
    s = fn(par, frow, carry)
    v = 2.0 * np.pi * ebt.hemispheric_mean(torch.nan_to_num(s.avg["phi"]), st.x)
    grads = torch.autograd.grad(v, list(par.values()) + [frow] + list(carry.values()),
                                allow_unused=True)
    np.testing.assert_allclose(float(v.detach()), float(vj), rtol=1e-10)
    rels = [abs(float(g) - float(pj[k])) / abs(float(pj[k]))
            for (k, _), g in zip(par.items(), grads) if abs(float(pj[k])) > 1e-12]
    record_property("max_rel_leaves_above_1e-12", max(rels))
    alive = 0
    for (k, _), g in zip(par.items(), grads):
        assert_close(g.numpy(), pj[k], k)
        alive += abs(float(g)) > 1e-6
    assert alive >= 10  # the configuration is gradient-alive
    assert_close(grads[len(par)].numpy(), fj, "frow")
    for g in grads[len(par) + 1:]:
        assert g is None or not g.any()


def test_a_leaf_without_a_finite_increment_warns():
    """A leaf whose backward increments are never finite returns 0, as JAX's
    does, and the port says so with a RuntimeWarning. The toy year map
    ``c -> c/2 + a + 0*sqrt(b)`` at ``b = 0`` has a finite forward and a NaN
    VJP for ``b`` (``0 * inf``)."""
    import pytest

    from energybalancemodel_jl_tpu_torch.equilibrium import _FixedPoint, _FixedPointSpec

    def step(c, p, f):
        return ebt.Collection(x=0.5 * c["x"] + p["a"] + 0.0 * torch.sqrt(p["b"]) + f.sum())

    spec = _FixedPointSpec(step, ("x",), ("a", "b"), False, 1e-12, 200, 1e-12, 100)
    a = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    b = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
    f = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    (x,) = _FixedPoint.apply(spec, torch.zeros(4, dtype=torch.float64), a, b, f)
    np.testing.assert_allclose(x.detach().numpy(), 2.0, rtol=1e-10)
    with pytest.warns(RuntimeWarning, match="gradient of b:"):
        ga, gb, gf = torch.autograd.grad(x.sum(), [a, b, f])
    # d x*/d a = 1 / (1 - 1/2) per entry, four entries
    np.testing.assert_allclose(float(ga), 8.0, rtol=1e-9)
    assert float(gb) == 0.0 and torch.isfinite(gf).all()
