"""Reverse mode through the PyTorch port's eager year, against the JAX
package in float64 on the CPU: year gradients (MIZ ``D``/``A``/``Fb``,
Classic ``D``, the Classic albedo-hole init, two chained MIZ years) equal
to ``jax.grad`` at rel 1e-9 and to central finite differences at the JAX
tests' 1e-3 (``tests/test_gradients.py``). The Newton root's VJP itself,
the kernel wrappers' gradient check, the numeric helpers and the import
rule: ``tests/test_torch_newton_vjp.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.integrate import make_year_fn as jax_year_fn
from energybalancemodel_jl_tpu.models.base import StepConfig as JaxStepConfig
from energybalancemodel_jl_tpu.models.base import get_model as jax_model
from energybalancemodel_jl_tpu_torch.integrate import make_year_fn
from energybalancemodel_jl_tpu_torch.models.base import StepConfig, get_model

torch.set_num_threads(1)
F64 = torch.float64
BAR_JAX = 1e-9
BAR_FD = 1e-3


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


# -- year gradients ----------------------------------------------------------

TIGHT = dict(newton_abstol=1e-11, newton_reltol=1e-9)


def jax_loss(model, st, init, name, var="E", years=1):
    year = jax_year_fn(model, st, JaxStepConfig(**TIGHT), "float64", False)
    base = ebm.default_parameters(model)

    def loss(v):
        par = ebm.Collection({k: jnp.float64(x) for k, x in base.items()})
        par[name] = v
        carry = jax_model(model).init_carry(init, st, jnp.float64)
        for _ in range(years):
            carry, seasonal, _, _ = year(carry, par, jnp.zeros(st.nt))
        return jnp.sum(jnp.nan_to_num(seasonal.avg[var]))

    return loss


def port_loss(model, st, init, name, var="E", years=1):
    year = make_year_fn(model, st, StepConfig(**TIGHT), False)
    base = ebt.default_parameters(model)

    def loss(v):
        par = ebt.Collection({k: torch.tensor(float(x), dtype=F64) for k, x in base.items()})
        par[name] = v
        carry = get_model(model).init_carry(init, st, F64, "cpu")
        for _ in range(years):
            carry, seasonal, _, _ = year(carry, par, torch.zeros(st.nt, dtype=F64))
        return torch.sum(torch.nan_to_num(seasonal.avg[var]))

    return loss


def check_year_gradient(model, grid, init, name, value, eps, var="E", years=1, fd=True,
                        record=lambda *a: None):
    st_j, st_t = (getattr(m.SpaceTime, grid[0])(*grid[1:]) for m in (ebm, ebt))
    gj = float(jax.grad(jax_loss(model, st_j, init, name, var, years))(jnp.float64(value)))
    loss = port_loss(model, st_t, init, name, var, years)
    v = torch.tensor(value, dtype=F64, requires_grad=True)
    gp = float(torch.autograd.grad(loss(v), v)[0])
    assert np.isfinite(gp)
    record("rel_vs_jax", rel(gp, gj))
    assert rel(gp, gj) <= BAR_JAX, (name, gp, gj)
    if fd:
        with torch.no_grad():
            d = float((loss(torch.tensor(value + eps, dtype=F64))
                       - loss(torch.tensor(value - eps, dtype=F64))) / (2 * eps))
        record("rel_vs_fd", abs(gp - d) / max(abs(d), 1e-6))
        assert abs(gp - d) <= BAR_FD * max(abs(d), 1e-6), (name, gp, d)
    return gp


MIZ_GRID = ("sin", 16, 50, 1)


@pytest.fixture(scope="module")
def miz_gradients():
    """d sum(avg E)/d(D, A, Fb) after one MIZ year from zero init: one
    ``jax.grad`` and one backward for the three (one compilation)."""
    st_j, st_t = (getattr(m.SpaceTime, MIZ_GRID[0])(*MIZ_GRID[1:]) for m in (ebm, ebt))
    init = ebm.zeros_init(st_j)
    names = ("D", "A", "Fb")
    base = ebm.default_parameters("MIZ")
    jyear = jax_year_fn("MIZ", st_j, JaxStepConfig(**TIGHT), "float64", False)

    def jloss(over):
        par = ebm.Collection({k: jnp.float64(x) for k, x in base.items()})
        par.update(over)
        carry = jax_model("MIZ").init_carry(init, st_j, jnp.float64)
        return jnp.sum(jnp.nan_to_num(jyear(carry, par, jnp.zeros(st_j.nt))[1].avg["E"]))

    gj = jax.grad(jloss)({n: jnp.float64(base[n]) for n in names})
    year = make_year_fn("MIZ", st_t, StepConfig(**TIGHT), False)
    leaves = {n: torch.tensor(float(base[n]), dtype=F64, requires_grad=True) for n in names}
    par = ebt.Collection({k: torch.tensor(float(x), dtype=F64) for k, x in base.items()})
    par.update(leaves)
    carry = get_model("MIZ").init_carry(init, st_t, F64, "cpu")
    total = torch.sum(torch.nan_to_num(year(carry, par, torch.zeros(st_t.nt, dtype=F64))[1]
                                       .avg["E"]))
    gp = torch.autograd.grad(total, [leaves[n] for n in names])
    return {n: (float(gj[n]), float(g)) for n, g in zip(names, gp)}, st_t, init


@pytest.mark.parametrize("name,value,eps", [("D", 0.6, 1e-6), ("A", 193.0, 1e-5),
                                            ("Fb", 4.0, 1e-6)])
def test_miz_year_gradient(miz_gradients, name, value, eps, record_property):
    grads, st, init = miz_gradients
    gj, gp = grads[name]
    assert np.isfinite(gp) and rel(gp, gj) <= BAR_JAX, (name, gp, gj)
    loss = port_loss("MIZ", st, init, name)
    with torch.no_grad():
        d = float((loss(torch.tensor(value + eps, dtype=F64))
                   - loss(torch.tensor(value - eps, dtype=F64))) / (2 * eps))
    record_property("rel_vs_jax", rel(gp, gj))
    record_property("rel_vs_fd", abs(gp - d) / max(abs(d), 1e-6))
    assert abs(gp - d) <= BAR_FD * max(abs(d), 1e-6), (name, gp, d)


def test_miz_gradient_through_two_chained_years(record_property):
    check_year_gradient("MIZ", ("sin", 12, 40, 1), ebm.zeros_init(ebm.SpaceTime.sin(12, 40, 1)),
                        "D", 0.6, 1e-6, var="phi", years=2, record=record_property)


def test_classic_year_gradient(record_property):
    E0 = np.full(16, 30.0)
    init = ebm.Collection(E=E0, Tg=E0 / float(ebm.default_parameters("Classic")["cw"]))
    check_year_gradient("Classic", ("identity", 16, 1000, 1), init, "D", 0.6, 1e-6,
                        record=record_property)


def test_classic_gradient_from_the_albedo_hole_init(record_property):
    """E = 0 everywhere: the guarded kLf/E lanes; JAX's test asks for a finite
    gradient, here it also equals JAX's."""
    init = ebm.Collection(E=np.zeros(12), Tg=np.zeros(12))
    check_year_gradient("Classic", ("identity", 12, 1000, 1), init, "A", 193.0, 1e-5, fd=False,
                        record=record_property)
