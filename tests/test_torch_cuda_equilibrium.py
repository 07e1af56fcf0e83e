"""The equilibrium layer of the PyTorch port on a CUDA device.

Every test here needs a CUDA device and nvcc; without them each skips (the
kernels have no CPU mode). Run on the card with ``python -m pytest
--noconftest tests/test_torch_cuda_equilibrium.py`` (the repo's conftest
imports jax).

- The four kernel wrappers refuse inputs that require grad (their kernels
  have no VJP) instead of returning a result with no gradient.
- ``equilibrate`` on the fused engine: one ``miz_year`` launch per simulated
  year, and ensemble members equal to their solo runs bitwise over 20 years
  (the kernel runs each member's Newton loop on its own).
- The differentiable fixed point on the card equals the CPU's at rel 1e-9
  (the eager year, both float64).
- The Arrhenius test of ``tests/test_stochastic_oracle.py`` (part b): ln(escape
  rate) against 1/sigma^2 over 300 Classic years at sigma 9/11/13, held to
  the JAX test's bars (rates positive and rising, slope negative,
  correlation below -0.98).
"""
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.equilibrium import make_equilibrium_seasonal_fn
from energybalancemodel_jl_tpu_torch.models.base import default_step_config, get_model
from energybalancemodel_jl_tpu_torch.ops.classic_year import classic_year
from energybalancemodel_jl_tpu_torch.ops.miz_year import CARRY_KEYS, miz_year
from energybalancemodel_jl_tpu_torch.ops.newton_t0 import newton_t0
from energybalancemodel_jl_tpu_torch.ops.pcr_fused import pcr_fused

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def test_kernel_wrappers_refuse_gradients(cuda):
    st = ebt.SpaceTime.sin(16, 100, 1)
    cfg = default_step_config("float32")
    z = lambda *shape: torch.zeros(shape, device=cuda)
    D = torch.tensor([0.6], device=cuda, requires_grad=True)
    carry = ebt.Collection({k: z(1, 16) for k in CARRY_KEYS})
    with pytest.raises(ValueError, match="engine='batched'"):
        miz_year(carry, dict(ebt.default_parameters("MIZ"), D=D), z(100), st, cfg)
    E = z(1, 16).requires_grad_(True)
    with pytest.raises(ValueError, match="engine='batched'"):
        classic_year(ebt.Collection(E=E, Tg=z(1, 16)), ebt.default_parameters("Classic"),
                     z(100), st, cfg)
    b = z(4, 16).requires_grad_(True)
    with pytest.raises(ValueError, match="engine='batched'"):
        pcr_fused(z(4, 16), z(4, 16) + 1.0, z(4, 16), b)
    with pytest.raises(ValueError, match="engine='batched'"):
        newton_t0(b, z(4, 16) + 1.0, z(4, 16), z(4, 16), z(4, 16), z(16), z(16), z(16), 0.6,
                  2.0, 0.0, 193.0, 2.1, 0.4, 0.0)
    with torch.no_grad():  # nothing to lose: the launch goes ahead
        pcr_fused(z(4, 16), z(4, 16) + 1.0, z(4, 16), b)


def test_fused_equilibrate_launches_and_members_equal_solo(cuda):
    st = ebt.SpaceTime.sin(40, 200, 1)
    par = ebt.Collection(ebt.default_parameters("MIZ"), F=np.array([-4.0, 0.0, 4.0]))
    miz_year.launches = 0
    ens = ebt.equilibrate("MIZ", st, 0.0, par, ebt.zeros_init(st), tol=0.0, max_years=20,
                          dtype="float32", device=cuda)
    assert miz_year.launches == ens.years == 20
    for i, F in enumerate((-4.0, 0.0, 4.0)):
        solo = ebt.equilibrate("MIZ", st, F, ebt.default_parameters("MIZ"), ebt.zeros_init(st),
                               tol=0.0, max_years=ens.years, dtype="float32", device=cuda)
        for k in solo.state:
            np.testing.assert_array_equal(ens.state[k][i], solo.state[k], err_msg=k)
        for k in solo.seasonal.avg:
            np.testing.assert_array_equal(ens.seasonal.avg[k][i], solo.seasonal.avg[k])


def test_fixed_point_gradient_on_the_card_equals_the_cpu(cuda):
    st = ebt.SpaceTime.sin(8, 50, 1)
    fn = make_equilibrium_seasonal_fn("MIZ", st, default_step_config("float64"), "float64",
                                      bwd_max_iters=20)
    out = {}
    for dev in ("cpu", cuda):
        par = ebt.Collection({k: torch.tensor(float(v), dtype=torch.float64, device=dev,
                                              requires_grad=True)
                              for k, v in ebt.default_parameters("MIZ").items()})
        frow = torch.full((50,), 4.0, dtype=torch.float64, device=dev)
        carry = get_model("MIZ").init_carry(ebt.zeros_init(st), st, torch.float64, dev)
        phi = torch.nan_to_num(fn(par, frow, carry).avg["phi"]).sum()
        out[str(dev)] = [float(phi.detach())] + [float(g) for g in torch.autograd.grad(
            phi, list(par.values()))]
    a, b = np.asarray(out["cpu"]), np.asarray(out[str(cuda)])
    assert np.all(np.abs(a - b) <= 1e-9 * np.abs(a) + 1e-15)


def test_arrhenius_scaling_of_escape_rates(cuda):
    nx = 8
    st = ebt.SpaceTime.sin(nx, 1000, 1)
    par = ebt.Collection(ebt.default_parameters("Classic"))
    mk = lambda e: ebt.Collection(E=np.full(nx, e), Tg=np.full(nx, e) / float(par["cw"]))
    F, kw = 6.5, dict(dtype="float64", device=cuda)
    warm = ebt.equilibrate("Classic", st, F, par, mk(30.0), max_years=120, tol=2.0, **kw)
    snow = ebt.equilibrate("Classic", st, F, par, mk(-30.0), max_years=120, tol=2.0, **kw)
    assert warm.converged and snow.converged
    levels, reps = np.array([9.0, 11.0, 13.0]), 32
    sigma = np.repeat(levels, reps)
    r = ebt.transitions("Classic", st, F, par, warm, snow, sigma=sigma, tau=0.05, years=300,
                        K=sigma.size, seed=0, **kw)
    assert r.newton_ok
    rates = []
    for i in range(levels.size):
        sl = slice(i * reps, (i + 1) * reps)
        fin = r.finite[sl]
        esc = r.escaped[sl] & fin
        obs = np.where(esc, r.first_passage[sl], float(r.years))
        rates.append(np.count_nonzero(esc) / obs[fin].sum())
    rates = np.array(rates)
    assert np.all(rates > 0.0)
    assert np.all(np.diff(rates) > 0.0)
    xs, lr = 1.0 / levels ** 2, np.log(rates)
    assert np.polyfit(xs, lr, 1)[0] < 0.0
    assert np.corrcoef(xs, lr)[0, 1] < -0.98
