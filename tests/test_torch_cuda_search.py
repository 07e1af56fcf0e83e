"""The search and spectra drivers of the PyTorch port on a CUDA device.

Every test here needs a CUDA device and nvcc; without them each skips (the
kernels have no CPU mode). Run on the card with ``python -m pytest
--noconftest tests/test_torch_cuda_search.py`` (the repo's conftest imports
jax).

- ``fold`` (Classic) and ``basins`` (MIZ) at nx=40: one year-kernel launch
  per simulated year, and each member of the last solve equal to its run
  alone of the same year count, bitwise (the kernels run each member on its
  own).
- The polish's dense Jacobian and ``lyapunov`` (MIZ, ``member_chunk``,
  ``project``) on the card equal the CPU's at 1e-10 (the eager year, both
  float64).
"""
import sys

import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.basins import _residual_fns
from energybalancemodel_jl_tpu_torch.ops.classic_year import classic_year
from energybalancemodel_jl_tpu_torch.ops.miz_year import miz_year

pytestmark = pytest.mark.gpu
BAR_CARD_CPU = 1e-10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


class SolveLog:
    """Each ``equilibrate`` call of a driver module: its years, and the last
    call's arguments and result."""

    def __init__(self, monkeypatch, module_name):
        module = sys.modules[module_name]
        inner = module.equilibrate
        self.years, self.last = [], None

        def logged(*args, **kwargs):
            res = inner(*args, **kwargs)
            self.years.append(res.years)
            self.last = (args, res)
            return res

        monkeypatch.setattr(module, "equilibrate", logged)


def assert_members_run_alone(log, device, dtype):
    """Every member of the last solve against its run alone, from the same
    state with the same parameters, for the same year count: bitwise."""
    (model, st, forcing, par, state), res = log.last
    K = len(res.member_years)
    for i in range(K):
        p = {k: (np.asarray(v)[i] if np.ndim(v) else v) for k, v in par.items()}
        s = {k: (np.asarray(v)[i] if np.ndim(v) > 1 else v) for k, v in state.items()}
        solo = ebt.equilibrate(model, st, forcing, p, s, tol=0.0, max_years=res.years,
                               dtype=dtype, device=device)
        for k in solo.state:
            np.testing.assert_array_equal(solo.state[k], res.state[k][i], err_msg=f"{i} {k}")
        for a, b in zip(solo.seasonal, res.seasonal):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k][i], err_msg=f"{i} {k}")


def test_fold_members_equal_their_runs_alone(cuda, monkeypatch):
    st = ebt.SpaceTime.sin(40, 1000, 1)
    par = ebt.default_parameters("Classic")
    par["D"] = np.array([0.45, 0.6, 0.75])
    E0 = np.full(40, 30.0)
    log = SolveLog(monkeypatch, "energybalancemodel_jl_tpu_torch.fold")
    classic_year.launches = 0
    res = ebt.fold("Classic", st, par, {"E": E0, "Tg": E0 / par["cw"]}, lo=-10.0, hi=20.0,
                   steps=3, tol=0.5, max_years=40, dtype="float32", device=cuda)
    assert classic_year.launches == sum(log.years)
    assert np.all(res.width == 30.0 / 8)
    assert_members_run_alone(log, cuda, "float32")


def test_basins_members_equal_their_runs_alone(cuda, monkeypatch):
    st = ebt.SpaceTime.sin(40, 1000, 1)
    z = ebt.zeros_init(st)
    cold = dict(z, Ei=np.full(40, -20.0), h=np.full(40, 2.0), phi=np.full(40, 1.0))
    log = SolveLog(monkeypatch, "energybalancemodel_jl_tpu_torch.basins")
    miz_year.launches = 0
    res = ebt.basins("MIZ", st, ebt.default_parameters("MIZ"),
                     ebt.blend_states(z, cold, np.linspace(0.0, 1.0, 4)), forcing=0.0,
                     tol=1e-2, max_years=30, dtype="float64", device=cuda)
    assert miz_year.launches == sum(log.years) == res.result.years
    assert np.all(np.isfinite(res.areas))
    assert_members_run_alone(log, cuda, "float64")


def test_dense_jacobian_card_equals_cpu(cuda):
    st = ebt.SpaceTime.sin(8, 1000, 1)
    saddle = dict(E=np.array([93.6, 72.2, 18.8, -5.9, -15.2, -38.6, -58.5, -75.0]),
                  Tg=np.array([8.86, 6.67, 1.29, -12.1, -25.7, -38.8, -50.7, -61.3]))
    out = []
    for dev in (cuda, torch.device("cpu")):
        x0, f, jac, _, _ = _residual_fns("Classic", st, ebt.Forcing(10.0),
                                         ebt.default_parameters("Classic"), saddle,
                                         torch.float64, dev)
        out.append((f(x0), jac(x0)))
    (fa, Ja), (fb, Jb) = out
    np.testing.assert_allclose(fa, fb, rtol=0, atol=BAR_CARD_CPU * np.abs(fb).max())
    np.testing.assert_allclose(Ja, Jb, rtol=0, atol=BAR_CARD_CPU * np.abs(Jb).max())


def test_lyapunov_card_equals_cpu(cuda):
    st = ebt.SpaceTime.sin(8, 50, 40)
    sol = ebt.integrate("MIZ", st, ebt.Forcing(4.0), ebt.default_parameters("MIZ"),
                        ebt.zeros_init(st), dtype="float64", device="cpu", progress=False)
    init = {k: np.array(sol.raw[k][-1]) for k in ("Ei", "Ew", "h", "D", "phi")}
    par = ebt.Collection(ebt.default_parameters("MIZ"), F=np.linspace(3.0, 5.0, 4))
    runs = [ebt.lyapunov("MIZ", ebt.SpaceTime.sin(8, 50, 1), 0.0, par, init, years=2,
                         n_modes=2, project=("Ew", "phi"), member_chunk=2, dtype="float64",
                         device=dev)
            for dev in (cuda, torch.device("cpu"))]
    np.testing.assert_allclose(runs[0].history, runs[1].history, rtol=0, atol=BAR_CARD_CPU)
    for k in runs[1].state:
        np.testing.assert_allclose(runs[0].state[k], runs[1].state[k], rtol=0,
                                   atol=BAR_CARD_CPU * (1.0 + np.abs(runs[1].state[k]).max()))
