"""The CUDA kernel ``csrc/miz_year.cu`` on the card, against its plain
PyTorch version ``miz_year_reference`` on the same inputs.

Every test here needs a CUDA device and nvcc; without them each skips
(decided inside the ``cuda`` fixture, never at import). Run on a GPU with::

    python -m pytest tests/test_torch_cuda.py -q

Bars:
- float64, nx=40/nt=200, K=8 with D swept, 2 years (the second one
  raw-collected), default Newton tolerances: 1e-8 (rtol and atol) on carry,
  seasonal stores and raw steps, equal NaN positions. The kernel iterates
  Newton per member, the plain version in lockstep over the batch, so they
  agree to below the Newton tolerance;
- float32, the same run with a fixed Newton iteration count: bitwise equal.
  Built without FMA contraction, the kernel rounds every operation where the
  plain version does (measured: 0 difference on an H100). The JAX package's
  own fused-vs-XLA bars, atol 0.5 on the carry and 0.05 on the seasonal
  stores (``tests/test_pallas_year.py:108,121``), are the documented upper
  bound and are not what is held here;
- an ensemble member equals the same member run alone, bitwise.
"""
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.models.base import (StepConfig, default_step_config,
                                                              dtype_name)
from energybalancemodel_jl_tpu_torch.ops.miz_year import (CARRY_KEYS, miz_year,
                                                           miz_year_reference)

pytestmark = pytest.mark.gpu

FIXED32 = StepConfig(solver="pcr", newton_abstol=0.0, newton_reltol=0.0,
                     newton_max_step=50.0, newton_max_iter=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def setup(dev, dtype, nx=40, nt=200, K=8):
    st = ebt.SpaceTime.sin(nx, nt, 1)
    par = ebt.default_parameters("MIZ")
    par["D"] = np.linspace(0.55, 0.65, K)
    carry = ebt.Collection({k: torch.zeros((K, nx), dtype=dtype, device=dev) for k in CARRY_KEYS})
    return st, par, carry, torch.zeros(nt, dtype=dtype, device=dev)


def two_years(fn, carry, par, f, st, cfg):
    """Two years, the second raw-collected: (carry, seasonal, conv, raw)."""
    carry, seas, conv, raw = fn(carry, par, f, st, cfg)
    assert raw is None
    carry, seas, conv, raw = fn(carry, par, f, st, cfg, collect_raw=True)
    torch.cuda.synchronize()
    return carry, seas, conv, raw


def pairs(a, b):
    """(name, a, b) over carry, seasonal stores and raw steps."""
    (ca, sa, _, ra), (cb, sb, _, rb) = a, b
    assert ra["E"].shape[1:] == ca["Ei"].shape  # (nt, K, nx)
    return ([(f"carry.{k}", ca[k], cb[k]) for k in ca]
            + [(f"{name}.{k}", x[k], y[k])
               for name, x, y in zip(("winter", "summer", "avg"), sa, sb) for k in x]
            + [(f"raw.{k}", ra[k], rb[k]) for k in ra])


def test_kernel_matches_plain_float64(cuda):
    st, par, carry, f = setup(cuda, torch.float64)
    cfg = default_step_config("float64")
    before = miz_year.launches
    k = two_years(miz_year, carry, par, f, st, cfg)
    assert miz_year.launches == before + 2
    p = two_years(miz_year_reference, carry, par, f, st, cfg)
    assert miz_year.launches == before + 2  # the plain version launches nothing
    assert float(k[2]) == float(p[2]) == 1.0
    for what, x, y in pairs(k, p):
        assert torch.equal(torch.isnan(x), torch.isnan(y)), what
        torch.testing.assert_close(torch.nan_to_num(x), torch.nan_to_num(y), rtol=1e-8,
                                   atol=1e-8, msg=what)


def test_kernel_matches_plain_float32_fixed_iterations(cuda):
    st, par, carry, f = setup(cuda, torch.float32)
    k = two_years(miz_year, carry, par, f, st, FIXED32)
    p = two_years(miz_year_reference, carry, par, f, st, FIXED32)
    for what, x, y in pairs(k, p):
        assert torch.equal(torch.isnan(x), torch.isnan(y)), what
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), what
    # tol = 0 is unsatisfiable: both report non-convergence
    assert float(k[2]) == float(p[2]) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_members_equal_solo_runs_bitwise(cuda, dtype):
    st, par, carry, f = setup(cuda, dtype, nx=180, nt=2000, K=16)
    cfg = default_step_config(dtype_name(dtype))
    ens = two_years(miz_year, carry, par, f, st, cfg)
    for m in (0, 7, 15):
        solo = ebt.Collection({k: v[m:m + 1] for k, v in carry.items()})
        one = two_years(miz_year, solo, dict(par, D=par["D"][m]), f, st, cfg)
        for x, y in [(one[0][k][0], ens[0][k][m]) for k in CARRY_KEYS] + [
                (a[k][0], b[k][m]) for a, b in zip(one[1], ens[1]) for k in a] + [
                (one[3][k][:, 0], ens[3][k][:, m]) for k in ens[3]]:
            assert torch.equal(torch.isnan(x), torch.isnan(y))
            assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


def test_unsupported_inputs_raise_instead_of_running_the_plain_version(cuda):
    before = miz_year.launches
    st, par, carry, f = setup(cuda, torch.float64, nx=1025, nt=10, K=2)
    with pytest.raises(ValueError, match="M8"):
        miz_year(carry, par, f, st, default_step_config("float64"))
    st, par, carry, f = setup(cuda, torch.float16, nt=10, K=2)
    with pytest.raises(ValueError, match="float32 or float64"):
        miz_year(carry, par, f, st, default_step_config("float32"))
    # the entry points raise too, with engine='auto', before any work
    wide = ebt.SpaceTime.sin(1025, 10, 1)
    with pytest.raises(ValueError, match="M8"):
        ebt.integrate("MIZ", wide, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                      ebt.zeros_init(wide), device=cuda, progress=False)
    with pytest.raises(ValueError, match="M8"):
        ebt.ensemble_integrate("MIZ", wide, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                               ebt.zeros_init(wide), n_members=2, device=cuda,
                               progress=False)
    assert miz_year.launches == before


def test_entry_points_launch_the_kernel(cuda):
    st = ebt.SpaceTime.sin(40, 200, 3)
    par = ebt.default_parameters("MIZ")
    par["D"] = np.linspace(0.55, 0.65, 4)
    before = miz_year.launches
    ens = ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                                 dtype="float32", device=cuda, progress=False)
    assert miz_year.launches == before + 3
    assert np.isfinite(ens.seasonal.avg["E"]).all()
    sol = ebt.integrate("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                        ebt.zeros_init(st), dtype="float64", device=cuda, progress=False)
    assert miz_year.launches == before + 6  # the raw last year runs the kernel too
    assert sol.raw["E"].shape == (st.nt, st.nx) and np.isfinite(sol.raw["E"]).all()
