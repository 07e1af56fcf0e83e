"""The CUDA kernels on the card, against their plain PyTorch versions on the
same inputs: ``csrc/miz_year.cu`` (``miz_year_reference``),
``csrc/classic_year.cu`` (``classic_year_reference``), ``csrc/pcr.cu``
(``tridiag.pcr_solve``) and ``csrc/newton_t0.cu`` (``newton_t0_reference``).

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
- an ensemble member equals the same member run alone, bitwise;
- the Classic year, f32 and f64, nx=40/nt=1000, K=8 with D, S1 and F swept,
  2 years (the second raw-collected), from the warm init and from zeros, and
  single runs at nx=1500 and nx=4096 (2 and 4 cells per thread): bitwise
  equal. Classic has no Newton loop, so the adaptive configuration is held
  bitwise too. The warp builds (nx <= 256, one member per warp) and the
  block build at every slot class, members of a block of warps against
  their solo runs, and both sides of the K dispatch: bitwise;
- the batched PCR and the fixed-iteration Newton for T0: bitwise equal, with
  shared and per-system bands, 1 to 4 rows per thread, and K11's warp
  layout (a system per warp up to n = 256);
- the wide builds (above the register builds' widths; the year kernels'
  cluster builds, a thread-block cluster per member): Classic at nx 8192
  and 32768, MIZ at 1025, 1536, 2048 and 16384 (D scaled so D nx^2/nt is
  the canonical grid's, 2 fixed Newton iterations), every noise mode, K11
  up to 32768 rows and K10 up to 16384:
  bitwise equal; MIZ with the adaptive Newton: float64 to 1e-8 at K=2, and
  at K=1 (nx=1536, f32 and f64) bitwise with the plain version's Newton
  updates; more members than the card keeps resident, each bitwise its solo run; the entry points
  launch them with ``engine='auto'`` and raise past their widths.
"""
import contextlib

import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.models.base import (StepConfig, default_step_config,
                                                              dtype_name)
from energybalancemodel_jl_tpu_torch.models import miz as tmiz
from energybalancemodel_jl_tpu_torch.ops.classic_year import classic_year, classic_year_reference
from energybalancemodel_jl_tpu_torch.ops.diffusion import diffusion_bands
from energybalancemodel_jl_tpu_torch.ops.miz_year import (CARRY_KEYS, miz_year,
                                                           miz_year_reference)
from energybalancemodel_jl_tpu_torch.ops import _year, prng
from energybalancemodel_jl_tpu_torch.ops.newton_t0 import newton_t0, newton_t0_reference
from energybalancemodel_jl_tpu_torch.ops.pcr_fused import pcr_fused
from energybalancemodel_jl_tpu_torch.ops.tridiag import pcr_solve

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


# Newton updates of all members over one canonical year from zero init, as
# the kernel counts them with XLA:CPU's fused multiply-adds at their sites
# (chip_smoke.py's NEWTON_UPDATES): a change to how values move between
# threads changes no iterate
NEWTON_UPDATES_BEFORE = {(torch.float32, 8192): 18762098, (torch.float32, 1): 2299,
                         (torch.float64, 8192): 18740528}


@pytest.mark.parametrize("dtype,K", list(NEWTON_UPDATES_BEFORE), ids=lambda v: str(v))
def test_newton_update_counts_unchanged_by_the_redesign(cuda, dtype, K):
    st, par, carry, f = setup(cuda, dtype, nx=180, nt=2000, K=K)
    n = torch.zeros(K, dtype=torch.int32, device=cuda)
    miz_year(carry, par, f, st, default_step_config(dtype_name(dtype)), newton_iters=n)
    assert int(n.sum()) == NEWTON_UPDATES_BEFORE[dtype, K]


def test_unsupported_inputs_raise_instead_of_running_the_plain_version(cuda):
    before = miz_year.launches
    st, par, carry, f = setup(cuda, torch.float64, nx=16385, nt=10, K=2)
    with pytest.raises(ValueError, match="runs nx <= 16384"):
        miz_year(carry, par, f, st, default_step_config("float64"))
    st, par, carry, f = setup(cuda, torch.float16, nt=10, K=2)
    with pytest.raises(ValueError, match="float32 or float64"):
        miz_year(carry, par, f, st, default_step_config("float32"))
    # the entry points raise too, with engine='auto', before any work
    wide = ebt.SpaceTime.sin(16385, 10, 1)
    with pytest.raises(ValueError, match="runs nx <= 16384"):
        ebt.integrate("MIZ", wide, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                      ebt.zeros_init(wide), device=cuda, progress=False)
    with pytest.raises(ValueError, match="runs nx <= 16384"):
        ebt.ensemble_integrate("MIZ", wide, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                               ebt.zeros_init(wide), n_members=2, device=cuda,
                               progress=False)
    assert miz_year.launches == before
    # K11 and K10 past their cluster builds' reach
    solvers = pcr_fused.launches, newton_t0.launches
    z = lambda n: torch.zeros((2, n), device=cuda)
    with pytest.raises(ValueError, match="runs nx <= 32768"):
        pcr_fused(z(32769), z(32769) + 1.0, z(32769), z(32769))
    with pytest.raises(ValueError, match="runs nx <= 16384"):
        newton_t0(*(z(16385) for _ in range(5)), *(torch.zeros(16385, device=cuda),) * 3,
                  0.6, 2.0, 0.0, 2.0, 2.0, 0.6, 0.0)
    assert (pcr_fused.launches, newton_t0.launches) == solvers
    # nx = 1025, which raised before the wide build, launches it
    wide = ebt.SpaceTime.sin(1025, 10, 1)
    ebt.integrate("MIZ", wide, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                  ebt.zeros_init(wide), device=cuda, progress=False, raw_mode="none")
    assert miz_year.launches == before + 1


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


def bitwise(x, y):
    return bool(torch.equal(torch.isnan(x), torch.isnan(y))
                and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)))


def classic_setup(dev, dtype, nx=40, nt=1000, K=8, warm=True, sweep=True):
    st = ebt.SpaceTime.sin(nx, nt, 1)
    par = ebt.default_parameters("Classic")
    if sweep:
        par["D"] = np.linspace(0.55, 0.65, K)
        par["S1"] = np.linspace(320.0, 350.0, K)
        par["F"] = np.linspace(-1.0, 1.0, K)
    E = torch.full((K, nx), 30.0 if warm else 0.0, dtype=dtype, device=dev)
    carry = ebt.Collection(E=E, Tg=E / par["cw"])
    f = torch.as_tensor(np.random.default_rng(0).normal(0.0, 0.5, nt), dtype=dtype, device=dev)
    return st, par, carry, f


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "zeros"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_classic_kernel_matches_plain_bitwise(cuda, dtype, warm):
    st, par, carry, f = classic_setup(cuda, dtype, warm=warm)
    cfg = default_step_config(dtype_name(dtype))
    before = classic_year.launches
    k = two_years(classic_year, carry, par, f, st, cfg)
    assert classic_year.launches == before + 2
    p = two_years(classic_year_reference, carry, par, f, st, cfg)
    assert classic_year.launches == before + 2
    assert k[2] is None and p[2] is None
    for what, x, y in ([(f"carry.{n}", k[0][n], p[0][n]) for n in k[0]]
                       + [(f"{name}.{n}", a[n], b[n])
                          for name, a, b in zip(("winter", "summer", "avg"), k[1], p[1])
                          for n in a]
                       + [(f"raw.{n}", k[3][n], p[3][n]) for n in k[3]]):
        assert bitwise(x, y), what
    assert torch.isfinite(k[0]["E"]).all()


@pytest.mark.parametrize("nx", [1500, 4096])
def test_classic_kernel_high_resolution_single_run(cuda, nx):
    st, par, carry, f = classic_setup(cuda, torch.float32, nx=nx, K=1, sweep=False)
    cfg = default_step_config("float32")
    k = classic_year(carry, par, f, st, cfg, collect_raw=True)
    p = classic_year_reference(carry, par, f, st, cfg, collect_raw=True)
    torch.cuda.synchronize()
    for x, y in [(k[0][n], p[0][n]) for n in k[0]] + [(k[3][n], p[3][n]) for n in k[3]]:
        assert bitwise(x, y)


def test_classic_members_equal_solo_runs_bitwise(cuda):
    st, par, carry, f = classic_setup(cuda, torch.float32, nx=180, nt=2000, K=16)
    cfg = default_step_config("float32")
    ens = classic_year(carry, par, f, st, cfg)
    for m in (0, 9, 15):
        solo_par = {n: (v[m] if np.ndim(v) else v) for n, v in par.items()}
        one = classic_year(ebt.Collection({n: v[m:m + 1] for n, v in carry.items()}),
                           solo_par, f, st, cfg)
        for x, y in [(one[0][n][0], ens[0][n][m]) for n in one[0]] + [
                (a[n][0], b[n][m]) for a, b in zip(one[1], ens[1]) for n in a]:
            assert bitwise(x, y)


# the grids around the Classic warp builds' slots (1, 2, 4, 6, 8 of 32
# cells; nx = 257 runs the block build)
WARP_WIDTHS = [1, 31, 32, 33, 180, 255, 256, 257]


@contextlib.contextmanager
def classic_build(kind):
    """Run the Classic kernel's warp builds (``"warp"``: from K = 1) or its
    block build (``"block"``) for grids of nx <= 256."""
    from energybalancemodel_jl_tpu_torch.ops import classic_year as cy

    saved = cy.WARP_MIN_K
    cy.WARP_MIN_K = 1 if kind == "warp" else 2 ** 30
    try:
        yield
    finally:
        cy.WARP_MIN_K = saved


@pytest.mark.parametrize("build", ["warp", "block"])
@pytest.mark.parametrize("nx", WARP_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_classic_warp_and_block_builds_match_plain_bitwise(cuda, dtype, nx, build):
    st, par, carry, f = classic_setup(cuda, dtype, nx=nx, nt=400, K=9)
    cfg = default_step_config(dtype_name(dtype))
    with classic_build(build):
        k = two_years(classic_year, carry, par, f, st, cfg)
    p = two_years(classic_year_reference, carry, par, f, st, cfg)
    for x, y in ([(k[0][n], p[0][n]) for n in k[0]]
                 + [(a[n], b[n]) for a, b in zip(k[1], p[1]) for n in a]
                 + [(k[3][n], p[3][n]) for n in k[3]]):
        assert bitwise(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_classic_warp_members_equal_solo_runs_bitwise(cuda, dtype):
    """Members of one block of warps, and of the last, partly filled block,
    on the warp build against the same members alone on the block build."""
    st, par, carry, f = classic_setup(cuda, dtype, nx=180, nt=2000, K=11)
    cfg = default_step_config(dtype_name(dtype))
    with classic_build("warp"):
        ens = classic_year(carry, par, f, st, cfg)
    for m in (0, 3, 4, 10):
        solo_par = {n: (v[m] if np.ndim(v) else v) for n, v in par.items()}
        solo = ebt.Collection({n: v[m:m + 1] for n, v in carry.items()})
        one = classic_year(solo, solo_par, f, st, cfg)  # K = 1: the block build
        for x, y in [(one[0][n][0], ens[0][n][m]) for n in one[0]] + [
                (a[n][0], b[n][m]) for a, b in zip(one[1], ens[1]) for n in a]:
            assert bitwise(x, y)


def test_classic_k_dispatch_crossover_both_sides(cuda):
    """K = WARP_MIN_K - 1 runs the block build and K = WARP_MIN_K the warp
    builds: both bitwise the plain version, and a member equal across them."""
    from energybalancemodel_jl_tpu_torch.ops.classic_year import WARP_MIN_K

    outs = []
    for K in (max(1, WARP_MIN_K - 1), WARP_MIN_K):
        st, par, carry, f = classic_setup(cuda, torch.float32, nx=180, nt=2000, K=K,
                                          sweep=False)
        cfg = default_step_config("float32")
        k = classic_year(carry, par, f, st, cfg)
        p = classic_year_reference(carry, par, f, st, cfg)
        torch.cuda.synchronize()
        assert all(bitwise(k[0][n], p[0][n]) for n in k[0])
        assert all(bitwise(a[n], b[n]) for a, b in zip(k[1], p[1]) for n in a)
        outs.append(k)
    assert all(bitwise(outs[0][0][n][0], outs[1][0][n][0]) for n in outs[0][0])


# one case per shape class of the padded, packed PCR rows: no level, one
# level, around a warp, the canonical grid, the widest one-row-per-thread
# system, the 2- and 4-row builds with their one clamped buffer, and the
# wide build (rows in device memory) up to its widest
SHAPE_CLASSES = [1, 2, 7, 31, 32, 33, 180, 1024, 1025, 1500, 4096, 8192, 32768]


# K11 runs one system per warp up to n = 256 and a block per system above
@pytest.mark.parametrize("n", SHAPE_CLASSES + [255, 256, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pcr_kernel_matches_plain_bitwise(cuda, dtype, n):
    g = torch.Generator().manual_seed(n)
    K = 64
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64).to(cuda, dtype)
    lo, up = rnd(K, n), rnd(K, n)
    di = (lo.abs() + up.abs() + 1.0) * torch.where(rnd(K, n) > 0, 1.0, -1.0)
    b = rnd(K, n)
    before = pcr_fused.launches
    for bands in ((lo, di, up), (lo[0], di[0], up[0])):  # per-system, then shared
        x = pcr_fused(*bands, b)
        assert bitwise(x, pcr_solve(*bands, b))
    assert pcr_fused.launches == before + 2


@pytest.mark.parametrize("K,nx", [(16, 180), (4, 3000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_newton_t0_kernel_matches_plain_bitwise(cuda, dtype, K, nx):
    rng = np.random.default_rng(nx)
    st = ebt.SpaceTime.sin(nx, 200, 1)
    par = ebt.default_parameters("MIZ")
    geom = diffusion_bands(st)
    insol = (par["S0"] - par["S1"] * st.x * np.cos(2 * np.pi * 0.3)) - par["S2"] * st.x**2
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=cuda)
    args = [t(rng.normal(-5.0, 5.0, (K, nx))), t(np.abs(rng.normal(1.0, 0.5, (K, nx))) + 0.1),
            t(rng.normal(0.0, 3.0, (K, nx))), t(rng.uniform(0.0, 1.0, (K, nx))),
            t(np.tile(insol, (K, 1))), t(geom.lo), t(geom.di), t(geom.up),
            t(np.linspace(0.5, 0.7, K)), par["k"], par["Tm"], par["A"], par["B"], par["ai"], 0.7]
    before = newton_t0.launches
    x = newton_t0(*args, max_step=50.0, iters=6)
    assert newton_t0.launches == before + 1
    assert bitwise(x, newton_t0_reference(*args, max_step=50.0, iters=6))


# K10's wide build runs up to n = 16384
@pytest.mark.parametrize("n", [n for n in SHAPE_CLASSES if n <= 16384] + [16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_newton_t0_kernel_shape_classes_bitwise(cuda, dtype, n):
    """K10 at every shape class of the shared PCR and exchange layer, on
    seeded fields and stencil bands (no grid is needed for the arithmetic)."""
    rng = np.random.default_rng(100 + n)
    K = 5
    par = ebt.default_parameters("MIZ")
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=cuda)
    glo, gup = rng.uniform(0.5, 2.0, n), rng.uniform(0.5, 2.0, n)
    glo[0] = gup[-1] = 0.0
    args = [t(rng.normal(-5.0, 5.0, (K, n))), t(np.abs(rng.normal(1.0, 0.5, (K, n))) + 0.1),
            t(rng.normal(0.0, 3.0, (K, n))), t(rng.uniform(0.0, 1.0, (K, n))),
            t(rng.uniform(100.0, 400.0, (K, n))), t(glo), t(-(glo + gup)), t(gup),
            t(np.linspace(0.5, 0.7, K)), par["k"], par["Tm"], par["A"], par["B"], par["ai"], 0.7]
    x = newton_t0(*args, max_step=50.0, iters=6)
    assert torch.isfinite(x).all()
    assert bitwise(x, newton_t0_reference(*args, max_step=50.0, iters=6))


def test_solver_pallas_launches_for_batches_only(cuda):
    st = ebt.SpaceTime.sin(40, 200, 1)
    par = ebt.from_numpy(ebt.default_parameters("MIZ"), device=cuda)
    stat = tmiz.statics(st, par, torch.float64, cuda)
    cfg = default_step_config("float64", solver="pallas")
    z = torch.zeros((3, st.nx), dtype=torch.float64, device=cuda)
    h, phi = z + 0.5, z + 0.6
    f = torch.zeros((), dtype=torch.float64, device=cuda)
    before = newton_t0.launches
    tmiz.solve_T0(z, tmiz.insolation(stat, 3), h, z, phi, f, stat, par, cfg)
    assert newton_t0.launches == before + 1
    tmiz.solve_T0(z[0], tmiz.insolation(stat, 3), h[0], z[0], phi[0], f, stat, par, cfg)
    assert newton_t0.launches == before + 1  # a single run keeps the adaptive Newton


def test_classic_and_solver_entry_points_launch_their_kernels(cuda):
    st = ebt.SpaceTime.sin(40, 1000, 3)
    par = ebt.default_parameters("Classic")
    par["D"] = np.linspace(0.55, 0.65, 4)
    E0 = np.full(st.nx, 30.0)
    init = {"E": E0, "Tg": E0 / par["cw"]}
    before = classic_year.launches
    ens = ebt.ensemble_integrate("Classic", st, ebt.Forcing(0.0), par, init, dtype="float32",
                                 device=cuda, progress=False)
    assert classic_year.launches == before + 3
    assert np.isfinite(ens.seasonal.avg["E"]).all()
    sol = ebt.integrate("Classic", st, ebt.Forcing(0.0), ebt.default_parameters("Classic"),
                        init, dtype="float64", device=cuda, progress=False)
    assert classic_year.launches == before + 6  # the raw last year runs the kernel too
    assert sol.raw["E"].shape == (st.nt, st.nx) and np.isfinite(sol.raw["E"]).all()
    # nx = 4097 runs the wide build; past 32768 the kernel raises, before any work
    wide = ebt.SpaceTime.sin(4097, 1000, 1)
    ebt.integrate("Classic", wide, ebt.Forcing(0.0), ebt.default_parameters("Classic"),
                  ebt.zeros_init(wide, "Classic"), device=cuda, progress=False,
                  raw_mode="none")
    assert classic_year.launches == before + 7
    past = ebt.SpaceTime.sin(32769, 1000, 1)
    with pytest.raises(ValueError, match="runs nx <= 32768"):
        ebt.integrate("Classic", past, ebt.Forcing(0.0), ebt.default_parameters("Classic"),
                      ebt.zeros_init(past, "Classic"), device=cuda, progress=False)
    assert classic_year.launches == before + 7
    st = ebt.SpaceTime.sin(40, 200, 1)
    mpar = ebt.default_parameters("MIZ")
    mpar["D"] = np.linspace(0.55, 0.65, 4)
    for solver, counter in (("pcr_fused", pcr_fused), ("pallas", newton_t0)):
        before = counter.launches
        out = ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), mpar, ebt.zeros_init(st),
                                     dtype="float32", device=cuda, engine="batched",
                                     solver=solver, progress=False)
        assert counter.launches > before, solver
        assert np.isfinite(out.seasonal.avg["E"]).all()


# -- the wide builds (grids above the register builds' widths): bitwise the
# plain versions, as chip_smoke.py phase 22 holds them. Each year is held
# finite too (a year of NaNs would compare trivially): MIZ scales D so that
# D nx^2 / nt is the canonical grid's (its Tb diffusion is explicit), Classic
# runs nt = 1000 (at nt = 200 its explicit E step diverges at these widths)
COUPLING = 180 ** 2 / 2000
FIXED2 = StepConfig(solver="pcr", newton_abstol=0.0, newton_reltol=0.0,
                    newton_max_step=50.0, newton_max_iter=2)


def wide_miz_setup(dev, dtype, nx, nt, K):
    st, par, carry, f = setup(dev, dtype, nx=nx, nt=nt, K=K)
    par["D"] = par["D"] * COUPLING * nt / nx ** 2
    return st, par, carry, f


def leaves(v, path="result"):
    """(name, tensor) over a year's results, nested."""
    if torch.is_tensor(v):
        yield path, v
    elif isinstance(v, dict):
        for k in v:
            yield from leaves(v[k], f"{path}.{k}")
    elif v is not None:
        for i, x in enumerate(v):
            yield from leaves(x, f"{path}[{i}]")


def assert_same_years(k, p):
    pairs_kp = list(zip(leaves(tuple(k)), leaves(tuple(p))))
    assert pairs_kp
    for (what, x), (_, y) in pairs_kp:
        assert bitwise(x, y), what


@pytest.mark.parametrize("nx", [8192, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_classic_wide_build_matches_plain_bitwise(cuda, dtype, nx):
    st, par, carry, f = classic_setup(cuda, dtype, nx=nx, nt=1000, K=2)
    cfg = default_step_config(dtype_name(dtype))
    before = classic_year.launches
    k = two_years(classic_year, carry, par, f, st, cfg)
    assert classic_year.launches == before + 2
    assert_same_years(k, two_years(classic_year_reference, carry, par, f, st, cfg))
    assert torch.isfinite(k[0]["E"]).all()


@pytest.mark.parametrize("nx", [1025, 1536, 2048, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_miz_wide_build_matches_plain_bitwise(cuda, dtype, nx):
    st, par, carry, f = wide_miz_setup(cuda, dtype, nx, 32, 2)
    before = miz_year.launches
    k = two_years(miz_year, carry, par, f, st, FIXED2)
    assert miz_year.launches == before + 2
    assert_same_years(k, two_years(miz_year_reference, carry, par, f, st, FIXED2))
    assert all(torch.isfinite(v).all() for v in k[0].values())


def test_miz_wide_build_adaptive_newton_float64(cuda):
    """The default Newton tolerances: the kernel iterates per member, the
    plain version in lockstep, so they agree to below the tolerance (the
    bar of the canonical grid's float64 test)."""
    st, par, carry, f = wide_miz_setup(cuda, torch.float64, 2048, 32, 2)
    cfg = default_step_config("float64")
    k = two_years(miz_year, carry, par, f, st, cfg)
    p = two_years(miz_year_reference, carry, par, f, st, cfg)
    for what, x, y in pairs(k, p):
        assert torch.equal(torch.isnan(x), torch.isnan(y)), what
        torch.testing.assert_close(torch.nan_to_num(x), torch.nan_to_num(y), rtol=1e-8,
                                   atol=1e-8, msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_miz_wide_build_adaptive_newton_single_run_bitwise(cuda, monkeypatch, dtype):
    """The default Newton tolerances in a single run at the width of the
    high-resolution year: at K=1 the plain version's lockstep loop is the
    kernel's per-member one, so both make the same Newton updates (the
    kernel's decided by its block max of the residual) and round alike."""
    st, par, carry, f = wide_miz_setup(cuda, dtype, 1536, 64, 1)
    cfg = default_step_config(dtype_name(dtype))
    counted = torch.zeros(1, dtype=torch.int32, device=cuda)
    k = miz_year(carry, par, f, st, cfg, newton_iters=counted)
    plain_updates, inner = [0], tmiz._newton_root

    def counting(T0_warm, args, cfg):
        T0, converged, it = inner(T0_warm, args, cfg)
        plain_updates[0] += it
        return T0, converged, it

    monkeypatch.setattr(tmiz, "_newton_root", counting)
    assert_same_years(k, miz_year_reference(carry, par, f, st, cfg))
    assert int(counted.sum()) == plain_updates[0] > 64


def test_wide_build_loops_over_members_beyond_the_resident_blocks(cuda):
    K = torch.cuda.get_device_properties(cuda).multi_processor_count + 4
    st, par, carry, f = classic_setup(cuda, torch.float32, nx=8192, nt=1000, K=K)
    # more members than clusters resident: each cluster loops over members
    assert K > _year.cluster_plan("classic_year", st.nx, st.nt, K, torch.float32, cuda).clusters
    cfg = default_step_config("float32")
    ens = classic_year(carry, par, f, st, cfg)
    assert_same_years(ens, classic_year_reference(carry, par, f, st, cfg))
    for m in (0, K // 2, K - 1):
        solo_par = {n: (v[m] if np.ndim(v) else v) for n, v in par.items()}
        one = classic_year(ebt.Collection({n: v[m:m + 1] for n, v in carry.items()}),
                           solo_par, f, st, cfg)
        for x, y in [(one[0][n][0], ens[0][n][m]) for n in one[0]] + [
                (a[n][0], b[n][m]) for a, b in zip(one[1], ens[1]) for n in a]:
            assert bitwise(x, y)


NOISE_MODES = ["table", "table/OU", "keys/serial", "keys/assoc", "keys/crossing"]


@pytest.mark.parametrize("mode", NOISE_MODES)
@pytest.mark.parametrize("model", ["Classic", "MIZ"])
def test_wide_build_noise_modes_match_plain_bitwise(cuda, model, mode):
    if model == "Classic":
        st, par, carry, f = classic_setup(cuda, torch.float32, nx=8192, nt=1000, K=2)
        year, plain, cfg = classic_year, classic_year_reference, default_step_config("float32")
    else:
        st, par, carry, f = wide_miz_setup(cuda, torch.float32, 2048, 32, 2)
        year, plain, cfg = miz_year, miz_year_reference, FIXED2
    table = torch.as_tensor(np.random.default_rng(3).normal(size=(st.nt, 2)),
                            dtype=torch.float32, device=cuda)
    keys, ou = prng.member_year_keys(5, 2, 2), (0.95, 3.0, 0.5)
    kw = {"table": dict(noise=table), "table/OU": dict(noise=table, noise_ou=ou),
          "keys/serial": dict(noise_keys=keys, noise_ou=ou),
          "keys/assoc": dict(noise_keys=keys, noise_ou=ou, ou_assoc=True),
          "keys/crossing": dict(noise_keys=keys, noise_ou=ou,
                                crossing=(float(np.sum(np.diff(st.x))) * 0.3, 1.0))}[mode]
    k = year(carry, par, f, st, cfg, **kw)
    assert_same_years(k, plain(carry, par, f, st, cfg, **kw))
    assert all(torch.isfinite(v).all() for v in k[0].values())


@pytest.mark.parametrize("mode", ["table", "table/OU"])
def test_classic_wide_build_float64_noise_matches_plain_bitwise(cuda, mode):
    """The float64 noisy cluster build, whose chunks' eliminated rows wait in
    local memory across the solve, against its plain version."""
    st, par, carry, f = classic_setup(cuda, torch.float64, nx=8192, nt=1000, K=2)
    table = torch.as_tensor(np.random.default_rng(3).normal(size=(st.nt, 2)),
                            dtype=torch.float64, device=cuda)
    kw = dict(noise=table) if mode == "table" else dict(noise=table, noise_ou=(0.95, 3.0, 0.5))
    cfg = default_step_config("float64")
    before = classic_year.chunked_launches
    k = classic_year(carry, par, f, st, cfg, **kw)
    assert classic_year.chunked_launches == before + 1
    assert_same_years(k, classic_year_reference(carry, par, f, st, cfg, **kw))
    assert all(torch.isfinite(v).all() for v in k[0].values())


def test_entry_points_launch_the_wide_builds(cuda):
    """ensemble_integrate and transitions with engine='auto' above the
    register builds' widths run the wide build, one launch per year."""
    st = ebt.SpaceTime.sin(8192, 1000, 1)
    par = ebt.default_parameters("Classic")
    E0 = np.full(st.nx, 30.0)
    warm = ebt.Collection(E=E0, Tg=E0 / par["cw"])
    cold = ebt.Collection(E=-E0, Tg=-E0 / par["cw"])
    before = classic_year.launches
    ens = ebt.ensemble_integrate("Classic", st, ebt.Forcing(0.0),
                                 dict(par, D=np.array([0.55, 0.65])), warm, dtype="float32",
                                 device=cuda, progress=False)
    assert classic_year.launches == before + 1
    assert np.isfinite(ens.seasonal.avg["E"]).all()
    before = classic_year.launches
    r = ebt.transitions("Classic", st, 0.0, par, warm, cold, sigma=4.0, tau=0.05, years=1, K=2,
                        seed=0, dtype="float32", device=cuda)
    assert classic_year.launches > before
    assert r.finite.all()
    mst = ebt.SpaceTime.sin(2048, 64, 1)
    mpar = ebt.default_parameters("MIZ")
    mpar["D"] = mpar["D"] * COUPLING * mst.nt / mst.nx ** 2 * np.array([1.0, 1.1])
    before = miz_year.launches
    ebt.ensemble_integrate("MIZ", mst, ebt.Forcing(0.0), mpar, ebt.zeros_init(mst),
                           dtype="float32", device=cuda, progress=False)
    assert miz_year.launches == before + 1


def test_wide_build_workspace_scales_with_resident_blocks(cuda):
    """The workspace of a wide call: a cluster build's at most its resident
    clusters' blocks (none where its records fit in shared memory, K11's
    always), whatever K; a cluster build that cannot launch raises; a raw
    year that would not fit raises naming its size."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for kernel, n in (("classic_year", 32768), ("pcr_fused", 32768), ("newton_t0", 16384)):
        for dtype in (torch.float32, torch.float64):
            plan = _year.cluster_plan(kernel, n, 1000, 8192, dtype, cuda)
            blocks, words = _year.wide_workspace(kernel, n, 8192, plan)
            assert plan.C * plan.clusters <= sms and plan.shared_bytes <= _year.MAX_SHARED_BYTES
            assert (blocks, words) == ((0, 0) if plan.records_shared else (
                plan.clusters * plan.C, _year.wide_words(kernel, n, plan.C)))
            assert plan.records_shared or kernel != "pcr_fused"
    with pytest.MonkeyPatch.context() as mp:
        # K10 in float64 at C = 8: 2048 cells a block, the records in device memory
        mp.setitem(_year.FORCE_CLUSTER, "newton_t0", 8)
        plan = _year.cluster_plan("newton_t0", 16384, 1, 64, torch.float64, cuda)
        assert not plan.records_shared
        assert _year.wide_workspace("newton_t0", 16384, 64, plan) == (
            min(64, plan.clusters) * 8, _year.wide_words("newton_t0", 16384, 8))
    with pytest.MonkeyPatch.context() as mp:
        # 16384 cells a block: in float64 the two buffers of their 4096
        # interface rows alone take 256 KB
        mp.setitem(_year.FORCE_CLUSTER, "classic_year", 2)
        with pytest.raises(RuntimeError, match="cannot launch"):
            _year.cluster_plan("classic_year", 32768, 1000, 1, torch.float64, cuda)
    st = ebt.SpaceTime.sin(16384, 262144, 1)
    carry = ebt.Collection({k: torch.zeros((64, st.nx), device=cuda) for k in CARRY_KEYS})
    with pytest.raises(ValueError, match="raw-collected year stores"):
        miz_year(carry, ebt.default_parameters("MIZ"), torch.zeros(st.nt, device=cuda), st,
                 default_step_config("float32"), collect_raw=True)



# K11 and K10 above 4096 rows: the cluster builds, at the C side's choice (0)
# and forced C; a C whose plan cannot launch raises, it never falls back
@pytest.mark.parametrize("C", [0, 2, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel,n", [("pcr_fused", 32768), ("pcr_fused", 8193),
                                      ("newton_t0", 16384), ("newton_t0", 6000)])
def test_k10_k11_cluster_builds_match_plain_bitwise(cuda, kernel, n, dtype, C, monkeypatch):
    monkeypatch.setitem(_year.FORCE_CLUSTER, kernel, C)
    rng = np.random.default_rng(n + C)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=cuda)
    try:
        plan = _year.cluster_plan(kernel, n, 1, 8, dtype, cuda)
    except RuntimeError:
        assert C > 0  # the C side's own choice always launches
        K = 8
        plan = None
    else:
        # more systems than clusters resident: each cluster loops over them
        K = plan.clusters + 3
    if kernel == "pcr_fused":
        lo, up = rng.normal(size=(K, n)), rng.normal(size=(K, n))
        di = (np.abs(lo) + np.abs(up) + 1.0) * rng.choice([-1.0, 1.0], (K, n))
        args = [t(lo), t(di), t(up), t(rng.normal(size=(K, n)))]
        run, plain = pcr_fused, pcr_solve
        one = lambda m: [a[m:m + 1] for a in args]
    else:
        par = ebt.default_parameters("MIZ")
        glo, gup = rng.uniform(0.5, 2.0, n), rng.uniform(0.5, 2.0, n)
        glo[0] = gup[-1] = 0.0
        args = [t(rng.normal(-5.0, 5.0, (K, n))), t(np.abs(rng.normal(1.0, 0.5, (K, n))) + 0.1),
                t(rng.normal(0.0, 3.0, (K, n))), t(rng.uniform(0.0, 1.0, (K, n))),
                t(rng.uniform(100.0, 400.0, (K, n))), t(glo), t(-(glo + gup)), t(gup),
                t(np.linspace(0.5, 0.7, K)), par["k"], par["Tm"], par["A"], par["B"],
                par["ai"], 0.7]
        run = lambda *a: newton_t0(*a, max_step=50.0, iters=3)
        plain = lambda *a: newton_t0_reference(*a, max_step=50.0, iters=3)
        one = lambda m: [a[m:m + 1] for a in args[:5]] + args[5:8] + [args[8][m:m + 1]] + args[9:]
    if plan is None:
        with pytest.raises(RuntimeError, match="cannot launch"):
            run(*args)
        return
    x = run(*args)
    assert bitwise(x, plain(*args))
    for m in (0, K - 1):
        assert bitwise(run(*one(m))[0], x[m])
