"""The high-resolution runs of the PyTorch port on the CPU: the plain year
against the JAX package at widths above the kernels' register builds, the
host functions of the wide builds, and the two operator names ported with
them.

Bars (float64):
- Classic ``SpaceTime.sin(8192, 1000, 1)`` from the warm init, the scan
  engines of both packages: every seasonal store within 1e-8 absolute on the
  O(10-100) fields. Measured 1.61e-9 (avg E), in ice cells, where T0's
  division by M - kLf / E amplifies the two packages' rounding orders; the
  gap grows with nx (3.4e-10 at nx=4096, 1.7e-11 at 1024). At nt=200 the
  explicit E step diverges in both packages (|E| ~ 1e33), so there is
  nothing to compare;
- MIZ at nx=2048, nt=400 with D scaled so that D nx^2 / nt is the canonical
  grid's (explicit Tb diffusion), zero init: the first 20 steps, equal NaN
  positions, and two bars on every output and the carry. Over the field's
  magnitude, max |port - JAX| / max |JAX| within 3e-10: measured below
  7e-12 through step 15, then 1.05e-10 (phi of one cell freezing at step
  16). Point by point, the canonical parity window's bar, rtol 1.5e-8 /
  atol 1e-12 (ROADMAP "held against the reference"): measured 4.5e-9 (E of
  a cell crossing zero at step 11);
- ``ops.tridiag.tridiag_matvec`` and ``ops.diffusion.diffusion``: 1e-13,
  normwise relative;
- the wide builds' crossing sum, emulated thread by thread as
  ``csrc/noise.cuh::wide_noise_crossing`` runs it (the block layout's
  virtual threads in rounds of the block's own): bitwise ``block_sum``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.models import miz as jmiz
from energybalancemodel_jl_tpu.models.base import default_step_config as jcfg
from energybalancemodel_jl_tpu.ops.diffusion import diffusion as jax_diffusion
from energybalancemodel_jl_tpu.ops.tridiag import tridiag_matvec as jax_matvec
from energybalancemodel_jl_tpu_torch import ops
from energybalancemodel_jl_tpu_torch.integrate import check_fused, resolve_engine
from energybalancemodel_jl_tpu_torch.models import miz as tmiz
from energybalancemodel_jl_tpu_torch.models.base import default_step_config
from energybalancemodel_jl_tpu_torch.ops import _year
from energybalancemodel_jl_tpu_torch.ops import classic_year as tcy
from energybalancemodel_jl_tpu_torch.ops import miz_year as tmy
from energybalancemodel_jl_tpu_torch.ops import newton_t0 as tk10
from energybalancemodel_jl_tpu_torch.ops import pcr_fused as tk11

T64 = torch.float64
CPU = torch.device("cpu")
GPU = torch.device("cuda")  # a device object only: nothing here runs on it
COUPLING = 180 ** 2 / 2000  # the canonical MIZ grid's nx^2 / nt


def relative(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_classic_year_at_nx_8192_matches_jax():
    st = ebt.SpaceTime.sin(8192, 1000, 1)
    par = ebt.default_parameters("Classic")
    E0 = np.full(st.nx, 30.0)
    init = {"E": E0, "Tg": E0 / par["cw"]}
    j = ebm.integrate("Classic", st, ebm.Forcing(0.0), ebm.default_parameters("Classic"),
                      ebm.Collection(init), engine="scan", raw_mode="none", dtype="float64",
                      progress=False)
    t = ebt.integrate("Classic", st, ebt.Forcing(0.0), par, init, engine="scan",
                      raw_mode="none", dtype="float64", device="cpu", progress=False)
    worst = 0.0
    for name, a, b in zip(("winter", "summer", "avg"), t.seasonal, j.seasonal):
        for k in ("E", "T", "h"):
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.shape == (1, st.nx) and np.isfinite(x).all(), f"{name}.{k}"
            worst = max(worst, float(np.max(np.abs(x - y))))
    assert worst <= 1e-8
    assert np.ptp(np.asarray(t.seasonal.avg["E"])) > 10.0  # not a flat field


def test_miz_first_20_steps_at_nx_2048_match_jax():
    n_steps, nx, nt = 20, 2048, 400
    st = ebt.SpaceTime.sin(nx, nt, 1)
    par = ebt.default_parameters("MIZ")
    par["D"] = par["D"] * COUPLING * nt / nx ** 2
    jpar = ebm.Collection({k: jnp.asarray(v, jnp.float64) for k, v in par.items()})
    init = ebt.zeros_init(st)

    js = jmiz.statics(st, jpar, jnp.float64)
    cfg = jcfg("float64")

    @jax.jit
    def jax_steps(carry):
        xs = dict(insol=js.insol[:n_steps], f=jnp.zeros(n_steps))
        return lax.scan(lambda c, x: jmiz.step(c, x, js, jpar, cfg), carry, xs)

    jcarry, jouts = jax_steps(jmiz.init_carry(init, st, jnp.float64))
    tpar = ebt.from_numpy(par)
    ts = tmiz.statics(st, tpar, T64, CPU)
    carry = tmiz.init_carry(init, st, T64, CPU)
    zero = torch.zeros((), dtype=T64)
    tcfg = default_step_config("float64")

    def held(a, b, what):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
        a, b = np.nan_to_num(a), np.nan_to_num(b)
        assert np.max(np.abs(a - b)) <= 3e-10 * np.max(np.abs(b)), what
        np.testing.assert_allclose(a, b, rtol=1.5e-8, atol=1e-12, err_msg=what)

    for i in range(n_steps):
        carry, out = tmiz.step(carry, tmiz.step_inputs(ts, zero.expand(nt), i), ts, tpar, tcfg)
        for k in out:
            held(out[k].numpy(), np.asarray(jouts[k][i]), f"step {i + 1} {k}")
    for k in carry:
        held(carry[k].numpy(), np.asarray(jcarry[k]), f"carry {k}")
    assert np.nanmax(out["phi"].numpy()) > 0.0  # ice forms in the window


@pytest.mark.parametrize("shape", [(50,), (3, 50)])
def test_tridiag_matvec_matches_jax(shape):
    rng = np.random.default_rng(1)
    lo, di, up, x = (rng.normal(size=shape) for _ in range(4))
    lo[..., 0] = up[..., -1] = 0.0
    t = ops.tridiag_matvec(*(torch.as_tensor(v) for v in (lo, di, up, x)))
    j = jax_matvec(*(jnp.asarray(v) for v in (lo, di, up, x)))
    assert relative(t.numpy(), j) <= 1e-13
    # A x of the system pcr_solve solves gives back its right-hand side
    b = ops.tridiag_matvec(*(torch.as_tensor(v) for v in (lo, di + 4.0 * np.sign(di), up, x)))
    sol = ops.pcr_solve(*(torch.as_tensor(v) for v in (lo, di + 4.0 * np.sign(di), up)), b)
    assert relative(sol.numpy(), x) <= 1e-13


@pytest.mark.parametrize("grid", ["identity", "sin"])
def test_diffusion_matches_jax(grid):
    st = getattr(ebt.SpaceTime, grid)(64, 100, 1)
    T = np.random.default_rng(2).normal(0.0, 10.0, (2, st.nx))
    par = ebt.default_parameters("MIZ")
    j = jax_diffusion(T, getattr(ebm.SpaceTime, grid)(64, 100, 1), par)
    assert relative(ops.diffusion(T, st, par).numpy(), j) <= 1e-13
    assert relative(ops.diffusion(torch.as_tensor(T), st, par).numpy(), j) <= 1e-13


def test_the_kernels_widest_grids():
    assert (tcy.MAX_NX, tmy.MAX_NX, tk11.MAX_N, tk10.MAX_N) == (32768, 16384, 32768, 16384)
    for check, top in ((tcy.check_nx, 32768), (tmy.check_nx, 16384)):
        check(top)
        with pytest.raises(ValueError, match=f"runs nx <= {top}: its wide build"):
            check(top + 1)


@pytest.mark.parametrize("model,top", [("Classic", 32768), ("MIZ", 16384)])
def test_auto_engine_is_fused_up_to_the_wide_builds_reach(model, top):
    for nx in (top // 4, top):
        assert resolve_engine(model, ebt.SpaceTime.sin(nx, 100, 1), GPU) == "fused"
        check_fused(model, nx, GPU)
    check_fused(model, top + 1, CPU)  # the plain version has no width
    with pytest.raises(ValueError, match=f"runs nx <= {top}"):
        resolve_engine(model, ebt.SpaceTime.sin(top + 1, 100, 1), GPU)
    with pytest.raises(ValueError, match=f"runs nx <= {top}"):
        check_fused(model, top + 1, GPU)


# kernel, n -> whether the wide build runs it (the register builds up to
# each kernel's narrow width take no workspace)
BUILDS = [
    ("classic_year", 180, False), ("classic_year", 4096, False), ("classic_year", 4097, True),
    ("classic_year", 8192, True), ("classic_year", 32768, True), ("miz_year", 1024, False),
    ("miz_year", 1025, True), ("miz_year", 16384, True), ("pcr_fused", 180, False),
    ("pcr_fused", 4096, False), ("pcr_fused", 32768, True), ("newton_t0", 16384, True),
]


@pytest.mark.parametrize("kernel,n,wide", BUILDS)
def test_kernel_build_picks_the_build_and_sizes_the_workspace(kernel, n, wide):
    for K in (1, 64, 8192):
        blocks, words = _year.wide_workspace(kernel, n, K, 132)
        if wide:
            # one block per SM at most: the workspace scales with the card
            assert (blocks, words) == (min(K, 132 * _year.WIDE_BLOCKS_PER_SM),
                                       _year.wide_words(kernel, n))
        else:
            assert (blocks, words) == (0, 0)
    with pytest.raises(ValueError, match="wide build"):
        _year.wide_workspace(kernel, _year.WIDE[kernel]["max"] + 1, 1, 132)


def test_wide_words_count_the_rows_the_exchange_and_the_records():
    # csrc: 8 (n + 2) PCR words, 4 (n + 2) exchange words, then a record of
    # 12 (Classic), 21 (MIZ), 5 (K10) values per cell, rounded up to 32
    n = 8192
    assert _year.wide_words("pcr_fused", n) == 65568
    assert _year.wide_words("classic_year", n) == -(-(8 * (n + 2) + 12 * n) // 32) * 32
    assert _year.wide_words("miz_year", n) == -(-(12 * (n + 2) + 21 * n) // 32) * 32
    assert _year.wide_words("newton_t0", n) == -(-(12 * (n + 2) + 5 * n) // 32) * 32
    for k in _year.WIDE:
        assert _year.wide_words(k, 1025) % 32 == 0
    # at Classic nx = 32768 in float64 the 132 blocks' workspace is 0.69 GB,
    # whatever K; a workspace per member would be 40 GB at K = 8192
    blocks, words = _year.wide_workspace("classic_year", 32768, 8192, 132)
    assert blocks * words * 8 < 0.7e9 < 8192 * words * 8 / 50


# the layout of the register builds, as tests/test_torch_block_sum.py pins
# it, and its extension above 4096 cells (a power of two per thread)
LAYOUTS = {1: (1, 32), 180: (1, 192), 1024: (1, 1024), 1025: (2, 544), 2048: (2, 1024),
           2049: (4, 544), 4096: (4, 1024), 4097: (8, 544), 8192: (8, 1024),
           8193: (16, 544), 16384: (16, 1024), 32767: (32, 1024), 32768: (32, 1024)}


@pytest.mark.parametrize("n", sorted(LAYOUTS))
def test_block_layout_below_and_above_4096(n):
    assert _year.block_layout(n) == LAYOUTS[n]


def emulate_wide_crossing(v, block_threads):
    """One member's area as a wide block sums it
    (``csrc/noise.cuh::wide_noise_crossing``), in scalar arithmetic of
    ``v``'s dtype: the layout's vt virtual threads run in rounds of the
    block's threads, each adds its cells v + c * vt in order (0 beyond the
    grid), a virtual warp's lanes add in the halving tree, thread 0 adds the
    virtual warps in order."""
    n = v.shape[0]
    cpt, vt = _year.block_layout(n)
    zero = v.dtype.type(0)
    slots = {}
    for base in range(0, vt, block_threads):
        for warp in range(block_threads // 32):
            lanes = []
            for lane in range(32):
                u = base + 32 * warp + lane
                part = zero
                for c in range(cpt):
                    i = u + c * vt
                    x = v[i] if u < vt and i < n else zero
                    part = x if c == 0 else part + x
                lanes.append(part)
            for half in (16, 8, 4, 2, 1):
                lanes = [lanes[l] + lanes[l + half] for l in range(half)] + lanes[half:]
            if base + 32 * warp < vt:
                slots[(base + 32 * warp) // 32] = lanes[0]
    total = slots[0]
    for w in range(1, vt // 32):
        total = total + slots[w]
    return total


@pytest.mark.parametrize("threads", [256, 512])
@pytest.mark.parametrize("n", [1025, 2049, 4097, 8192, 16383, 32768])
def test_wide_crossing_sum_is_block_sum_bitwise(n, threads):
    v = (np.random.default_rng(n).uniform(0.0, 1.0, n) ** 3).astype(np.float32)
    got = emulate_wide_crossing(v, threads)
    want = _year.block_sum(torch.as_tensor(v)[None])[0].numpy()
    assert got.tobytes() == want.tobytes()
