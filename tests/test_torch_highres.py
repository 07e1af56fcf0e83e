"""The high-resolution runs of the PyTorch port on the CPU: the plain year
against the JAX package at widths above the kernels' register builds, the
host functions of the wide builds, and the two operator names ported with
them.

Bars (float64), against the JAX package's scan engine (its graph: statics
from the traced parameters inside jit, the year's first step peeled), whose
fused multiply-adds the port makes (utils/numerics.py):
- Classic ``SpaceTime.sin(8192, 1000, 1)`` from the warm init, the scan
  engines of both packages: every seasonal store within 1e-9 absolute on the
  O(10-100) fields. Measured 1.4e-14 (1.61e-9 before the port made XLA's
  contractions). At nt=200 the explicit E step diverges in both packages
  (|E| ~ 1e33), so there is nothing to compare;
- MIZ at nx=2048, nt=400 with D scaled so that D nx^2 / nt is the canonical
  grid's (explicit Tb diffusion), zero init: the first 20 steps, equal NaN
  positions, and two bars on every output and the carry. Over the field's
  magnitude, max |port - JAX| / max |JAX| within 1e-10: step 1 is bitwise,
  measured 4.2e-12 at most (phi, from step 15; 1.05e-10 before). Point by
  point, the canonical parity window's bar, rtol 1.5e-8 / atol 1e-12
  (ROADMAP "held against the reference"): measured 0.25% of it;
- ``ops.tridiag.tridiag_matvec`` and ``ops.diffusion.diffusion``: 1e-13,
  normwise relative;
- the wide builds' crossing sum, emulated thread by thread as
  ``csrc/noise.cuh::wide_noise_crossing`` runs it (the block layout's
  virtual threads in rounds of the block's own): bitwise ``block_sum``.
"""
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch import ops
from energybalancemodel_jl_tpu_torch.integrate import check_fused, resolve_engine
from energybalancemodel_jl_tpu_torch.models import miz as tmiz
from energybalancemodel_jl_tpu_torch.models.base import StepConfig, default_step_config
from energybalancemodel_jl_tpu_torch.ops import _year
from energybalancemodel_jl_tpu_torch.ops import classic_year as tcy
from energybalancemodel_jl_tpu_torch.ops import miz_year as tmy
from energybalancemodel_jl_tpu_torch.ops import newton_t0 as tk10
from energybalancemodel_jl_tpu_torch.ops import pcr_fused as tk11

T64 = torch.float64
CPU = torch.device("cpu")
GPU = torch.device("cuda")  # a device object only: nothing here runs on it
COUPLING = 180 ** 2 / 2000  # the canonical MIZ grid's nx^2 / nt


def jax_side():
    """The JAX package and jax, imported by the tests that compare with
    them: the card tests of this file run where jax is not installed."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    import energybalancemodel_jl_tpu as ebm
    from energybalancemodel_jl_tpu.models import miz as jmiz
    from energybalancemodel_jl_tpu.models.base import default_step_config as jcfg

    return jax, jnp, lax, ebm, jmiz, jcfg


def jax_scan_engine(jmiz, cfg, st, n_steps, dtype):
    """JAX ``integrate.make_year_fn``'s graph cut to ``n_steps`` steps,
    ``(carry, par) -> (carry, outputs stacked by step)``: the statics from
    the traced parameters inside jit, the first step peeled, a scan over the
    rest."""
    jax, jnp, lax = jax_side()[:3]

    @jax.jit
    def steps(carry, p):
        js = jmiz.statics(st, p, dtype)
        xs = dict(insol=js.insol[:n_steps], f=jnp.zeros(n_steps, dtype))
        carry, out0 = jmiz.step(carry, jax.tree_util.tree_map(lambda v: v[0], xs), js, p, cfg)
        carry, outs = lax.scan(lambda c, x: jmiz.step(c, x, js, p, cfg), carry,
                               jax.tree_util.tree_map(lambda v: v[1:], xs))
        return carry, jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a[None], b]),
                                             out0, outs)

    return steps


def relative(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_classic_year_at_nx_8192_matches_jax():
    ebm = jax_side()[3]
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
    assert worst <= 1e-9
    assert np.ptp(np.asarray(t.seasonal.avg["E"])) > 10.0  # not a flat field


def test_miz_first_20_steps_at_nx_2048_match_jax():
    jax, jnp, lax, ebm, jmiz, jcfg = jax_side()
    n_steps, nx, nt = 20, 2048, 400
    st = ebt.SpaceTime.sin(nx, nt, 1)
    par = ebt.default_parameters("MIZ")
    par["D"] = par["D"] * COUPLING * nt / nx ** 2
    jpar = ebm.Collection({k: jnp.asarray(v, jnp.float64) for k, v in par.items()})
    init = ebt.zeros_init(st)

    cfg = jcfg("float64")
    jcarry, jouts = jax_scan_engine(jmiz, cfg, st, n_steps, jnp.float64)(
        jmiz.init_carry(init, st, jnp.float64), jpar)
    tpar = ebt.from_numpy(par)
    ts = tmiz.statics(st, tpar, T64, CPU)
    carry = tmiz.init_carry(init, st, T64, CPU)
    zero = torch.zeros((), dtype=T64)
    tcfg = default_step_config("float64")

    def held(a, b, what):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
        a, b = np.nan_to_num(a), np.nan_to_num(b)
        assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b)), what
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
    import jax.numpy as jnp

    from energybalancemodel_jl_tpu.ops.tridiag import tridiag_matvec as jax_matvec

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
    from energybalancemodel_jl_tpu.ops.diffusion import diffusion as jax_diffusion

    ebm = jax_side()[3]
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


def plan(C, clusters, records_shared):
    """A C-side plan as the card reports it (csrc/*_year.cu::*_cluster_plan);
    the host sizes the workspace from it and guesses nothing."""
    return _year.ClusterPlan(C=C, threads=256, records_shared=records_shared,
                             clusters=clusters, shared_bytes=100000)


@pytest.mark.parametrize("kernel,n,wide", BUILDS)
def test_kernel_build_picks_the_build_and_sizes_the_workspace(kernel, n, wide):
    """Every wide build is a cluster build (K10 and K11 too, on the year
    kernels' cluster PCR): sized from the C side's plan alone."""
    for K in (1, 64, 8192):
        if not wide:
            assert _year.wide_workspace(kernel, n, K) == (0, 0)
        else:
            # records in shared memory: no workspace; in device memory: one
            # part per block of the clusters launched, at most the resident
            # ones, each looping over members
            assert _year.wide_workspace(kernel, n, K, plan(16, 7, True)) == (0, 0)
            for C, clusters in ((16, 7), (4, 30)):
                assert _year.wide_workspace(kernel, n, K, plan(C, clusters, False)) == (
                    min(K, clusters) * C, _year.wide_words(kernel, n, C))
    if wide:
        with pytest.raises(ValueError, match="C side's plan"):
            _year.wide_workspace(kernel, n, 1)
    with pytest.raises(ValueError, match="wide build"):
        _year.wide_workspace(kernel, _year.WIDE[kernel]["max"] + 1, 1, plan(16, 7, False))


def test_wide_words_count_the_rows_the_exchange_and_the_records():
    # every cluster build: a rank's records alone, 0 (K11: its rows are its
    # records, always in shared memory), 5 (K10), 11 (Classic) and 20 (MIZ)
    # values for each of its ceil(n / C) cells, rounded up to 32 (the rows
    # and the exchange live in shared memory)
    n = 8192
    for C in (2, 8, 16):
        assert _year.wide_words("pcr_fused", 32768, C) == 0
        assert _year.wide_words("newton_t0", 16384, C) == -(-(5 * -(-16384 // C)) // 32) * 32
    assert _year.wide_words("newton_t0", n, 8) == 5120
    for C in (1, 2, 4, 8, 16):
        assert _year.wide_words("classic_year", n, C) == -(-(11 * -(-n // C)) // 32) * 32
        assert _year.wide_words("miz_year", 1536, C) == -(-(20 * -(-1536 // C)) // 32) * 32
    for k in _year.WIDE:
        for C in (1, 3, 16):
            assert _year.wide_words(k, 1025, C) % 32 == 0
    # at Classic nx = 32768 in float64 with the records in device memory, the
    # 7 resident clusters of 16 take 20 MB whatever K; a part for every
    # member's 16 blocks would take 23.6 GB at K = 8192
    blocks, words = _year.wide_workspace("classic_year", 32768, 8192, plan(16, 7, False))
    assert blocks * words * 8 < 2.1e7 < 2e10 < 8192 * 16 * words * 8


def test_cluster_size_can_be_forced_and_defaults_to_the_c_side():
    assert _year.FORCE_CLUSTER == {"classic_year": 0, "miz_year": 0, "pcr_fused": 0,
                                   "newton_t0": 0}
    assert set(_year.FORCE_CLUSTER) == set(_year.WIDE)


# the layout of the register builds, as tests/test_torch_block_sum.py pins
# it, and its extension above 4096 cells (a power of two per thread)
LAYOUTS = {1: (1, 32), 180: (1, 192), 1024: (1, 1024), 1025: (2, 544), 2048: (2, 1024),
           2049: (4, 544), 4096: (4, 1024), 4097: (8, 544), 8192: (8, 1024),
           8193: (16, 544), 16384: (16, 1024), 32767: (32, 1024), 32768: (32, 1024)}


@pytest.mark.parametrize("n", sorted(LAYOUTS))
def test_block_layout_below_and_above_4096(n):
    assert _year.block_layout(n) == LAYOUTS[n]


def emulate_cluster_crossing(v, C, block_threads):
    """One member's area as a cluster build sums it
    (``csrc/cluster.cuh::cluster_noise_crossing``), in scalar arithmetic of
    ``v``'s dtype: each of the C ranks holds the values of its slice of
    ceil(n / C) cells; rank 0's threads run the layout's vt virtual threads
    in rounds, each adds its cells v + c * vt in order (0 beyond the grid),
    reading each from the rank that holds it (owner j // slice, by the
    kernel's multiply-high), a virtual warp's lanes add in the halving tree,
    thread 0 adds the virtual warps in order."""
    n = v.shape[0]
    slice_ = -(-n // C)
    magic = ((1 << 32) + slice_ - 1) // slice_
    ranks = [v[r * slice_:(r + 1) * slice_] for r in range(C)]
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
                    if u < vt and i < n:
                        owner = (i * magic) >> 32
                        assert owner == i // slice_
                        x = ranks[owner][i - owner * slice_]
                    else:
                        x = zero
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


@pytest.mark.parametrize("C", [2, 4, 8, 16])
@pytest.mark.parametrize("threads", [96, 512])
@pytest.mark.parametrize("n", [1025, 1536, 2049, 4097, 8192, 16383, 32768])
def test_wide_crossing_sum_is_block_sum_bitwise(n, threads, C):
    v = (np.random.default_rng(n).uniform(0.0, 1.0, n) ** 3).astype(np.float32)
    got = emulate_cluster_crossing(v, C, threads)
    want = _year.block_sum(torch.as_tensor(v)[None])[0].numpy()
    assert got.tobytes() == want.tobytes()


def test_float32_newton_updates_per_step_jax_against_the_port():
    """The high-resolution year of chip_smoke.py phase 22, SpaceTime.sin(1536,
    147456) in float32 from zero init at F = 0 with the default Newton
    tolerances: the JAX package's Newton (ops/newton.py::newton_tridiag, its
    iteration count) in the scan engine's graph and the port's plain step
    (models/miz.py::_newton_root, with the float32 parameters a float32 run
    takes) over the first 120 steps. Measured: the first step is bitwise
    JAX's (the port makes XLA's fused multiply-adds, tests/test_torch_fma.py),
    the states part from step 2 in the cells where ice forms (the scan body's
    contractions follow its fused loops, ROADMAP Queue 3), both make 1 update
    a step through step 91, differ from step 92 (the port 3, JAX 1), and both
    run into the 30-update cap from step ~110."""
    jax, jnp, lax, ebm, jmiz, jcfg = jax_side()
    n_steps, nx, nt = 120, 1536, 147456
    st = ebt.SpaceTime.sin(nx, nt, 1)
    par = ebt.default_parameters("MIZ")
    init = ebt.zeros_init(st)
    jst = ebm.SpaceTime.sin(nx, nt, 1)
    jpar = ebm.Collection({k: jnp.asarray(v, jnp.float32) for k, v in par.items()})
    jax_counts, port_counts = [], []
    inner = jmiz._newton_root.fun  # newton_tridiag's (x, converged, iterations)

    def counted(T0_warm, args, cfg):
        out = inner(T0_warm, args, cfg)
        jax.debug.callback(lambda it: jax_counts.append(int(it)), out[2], ordered=True)
        return out

    jcfg32 = jcfg("float32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmiz, "_newton_root", counted)

        jax_steps = jax_scan_engine(jmiz, jcfg32, jst, n_steps, jnp.float32)
        jax.block_until_ready(jax_steps(jmiz.init_carry(init, jst, jnp.float32), jpar))
    port_inner = tmiz._newton_root

    def port_counted(T0_warm, args, cfg):
        T0, converged, it = port_inner(T0_warm, args, cfg)
        port_counts.append(int(it))
        return T0, converged, it

    tpar = ebt.from_numpy(par, torch.float32)  # as integrate takes them in a float32 run
    ts = tmiz.statics(st, tpar, torch.float32, CPU)
    carry = tmiz.init_carry(init, st, torch.float32, CPU)
    cfg = default_step_config("float32")
    zero = torch.zeros((), dtype=torch.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmiz, "_newton_root", port_counted)
        for i in range(n_steps):
            carry, _ = tmiz.step(carry, tmiz.step_inputs(ts, zero.expand(nt), i), ts, tpar, cfg)
    assert len(jax_counts) == len(port_counts) == n_steps
    assert cfg.newton_max_iter == jcfg32.newton_max_iter == 30
    # every step before ice forms: the same updates
    assert jax_counts[:91] == port_counts[:91] == [1] * 91
    first = next(i for i, (a, b) in enumerate(zip(jax_counts, port_counts)) if a != b)
    assert first == 91, (first, jax_counts[90:], port_counts[90:])
    # the high counts are the model's own: both iterate to the cap
    for counts in (jax_counts, port_counts):
        assert sum(c == 30 for c in counts[110:]) >= 7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cluster builds have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", ["Classic", "MIZ"])
def test_cluster_builds_match_plain_bitwise(cuda, model, dtype):
    """Each cluster build at a small wide width, as the C side plans it and
    with C forced to 2 and 16, against its plain version: bitwise (MIZ with
    2 fixed Newton iterations); C = 1 is refused."""
    if model == "Classic":
        nx, nt = 4352, 1000
        st = ebt.SpaceTime.sin(nx, nt, 1)
        par = ebt.default_parameters("Classic")
        par["D"] = np.array([0.55, 0.65])
        E = torch.full((2, nx), 30.0, dtype=dtype, device=cuda)
        carry = ebt.Collection(E=E, Tg=E / par["cw"])
        year, plain = tcy.classic_year, tcy.classic_year_reference
        cfg = default_step_config("float32")
    else:
        nx, nt = 1088, 32
        st = ebt.SpaceTime.sin(nx, nt, 1)
        par = ebt.default_parameters("MIZ")
        par["D"] = par["D"] * COUPLING * nt / nx ** 2 * np.array([1.0, 1.1])
        carry = ebt.Collection({k: torch.zeros((2, nx), dtype=dtype, device=cuda)
                                for k in tmy.CARRY_KEYS})
        year, plain = tmy.miz_year, tmy.miz_year_reference
        cfg = StepConfig(solver="pcr", newton_abstol=0.0, newton_reltol=0.0,
                         newton_max_step=50.0, newton_max_iter=2)
    f = torch.as_tensor(np.random.default_rng(7).normal(0.0, 0.5, nt), dtype=dtype,
                        device=cuda)
    want = plain(carry, par, f, st, cfg, collect_raw=True)
    kernel = "classic_year" if model == "Classic" else "miz_year"
    with pytest.MonkeyPatch.context() as mp:
        for C in (0, 2, 16):
            mp.setitem(_year.FORCE_CLUSTER, kernel, C)
            before = year.launches
            got = year(carry, par, f, st, cfg, collect_raw=True)
            assert year.launches == before + 1
            for (a, b) in zip(tensors(got), tensors(want)):
                assert torch.equal(torch.isnan(a), torch.isnan(b))
                assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), C
        mp.setitem(_year.FORCE_CLUSTER, kernel, 1)
        with pytest.raises(RuntimeError, match="cannot launch"):
            year(carry, par, f, st, cfg)


def tensors(v):
    if torch.is_tensor(v):
        yield v
    elif isinstance(v, dict):
        for k in v:
            yield from tensors(v[k])
    elif v is not None:
        for x in v:
            yield from tensors(x)
