"""The fused MIZ year of the PyTorch port (``ops/miz_year.py``) against the
JAX package's whole-year Pallas kernel, float64 on CPU.

On a CPU tensor ``miz_year`` runs its plain PyTorch version; the JAX side
runs ``pallas_miz_year(..., interpret=True)``, as the JAX package's own tests
do off-TPU. Bar: carry, the three seasonal stores and the convergence flag
agree to 1e-8 (rtol and atol), with equal NaN positions, in both of the JAX
kernel's layouts ('xk' for ensembles, 'kx' for single runs), with D, S1 (a
table parameter) and the virtual forcing offset F swept or set. The CUDA
kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.models.base import default_step_config as jcfg
from energybalancemodel_jl_tpu.ops import pallas_year as jpy
from energybalancemodel_jl_tpu_torch.models.base import default_step_config
from energybalancemodel_jl_tpu_torch.ops import _build
from energybalancemodel_jl_tpu_torch.ops import miz_year as tmy

torch.set_num_threads(1)
T64 = torch.float64
BAR = 1e-8


def year_inputs(K, sweep, seed=0):
    rng = np.random.default_rng(seed)
    st = ebt.SpaceTime.sin(40, 200, 1)
    par = ebt.default_parameters("MIZ")
    if sweep:
        par["D"] = np.linspace(0.55, 0.65, K)
        par["S1"] = np.linspace(320.0, 350.0, K)
        par["F"] = np.linspace(-1.0, 1.0, K)
    else:
        par.update(D=0.62, S1=330.0, F=0.5)
    carry = {k: np.zeros((K, st.nx)) for k in tmy.CARRY_KEYS}
    fyear = rng.normal(0.0, 0.5, st.nt)
    return st, par, carry, fyear


def run_both(K, layout, sweep):
    st, par, carry, fyear = year_inputs(K, sweep)
    j = jpy.pallas_miz_year(
        ebm.Collection({k: jnp.asarray(v) for k, v in carry.items()}),
        ebm.Collection({k: jnp.asarray(v, jnp.float64) for k, v in par.items()}),
        jnp.asarray(fyear), st, jcfg("float64"), interpret=True, layout=layout)
    before = tmy.miz_year.launches
    t = tmy.miz_year(ebt.from_numpy(carry), ebt.from_numpy(par), fyear, st,
                     default_step_config("float64"))
    assert tmy.miz_year.launches == before  # the CPU runs the plain version
    return j, t


def assert_year_close(j, t):
    (jc, js, jconv, jx), (tc, ts, tconv, tx) = j, t
    assert jx is None and tx is None
    assert float(jconv) == float(tconv) == 1.0

    def close(a, b, what):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, what
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{what} NaN positions")
        np.testing.assert_allclose(np.nan_to_num(b), np.nan_to_num(a), rtol=BAR, atol=BAR,
                                   err_msg=what)

    for k in jc:
        close(jc[k], tc[k], f"carry {k}")
    for name, a, b in zip(("winter", "summer", "avg"), js, ts):
        assert sorted(a) == sorted(b)
        for k in a:
            close(a[k], b[k], f"{name} {k}")


def test_layout_xk_ensemble_matches_jax():
    """K=8 with D, S1 and F swept: the JAX ensemble kernel's layout."""
    j, t = run_both(8, "xk", sweep=True)
    assert_year_close(j, t)
    # the sweep reaches the result: members differ
    assert not np.allclose(t[1].avg["E"][0].numpy(), t[1].avg["E"][-1].numpy())


def test_layout_kx_single_run_matches_jax():
    """K=1 with non-default D, S1 and F: the JAX single-run kernel's layout."""
    j, t = run_both(1, "kx", sweep=False)
    assert_year_close(j, t)


def test_wrapper_on_cpu_equals_plain_version():
    st, par, carry, fyear = year_inputs(3, sweep=True, seed=1)
    cfg = default_step_config("float64")
    a = tmy.miz_year(ebt.from_numpy(carry), ebt.from_numpy(par), fyear, st, cfg)
    b = tmy.miz_year_reference(ebt.from_numpy(carry), ebt.from_numpy(par), fyear, st, cfg)
    for x, y in zip(ebt.to_numpy(a[0]).values(), ebt.to_numpy(b[0]).values()):
        np.testing.assert_array_equal(x, y)
    for sa, sb in zip(a[1], b[1]):
        for k in sa:
            np.testing.assert_array_equal(sa[k].numpy(), sb[k].numpy())


def test_member_parameter_stack_matches_jax_layout():
    assert tmy.PAR_NAMES == jpy.PAR_NAMES
    assert tmy.XK_TABLE_ROWS == jpy.XK_TABLE_ROWS
    assert len(tmy.ROW_NAMES) == jpy.N_PAR + len(jpy.XK_TABLE_ROWS) == 23
    par = ebt.default_parameters("MIZ")
    par["D"] = np.array([0.5, 0.6])
    par["Tm"] = 1.5
    stack = tmy.member_params(par, 2, T64, torch.device("cpu"))
    assert stack.shape == (2, 23) and stack.is_contiguous()
    col = dict(zip(tmy.ROW_NAMES, stack.T.numpy()))
    np.testing.assert_array_equal(col["D"], [0.5, 0.6])
    np.testing.assert_array_equal(col["Tm_pow_m2"], [1.5 ** 1.36] * 2)
    np.testing.assert_array_equal(col["F"], [0.0, 0.0])
    np.testing.assert_array_equal(col["S1"], [338.0, 338.0])


def test_argument_checks():
    st, par, carry, fyear = year_inputs(2, sweep=False)
    cfg = default_step_config("float64")
    c = ebt.from_numpy(carry)
    with pytest.raises(ValueError, match=r"\(K, nx\) carry"):
        tmy.miz_year({k: v[0] for k, v in c.items()}, par, fyear, st, cfg)
    with pytest.raises(ValueError, match="nx=40"):
        tmy.miz_year(c, par, fyear, ebt.SpaceTime.sin(41, 200, 1), cfg)
    with pytest.raises(ValueError, match="fyear"):
        tmy.miz_year(c, par, fyear[:-1], st, cfg)
    with pytest.raises(ValueError, match=r"shape \(2,\)"):
        tmy.miz_year(c, dict(par, D=np.ones(3)), fyear, st, cfg)
    bad = dict(c, h=c["h"].float())
    with pytest.raises(ValueError, match="carry\\['h'\\]"):
        tmy.miz_year(bad, par, fyear, st, cfg)
    # a device with no kernel and no plain path raises, it never moves data
    meta = {k: torch.empty((2, 40), dtype=T64, device="meta") for k in tmy.CARRY_KEYS}
    with pytest.raises(ValueError, match="no kernel for device"):
        tmy.miz_year(meta, par, fyear, st, cfg)


def test_newton_update_count_is_the_kernels_own():
    """The per-member Newton count is a kernel output: the plain version's
    lockstep loop has none, so asking for it on the CPU raises."""
    st, par, carry, fyear = year_inputs(2, sweep=False)
    cfg = default_step_config("float64")
    with pytest.raises(ValueError, match="counted by the kernel only"):
        tmy.miz_year(ebt.from_numpy(carry), par, fyear, st, cfg,
                     newton_iters=torch.zeros(2, dtype=torch.int32))


def test_kernel_build_is_keyed_by_source_and_raises_without_nvcc(monkeypatch):
    sources = _build._sources()
    assert [s.name for s in sources] == ["classic_year.cu", "miz_year.cu", "newton_t0.cu",
                                         "normal_table.cu", "pcr.cu"]
    path = _build._library_path()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libebm_kernels_")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_raw_year_agrees_with_the_seasonal_store():
    """``collect_raw``: every step's outputs, ``(nt, K, nx)`` per variable.
    Snapshots equal the raw steps at the tick indices and the carry the last
    step, bitwise; the annual mean equals the raw mean to 1e-12 (the sums
    run in another order); the seasonal store does not depend on it."""
    st, par, carry, fyear = year_inputs(3, sweep=True, seed=2)
    cfg = default_step_config("float64")
    c, seas, conv, raw = tmy.miz_year(ebt.from_numpy(carry), ebt.from_numpy(par), fyear, st,
                                      cfg, collect_raw=True)
    plain = tmy.miz_year(ebt.from_numpy(carry), ebt.from_numpy(par), fyear, st, cfg)
    assert plain[3] is None and sorted(raw) == sorted(tmy.OUT_VARS)
    for k in tmy.OUT_VARS:
        r = raw[k].numpy()
        assert r.shape == (st.nt, 3, st.nx)
        np.testing.assert_array_equal(r[st.winter_inx - 1], seas.winter[k].numpy())
        np.testing.assert_array_equal(r[st.summer_inx - 1], seas.summer[k].numpy())
        np.testing.assert_allclose(np.mean(r, axis=0), seas.avg[k].numpy(), rtol=1e-12,
                                   atol=1e-12)
        for a, b in zip(seas, plain[1]):
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
    for k in ("Ei", "Ew", "h", "D", "phi"):
        np.testing.assert_array_equal(raw[k][-1].numpy(), c[k].numpy())


def test_kernel_build_is_keyed_by_headers_too(tmp_path):
    """Editing a header that the sources include names a new library, so a
    stale build is never loaded; every C entry point has a signature."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    before = _build._library_path(csrc)
    assert before == _build._library_path()  # the copy hashes as the package
    headers = sorted(h.name for h in csrc.glob("*.cuh"))
    assert headers == ["cluster.cuh", "common.cuh", "newton.cuh", "noise.cuh", "prng.cuh"]
    for name in headers:
        header = csrc / name
        header.write_bytes(header.read_bytes() + b"// edited\n")
        after = _build._library_path(csrc)
        assert after != before, name
        before = after
    # the residual is one function, shared by the two kernels that use it
    for user in ("miz_year.cu", "newton_t0.cu"):
        text = (csrc / user).read_text()
        assert '#include "newton.cuh"' in text and "t0_residual_bands<" in text, user
    exported = {"ebm_cuda_error_string", "ebm_normal_table", "ebm_normal_bits"} | {
        f"ebm_{k}_{d}" for k in ("miz_year", "classic_year", "pcr", "newton_t0",
                                 "miz_year_plan", "classic_year_plan", "pcr_plan",
                                 "newton_t0_plan")
        for d in ("f32", "f64")}
    assert set(_build._SIGNATURES) == exported
    for src in _build._sources():
        text = src.read_text()
        for name in exported:
            if f"int {name}(" in text:
                n_args = text.split(f"int {name}(")[1].split(")")[0].count(",") + 1
                assert len(_build._SIGNATURES[name][0]) == n_args, name
