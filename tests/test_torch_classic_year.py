"""The fused Classic year of the PyTorch port (``ops/classic_year.py``)
against the JAX package's whole-year Pallas kernel, float64 on CPU.

On a CPU tensor ``classic_year`` runs its plain PyTorch version; the JAX
side runs ``pallas_classic_year(..., interpret=True)``, as the JAX package's
own tests do off-TPU. Bar: carry and the three seasonal stores agree to 1e-8
(rtol and atol), with equal NaN positions, in both of the JAX kernel's
layouts ('xk' for ensembles, 'kx' for single runs), with D, S1 (a table
parameter) and the virtual forcing offset F swept or set, from the warm init
``E = 30, Tg = E/cw`` and from zeros; the raw-collected year agrees with the
JAX scan engine's raw steps to the same bar. Measured maximum: 4.1e-12 (the
'xk' carry from the warm init). The CUDA kernel itself is held against the
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.integrate import make_year_fn as jax_year_fn
from energybalancemodel_jl_tpu.models.base import default_step_config as jcfg
from energybalancemodel_jl_tpu.ops import pallas_year as jpy
from energybalancemodel_jl_tpu_torch.models import classic as tcl
from energybalancemodel_jl_tpu_torch.models.base import default_step_config
from energybalancemodel_jl_tpu_torch.ops import classic_year as tcy

torch.set_num_threads(1)
T64 = torch.float64
BAR = 1e-8
CFG = default_step_config("float64")


def year_inputs(K, sweep, warm, seed=0):
    rng = np.random.default_rng(seed)
    st = ebt.SpaceTime.sin(40, 1000, 1)
    par = ebt.default_parameters("Classic")
    if sweep:
        par["D"] = np.linspace(0.55, 0.65, K)
        par["S1"] = np.linspace(320.0, 350.0, K)
        par["F"] = np.linspace(-1.0, 1.0, K)
    else:
        par.update(D=0.62, S1=330.0, F=0.5)
    E0 = np.full((K, st.nx), 30.0 if warm else 0.0)
    carry = {"E": E0, "Tg": E0 / par["cw"]}
    fyear = rng.normal(0.0, 0.5, st.nt)
    return st, par, carry, fyear


def close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{what} NaN positions")
    np.testing.assert_allclose(np.nan_to_num(b), np.nan_to_num(a), rtol=BAR, atol=BAR,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def jax_year(K, layout, sweep, warm):
    st, par, carry, fyear = year_inputs(K, sweep, warm)
    return jpy.pallas_classic_year(
        ebm.Collection({k: jnp.asarray(v) for k, v in carry.items()}),
        ebm.Collection({k: jnp.asarray(v, jnp.float64) for k, v in par.items()}),
        jnp.asarray(fyear), st, jcfg("float64"), interpret=True, layout=layout)


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "zeros"])
@pytest.mark.parametrize("K,layout,sweep", [(8, "xk", True), (1, "kx", False)],
                         ids=["xk-K8-swept", "kx-K1-set"])
def test_plain_year_matches_jax_kernel(K, layout, sweep, warm):
    """'xk': K=8 with D, S1 and F swept (the JAX ensemble kernel's layout);
    'kx': K=1 with non-default D, S1 and F (its single-run layout, which
    takes scalar table parameters)."""
    st, par, carry, fyear = year_inputs(K, sweep, warm)
    jc, js, jconv, jextra = jax_year(K, layout, sweep, warm)
    before = tcy.classic_year.launches
    tc, ts, tconv, traw = tcy.classic_year(ebt.from_numpy(carry), ebt.from_numpy(par), fyear,
                                           st, CFG)
    assert tcy.classic_year.launches == before  # the CPU runs the plain version
    assert jconv is None and tconv is None and traw is None
    for k in jc:
        close(jc[k], tc[k], f"carry {k}")
    for name, a, b in zip(("winter", "summer", "avg"), js, ts):
        assert sorted(a) == sorted(b)
        for k in a:
            close(a[k], b[k], f"{name} {k}")
    if sweep:  # the sweep reaches the result: members differ
        assert not np.allclose(ts.avg["E"][0].numpy(), ts.avg["E"][-1].numpy())


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "zeros"])
def test_raw_year_matches_jax_scan_engine(warm):
    """The raw-collected year of member 0 against the JAX scan engine's year
    with the same forcing ``fyear + F``; snapshots equal the raw steps at
    the tick indices and the carry the last step, bitwise."""
    st, par, carry, fyear = year_inputs(3, True, warm, seed=2)
    tc, ts, _, traw = tcy.classic_year(ebt.from_numpy(carry), ebt.from_numpy(par), fyear, st,
                                       CFG, collect_raw=True)
    m0 = {k: (v[0] if np.ndim(v) else v) for k, v in par.items()}
    jfn = jax.jit(jax_year_fn("Classic", st, jcfg("float64"), "float64", True))
    jpar = ebm.Collection({k: jnp.asarray(v, jnp.float64) for k, v in m0.items()})
    jc, js, _, jraw = jfn(ebm.Collection({k: jnp.asarray(v[0]) for k, v in carry.items()}),
                          jpar, jnp.asarray(fyear + m0["F"]))
    assert sorted(traw) == sorted(tcy.OUT_VARS)
    for k in tcy.OUT_VARS:
        r = traw[k].numpy()
        assert r.shape == (st.nt, 3, st.nx)
        close(jraw[k], r[:, 0], f"raw {k}")
        np.testing.assert_array_equal(r[st.winter_inx - 1], ts.winter[k].numpy())
        np.testing.assert_array_equal(r[st.summer_inx - 1], ts.summer[k].numpy())
    np.testing.assert_array_equal(traw["E"][-1].numpy(), tc["E"].numpy())
    for k in jc:
        close(jc[k], tc[k][0], f"carry {k}")


def test_member_parameter_stack():
    """The kernel's (K, 18) stack holds the statics' scalar combinations,
    computed by ``models.classic.member_scalars`` — the plain version's own
    code — and the parameters the step reads."""
    par = ebt.default_parameters("Classic")
    par["D"] = np.array([0.5, 0.6])
    par["tau"] = 2e-5
    st = ebt.SpaceTime.sin(10, 1000, 1)
    stack = tcy.member_params(par, 2, st.dt, T64, torch.device("cpu"))
    assert stack.shape == (2, len(tcy.ROW_NAMES)) == (2, 18) and stack.is_contiguous()
    col = dict(zip(tcy.ROW_NAMES, stack.T.numpy()))
    stat = tcl.statics(st, ebt.from_numpy(dict(par, D=par["D"][:, None])), T64,
                       torch.device("cpu"))
    for k in ("cg_tau", "dt_tau", "dc", "M", "kLf"):
        np.testing.assert_array_equal(np.broadcast_to(stat[k].numpy().reshape(-1), (2,)),
                                      col[k], err_msg=k)
    np.testing.assert_array_equal(col["dtD"], st.dt * par["D"])
    np.testing.assert_array_equal(col["F"], [0.0, 0.0])
    np.testing.assert_array_equal(col["S1"], [338.0, 338.0])


def test_wrapper_argument_checks():
    st, par, carry, fyear = year_inputs(2, False, True)
    c = ebt.from_numpy(carry)
    with pytest.raises(ValueError, match=r"\(K, nx\) carry"):
        tcy.classic_year({k: v[0] for k, v in c.items()}, par, fyear, st, CFG)
    with pytest.raises(ValueError, match="fyear"):
        tcy.classic_year(c, par, fyear[:-1], st, CFG)
    with pytest.raises(ValueError, match=r"shape \(2,\)"):
        tcy.classic_year(c, dict(par, S1=np.ones(3)), fyear, st, CFG)
    with pytest.raises(ValueError, match="carry\\['Tg'\\]"):
        tcy.classic_year(dict(c, Tg=c["Tg"].float()), par, fyear, st, CFG)
    meta = {k: torch.empty((2, 40), dtype=T64, device="meta") for k in tcy.CARRY_KEYS}
    with pytest.raises(ValueError, match="no kernel for device"):
        tcy.classic_year(meta, par, fyear, st, CFG)
    tcy.check_nx(4096)  # the high-resolution single run of tests/test_highres.py
    tcy.check_nx(4097)  # the wide build, up to the JAX package's fused Classic reach
    tcy.check_nx(32768)
    with pytest.raises(ValueError, match="runs nx <= 32768"):
        tcy.check_nx(32769)
