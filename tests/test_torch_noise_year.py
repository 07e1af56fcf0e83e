"""The plain noisy years of the port (``ops/miz_year.py``,
``ops/classic_year.py`` with ``noise=``, ``noise_ou=``, ``noise_keys=``,
``ou_assoc=True``, ``crossing=``) against the JAX package's
``pallas_{miz,classic}_year(interpret=True, layout="xk", ...)``, on the CPU.

Bars:
- the year-end OU value ``eta`` in serial mode: bitwise (the same draws
  and the same fused multiply-adds as XLA:CPU evaluates the JAX kernels);
- float64 table and table/OU fields: 1e-8 (rtol and atol, the bar of the
  deterministic years' parity tests);
- float32 keys-mode fields: JAX's own fused-vs-XLA bars
  (``tests/test_pallas_year.py``): atol 0.5 on the carry, 0.05 on the
  seasonal stores;
- ``ou_assoc=True`` against serial: engine parity, 1e-5 relative on eta;
- sigma = 0 (scale 0, eta0 0): bitwise the deterministic plain year; keys
  mode: bitwise the table mode fed ``prng.normal_table``;
- crossing steps equal, except members whose area at that step lies within
  1e-6 (relative) of the threshold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.models.base import default_step_config as jcfg
from energybalancemodel_jl_tpu.ops.pallas_year import pallas_classic_year, pallas_miz_year
from energybalancemodel_jl_tpu_torch.integrate import make_year_fn
from energybalancemodel_jl_tpu_torch.models.base import default_step_config
from energybalancemodel_jl_tpu_torch.ops import _year, prng
from energybalancemodel_jl_tpu_torch.ops import classic_year as tcy
from energybalancemodel_jl_tpu_torch.ops import miz_year as tmy

K = 4
OU = (0.9, 3.0, 0.7)


def case(model, dtype, nx=16):
    """Seeded inputs: the grid, parameters with D swept, the carry (MIZ from
    zeros, Classic from the warm state), a forcing row, as numpy."""
    nt = 48 if model == "MIZ" else 1000
    st = ebt.SpaceTime.sin(nx, nt, 1)
    par = dict(ebt.default_parameters(model))
    par["D"] = np.linspace(0.55, 0.65, K)
    if model == "MIZ":
        carry = {k: np.zeros((K, nx)) for k in tmy.CARRY_KEYS}
        f = np.full(nt, 2.0)
    else:
        E = np.full((K, nx), 12.0)
        carry = {"E": E, "Tg": E / par["cw"]}
        f = np.full(nt, -8.0)
    return st, par, carry, f


def run_jax(model, st, par, carry, f, dtype, **kw):
    fn = pallas_miz_year if model == "MIZ" else pallas_classic_year
    jst = ebm.SpaceTime.sin(st.nx, st.nt, 1)
    jkw = {}
    for k, v in kw.items():
        if k == "noise_ou" or k == "crossing":
            jkw[k] = tuple(jnp.asarray(np.asarray(x), dtype) for x in v)
        elif k == "noise_keys":
            jkw[k] = jnp.asarray(v)
        elif k == "noise":
            jkw[k] = jnp.asarray(np.asarray(v), dtype)
        else:
            jkw[k] = v
    out = fn(ebm.Collection({k: jnp.asarray(v, dtype) for k, v in carry.items()}),
             ebm.Collection({k: jnp.asarray(v, dtype) for k, v in par.items()}),
             jnp.asarray(f, dtype), jst, jcfg(dtype), interpret=True, layout="xk", **jkw)
    return out


def run_torch(model, st, par, carry, f, dtype, **kw):
    fn = tmy.miz_year if model == "MIZ" else tcy.classic_year
    tdt = getattr(torch, dtype)
    c = ebt.Collection({k: torch.as_tensor(v, dtype=tdt) for k, v in carry.items()})
    return fn(c, par, torch.as_tensor(f, dtype=tdt), st, default_step_config(dtype), **kw)


def assert_fields(out_t, out_j, carry_tol, store_tol, label):
    """Hold the carry and the seasonal stores to their bars; print the
    largest differences (``pytest -s`` shows them)."""
    worst = {"carry": 0.0, "stores": 0.0}
    for k in out_t[0]:
        a, b = out_t[0][k].numpy(), np.asarray(out_j[0][k])
        np.testing.assert_allclose(a, b, rtol=carry_tol, atol=carry_tol, err_msg=k)
        worst["carry"] = max(worst["carry"], float(np.max(np.abs(a - b))))
    for name, a, b in zip(("winter", "summer", "avg"), out_t[1], out_j[1]):
        for k in a:
            x, y = a[k].numpy(), np.asarray(b[k])
            np.testing.assert_allclose(x, y, rtol=store_tol, atol=store_tol,
                                       err_msg=f"{name}.{k}", equal_nan=True)
            worst["stores"] = max(worst["stores"], float(np.nanmax(np.abs(x - y), initial=0.0)))
    print(f"[{label}] max |port - JAX| carry {worst['carry']:.3e} stores {worst['stores']:.3e}")


def bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("model", ["MIZ", "Classic"])
def test_f64_table_modes_match_jax(model):
    st, par, carry, f = case(model, "float64")
    table = np.random.default_rng(1).normal(size=(st.nt, K))
    for kw in (dict(noise=table), dict(noise=table, noise_ou=OU)):
        out_t = run_torch(model, st, par, carry, f, "float64", **kw)
        out_j = run_jax(model, st, par, carry, f, jnp.float64, **kw)
        mode = "table/OU" if "noise_ou" in kw else "table"
        assert_fields(out_t, out_j, 1e-8, 1e-8, f"{model} f64 {mode}")
        if "noise_ou" in kw:
            assert bits(out_t[3].numpy(), out_j[3])
        else:
            assert out_t[3] is None and out_j[3] is None


@pytest.mark.parametrize("model", ["MIZ", "Classic"])
def test_f32_keys_modes_match_jax(model):
    st, par, carry, f = case(model, "float32")
    keys = prng.member_year_keys(3, K, 1)
    serial = run_torch(model, st, par, carry, f, "float32", noise_keys=keys, noise_ou=OU)
    out_j = run_jax(model, st, par, carry, f, jnp.float32, noise_keys=keys, noise_ou=OU)
    assert_fields(serial, out_j, 0.5, 0.05, f"{model} f32 keys/serial")
    assert bits(serial[3].numpy(), out_j[3])
    assoc = run_torch(model, st, par, carry, f, "float32", noise_keys=keys, noise_ou=OU,
                      ou_assoc=True)
    assoc_j = run_jax(model, st, par, carry, f, jnp.float32, noise_keys=keys, noise_ou=OU,
                      ou_assoc=True)
    assert_fields(assoc, assoc_j, 0.5, 0.05, f"{model} f32 keys/assoc")
    np.testing.assert_allclose(assoc[3].numpy(), np.asarray(assoc_j[3]), rtol=1e-5)
    np.testing.assert_allclose(assoc[3].numpy(), serial[3].numpy(), rtol=1e-5)
    rel = np.abs(assoc[3].numpy() - serial[3].numpy()) / np.abs(serial[3].numpy())
    print(f"[{model} f32 keys/assoc] eta vs serial max rel {float(rel.max()):.3e}")


def step_areas(model, st, par, carry, f, keys):
    """Every step's crossing area of the plain keys/serial year, float64."""
    areas = []
    w = _year.trapezoid_weights(st.x, torch.float32)

    def hook(t, out):
        v = out["phi"] if model == "MIZ" else (out["E"] < 0).float()
        areas.append((torch.nan_to_num(v) * w).double().sum(-1))

    offsets, _ = _year.noise_offsets(None, OU, keys, False, K, st.nt, torch.float32, "cpu",
                                     unroll=1 if model == "MIZ" else _year.classic_ou_unroll(st.nt))
    cols = tmy.PAR_NAMES + tmy.XK_TABLE_ROWS + ("m2",) if model == "MIZ" else tcy.PAR_NAMES
    pc = _year.member_columns(par, cols, K, torch.float32, "cpu")
    fr = (torch.as_tensor(f, dtype=torch.float32)[:, None] + pc.pop("F")[None, :]) + offsets
    year = make_year_fn(model, st, default_step_config("float32"), False, hook)
    year(ebt.Collection({k: torch.as_tensor(v, dtype=torch.float32) for k, v in carry.items()}),
         ebt.Collection({n: v[:, None] for n, v in pc.items()}), fr[:, :, None])
    return torch.stack(areas).numpy()


@pytest.mark.parametrize("model", ["MIZ", "Classic"])
def test_crossing_steps_match_jax(model):
    st, par, carry, f = case(model, "float32")
    keys = prng.member_year_keys(5, K, 0)
    areas = step_areas(model, st, par, carry, f, keys)
    thr = np.quantile(areas, 0.5, axis=0).astype(np.float32)  # a crossing inside the year
    sgn = np.where(areas[0] < thr, 1.0, -1.0).astype(np.float32)
    kw = dict(noise_keys=keys, noise_ou=OU, crossing=(thr, sgn))
    got = run_torch(model, st, par, carry, f, "float32", **kw)[4].numpy()
    want = np.asarray(run_jax(model, st, par, carry, f, jnp.float32, **kw)[4])
    print(f"[{model} crossing] port {got.tolist()} JAX {want.tolist()}")
    assert (got >= 0).any()
    for k in range(K):
        if got[k] != want[k]:
            step = int(min(s for s in (got[k], want[k]) if s >= 0))
            assert abs(areas[step, k] - thr[k]) <= 1e-6 * abs(thr[k]), (k, got[k], want[k])


@pytest.mark.parametrize("model", ["MIZ", "Classic"])
def test_sigma_zero_is_the_deterministic_year_and_keys_equal_table(model):
    st, par, carry, f = case(model, "float32")
    keys = prng.member_year_keys(2, K, 4)
    det = run_torch(model, st, par, carry, f, "float32")
    for assoc in (False, True):
        zero = run_torch(model, st, par, carry, f, "float32", noise_keys=keys,
                         noise_ou=(0.9, 0.0, 0.0), ou_assoc=assoc)
        for a, b in zip((zero[0], *zero[1]), (det[0], *det[1])):
            for k in a:
                assert bits(a[k].numpy(), b[k].numpy()), k
        assert not zero[3].any()
    by_keys = run_torch(model, st, par, carry, f, "float32", noise_keys=keys, noise_ou=OU)
    by_table = run_torch(model, st, par, carry, f, "float32",
                         noise=prng.normal_table(keys, st.nt), noise_ou=OU)
    for a, b in zip((by_keys[0], *by_keys[1]), (by_table[0], *by_table[1])):
        for k in a:
            assert bits(a[k].numpy(), b[k].numpy()), k
    assert bits(by_keys[3].numpy(), by_table[3].numpy())


@pytest.mark.parametrize("kw,match", [
    (dict(noise=np.zeros((48, K)), noise_keys=np.zeros((K, 2), np.uint32)), "mutually exclusive"),
    (dict(noise_ou=OU), "requires the white-noise table"),
    (dict(noise_keys=np.zeros((K, 2), np.uint32)), "requires noise_ou"),
    (dict(noise=np.zeros((48, K)), noise_ou=OU, ou_assoc=True), "ou_assoc=True"),
    (dict(noise=np.zeros((48, K)), noise_ou=OU, crossing=(0.1, 1.0)), "crossing="),
    (dict(noise_keys=np.zeros((K, 2), np.uint32), noise_ou=OU, crossing=(0.1,)), "threshold"),
    (dict(noise=np.zeros((47, K))), r"\(nt, K\)"),
    (dict(noise_keys=np.zeros((K, 3), np.uint32), noise_ou=OU), "uint32 key-data"),
])
def test_noise_argument_errors(kw, match):
    st, par, carry, f = case("MIZ", "float32")
    with pytest.raises(ValueError, match=match):
        run_torch("MIZ", st, par, carry, f, "float32", **kw)
    with pytest.raises(ValueError, match="float32"):
        run_torch("MIZ", st, par, carry, f, "float64", noise_keys=prng.member_year_keys(0, K, 0),
                  noise_ou=OU)
