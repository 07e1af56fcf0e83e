"""Subnormal numbers in the PyTorch port's MIZ step against the JAX package.

XLA's CPU backend (and the TPU) flush subnormal results to zero; PyTorch and
the CUDA kernels keep them. Where sea ice melts away, ``Ei`` and ``phi``
decay by a factor of a few hundred per step through the subnormal range, and
kept there they reach the step's divisions and zero tests as subnormals: the
floe-size update reads ``-inf * 0``, a NaN, where the JAX package's value is
finite (found in the canonical forcing sweep, float32 and float64).

- ``utils.numerics.flush_subnormal`` equals XLA's flush bitwise, the sign of
  zero included, float32 and float64; its derivative is 0 at a flushed value
  and 1 elsewhere, exact zeros included (the MIZ gradient tests against
  ``jax.grad`` depend on it: ice-free cells hold exact zeros).
- A cell whose ice melts away through the subnormal range: every step of the
  port's MIZ step stays finite, takes the value 0 where JAX's does, and
  agrees with JAX's step at rel 1e-9 (float64) / 1e-5 (float32) on every
  value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebj
from energybalancemodel_jl_tpu.models.base import default_step_config as jax_step_config
from energybalancemodel_jl_tpu.models.base import get_model as jax_get_model
from energybalancemodel_jl_tpu.utils.collection import Collection as JaxCollection
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.models.base import default_step_config, get_model
from energybalancemodel_jl_tpu_torch.utils.numerics import flush_subnormal

torch.set_num_threads(1)
BAR_REL = {"float64": 1e-9, "float32": 1e-5}
STEPS = 40


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_flush_subnormal_matches_xla(dtype):
    fi = np.finfo(dtype)
    x = np.array([fi.tiny, -fi.tiny, fi.tiny / 2, -fi.tiny / 2, fi.tiny * (1 - fi.eps),
                  fi.smallest_subnormal, -fi.smallest_subnormal, 0.0, -0.0, 1.5, -3e-30,
                  np.inf, -np.inf, np.nan], dtype=dtype)
    # a product with a runtime 1 is not simplified away; its result is flushed
    want = np.asarray(jax.jit(lambda a, b: a * b)(jnp.asarray(x), jnp.ones_like(x)))
    assert want.dtype == x.dtype
    got = flush_subnormal(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(f"u{x.itemsize}")[:-1], want.view(f"u{x.itemsize}")[:-1])
    assert np.isnan(got[-1]) and np.isnan(want[-1])
    assert np.count_nonzero(got == 0) == 7  # the four subnormals, both zeros, fi.tiny*(1-eps)
    # the derivative: 1 but at a flushed value; an exact zero keeps it
    t = torch.from_numpy(x[:-1].copy()).requires_grad_(True)
    (g,) = torch.autograd.grad(flush_subnormal(t).sum(), t)
    flushed = (x[:-1] != 0) & (np.abs(x[:-1]) < fi.tiny)
    assert np.array_equal(g.numpy(), np.where(flushed, 0.0, 1.0).astype(dtype))


def melting_state(dtype, nx=8):
    """Warm open water everywhere, and in the first cell a little ice (phi
    1e-30 in float32, 1e-280 in float64) that melts away within the steps."""
    phi0 = 1e-30 if dtype == "float32" else 1e-280
    z = np.zeros(nx)
    s = dict(Ei=z.copy(), Ew=np.full(nx, 81.0), h=z.copy(), D=z.copy(), phi=z.copy(),
             T0=z.copy())
    s["phi"][0], s["h"][0], s["D"][0] = phi0, 36.25, 1.0
    s["Ei"][0] = -phi0 * 9.5 * 36.25
    return s


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ice_melts_through_subnormals_as_in_jax(dtype):
    nx, nt, F = 8, 2000, -7.46
    state = melting_state(dtype, nx)
    spec = jax_get_model("MIZ")
    st = ebj.SpaceTime.sin(nx, nt, 1)
    par = {k: jnp.asarray(v, dtype) for k, v in ebj.default_parameters("MIZ").items()}
    stat = spec.statics(st, par, jnp.dtype(dtype))
    cfg = jax_step_config(dtype)
    step = jax.jit(lambda c, x: spec.step(c, x, stat, par, cfg))
    c = JaxCollection({k: jnp.asarray(v, dtype) for k, v in state.items()})
    want = []
    for t in range(STEPS):
        c, out = step(c, dict(insol=stat.insol[t], f=jnp.asarray(F, dtype)))
        want.append({k: np.asarray(out[k]) for k in ("E", "Ei", "Ew", "h", "D", "phi", "n")})

    tdt = getattr(torch, dtype)
    pspec = get_model("MIZ")
    pst = ebt.SpaceTime.sin(nx, nt, 1)
    ppar = {k: torch.tensor(float(v), dtype=tdt) for k, v in ebt.default_parameters("MIZ").items()}
    pstat = pspec.statics(pst, ppar, tdt, torch.device("cpu"))
    pcfg = default_step_config(dtype)
    pc = ebt.Collection({k: torch.tensor(v, dtype=tdt) for k, v in state.items()})
    f = torch.full((nt,), F, dtype=tdt)
    worst = 0.0
    for t in range(STEPS):
        pc, out = pspec.step(pc, pspec.step_inputs(pstat, f, t), pstat, ppar, pcfg)
        for k, b in want[t].items():
            a = out[k].numpy()
            assert np.isfinite(a).all(), (t, k)
            assert np.array_equal(a == 0, b == 0), (t, k)
            rel = np.abs(a - b) / np.maximum(np.abs(b), np.finfo(dtype).tiny)
            worst = max(worst, float(rel.max()))
    assert want[0]["phi"][0] > 0 and want[-1]["phi"][0] == 0  # the ice melted away
    assert worst <= BAR_REL[dtype], worst
