"""The fused multiply-adds of XLA:CPU, reproduced by the PyTorch port.

XLA:CPU contracts ``a * b + c`` into one fused multiply-add where the
product and the sum share a fused loop and the product has no other use
there. The port makes exactly those contractions, in its plain version
(``utils/numerics.py::fma``) and in its kernels (``__fmaf_rn``/``__fma_rn``),
so that:

- the contraction itself: a jitted ``a * b + c`` is ``fma_f32``/``fma_f64``
  bitwise (a jax whose CPU backend stops contracting fails here first);
- step 1 of the scan engine (``integrate.make_year_fn``, its peeled first
  step) is bitwise JAX's for MIZ and Classic at ``SpaceTime.sin(180, 2000)``
  in float64 and float32, from zero and random states, and for the MIZ at
  ``sin(1536, 147456)`` in float32 (JAX's year graph there cut to three
  steps: its first step is the same fused loops, checked at nx = 180);
- ``ops.tridiag.pcr_solve`` is bitwise JAX's at (64, 180) and (4, 8192);
- what cannot be matched is pinned: the insolation table of JAX's MIZ
  ``statics`` rounds ``S2 x^2`` on its own in the last columns of XLA's
  vectorised loop (its scalar tail), where the port contracts it as in the
  vectorised body and in the first step.

About 40 s on one worker (the two canonical years of each model and dtype
dominate).
"""
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.models.base import default_step_config
from energybalancemodel_jl_tpu_torch.models.base import get_model as tget
from energybalancemodel_jl_tpu_torch.ops import tridiag as ttri
from energybalancemodel_jl_tpu_torch.utils.numerics import fma, fma_f32, fma_f64

CPU = torch.device("cpu")


def jax_side():
    import jax
    import jax.numpy as jnp
    from jax import lax

    import energybalancemodel_jl_tpu as ebm
    from energybalancemodel_jl_tpu.integrate import make_year_fn
    from energybalancemodel_jl_tpu.models.base import default_step_config as jcfg
    from energybalancemodel_jl_tpu.models.base import get_model as jget

    return jax, jnp, lax, ebm, make_year_fn, jcfg, jget


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_xla_contracts_a_times_b_plus_c_into_one_rounding(dtype):
    jax, jnp = jax_side()[:2]
    rng = np.random.default_rng(7)
    a, b, c = (rng.normal(size=100_000).astype(dtype) for _ in range(3))
    got = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    one = (fma_f32 if dtype == "float32" else fma_f64)(*(torch.as_tensor(v) for v in (a, b, c)))
    np.testing.assert_array_equal(got, one.numpy())
    two = a * b + c  # numpy rounds the product, then the sum
    assert (got != two).mean() > 0.1  # the two-rounding result is a different one
    mixed = fma(torch.as_tensor(a), b[0].item(), torch.as_tensor(c))  # a Python scalar operand
    assert mixed.dtype == torch.from_numpy(a).dtype


def _state(model, nx, rng, K):
    if model == "MIZ":
        h = np.abs(rng.normal(1.0, 0.6, (K, nx))) * (rng.uniform(size=(K, nx)) > 0.2)
        phi = np.where(h > 0, rng.uniform(0.1, 1.0, (K, nx)), 0.0)
        return dict(Ei=-9.5 * h * phi * rng.uniform(0.5, 1.5, (K, nx)),
                    Ew=np.abs(rng.normal(0, 20, (K, nx))), h=h,
                    D=np.where(h > 0, rng.uniform(1.0, 150.0, (K, nx)), 0.0), phi=phi,
                    T0=rng.normal(-5, 4, (K, nx)))
    return dict(E=rng.normal(0, 40, (K, nx)), Tg=rng.normal(0, 10, (K, nx)))


def _init(model, st):
    if model == "MIZ":
        return {k: v[None] for k, v in ebt.zeros_init(st).items()} | {"T0": np.zeros((1, st.nx))}
    E0 = np.full((1, st.nx), 30.0)
    return {"E": E0, "Tg": E0 / 9.8}


def _port_step1(model, st, dtype, state):
    """The port's first step of a year (its step_inputs at t = 0) for each
    member alone, as the JAX single runs take it."""
    spec = tget(model)
    tdt = getattr(torch, dtype)
    par = ebt.default_parameters(model)
    tpar = ebt.Collection({k: torch.as_tensor(np.asarray(v, dtype)) for k, v in par.items()})
    stat = spec.statics(st, tpar, tdt, CPU)
    xs = spec.step_inputs(stat, torch.zeros(st.nt + 1, dtype=tdt), 0)
    outs = []
    for m in range(next(iter(state.values())).shape[0]):
        carry = ebt.Collection({k: torch.as_tensor(np.asarray(v[m], dtype))
                                for k, v in state.items()})
        outs.append(spec.step(carry, xs, stat, tpar, default_step_config(dtype))[1])
    return {k: torch.stack([o[k] for o in outs]).numpy()
            for k in outs[0] if k != "newton_converged"}


def _jax_step1(model, st, dtype, state, full_year):
    jax, jnp, lax, ebm, make_year_fn, jcfg, jget = jax_side()
    spec = jget(model)
    par = ebm.default_parameters(model)
    jpar = ebm.Collection({k: jnp.asarray(v, dtype) for k, v in par.items()})
    cfg = jcfg(dtype)
    if full_year:
        fn = jax.jit(make_year_fn(model, st, cfg, dtype, True))
        run = lambda c: {k: np.asarray(v[0]) for k, v in fn(c, jpar, np.zeros(st.nt))[3].items()}
    else:
        # make_year_fn's graph for three steps: statics from the traced
        # parameters, the first step peeled, a scan over the rest
        @jax.jit
        def three(carry, p):
            stat = spec.statics(st, p, jnp.dtype(dtype))
            xs = ebm.Collection(spec.step_inputs(stat, jnp.zeros(st.nt, dtype)))
            xs = jax.tree_util.tree_map(lambda v: v[:3], xs)
            carry, out0 = spec.step(carry, jax.tree_util.tree_map(lambda v: v[0], xs), stat, p,
                                    cfg)
            carry, _ = lax.scan(lambda c, x: spec.step(c, x, stat, p, cfg), carry,
                                jax.tree_util.tree_map(lambda v: v[1:], xs))
            return out0

        run = lambda c: {k: np.asarray(v) for k, v in three(c, jpar).items()}
    outs = [run(ebm.Collection({k: jnp.asarray(v[m], dtype) for k, v in state.items()}))
            for m in range(next(iter(state.values())).shape[0])]
    return {k: np.stack([o[k] for o in outs]) for k in outs[0] if k != "newton_converged"}


@pytest.mark.parametrize("model,dtype,nx,nt", [
    ("MIZ", "float64", 180, 2000), ("MIZ", "float32", 180, 2000),
    ("Classic", "float64", 180, 2000), ("Classic", "float32", 180, 2000),
    ("MIZ", "float32", 1536, 147456),
])
def test_first_step_of_the_scan_engine_is_jax_bitwise(model, dtype, nx, nt):
    st = ebt.SpaceTime.sin(nx, nt, 1)
    states = [_init(model, st)]
    if nx == 180:
        states.append(_state(model, nx, np.random.default_rng(11), 3))
    for state in states:
        want = _jax_step1(model, st, dtype, state, full_year=nx == 180)
        got = _port_step1(model, st, dtype, state)
        for k in want:
            a, b = want[k], got[k]
            assert a.tobytes() == b.tobytes(), (
                k, int(np.sum((a != b) & ~(np.isnan(a) & np.isnan(b)))))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("K,n", [(64, 180), (4, 8192)])
def test_pcr_solve_is_jax_bitwise(dtype, K, n):
    jax = jax_side()[0]
    from energybalancemodel_jl_tpu.ops import tridiag as jtri

    rng = np.random.default_rng(n)
    lo = rng.uniform(-1, 1, (K, n))
    up = rng.uniform(-1, 1, (K, n))
    lo[:, 0] = up[:, -1] = 0.0
    di = (np.abs(lo) + np.abs(up) + rng.uniform(0.1, 2, (K, n))) * rng.choice([-1, 1], (K, 1))
    b = rng.normal(size=(K, n))
    bands = [v.astype(dtype) for v in (lo, di, up, b)]
    want = np.asarray(jax.jit(jtri.pcr_solve)(*bands))
    got = ttri.pcr_solve(*(torch.as_tensor(v) for v in bands)).numpy()
    assert want.tobytes() == got.tobytes()
    # the Newton update's solve: XLA folds the negation of its right-hand
    # side into the first level, which contracts the other product there
    want = np.asarray(jax.jit(lambda lo, di, up, r: jtri.pcr_solve(lo, di, up, -r))(*bands))
    t = [torch.as_tensor(v) for v in bands]
    got = ttri.pcr_solve(t[0], t[1], t[2], -t[3], negated=True).numpy()
    assert want.tobytes() == got.tobytes()


def test_the_insolation_table_rounds_s2_x2_alone_in_the_loops_tail():
    """Pinned: JAX's MIZ insolation table (``models/miz.py::statics``, one
    fused loop over (nt, nx)) is the port's rows bitwise in float64 except
    in the scalar tail of XLA's vectorised loop, the columns past the last
    full vector step (176-179 of 180), where ``S2 x^2`` is rounded before
    the subtraction: ``fma(-S1 x, cos, S0) - S2 x^2``. The port contracts
    it everywhere, as the first step and the vectorised body do."""
    jax, jnp, lax, ebm = jax_side()[:4]
    from energybalancemodel_jl_tpu.models import miz as jmiz
    from energybalancemodel_jl_tpu_torch.models import miz as tmiz

    st = ebt.SpaceTime.sin(180, 2000, 1)
    par = ebm.default_parameters("MIZ")
    jpar = ebm.Collection({k: jnp.asarray(v, jnp.float64) for k, v in par.items()})
    want = np.asarray(jax.jit(lambda p: jmiz.statics(st, p, jnp.float64).insol)(jpar))
    tpar = ebt.Collection({k: torch.as_tensor(np.asarray(v, np.float64)) for k, v in par.items()})
    stat = tmiz.statics(st, tpar, torch.float64, CPU)
    got = np.stack([tmiz.insolation(stat, t).numpy() for t in range(st.nt)])
    differ = np.nonzero((want != got).any(axis=0))[0]
    assert differ.tolist() == [176, 177, 178, 179]
    tail = np.stack([(fma(-stat.S1x, stat.cosv[t], stat.S0) - stat.S2 * stat.x2).numpy()
                     for t in range(st.nt)])
    np.testing.assert_array_equal(want[:, 176:], tail[:, 176:])
    assert np.max(np.abs(want - got)) <= 4 * np.spacing(np.max(np.abs(want)))
