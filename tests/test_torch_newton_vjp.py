"""The Newton root's implicit-function VJP in the PyTorch port
(``models/miz.py::_NewtonRoot``) against the JAX package's, float64 on the
CPU, and the host pieces of the equilibrium layer.

- The VJP against JAX ``_newton_root``'s custom VJP on seeded inputs: rel
  1e-9; ``J v`` by a second backward
  through it against the dense Jacobian: 1e-10.
- The kernel wrappers' gradient check; the numeric helpers and
  ``default_dtype`` against their JAX counterparts (host operators: equal to
  1e-13 relative); the import rule (no ``jax``, nothing of the JAX package,
  in the port or ``chip_smoke.py``).
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.models import miz as jax_miz
from energybalancemodel_jl_tpu.models.base import default_step_config as jax_step_config
from energybalancemodel_jl_tpu_torch.models import miz as port_miz
from energybalancemodel_jl_tpu_torch.models.base import default_step_config, get_model
from energybalancemodel_jl_tpu_torch.ops._year import refuse_grad
from energybalancemodel_jl_tpu_torch.ops.diffusion import diffusion_bands
from energybalancemodel_jl_tpu_torch.ops.miz_year import miz_year

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
BAR_JAX = 1e-9


# -- the Newton root ---------------------------------------------------------

def newton_inputs(nx=8, K=3, seed=0):
    """Seeded arguments of the T0 residual on a (K, nx) batch, the order of
    ``_t0_residual``'s ``args``, with the canonical stencil bands."""
    g = np.random.default_rng(seed)
    st = ebt.SpaceTime.sin(nx, 50, 1)
    geom = diffusion_bands(st)
    par = ebt.default_parameters("MIZ")
    args = [
        g.uniform(50.0, 250.0, (K, nx)),          # insol
        g.uniform(0.1, 2.0, (K, nx)),             # hp
        g.normal(0.0, 3.0, (K, nx)),              # Tw
        g.uniform(0.0, 1.0, (K, nx)),             # phi
        np.asarray(g.normal(0.0, 2.0)),           # f
        np.asarray(geom.lo), np.asarray(geom.di), np.asarray(geom.up),
        np.asarray(par["k"]), np.asarray(par["Tm"]), np.asarray(par["A"]),
        np.asarray(par["B"]), np.asarray(par["ai"]), g.uniform(0.5, 0.7, (K, 1)),  # D
    ]
    return g.normal(-8.0, 4.0, (K, nx)), args


def relmax(a, b):
    """max |a - b| / |b| over the entries where b != 0 (0 where none)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nz = b != 0
    return float(np.max(np.abs(a - b)[nz] / np.abs(b[nz]), initial=0.0))


def test_newton_root_vjp_matches_jax(record_property):
    T0w, args = newton_inputs()
    cot = np.random.default_rng(1).normal(size=T0w.shape)
    jcfg = jax_step_config("float64")
    jargs = tuple(jnp.asarray(a) for a in args)
    (jT0, _, _), vjp = jax.vjp(lambda a: jax_miz._newton_root(jnp.asarray(T0w), a, jcfg), jargs)
    jgrads = vjp((jnp.asarray(cot), jnp.zeros(T0w.shape[0], bool), jnp.int32(0)))[0]

    targs = [torch.tensor(a, dtype=F64, requires_grad=True) for a in args]
    T0, _ = port_miz._NewtonRoot.apply(default_step_config("float64"), [],
                                       torch.tensor(T0w), *targs)
    np.testing.assert_allclose(T0.detach().numpy(), np.asarray(jT0), rtol=1e-12, atol=1e-12)
    grads = torch.autograd.grad(T0, targs, grad_outputs=torch.tensor(cot))
    record_property("max_rel_vs_jax", max(relmax(gp.numpy(), gj) for gp, gj in
                                          zip(grads, jgrads)))
    for i, (gp, gj) in enumerate(zip(grads, jgrads)):
        np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=BAR_JAX, atol=1e-12,
                                   err_msg=f"arg {i}")


def test_newton_root_jvp_by_double_backward_is_exact(record_property):
    """J v of the root with respect to the forcing and D columns, by a second
    backward through the implicit VJP, against the dense Jacobian
    (``torch.autograd.functional.jacobian``) and a central difference."""
    T0w, args = newton_inputs(K=2)
    cfg = default_step_config("float64")
    base = [torch.tensor(a, dtype=F64) for a in args]

    def root(Tw):
        a = list(base)
        a[2] = Tw
        return port_miz._NewtonRoot.apply(cfg, [], torch.tensor(T0w), *a)[0]

    Tw = base[2].clone().requires_grad_(True)
    v = torch.tensor(np.random.default_rng(5).normal(size=T0w.shape))
    u = torch.zeros_like(Tw, requires_grad=True)
    out = root(Tw)
    g = torch.autograd.grad(out, Tw, grad_outputs=u, create_graph=True)[0]
    jv = torch.autograd.grad(g, u, grad_outputs=v)[0]
    J = torch.autograd.functional.jacobian(root, base[2])  # (K, nx, K, nx)
    dense = torch.einsum("ijkl,kl->ij", J, v)
    record_property("max_abs_vs_dense", float((jv - dense).abs().max()))
    np.testing.assert_allclose(jv.numpy(), dense.numpy(), rtol=1e-10, atol=1e-10)
    eps = 1e-6
    fd = (root(base[2] + eps * v) - root(base[2] - eps * v)) / (2 * eps)
    np.testing.assert_allclose(jv.numpy(), fd.numpy(), rtol=1e-5, atol=1e-7)


def test_residual_vjp_by_hand_equals_autograd_ties_included():
    """The written-out VJP of the T0 residual (the Newton root's backward)
    against autograd of the residual itself, every argument at its own shape
    (scalars, (K, 1) columns, (nx,) rows, (K, nx) fields), with a third of
    the cells at T0 == Tm, where min(T0, Tm) splits its derivative half and
    half: equal to 1e-13 relative."""
    T0w, args = newton_inputs(K=3)
    T0 = torch.tensor(T0w)
    T0[:, ::3] = float(args[9])  # ties with Tm
    leaves = [torch.tensor(a, dtype=F64, requires_grad=True) for a in args]
    u = torch.tensor(np.random.default_rng(3).normal(size=T0w.shape))
    want = torch.autograd.grad(port_miz._t0_residual(T0, leaves), leaves, grad_outputs=u)
    got = port_miz._t0_residual_vjp(T0, [a.detach() for a in leaves], u, range(len(args)))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-13, atol=1e-13,
                                   err_msg=f"arg {i}")


# -- the kernel wrappers' gradient check ---------------------------------------

def test_refuse_grad_raises_on_inputs_that_require_grad():
    x = torch.zeros(3, requires_grad=True)
    for value in (x, {"a": 1.0, "b": x}, ebt.Collection(c=(torch.zeros(2), [x]))):
        with pytest.raises(ValueError, match="engine='batched'"):
            refuse_grad("miz_year", torch.ones(2), value)
    refuse_grad("miz_year", torch.ones(2), {"a": 1.0}, None, (0.5, torch.zeros(2)))
    with torch.no_grad():  # no graph is being built: nothing is lost
        refuse_grad("miz_year", x)


def test_fused_year_on_the_cpu_keeps_its_gradient():
    """On a CPU tensor the year wrappers run their plain versions, which are
    differentiable: the check is the CUDA launch's."""
    st = ebt.SpaceTime.sin(8, 30, 1)
    par = ebt.default_parameters("MIZ")
    carry = get_model("MIZ").init_carry(ebt.zeros_init(st), st, F64, "cpu")
    carry = ebt.Collection({k: v[None] for k, v in carry.items()})
    D = torch.tensor([0.6], dtype=F64, requires_grad=True)
    out = miz_year(carry, dict(par, D=D), np.zeros(st.nt), st,
                   default_step_config("float64"))
    g = torch.autograd.grad(out[1].avg["E"].sum(), D)[0]
    assert torch.isfinite(g).all() and g.abs().sum() > 0


# -- numeric helpers and default_dtype ---------------------------------------

def test_numeric_helpers_match_jax():
    from energybalancemodel_jl_tpu.utils import numerics as jn
    from energybalancemodel_jl_tpu_torch.utils import numerics as tn

    g = np.random.default_rng(4)
    v = g.normal(size=(3, 9))
    v[0, 2] = np.nan
    ref = np.where(g.uniform(size=(3, 9)) < 0.3, 0.0, 1.0)
    mask = g.uniform(size=(3, 9)) < 0.5
    x = np.sort(g.uniform(size=9))
    t = torch.tensor(v)
    pairs = [
        (tn.condset(t, 2.5, torch.tensor(mask)), jn.condset(v, 2.5, mask)),
        (tn.condset(v, 2.5, mask), jn.condset(v, 2.5, mask)),
        (tn.zeroref(t, torch.tensor(ref)), jn.zeroref(v, ref)),
        (tn.zeroref(v, ref), jn.zeroref(v, ref)),
        (tn.nan_to_zero(t), jn.nan_to_zero(v)),
        (tn.nan_to_zero(v), jn.nan_to_zero(v)),
        (ebt.crossmean(t), jn.crossmean(v)),
        (ebt.crossmean(v), jn.crossmean(v)),
        (ebt.hemispheric_mean(t, x), jn.hemispheric_mean(v, x)),
        (ebt.hemispheric_mean(v, x), jn.hemispheric_mean(v, x)),
    ]
    for i, (a, b) in enumerate(pairs):
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        # host operators: equal to within 1e-13 relative (the mean's summation
        # order may differ by an ulp)
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-13, atol=0, err_msg=f"pair {i}")
    w = np.nan_to_num(v[1])
    assert tn.np_hemispheric_mean(w, x) == jn.np_hemispheric_mean(w, x)
    assert isinstance(tn.np_hemispheric_mean(w, x), float)


def test_default_dtype_follows_the_default_like_jax_x64():
    from energybalancemodel_jl_tpu.integrate import default_dtype as jax_default

    from energybalancemodel_jl_tpu_torch.integrate import default_dtype

    # the tests enable jax_enable_x64: the JAX default is float64
    assert np.dtype(jax_default()) == np.float64
    saved = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        assert default_dtype() == torch.float64
        torch.set_default_dtype(torch.float32)
        assert default_dtype() == torch.float32  # JAX's without x64
    finally:
        torch.set_default_dtype(saved)


# -- the import rule -----------------------------------------------------------

IMPORT_RULE = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|optax|energybalancemodel_jl_tpu)"
                         r"(\.|\s|$|,)")


def test_port_and_chip_smoke_never_import_jax_or_the_jax_package():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "energybalancemodel_jl_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if IMPORT_RULE.match(line):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
    assert not offenders


def test_equilibrium_layer_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['optax'] = None\n"
        "import energybalancemodel_jl_tpu_torch as ebt\n"
        "from energybalancemodel_jl_tpu_torch import equilibrium, sensitivity, calibrate\n"
        "assert ebt.equilibrate and ebt.stability and ebt.continuation\n"
        "assert ebt.sensitivity and ebt.calibrate\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax')"
        " and sys.modules[m] is not None]\n"
        "assert 'energybalancemodel_jl_tpu' not in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_parameters_come_in_one_order_in_every_process():
    """Flat lists of parameters line up across processes (the phase of
    ``chip_smoke.py`` that holds the card's fixed-point gradient against the
    CPU's runs each side in a process of its own): the keys follow
    ``default_parval``, not the string hashes of the process."""
    code = ("import energybalancemodel_jl_tpu_torch as ebt\n"
            "print([list(ebt.default_parameters(m)) for m in ('MIZ', 'Classic')])\n")
    outs = [subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           cwd=REPO, timeout=120,
                           env=dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED=str(seed)))
            for seed in (1, 2)]
    assert all(o.returncode == 0 for o in outs), [o.stderr for o in outs]
    here = str([list(ebt.default_parameters(m)) for m in ("MIZ", "Classic")])
    assert outs[0].stdout.strip() == outs[1].stdout.strip() == here
    assert list(ebt.default_parameters("MIZ"))[:3] == ["D", "A", "B"]
