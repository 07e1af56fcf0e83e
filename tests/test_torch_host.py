"""Host types of the PyTorch port against the JAX package.

Bar (ROADMAP "held against the reference"): host types agree exactly —
SpaceTime grids and tick indices, Forcing tables, default parameters, step
configurations — and the port imports with ``jax`` blocked.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.models.base import default_step_config as jax_step_config
from energybalancemodel_jl_tpu_torch.models.base import default_step_config, dtype_name

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "energybalancemodel_jl_tpu_torch")

GRIDS = [("sin", 180, 2000, 1), ("sin", 40, 200, 3), ("identity", 50, 1000, 2)]


@pytest.mark.parametrize("grid,nx,nt,dur", GRIDS)
def test_spacetime_matches_jax_exactly(grid, nx, nt, dur):
    a = getattr(ebm.SpaceTime, grid)(nx, nt, dur)
    b = getattr(ebt.SpaceTime, grid)(nx, nt, dur)
    for name in ("u", "x", "t", "T"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    for name in ("dx", "dt", "winter_inx", "summer_inx", "nx", "nt", "dur"):
        assert getattr(a, name) == getattr(b, name), name
    assert repr(a) == repr(b)


@pytest.mark.parametrize("args", [(0.0,), (2.5,), (0.0, 5.0, -5.0, (10, 10), (0.5, -0.5))])
def test_forcing_tables_match_jax_exactly(args):
    st = ebt.SpaceTime.sin(20, 100, 60)
    a, b = ebm.Forcing(*args), ebt.Forcing(*args)
    np.testing.assert_array_equal(a.table(st), b.table(st))
    for year in (1, 17, 60):
        assert a.annual_mean(st, year) == b.annual_mean(st, year)
    assert a(17.57) == b(17.57)


@pytest.mark.parametrize("model", ["MIZ", "Classic"])
def test_default_parameters_match_jax_exactly(model):
    a, b = ebm.default_parameters(model), ebt.default_parameters(model)
    assert dict(a) == dict(b)
    assert dict(ebm.default_parval) == dict(ebt.default_parval)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_step_config_matches_jax(dtype):
    # the per-dtype Newton tolerances, including float32's max_step=50
    name = dtype_name(dtype)
    a = dataclasses.asdict(jax_step_config(name))
    b = dataclasses.asdict(default_step_config(name))
    for key, value in b.items():
        assert a[key] == value, key
    if dtype == torch.float32:
        assert b["newton_max_step"] == 50.0


def test_zeros_init_and_solutions_helpers_match_jax():
    st = ebt.SpaceTime.sin(30, 100, 2)
    a, b = ebm.zeros_init(st), ebt.zeros_init(st)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for lastonly in (True, False):
        np.testing.assert_array_equal(ebm.Solutions.stored_times(st, lastonly),
                                      ebt.Solutions.stored_times(st, lastonly))
    raw = {"E": np.arange(12.0).reshape(4, 3)}
    np.testing.assert_array_equal(ebm.annual_mean(raw)["E"], ebt.annual_mean(raw)["E"])


@pytest.mark.parametrize("module", ["models", "utils", "parallel"])
def test_public_names_of_models_and_utils_match_jax(module):
    """The port's ``models``, ``utils`` and ``parallel`` export what the JAX
    package's do, each name bound to something of the same kind."""
    import importlib

    jax_mod = importlib.import_module(f"energybalancemodel_jl_tpu.{module}")
    port_mod = importlib.import_module(f"energybalancemodel_jl_tpu_torch.{module}")
    assert set(port_mod.__all__) == set(jax_mod.__all__)
    for name in jax_mod.__all__:
        assert callable(getattr(port_mod, name)) == callable(getattr(jax_mod, name)), name
    # the JAX registry may hold test-only models other test files registered
    assert ebt.models.available_models() == ["Classic", "MIZ"]
    assert set(ebt.models.available_models()) <= set(ebm.models.available_models())


def test_collection_is_a_plain_dot_dict():
    c = ebt.Collection(D=0.6)
    c.F = 1.0
    assert c["F"] == 1.0 and c.D == 0.6
    del c.F
    with pytest.raises(AttributeError):
        c.F
    assert type(c.copy()) is ebt.Collection


def test_convert_round_trip():
    rng = np.random.default_rng(3)
    carry = {"Ei": rng.normal(size=(4, 7)), "D": rng.normal(size=(4, 7))}
    seasonal = ebt.Seasonal(*({"E": rng.normal(size=(4, 7))} for _ in range(3)))
    t = ebt.from_numpy(carry, dtype=torch.float64)
    assert all(v.dtype == torch.float64 and v.device.type == "cpu" for v in t.values())
    back = ebt.to_numpy(t)
    for k in carry:
        np.testing.assert_array_equal(back[k], carry[k])
    s_back = ebt.to_numpy(ebt.from_numpy(seasonal))
    assert isinstance(s_back, ebt.Seasonal)
    np.testing.assert_array_equal(s_back.avg["E"], seasonal.avg["E"])
    assert ebt.from_numpy({"x": 1.5}, dtype=torch.float32)["x"].dtype == torch.float32


def test_convert_classic_state_and_solver_arguments():
    """The Classic carry and parameter set, and the argument tuple of the
    fixed-iteration Newton kernel (JAX ``pallas_solve_T0``), cross the
    package boundary as numpy and back unchanged."""
    rng = np.random.default_rng(4)
    par = ebm.default_parameters("Classic")
    tpar = ebt.from_numpy(par)
    assert sorted(tpar) == sorted(ebt.classic_paramset)
    assert all(v.ndim == 0 and float(v) == par[k] for k, v in tpar.items())
    carry = {"E": rng.normal(size=(3, 9)), "Tg": rng.normal(size=(3, 9))}
    back = ebt.to_numpy(ebt.from_numpy(carry))
    for k in carry:
        np.testing.assert_array_equal(back[k], carry[k])
    args = tuple(rng.normal(size=(3, 9)) for _ in range(5)) + tuple(
        rng.normal(size=9) for _ in range(3)) + (rng.normal(size=3), 2.0, 0.0, 193.0, 2.1, 0.4,
                                                 0.5)
    targs = ebt.from_numpy(args)
    assert isinstance(targs, tuple) and len(targs) == len(args)
    assert all(torch.is_tensor(v) and v.dtype == torch.float64 for v in targs)
    for a, b in zip(args, ebt.to_numpy(targs)):
        np.testing.assert_array_equal(b, a)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import energybalancemodel_jl_tpu_torch as ebt\n"
        "from energybalancemodel_jl_tpu_torch.ops import miz_year, classic_year, _build\n"
        "from energybalancemodel_jl_tpu_torch.ops import pcr_fused, newton_t0\n"
        "from energybalancemodel_jl_tpu_torch.models import classic, miz\n"
        "from energybalancemodel_jl_tpu_torch.parallel import ensemble\n"
        "from energybalancemodel_jl_tpu_torch import convert\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax')"
        " and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "assert 'energybalancemodel_jl_tpu' not in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    offenders = []
    for root, _, files in os.walk(PORT_DIR):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    for i, line in enumerate(f, 1):
                        s = line.strip()
                        if s.startswith(("import jax", "from jax", "import optax",
                                         "import energybalancemodel_jl_tpu ",
                                         "from energybalancemodel_jl_tpu ")):
                            offenders.append(f"{path}:{i}")
    assert not offenders
