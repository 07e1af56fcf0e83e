"""The float64 MIZ single run (``integrate``, one member, the fused engine)
against the benchmark's plain reference (``gpubench/reference``), which
imports nothing of the port.

On the CPU (``engine='fused'`` runs the whole-year kernel's plain version
there) at ``SpaceTime.sin(40, 200, 3)``: the zero state of the upstream's
headline run and seeded random states, each with seeded random ``D``, ``A``,
``B`` and forcing around the defaults, compared store by store and in the
final state. The test marked ``gpu`` runs the fused float64 K=1 kernel at
the canonical grid, ``sin(180, 2000, 2)``, and holds its own Newton updates
(its years launched with ``newton_iters=``, read through
``miz_year.newton_updates``) to the reference's count.

Tolerance: a value agrees within ``TOL`` times the largest magnitude the
reference gives its variable, and is NaN exactly where the reference's is.
Both sides stop each Newton solve at the float64 defaults (abstol 1e-11,
reltol 1e-9). On the CPU the plain version rounds as the reference does and
the two agree to the bit; the kernel orders and contracts its arithmetic
otherwise, which the adaptive Newton carries to about 1e-11 of scale in the
state and 2e-10 in single steps at nx=40. ``TOL`` leaves fifty times that,
and a float32 run, whose roundings are 1e-7 of scale before any growth,
misses it by far (:func:`test_float32_reference_fails_the_tolerance`: 1e-2
and more).
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.models.base import default_step_config
from energybalancemodel_jl_tpu_torch.ops import miz_year as miz_ops

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench.reference import STORES, run_state  # noqa: E402
from gpubench.reference.common import Grid  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-8
PARAMS = dict(ebt.default_parameters("MIZ"))
FIELDS = ("Ei", "Ew", "h", "D", "phi")
# the port's Newton defaults (models/base.py::default_step_config): float64
# with no step cap, and float32
NEWTON_F64 = {"abstol": 1e-11, "reltol": 1e-9, "max_step": math.inf, "max_iter": 30}
NEWTON_F32 = {"abstol": 0.5, "reltol": 1e-4, "max_step": 50.0, "max_iter": 30}
CASES = ["zero", "random-0", "random-1"]


def _case(name, st):
    """The parameters, forcing and initial state of a case: the zero state
    with the defaults, or a seeded random ice cap (thickness, concentration,
    floe size, its enthalpy, warm water equatorward) with ``D``, ``A``,
    ``B`` and the forcing drawn around the defaults."""
    par = dict(PARAMS)
    if name == "zero":
        return par, 0.0, {k: np.zeros(st.nx) for k in FIELDS}
    rng = np.random.default_rng([2**31 + 59, int(name.split("-")[1])])
    par.update(D=rng.uniform(0.5, 0.7), A=rng.uniform(190.0, 196.0), B=rng.uniform(2.0, 2.2))
    x = np.asarray(st.x)
    ice = x > rng.uniform(0.5, 0.9)
    phi = np.where(ice, rng.uniform(0.2, 0.99, st.nx), 0.0)
    h = np.where(ice, rng.uniform(0.2, 3.0, st.nx), 0.0)
    init = dict(Ei=-par["Lf"] * h * phi, h=h, phi=phi,
                D=np.where(ice, rng.uniform(par["Dmin"], par["Dmax"], st.nx), 0.0),
                Ew=np.where(ice, rng.uniform(0.0, 2.0, st.nx), rng.uniform(0.0, 60.0, st.nx)))
    return par, float(rng.uniform(-5.0, 5.0)), init


def _port(st, par, forcing, init, device):
    sol = ebt.integrate("MIZ", st, ebt.Forcing(forcing), par, init, dtype=torch.float64,
                        device=device, engine="fused", solver="pcr",
                        newton_max_iter=NEWTON_F64["max_iter"], progress=False,
                        raw_mode="last")
    stores = {s: {k: np.asarray(v)[None] for k, v in getattr(sol.seasonal, s).items()}
              for s in STORES}
    return stores, {k: np.asarray(sol.raw[k][-1])[None] for k in FIELDS}


def _reference(st, par, forcing, init, dtype, device, newton):
    return run_state("MIZ", Grid(st.nx, st.nt), par, {k: v[None] for k, v in init.items()},
                     st.dur, dtype, device, newton, forcing)


def _gap(got, want) -> float:
    """The largest disagreement of ``got`` with ``want``, as a share of the
    variable's largest magnitude in ``want``; inf where NaNs differ."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        return np.inf
    finite = np.isfinite(want)
    scale = float(np.max(np.abs(want[finite]), initial=0.0)) or 1.0
    return float(np.max(np.abs(got[finite] - want[finite]), initial=0.0)) / scale


def _gaps(got_stores, got_state, run) -> dict:
    out = {f"{s}.{k}": _gap(got_stores[s][k], run.stores[s][k])
           for s in STORES for k in run.stores[s]}
    out.update({f"state.{k}": _gap(got_state[k], run.state[k]) for k in FIELDS})
    return out


@pytest.mark.parametrize("case", CASES)
def test_port_matches_the_reference(case):
    st = ebt.SpaceTime.sin(40, 200, 3)
    par, forcing, init = _case(case, st)
    stores, state = _port(st, par, forcing, init, "cpu")
    run = _reference(st, par, forcing, init, torch.float64, "cpu", NEWTON_F64)
    gaps = _gaps(stores, state, run)
    assert max(gaps.values()) <= TOL, {k: v for k, v in gaps.items() if v > TOL}
    if case != "zero":  # the random state is a real ice cap, not the ice-free start
        assert np.nanmax(run.stores["avg"]["phi"]) > 0.1


def test_float32_reference_fails_the_tolerance():
    """The reference in float32 (with the port's float32 Newton defaults) on
    a random case lies outside ``TOL`` of the float64 reference: the
    tolerance tells the precisions apart."""
    st = ebt.SpaceTime.sin(40, 200, 3)
    par, forcing, init = _case("random-0", st)
    want = _reference(st, par, forcing, init, torch.float64, "cpu", NEWTON_F64)
    low = _reference(st, par, forcing, init, torch.float32, "cpu", NEWTON_F32)
    gaps = _gaps(low.stores, low.state, want)
    assert max(gaps.values()) > 100 * TOL, gaps


@pytest.mark.gpu
def test_fused_kernel_matches_the_reference_and_its_newton_count():
    """The float64 K=1 kernel at the canonical grid over two years from
    zero: the stores and final state within ``TOL`` of the reference's on
    the card, and the kernel's own Newton updates equal to the reference's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda = torch.device("cuda", 0)
    st = ebt.SpaceTime.sin(180, 2000, 2)
    par, forcing, init = _case("zero", st)
    stores, state = _port(st, par, forcing, init, cuda)
    run = _reference(st, par, forcing, init, torch.float64, cuda, NEWTON_F64)
    gaps = _gaps(stores, state, run)
    # the same kernel's years again, each launch counting its updates
    carry = ebt.Collection({k: torch.zeros((1, st.nx), dtype=torch.float64, device=cuda)
                            for k in miz_ops.CARRY_KEYS})
    f = torch.zeros(st.nt, dtype=torch.float64, device=cuda)
    st1, before = ebt.SpaceTime.sin(st.nx, st.nt, 1), miz_ops.miz_year.newton_updates
    for _ in range(st.dur):
        carry = miz_ops.miz_year(carry, par, f, st1, default_step_config("float64"),
                                 newton_iters=torch.zeros(1, dtype=torch.int32, device=cuda))[0]
    updates = miz_ops.miz_year.newton_updates - before
    print(f"kernel {updates} Newton updates, reference {run.updates}; largest gap "
          f"{max(gaps.values()):.3e}", flush=True)
    assert max(gaps.values()) <= TOL, {k: v for k, v in gaps.items() if v > TOL}
    assert updates == run.updates


def test_benchmark_configuration_runs_these_settings():
    """The benchmark's float64 MIZ configuration (``gpubench/configs/
    miz-f64.json``) states the Newton settings this file holds the port to,
    its step cap written as a finite number no update reaches, and the
    parameters and zero state of the upstream's headline run."""
    import json

    cfg = json.loads((ROOT / "gpubench" / "configs" / "miz-f64.json").read_text())
    newton = dict(cfg["newton"])
    assert newton.pop("max_step") >= 1e30
    assert newton == {k: v for k, v in NEWTON_F64.items() if k != "max_step"}
    assert cfg["dtype"] == "float64" and cfg["engine"] == "fused" and cfg["solver"] == "pcr"
    assert cfg["parameters"] == PARAMS
    assert cfg["init"] == {k: 0.0 for k in FIELDS}
