"""The entry points of the PyTorch port — ``integrate`` and
``ensemble_integrate`` — against the golden fixture and the JAX package,
float64 on CPU.

Bars:
- golden fixture (``tests/fixtures/solution_1year.h5``, the canonical run):
  raw steps 1 and 10 at rtol 1.5e-8 / atol 1e-12 with NaNs zeroed, the
  reference CI's bar (``tests/test_regression.py:46-56``). Later steps are
  tied to the JAX compiled graph (ROADMAP) and are not a port bar;
- nx=40/nt=200 over 2 years: seasonal output of ``integrate`` (scan and
  fused engines) and ``ensemble_integrate`` (K=4, D swept, with and without
  F; batched and fused engines) against the JAX package to 1e-8 (rtol and
  atol), equal NaN positions;
- ensemble members against solo runs: 1e-10 / 1e-12, the JAX package's own
  bar (``tests/test_parallel.py:41``) — on the CPU the members share one
  Newton loop, so they agree to below its tolerance, not bitwise;
- ``years_per_dispatch`` chunking: bitwise.
"""
import dataclasses
import functools
import os

import h5py
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu.parallel.ensemble import ensemble_integrate as jax_ensemble
from energybalancemodel_jl_tpu_torch.integrate import resolve_engine
from energybalancemodel_jl_tpu_torch.parallel.ensemble import _resolve_engine

torch.set_num_threads(1)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "solution_1year.h5")
ST = ebt.SpaceTime.sin(40, 200, 2)
BAR = 1e-8


def zero_nans(a):
    a = np.array(a, copy=True)
    a[np.isnan(a)] = 0.0
    return a


def assert_seasonal_close(a, b, rtol=BAR, atol=BAR):
    for name in ("winter", "summer", "avg"):
        ca, cb = getattr(a, name), getattr(b, name)
        assert sorted(ca) == sorted(cb)
        for k in ca:
            x, y = np.asarray(ca[k]), np.asarray(cb[k])
            assert x.shape == y.shape, (name, k)
            np.testing.assert_array_equal(np.isnan(x), np.isnan(y), err_msg=f"{name}.{k} NaNs")
            np.testing.assert_allclose(np.nan_to_num(x), np.nan_to_num(y), rtol=rtol, atol=atol,
                                       err_msg=f"{name}.{k}")


def assert_bitwise(a, b):
    for name in ("winter", "summer", "avg"):
        for k, v in getattr(a, name).items():
            np.testing.assert_array_equal(v, getattr(b, name)[k], err_msg=f"{name}.{k}")


@pytest.mark.skipif(not os.path.exists(FIXTURE), reason="fixture missing")
def test_golden_fixture_steps_1_and_10():
    st = ebt.SpaceTime.sin(180, 2000, 1)
    sol = ebt.integrate("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                        ebt.zeros_init(st), dtype=torch.float64, progress=False, device="cpu")
    assert sol.raw["E"].shape == (st.nt, st.nx)
    np.testing.assert_array_equal(sol.ts, ebm.Solutions.stored_times(st, True))
    with h5py.File(FIXTURE, "r") as f:
        for k in sol.raw:
            for s in (1, 10):
                np.testing.assert_allclose(
                    zero_nans(sol.raw[k][s - 1]), zero_nans(np.asarray(f[k][f"step{s}"])),
                    rtol=1.5e-8, atol=1e-12, err_msg=f"variable {k} step {s}")


@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_integrate_matches_jax(engine):
    par = ebt.default_parameters("MIZ")
    forcing = ebt.Forcing(0.0, 1.0, 0.0, (0, 0), (1.0, -1.0))  # ramp: forcing rows vary
    j = ebm.integrate("MIZ", ST, forcing, par, ebm.zeros_init(ST), progress=False,
                      raw_mode="none")
    t = ebt.integrate("MIZ", ST, forcing, par, ebt.zeros_init(ST), dtype="float64",
                      engine=engine, raw_mode="none", progress=False, device="cpu")
    assert t.seasonal.avg["E"].shape == (ST.dur, ST.nx)
    assert_seasonal_close(t.seasonal, j.seasonal)


def ensemble_par(with_F):
    par = ebt.default_parameters("MIZ")
    par["D"] = np.linspace(0.55, 0.65, 4)
    if with_F:
        par["F"] = np.linspace(-2.0, 2.0, 4)
    return par


@functools.lru_cache(maxsize=None)
def jax_ensemble_run(with_F):
    return jax_ensemble("MIZ", ST, ebm.Forcing(0.0), ensemble_par(with_F), ebm.zeros_init(ST),
                        engine="batched", progress=False)


@pytest.mark.parametrize("engine", ["batched", "fused"])
@pytest.mark.parametrize("with_F", [False, True])
def test_ensemble_matches_jax(engine, with_F):
    par = ensemble_par(with_F)
    j = jax_ensemble_run(with_F)
    t = ebt.ensemble_integrate("MIZ", ST, ebt.Forcing(0.0), par, ebt.zeros_init(ST),
                               dtype="float64", engine=engine, progress=False, device="cpu")
    assert t.n_members == 4 and t.seasonal.avg["E"].shape == (4, ST.dur, ST.nx)
    assert_seasonal_close(t.seasonal, j.seasonal)
    assert sorted(t.swept) == (["D", "F"] if with_F else ["D"])


def test_members_match_solo_runs_and_raw_modes():
    st = ebt.SpaceTime.sin(16, 50, 2)  # the JAX package's own configuration
    Ds = np.array([0.45, 0.65])
    par = ebt.default_parameters("MIZ")
    par["D"] = Ds
    ens = ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                                 dtype="float64", raw_mode="last", progress=False, device="cpu")
    assert ens.raw["E"].shape == (2, st.nt, st.nx)
    for i, D in enumerate(Ds):
        solo = ebt.integrate("MIZ", st, ebt.Forcing(0.0), dict(par, D=float(D)),
                             ebt.zeros_init(st), dtype="float64", progress=False, device="cpu")
        assert solo.raw["E"].shape == (st.nt, st.nx)  # raw_mode='last'
        np.testing.assert_allclose(ens.seasonal.avg["E"][i], solo.seasonal.avg["E"],
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(ens.raw["E"][i], solo.raw["E"], rtol=1e-10, atol=1e-12)
        m = ens.member_solutions(i)
        assert m.lastonly and m.parameters["D"] == D
    full = ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                                  dtype="float64", raw_mode="all", progress=False, device="cpu")
    assert full.raw["E"].shape == (2, st.dur * st.nt, st.nx)
    np.testing.assert_array_equal(full.raw["E"][:, -st.nt:], ens.raw["E"])
    assert "full raw" in repr(full)


def test_raw_modes_of_integrate():
    st = ebt.SpaceTime.sin(24, 100, 2)
    par = ebt.default_parameters("MIZ")
    args = ("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st))
    last = ebt.integrate(*args, dtype="float64", progress=False, device="cpu")
    full = ebt.integrate(*args, dtype="float64", lastonly=False, progress=False, device="cpu")
    none = ebt.integrate(*args, dtype="float64", raw_mode="none", progress=False, device="cpu")
    assert last.raw["E"].shape == (st.nt, st.nx) and len(last.ts) == st.nt
    assert full.raw["E"].shape == (st.dur * st.nt, st.nx)
    np.testing.assert_array_equal(full.ts, st.T)
    assert none.raw["E"].shape == (0, st.nx) and len(none.ts) == 0
    np.testing.assert_array_equal(full.raw["E"][-st.nt:], last.raw["E"])
    assert_bitwise(last.seasonal, none.seasonal)
    # the raw year's seasonal store equals the seasonal-only year's
    assert_bitwise(full.seasonal, none.seasonal)


def test_years_per_dispatch_is_bitwise_invariant():
    st = ebt.SpaceTime.sin(16, 50, 4)
    par = ebt.default_parameters("MIZ")
    par["D"] = np.linspace(0.5, 0.7, 3)
    par["F"] = np.array([-1.0, 0.0, 1.0])
    runs = [ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                                   dtype="float64", engine="fused", years_per_dispatch=n,
                                   progress=False, device="cpu") for n in (1, 3, 4)]
    for r in runs[1:]:
        assert_bitwise(runs[0].seasonal, r.seasonal)
    single = [ebt.integrate("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                            ebt.zeros_init(st), dtype="float64", engine="fused",
                            raw_mode="none", years_per_dispatch=n, progress=False, device="cpu")
              for n in (1, 3)]
    assert_bitwise(single[0].seasonal, single[1].seasonal)


def test_engine_resolution():
    """'auto' is the kernel on a CUDA device and the eager loop on the CPU;
    on a CUDA device a run the kernel cannot take raises, it never falls
    back to the eager loop. An explicit eager engine stays the caller's."""
    st = ebt.SpaceTime.sin(180, 2000, 1)
    wide = ebt.SpaceTime.sin(2048, 100, 1)  # nx > 1024: one cell per thread no more
    gpu, cpu = torch.device("cuda"), torch.device("cpu")
    spec = ebt.integrate.__globals__["get_model"]("MIZ")
    assert resolve_engine("MIZ", st, gpu) == "fused"
    assert resolve_engine("MIZ", st, cpu) == "scan"
    assert resolve_engine("MIZ", wide, cpu, "fused") == "fused"  # the plain version
    assert _resolve_engine("auto", spec, st, gpu, "pcr") == "fused"
    assert _resolve_engine("auto", spec, st, cpu, "pcr") == "batched"
    for eager in (lambda: resolve_engine("MIZ", wide, gpu, "scan"),
                  lambda: _resolve_engine("batched", spec, wide, gpu, "pcr"),
                  lambda: resolve_engine("MIZ", st, gpu, "scan", solver="thomas")):
        assert eager() in ("scan", "batched")
    with pytest.raises(ValueError, match="M8"):
        resolve_engine("MIZ", wide, gpu)
    with pytest.raises(ValueError, match="M8"):
        _resolve_engine("auto", spec, wide, gpu, "pcr")
    with pytest.raises(ValueError, match="solver='thomas' runs on engine='scan'"):
        resolve_engine("MIZ", st, gpu, solver="thomas")
    with pytest.raises(ValueError, match="solver='thomas' runs on engine='batched'"):
        _resolve_engine("fused", spec, st, cpu, "thomas")
    # Classic: the kernel takes up to 4 cells per thread of a 1024-thread block
    classic = ebt.integrate.__globals__["get_model"]("Classic")
    hires = ebt.SpaceTime.sin(4096, 1000, 1)
    assert resolve_engine("Classic", hires, gpu) == "fused"
    assert _resolve_engine("auto", classic, st, gpu, "pcr") == "fused"
    assert _resolve_engine("auto", classic, st, cpu, "pcr") == "batched"
    for too_wide in (lambda: resolve_engine("Classic", ebt.SpaceTime.sin(4097, 1000, 1), gpu),
                     lambda: _resolve_engine("auto", classic, ebt.SpaceTime.sin(8192, 1000, 1),
                                             gpu, "pcr")):
        with pytest.raises(ValueError, match="M8"):
            too_wide()


@pytest.mark.parametrize("model", ["MIZ", "Classic"])
def test_solver_resolution_of_the_fused_engine(model):
    """'pcr' and 'pcr_fused' both run the kernel's inline PCR (JAX
    pallas_year.py:979-983, integrate.py:442); 'pallas' exists on the eager
    engines only: 'auto' resolves to them on a CUDA device and an explicit
    engine='fused' raises (JAX parallel/ensemble.py:362); 'thomas' with
    'auto' on a CUDA device raises, it never falls back."""
    st = ebt.SpaceTime.sin(180, 2000, 1)
    gpu = torch.device("cuda")
    spec = ebt.integrate.__globals__["get_model"](model)
    for solver in ("pcr", "pcr_fused"):
        assert resolve_engine(model, st, gpu, solver=solver) == "fused"
        assert _resolve_engine("auto", spec, st, gpu, solver) == "fused"
    assert resolve_engine(model, st, gpu, solver="pallas") == "scan"
    assert _resolve_engine("auto", spec, st, gpu, "pallas") == "batched"
    with pytest.raises(ValueError, match="solver='pallas' runs on engine='batched'"):
        _resolve_engine("fused", spec, st, torch.device("cpu"), "pallas")
    with pytest.raises(ValueError, match="solver='thomas' runs on engine='scan'"):
        resolve_engine(model, st, gpu, solver="thomas")


def test_fused_engine_runs_solver_pcr_fused():
    """``ensemble_integrate(engine='fused', solver='pcr_fused')`` — the JAX
    package's benchmark default — runs, and equals ``solver='pcr'`` bitwise:
    both are the kernel's PCR (on the CPU, its plain version)."""
    st = ebt.SpaceTime.sin(16, 50, 2)
    par = ebt.default_parameters("MIZ")
    par["D"] = np.array([0.5, 0.7])
    runs = [ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                                   dtype="float64", engine="fused", solver=solver,
                                   raw_mode="last", progress=False, device="cpu")
            for solver in ("pcr", "pcr_fused")]
    assert_bitwise(runs[0].seasonal, runs[1].seasonal)
    np.testing.assert_array_equal(runs[0].raw["E"], runs[1].raw["E"])
    single = [ebt.integrate("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                            ebt.zeros_init(st), dtype="float64", engine="fused", solver=solver,
                            raw_mode="none", progress=False, device="cpu")
              for solver in ("pcr", "pcr_fused")]
    assert_bitwise(single[0].seasonal, single[1].seasonal)


def test_table_parameter_sweep_runs_on_the_fused_engine():
    """S1 and a0 (insolation and coalbedo table parameters) swept: both
    engines, raw year included, agree with solo runs to the members-vs-solo
    bar, and with each other bitwise (on the CPU both run the same loop)."""
    par = ebt.default_parameters("MIZ")
    par["S1"] = np.array([320.0, 350.0])
    par["a0"] = np.array([0.7, 0.72])
    st = ebt.SpaceTime.sin(24, 100, 2)
    runs = [ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                                   dtype="float64", engine=engine, raw_mode="last",
                                   progress=False, device="cpu") for engine in ("fused", "batched")]
    assert_bitwise(runs[0].seasonal, runs[1].seasonal)
    np.testing.assert_array_equal(runs[0].raw["E"], runs[1].raw["E"])
    for i in range(2):
        solo = ebt.integrate("MIZ", st, ebt.Forcing(0.0),
                             dict(par, S1=float(par["S1"][i]), a0=float(par["a0"][i])),
                             ebt.zeros_init(st), dtype="float64", progress=False, device="cpu")
        np.testing.assert_allclose(runs[0].seasonal.avg["E"][i], solo.seasonal.avg["E"],
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(runs[0].raw["E"][i], solo.raw["E"], rtol=1e-10, atol=1e-12)


def test_unported_options_and_bad_arguments_raise(tmp_path):
    st = ebt.SpaceTime.sin(8, 100, 1)
    par = ebt.default_parameters("MIZ")
    init = ebt.zeros_init(st)
    args = ("MIZ", st, ebt.Forcing(0.0), par, init)
    # the debug hook, sub-year ticks, the profiler trace and a checkpoint in
    # one run ('auto' picks the scan engine for the hook); resumes are held
    # bitwise in tests/test_torch_checkpoint.py
    ck, prof = str(tmp_path / "run.h5"), str(tmp_path / "prof")
    sols = ebt.integrate(*args, debug=lambda o, p: o["E"] * p["D"], progress_steps=25,
                         profile_dir=prof, checkpoint=ck, dtype="float64", device="cpu")
    np.testing.assert_array_equal(sols.raw["debug"], sols.raw["E"] * float(par["D"]))
    assert sols.seasonal.avg["debug"].shape == (1, 8) and sols.debug is not None
    assert os.path.getsize(os.path.join(prof, "integrate.pt.trace.json")) > 0
    with h5py.File(ck, "r") as f:
        assert int(f.attrs["years_done"]) == 1 and "T0" in f["carry"]
    with pytest.raises(ValueError, match="debug hook"):
        ebt.integrate(*args, debug=lambda o, p: o["E"], engine="fused", device="cpu")
    with pytest.warns(UserWarning, match="progress_steps is ignored"):
        ebt.integrate(*args, engine="fused", progress_steps=10, device="cpu")
    for kw in (dict(mesh=object()), dict(jit_wrapper=lambda f: f)):
        with pytest.raises(NotImplementedError, match="M14"):
            ebt.ensemble_integrate(*args, n_members=2, **kw, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        ebt.integrate(*args, engine="vmap", device="cpu")
    with pytest.raises(ValueError, match="raw_mode"):
        ebt.integrate(*args, raw_mode="some", device="cpu")
    with pytest.raises(ValueError, match="missing"):
        ebt.integrate("MIZ", st, ebt.Forcing(0.0), par, {"Ei": np.zeros(8)}, device="cpu")
    with pytest.raises(ValueError, match="Unknown model"):
        ebt.integrate("Snowball", st, ebt.Forcing(0.0), par, init, device="cpu")
    with pytest.raises(ValueError, match="missing"):  # MIZ initial conditions
        ebt.integrate("Classic", st, ebt.Forcing(0.0), par, init, device="cpu")
    with pytest.raises(ValueError, match="no whole-year kernel for model 'Other'"):
        _resolve_engine("fused", dataclasses.replace(ebt.integrate.__globals__["get_model"](
            "MIZ"), name="Other"), st, torch.device("cpu"), "pcr")
    with pytest.raises(ValueError, match="requires engine='fused'"):
        ebt.ensemble_integrate(*args, n_members=2, engine="batched", years_per_dispatch=2,
                               device="cpu")


def test_verbose_warns_on_newton_failure():
    st = ebt.SpaceTime.sin(16, 100, 1)
    with pytest.warns(UserWarning, match="Solving for T0 failed"):
        ebt.integrate("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                      ebt.zeros_init(st), dtype="float64", newton_max_iter=1, verbose=True,
                      raw_mode="none", progress=False, device="cpu")


def test_fused_engine_collects_raw_years():
    """Raw-collected years run on the fused engine too (on a GPU: the
    kernel). On the CPU its plain version is the eager engines' loop, so
    the results equal theirs bitwise, in every raw mode."""
    st = ebt.SpaceTime.sin(16, 50, 2)
    par = ebt.default_parameters("MIZ")
    args = ("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st))
    for raw_mode in ("last", "all"):
        fused, scan = (ebt.integrate(*args, dtype="float64", engine=engine, raw_mode=raw_mode,
                                     progress=False, device="cpu") for engine in ("fused", "scan"))
        assert fused.raw["E"].shape == scan.raw["E"].shape
        for k in scan.raw:
            np.testing.assert_array_equal(fused.raw[k], scan.raw[k], err_msg=k)
        assert_bitwise(fused.seasonal, scan.seasonal)
    epar = dict(par, D=np.array([0.5, 0.7]), F=np.array([-1.0, 1.0]))
    fused, batched = (ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), epar,
                                             ebt.zeros_init(st), dtype="float64",
                                             engine=engine, raw_mode="all", progress=False,
                                             device="cpu")
                      for engine in ("fused", "batched"))
    assert fused.raw["E"].shape == (2, st.dur * st.nt, st.nx)
    for k in batched.raw:
        np.testing.assert_array_equal(fused.raw[k], batched.raw[k], err_msg=k)
    assert_bitwise(fused.seasonal, batched.seasonal)


def test_device_none_is_the_gpu_and_raises_without_one(monkeypatch):
    """``device=None`` means the CUDA device for every entry point; with no
    CUDA device it raises and names ``device="cpu"``: nothing runs on the CPU
    unless asked."""
    from energybalancemodel_jl_tpu_torch.integrate import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = ebt.SpaceTime.sin(8, 100, 1)
    par = ebt.default_parameters("MIZ")
    init = ebt.zeros_init(st)
    calls = {
        "integrate": lambda: ebt.integrate("MIZ", st, ebt.Forcing(0.0), par, init),
        "ensemble_integrate": lambda: ebt.ensemble_integrate(
            "MIZ", st, ebt.Forcing(0.0), par, init, n_members=2),
        "sweep": lambda: ebt.sweep("MIZ", st, ebt.Forcing(0.0), par, {"D": [0.5, 0.6]}, init),
        "transitions": lambda: ebt.transitions("MIZ", st, 0.0, par, init, init, sigma=1.0),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
