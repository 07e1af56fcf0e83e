"""Checkpoints of the PyTorch port: resume within the port, resume across
packages, and ``config_key`` strings against the JAX package's, float64 on
the CPU (there the fused engine runs the kernels' plain versions).

Bars:
- a run interrupted after a checkpoint write and resumed equals the
  uninterrupted run bitwise (carry, raw steps, every seasonal store, NaNs at
  the same positions) for ``integrate`` (scan and fused engines),
  ``ensemble_integrate`` (batched and fused), Picard ``equilibrate``
  (batched and fused), ``continuation`` level for level, ``fold`` and
  ``edge``; an Anderson resume converges to the same tolerance, as JAX's
  ``tests/test_checkpoint.py`` holds it;
- ``config_key`` of every checkpointing driver equals the JAX package's
  string for the same call, character for character;
- a year-1 checkpoint that the JAX package wrote, resumed by the port,
  matches JAX's uninterrupted 2-year run (``SpaceTime.sin(40, 200, 2)``)
  at ``tests/test_torch_integrate.py``'s bar: rtol and atol 1e-8, NaNs at
  the same positions;
- the JAX checkpoint tests' refusals: a mismatched key warns and restarts,
  ``raw_mode='all'`` refuses to resume, the Newton cap is in the key.

The interruption is a writer that raises once the chosen year is on disk.
"""
import os

import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu as ebm
import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu import checkpoint as jck
from energybalancemodel_jl_tpu_torch import checkpoint as tck

torch.set_num_threads(1)
KW = dict(dtype="float64", device="cpu")


class Crash(Exception):
    pass


def crash_after(monkeypatch, mod, name, done, count=lambda args: args[2]):
    """Make ``mod.name`` (a checkpoint writer) raise once the write whose
    ``count(args)`` equals ``done`` is on disk."""
    orig = getattr(mod, name)

    def write(*args):
        out = orig(*args)
        if count(args) == done:
            raise Crash
        return out

    monkeypatch.setattr(mod, name, write)
    return orig


def interrupted(monkeypatch, run, mod, name, done, **count):
    orig = crash_after(monkeypatch, mod, name, done, **count)
    with pytest.raises(Crash):
        run()
    monkeypatch.setattr(mod, name, orig)


def assert_same(a, b, what=""):
    """Bitwise equality of two (nested) results, NaNs at the same places."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            assert_same(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def assert_same_solutions(a, b):
    assert_same(a.raw, b.raw, "raw")
    assert_same(tuple(a.seasonal), tuple(b.seasonal), "seasonal")


# -- integrate and ensemble_integrate --------------------------------------

ST = ebt.SpaceTime.sin(16, 50, 4)
EQ_ST = ebt.SpaceTime.sin(8, 50, 1)


def miz_run(**kw):
    return ebt.integrate("MIZ", ST, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                         ebt.zeros_init(ST), progress=False, **KW, **kw)


@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_integrate_resume_is_bit_exact(engine, tmp_path, monkeypatch):
    ck = str(tmp_path / "run.h5")
    full = miz_run(engine=engine)
    interrupted(monkeypatch, lambda: miz_run(engine=engine, checkpoint=ck),
                tck, "write_checkpoint", 2)
    assert tck.read_checkpoint(ck)[1] == 2
    resumed = miz_run(engine=engine, checkpoint=ck, resume=True)
    assert_same_solutions(resumed, full)
    assert tck.read_checkpoint(ck)[1] == ST.dur  # the final write covers the run


def test_resume_of_a_complete_run_returns_the_stored_seasons(tmp_path):
    ck = str(tmp_path / "run.h5")
    first = miz_run(engine="fused", checkpoint=ck)
    with pytest.warns(UserWarning, match="empty raw storage"):
        again = miz_run(engine="fused", checkpoint=ck, resume=True)
    assert_same(tuple(again.seasonal), tuple(first.seasonal))
    assert again.raw["E"].shape == (0, ST.nx)


def test_mismatched_key_warns_and_restarts(tmp_path):
    ck = str(tmp_path / "run.h5")
    miz_run(engine="fused", checkpoint=ck, raw_mode="none")
    par = ebt.Collection(ebt.default_parameters("MIZ"), D=0.7)
    with pytest.warns(UserWarning, match="does not match"):
        ebt.integrate("MIZ", ST, ebt.Forcing(0.0), par, ebt.zeros_init(ST), progress=False,
                      engine="fused", checkpoint=ck, resume=True, raw_mode="none", **KW)
    # a changed Newton cap is another run
    miz_run(engine="fused", checkpoint=ck, raw_mode="none")
    with pytest.warns(UserWarning, match="does not match"):
        miz_run(engine="fused", checkpoint=ck, resume=True, raw_mode="none",
                newton_max_iter=5)
    with pytest.raises(ValueError, match="raw_mode='all'"):
        miz_run(checkpoint=ck, resume=True, lastonly=False)


def ens_run(engine, **kw):
    par = ebt.Collection(ebt.default_parameters("MIZ"))
    par["D"] = np.linspace(0.55, 0.65, 3)
    par["F"] = np.array([-2.0, 0.0, 2.0])
    return ebt.ensemble_integrate("MIZ", ST, ebt.Forcing(0.0), par, ebt.zeros_init(ST),
                                  engine=engine, progress=False, **KW,
                                  **{"raw_mode": "last", **kw})


@pytest.mark.parametrize("engine", ["batched", "fused"])
def test_ensemble_resume_is_bit_exact(engine, tmp_path, monkeypatch):
    ck = str(tmp_path / "ens.h5")
    full = ens_run(engine)
    interrupted(monkeypatch, lambda: ens_run(engine, checkpoint=ck), tck,
                "write_checkpoint", 3)
    resumed = ens_run(engine, checkpoint=ck, resume=True)
    assert_same(resumed.raw, full.raw, "raw")
    assert_same(tuple(resumed.seasonal), tuple(full.seasonal), "seasonal")
    with pytest.raises(ValueError, match="raw_mode='all'"):
        ens_run(engine, checkpoint=ck, resume=True, raw_mode="all")


def test_resume_without_h5py(tmp_path, monkeypatch):
    """Where h5py is missing, the checkpoints are written and read by the
    port's numpy-only HDF5 module: the resume is bitwise all the same, and
    h5py reads the file."""
    from energybalancemodel_jl_tpu_torch import io as tio
    from energybalancemodel_jl_tpu_torch.utils.hdf5 import lite

    monkeypatch.setattr(tck, "h5py", lite)
    monkeypatch.setattr(tio, "h5py", lite)
    ck = str(tmp_path / "run.h5")
    full = miz_run(engine="fused")
    interrupted(monkeypatch, lambda: miz_run(engine="fused", checkpoint=ck),
                tck, "write_checkpoint", 1)
    assert_same_solutions(miz_run(engine="fused", checkpoint=ck, resume=True), full)
    carry, years, _, key = jck.read_checkpoint(ck)  # h5py reads the file
    assert years == ST.dur and "fused" in key and "T0" in carry
    # the continuation file grows level by level ('a' mode)
    cont = str(tmp_path / "cont.h5")
    kw = dict(vary="F", tol=1e-3, max_years=2, checkpoint=cont, **KW)
    par = ebt.default_parameters("MIZ")
    first = ebt.continuation("MIZ", EQ_ST, [0.0, 2.0], par, ebt.zeros_init(EQ_ST), **kw)
    assert len(jck.read_cont_checkpoint(cont)[0]) == 2
    again = ebt.continuation("MIZ", EQ_ST, [0.0, 2.0], par, ebt.zeros_init(EQ_ST),
                             resume=True, **kw)
    assert_same(again.years, first.years)


# -- equilibrate, continuation, fold, edge ----------------------------------

def eq_par():
    par = ebt.Collection(ebt.default_parameters("MIZ"))
    par["F"] = np.array([0.0, 4.0])
    return par


@pytest.mark.parametrize("engine", ["batched", "fused"])
def test_picard_resume_is_bit_exact(engine, tmp_path, monkeypatch):
    ck = str(tmp_path / "eq.h5")
    run = lambda **kw: ebt.equilibrate("MIZ", EQ_ST, 0.0, eq_par(), ebt.zeros_init(EQ_ST),
                                       tol=0.0, max_years=8, engine=engine, **KW, **kw)
    full = run()
    interrupted(monkeypatch, lambda: run(checkpoint=ck), tck, "write_eq_checkpoint", 4,
                count=lambda args: args[3])
    res = run(checkpoint=ck, resume=True)
    assert res.years == full.years == 8
    assert_same(res.member_years, full.member_years)
    assert_same(res.resid, full.resid)
    assert_same(res.state, full.state, "state")
    assert_same(tuple(res.seasonal), tuple(full.seasonal), "seasonal")
    # a resume of the finished run returns its state; a longer horizon
    # continues it (max_years is not in the key)
    again = run(checkpoint=ck, resume=True)
    assert again.years == 8
    assert_same(again.state, full.state)


def test_anderson_resume_converges_and_keys_refuse(tmp_path):
    ck = str(tmp_path / "eq.h5")
    par = ebt.default_parameters("MIZ")
    run = lambda **kw: ebt.equilibrate("MIZ", EQ_ST, 0.0, par, ebt.zeros_init(EQ_ST),
                                       anderson=3, checkpoint=ck, **KW, **kw)
    run(tol=1e-4, max_years=6)
    res = run(tol=1e-4, max_years=150, resume=True)
    assert res.converged and res.resid <= 1e-4 and res.years > 6
    assert "engine=batched" in tck.read_eq_checkpoint(ck)[-1]
    with pytest.warns(UserWarning, match="does not match"):
        ebt.equilibrate("MIZ", EQ_ST, 0.0, par, ebt.zeros_init(EQ_ST), tol=1e-4,
                        max_years=2, checkpoint=ck, resume=True, **KW)  # Picard: another key
    with pytest.raises(ValueError, match="checkpoint"):
        ebt.equilibrate("MIZ", EQ_ST, 0.0, eq_par(), ebt.zeros_init(EQ_ST), resume=True, **KW)


def test_continuation_resume_matches_level_for_level(tmp_path):
    ck = str(tmp_path / "cont.h5")
    par = ebt.default_parameters("MIZ")
    kw = dict(vary="F", round_trip=True, tol=1e-3, max_years=6, **KW)
    run = lambda **k: ebt.continuation("MIZ", EQ_ST, [0.0, 2.0, 4.0], par,
                                       ebt.zeros_init(EQ_ST), **kw, **k)
    full = run()
    run(checkpoint=ck)
    results, key = tck.read_cont_checkpoint(ck)
    assert len(results) == 5
    tck.write_cont_checkpoint(ck, results[:2], key)  # an interruption after level 2
    res = run(checkpoint=ck, resume=True)
    assert_same(res.years, full.years)
    for i, (a, b) in enumerate(zip(res.results, full.results)):
        assert_same(a.state, b.state, f"level {i}")
        assert_same(tuple(a.seasonal), tuple(b.seasonal), f"level {i}")
    with pytest.warns(UserWarning, match="does not match"):
        ebt.continuation("MIZ", EQ_ST, [0.0, 1.0], par, ebt.zeros_init(EQ_ST),
                         checkpoint=ck, resume=True, **kw)


def ice_pred(probe, anchor):
    """Stays on the branch while the annual-mean E stays below -10."""
    return np.asarray(probe.seasonal.avg["E"]).mean(-1) < -10.0


def test_fold_resume_is_bit_exact(tmp_path):
    ck = str(tmp_path / "fold.h5")
    par = ebt.Collection(ebt.default_parameters("MIZ"), D=np.array([0.5, 0.7]))
    run = lambda steps, **k: ebt.fold("MIZ", EQ_ST, par, ebt.zeros_init(EQ_ST), lo=20.0,
                                      hi=-10.0, steps=steps, predicate=ice_pred, tol=1e3,
                                      max_years=2, **KW, **k)
    full = run(4)
    run(2, checkpoint=ck)  # steps are not in the key: a resume may extend
    res = run(4, checkpoint=ck, resume=True)
    for name in ("lo", "hi", "history", "survived", "probe_converged"):
        assert_same(getattr(res, name), getattr(full, name), name)
    assert_same(res.anchor.state, full.anchor.state, "anchor")
    assert full.survived.any() and not full.survived.all()


def test_edge_resume_is_bit_exact(tmp_path, monkeypatch):
    ck = str(tmp_path / "edge.h5")
    par = ebt.default_parameters("MIZ")
    a = ebt.Collection({k: np.full(EQ_ST.nx, v) for k, v in
                        dict(Ei=-200.0, Ew=0.0, h=2.0, D=5.0, phi=1.0).items()})
    b = ebt.zeros_init(EQ_ST)
    run = lambda **k: ebt.edge("MIZ", EQ_ST, par, a, b, forcing=0.0, steps=4, tol=1e3,
                               max_years=2, jump_tol=1e-6, **KW, **k)
    full = run()
    interrupted(monkeypatch, lambda: run(checkpoint=ck), tck, "write_edge_checkpoint", 2,
                count=lambda args: len(args[8]))
    res = run(checkpoint=ck, resume=True)
    for name in ("wa", "wb", "history", "in_a", "probe_converged", "probe_finite"):
        assert_same(getattr(res, name), getattr(full, name), name)
    assert_same(res.result_a.state, full.result_a.state, "result_a")


# -- keys and files across packages -----------------------------------------

class Key(Exception):
    pass


def key_of(mod, ckpt_mod, monkeypatch, call):
    """The key a driver of ``mod`` checks its file against (it raises on
    the first lookup, before any year runs)."""
    def matches(path, key, kind="Checkpoint"):
        raise Key(key)

    monkeypatch.setattr(ckpt_mod, "checkpoint_matches", matches)
    with pytest.raises(Key) as e:
        call(mod)
    return e.value.args[0]


def _st(mod):
    return mod.SpaceTime.sin(12, 40, 3)


def _swept(mod):
    par = mod.Collection(mod.default_parameters("MIZ"))
    par["D"] = np.linspace(0.5, 0.7, 4)
    par["F"] = np.array([-1.0, 0.0, 1.0, 2.5])
    return par


def _ens(mod, engine, **kw):
    from importlib import import_module
    ens = import_module(mod.__name__ + ".parallel.ensemble").ensemble_integrate
    extra = KW if mod is ebt else dict(dtype="float64")
    return ens("MIZ", _st(mod), mod.Forcing(0.0, 2.0, -2.0, (1, 1), (2.0, -2.0)), _swept(mod),
               mod.zeros_init(_st(mod)), engine=engine, checkpoint="x.h5", resume=True,
               progress=False, **{**extra, **kw})


def _integrate(mod, engine, dtype="float64", **kw):
    extra = dict(device="cpu") if mod is ebt else {}
    return mod.integrate("MIZ", _st(mod), mod.Forcing(1.5), mod.default_parameters("MIZ"),
                         mod.zeros_init(_st(mod)), engine=engine, dtype=dtype,
                         checkpoint="x.h5", resume=True, progress=False, **extra, **kw)


def _eq_kw(mod, dtype="float64"):
    return dict(dtype=dtype, device="cpu") if mod is ebt else dict(dtype=dtype)


KEY_CALLS = {
    "integrate-scan": lambda m: _integrate(m, "scan"),
    "integrate-fused": lambda m: _integrate(m, "fused", dtype="float32"),
    "integrate-scan-ypd": lambda m: _integrate(m, "scan", years_per_dispatch=2,
                                               newton_max_iter=12),
    "integrate-classic": lambda m: m.integrate(
        "Classic", _st(m), m.Forcing(0.0), m.default_parameters("Classic"),
        m.zeros_init(_st(m), "Classic"), engine="fused", dtype="float32",
        checkpoint="x.h5", resume=True, progress=False,
        **(dict(device="cpu") if m is ebt else {})),
    "ensemble-batched": lambda m: _ens(m, "batched"),
    "ensemble-fused": lambda m: _ens(m, "fused", solver="pcr_fused"),
    "equilibrate": lambda m: m.equilibrate(
        "MIZ", _st(m), 0.5, _swept(m), m.zeros_init(_st(m)), engine="batched",
        metric=("E", "h"), check_every=2, checkpoint="x.h5", resume=True, **_eq_kw(m)),
    "equilibrate-anderson": lambda m: m.equilibrate(
        "MIZ", _st(m), m.Forcing(0.0), m.Collection(m.default_parameters("MIZ"), F=2.0),
        m.zeros_init(_st(m)), engine="fused", anderson=3, newton_max_iter=9,
        checkpoint="x.h5", resume=True, **_eq_kw(m, "float32")),
    "continuation": lambda m: m.continuation(
        "MIZ", _st(m), [0.0, 1.0, 2.5], m.default_parameters("MIZ"), m.zeros_init(_st(m)),
        vary="F", round_trip=True, tol=1e-3, max_years=7, checkpoint="x.h5", resume=True,
        engine="batched", **_eq_kw(m)),
    "fold": lambda m: m.fold(
        "MIZ", _st(m), m.Collection(m.default_parameters("MIZ"), D=np.array([0.4, 0.6])),
        m.zeros_init(_st(m)), lo=-10.0, hi=np.array([20.0, 25.0]), steps=3, tol=0.5,
        max_years=50, checkpoint="x.h5", resume=True, anderson=2, **_eq_kw(m)),
    "edge": lambda m: m.edge(
        "MIZ", _st(m), m.Collection(m.default_parameters("MIZ"), F=np.array([1.0, 3.0])),
        m.zeros_init(_st(m)), m.Collection({k: np.full(12, 2.0) for k in
                                            ("Ei", "Ew", "h", "D", "phi")}),
        steps=3, season="winter", checkpoint="x.h5", resume=True,
        metric=("E",), **_eq_kw(m)),
}


@pytest.mark.parametrize("name", sorted(KEY_CALLS))
def test_config_key_equals_jax(name, monkeypatch):
    call = KEY_CALLS[name]
    j = key_of(ebm, jck, monkeypatch, call)
    t = key_of(ebt, tck, monkeypatch, call)
    assert t == j
    assert "MIZ" in t or "Classic" in t


def test_torch_dtype_and_device_leave_the_key_unchanged(monkeypatch):
    call = lambda m, **kw: m.continuation(
        "MIZ", _st(m), [0.0, 1.0], m.default_parameters("MIZ"), m.zeros_init(_st(m)),
        checkpoint="x.h5", resume=True, **kw)
    j = key_of(ebm, jck, monkeypatch, lambda m: call(m, dtype="float64"))
    t = key_of(ebt, tck, monkeypatch, lambda m: call(m, dtype=torch.float64, device="cpu"))
    assert t == j


def test_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """JAX writes the year-1 checkpoint of a 2-year f64 run and is
    interrupted; the port resumes it and lands on JAX's uninterrupted run."""
    ck = str(tmp_path / "jax.h5")
    mk = lambda mod: (mod.SpaceTime.sin(40, 200, 2), mod.default_parameters("MIZ"))
    st, par = mk(ebm)
    run = lambda **kw: ebm.integrate("MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
                                     dtype="float64", progress=False, **kw)
    full = run()
    interrupted(monkeypatch, lambda: run(checkpoint=ck), jck, "write_checkpoint", 1)
    st, par = mk(ebt)
    res = ebt.integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st), checkpoint=ck,
                        resume=True, progress=False, **KW)
    assert os.path.exists(ck) and tck.read_checkpoint(ck)[1] == 2
    for k in full.raw:
        a, b = np.asarray(full.raw[k]), res.raw[k]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-8, err_msg=k)
    for s in ("winter", "summer", "avg"):
        for k in full.raw:
            a, b = np.asarray(getattr(full.seasonal, s)[k]), getattr(res.seasonal, s)[k]
            np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-8, err_msg=f"{s} {k}")
    # the first year is JAX's own, read back from its file
    np.testing.assert_array_equal(res.seasonal.avg["E"][0],
                                  np.asarray(full.seasonal.avg["E"])[0])
