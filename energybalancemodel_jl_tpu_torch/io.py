"""Persistence layer (rebuild of EnergyBalanceModel.jl src/io.jl).

The reference serializes whole ``Solutions`` objects to JLD2 (an HDF5
container). Here the container is plain HDF5 via h5py — self-describing
groups with a ``__ebm_type__`` tag — with the same safety semantics:

- ``save`` renames an EXISTING file at the target path to
  ``name_<hexid>.ext`` with a warning before writing (reference :37-52).
- ``load_into`` houses any existing variable in the safehouse before
  rebinding it (reference ``load!`` :84-92).

The files are the JAX package's, so either package loads what the other
saved. Where h5py is not installed they are written and read by
:mod:`.utils.hdf5`, a numpy-only writer of the same HDF5 layout.

Matplotlib figures save through their own writer (the reference forwards
``Makie.Figure`` to ``Makie.save``, EnergyBalanceModel.jl src/plot.jl:227-233).
"""
from __future__ import annotations

import datetime
import os
import warnings

import numpy as np

from .forcing import Forcing
from .solutions import Seasonal, Solutions
from .spacetime import SpaceTime
from .utils.collection import Collection
from .utils.hdf5 import h5py
from .utils.safehouse import house, reprhex, safehouse, unique_id

__all__ = ["save", "load", "load_into", "unsafesave", "unsafeload"]


# -- low-level writers ---------------------------------------------------

def _write_collection(grp: h5py.Group, coll) -> None:
    grp.attrs["__ebm_type__"] = "Collection"
    for k, v in coll.items():
        arr = np.asarray(v)
        grp.create_dataset(str(k), data=arr)


def _read_collection(grp: h5py.Group) -> Collection:
    out = Collection()
    for k in grp.keys():
        v = np.asarray(grp[k])
        out[k] = v.item() if v.ndim == 0 else v
    return out


def _write_solutions(f: h5py.Group, sols: Solutions) -> None:
    f.attrs["__ebm_type__"] = "Solutions"
    _write_spacetime(f, sols.spacetime)
    _write_forcing(f, sols.forcing)
    f.create_dataset("ts", data=np.asarray(sols.ts))
    f.attrs["lastonly"] = bool(sols.lastonly)
    _write_collection(f.create_group("parameters"), sols.parameters)
    _write_collection(f.create_group("initconds"), sols.initconds)
    _write_collection(f.create_group("raw"), sols.raw)
    g = f.create_group("seasonal")
    for season in ("winter", "summer", "avg"):
        _write_collection(g.create_group(season), getattr(sols.seasonal, season))


def _write_spacetime(f: h5py.Group, st: SpaceTime) -> None:
    g = f.create_group("spacetime")
    g.attrs.update(
        nx=st.nx, nt=st.nt, dur=st.dur, grid=st.grid,
        urange=np.asarray(st.urange), winter=st.winter, summer=st.summer,
    )


def _write_forcing(f: h5py.Group, fo: Forcing) -> None:
    g = f.create_group("forcing")
    g.attrs.update(
        base=fo.base, peak=fo.peak, cool=fo.cool,
        holdyrs=np.asarray(fo.holdyrs), rates=np.asarray(fo.rates),
        constant=fo.constant,
    )


def _write_ensemble(f: h5py.Group, ens) -> None:
    f.attrs["__ebm_type__"] = "EnsembleSolutions"
    f.attrs["n_members"] = int(ens.n_members)
    _write_spacetime(f, ens.spacetime)
    _write_forcing(f, ens.forcing)
    _write_collection(f.create_group("parameters"), ens.parameters)
    g = f.create_group("seasonal")
    for season in ("winter", "summer", "avg"):
        _write_collection(g.create_group(season), getattr(ens.seasonal, season))
    if ens.raw is not None:
        _write_collection(f.create_group("raw"), ens.raw)


def _read_ensemble(f: h5py.Group):
    from .parallel.ensemble import EnsembleSolutions

    st = _read_spacetime(f)
    forcing = _read_forcing(f)
    seasonal = Seasonal(
        winter=_read_collection(f["seasonal/winter"]),
        summer=_read_collection(f["seasonal/summer"]),
        avg=_read_collection(f["seasonal/avg"]),
    )
    return EnsembleSolutions(
        spacetime=st,
        forcing=forcing,
        parameters=_read_collection(f["parameters"]),
        n_members=int(f.attrs["n_members"]),
        seasonal=seasonal,
        raw=_read_collection(f["raw"]) if "raw" in f else None,
    )


def _read_spacetime(f: h5py.Group) -> SpaceTime:
    a = f["spacetime"].attrs
    return SpaceTime(
        nx=int(a["nx"]), nt=int(a["nt"]), dur=int(a["dur"]), grid=str(a["grid"]),
        urange=tuple(np.asarray(a["urange"]).tolist()),
        winter=float(a["winter"]), summer=float(a["summer"]),
    )


def _read_forcing(f: h5py.Group) -> Forcing:
    a = f["forcing"].attrs
    if bool(a["constant"]):
        return Forcing(float(a["base"]))
    return Forcing(
        float(a["base"]), float(a["peak"]), float(a["cool"]),
        tuple(int(v) for v in np.asarray(a["holdyrs"])),
        tuple(float(v) for v in np.asarray(a["rates"])),
    )


def _write_equilibrium(f: h5py.Group, eq) -> None:
    """Equilibria have no reference analog (the reference only persists
    trajectories); the schema mirrors the Solutions one — tagged groups of
    Collections — so `load` round-trips EquilibriumResult objects for
    warm-starting later runs."""
    f.attrs["__ebm_type__"] = "EquilibriumResult"
    f.attrs.update(years=int(eq.years), newton_ok=bool(eq.newton_ok),
                   tol=float(eq.tol))
    f.create_dataset("resid", data=np.asarray(eq.resid))
    f.create_dataset("converged", data=np.asarray(eq.converged))
    if eq.member_years is not None:
        f.create_dataset("member_years", data=np.asarray(eq.member_years))
    _write_collection(f.create_group("state"), eq.state)
    g = f.create_group("seasonal")
    for season in ("winter", "summer", "avg"):
        _write_collection(g.create_group(season), getattr(eq.seasonal, season))


def _read_equilibrium(f: h5py.Group):
    from .equilibrium import EquilibriumResult

    resid = np.asarray(f["resid"])
    conv = np.asarray(f["converged"])
    return EquilibriumResult(
        state=_read_collection(f["state"]),
        seasonal=Seasonal(
            winter=_read_collection(f["seasonal/winter"]),
            summer=_read_collection(f["seasonal/summer"]),
            avg=_read_collection(f["seasonal/avg"]),
        ),
        years=int(f.attrs["years"]),
        resid=float(resid) if resid.ndim == 0 else resid,
        converged=bool(conv) if conv.ndim == 0 else conv,
        member_years=(np.asarray(f["member_years"])
                      if "member_years" in f else None),
        newton_ok=bool(f.attrs["newton_ok"]),
        tol=float(f.attrs["tol"]),
    )


def _write_continuation(f: h5py.Group, cont) -> None:
    f.attrs["__ebm_type__"] = "ContinuationResult"
    f.attrs["vary"] = str(cont.vary)
    f.create_dataset("values", data=np.asarray(cont.values))
    f.create_dataset("direction", data=np.asarray(cont.direction))
    _write_spacetime(f, cont.spacetime)
    # analysis configuration (stability along the path); optional for
    # results constructed without it
    if cont.model is not None:
        f.attrs["model"] = str(cont.model)
    if cont.par is not None:
        _write_collection(f.create_group("par"), cont.par)
    if cont.forcing is not None:
        _write_forcing(f, cont.forcing)
    levels = f.create_group("levels")
    for i, r in enumerate(cont.results):
        _write_equilibrium(levels.create_group(f"{i:08d}"), r)


def _read_continuation(f: h5py.Group):
    from .equilibrium import ContinuationResult

    levels = f["levels"]
    # numeric order, not lexical: lexical sorting misorders level 10000+
    return ContinuationResult(
        values=np.asarray(f["values"]),
        direction=np.asarray(f["direction"]),
        results=[_read_equilibrium(levels[k])
                 for k in sorted(levels.keys(), key=int)],
        vary=str(f.attrs["vary"]),
        spacetime=_read_spacetime(f),
        model=str(f.attrs["model"]) if "model" in f.attrs else None,
        par=_read_collection(f["par"]) if "par" in f else None,
        forcing=_read_forcing(f) if "forcing" in f else None,
    )


def _write_fold(f: h5py.Group, res) -> None:
    f.attrs["__ebm_type__"] = "FoldResult"
    f.attrs["vary"] = str(res.vary)
    f.create_dataset("lo", data=np.asarray(res.lo))
    f.create_dataset("hi", data=np.asarray(res.hi))
    f.create_dataset("history", data=np.asarray(res.history))
    f.create_dataset("survived", data=np.asarray(res.survived))
    f.create_dataset("probe_converged", data=np.asarray(res.probe_converged))
    _write_spacetime(f, res.spacetime)
    _write_equilibrium(f.create_group("anchor"), res.anchor)
    if res.par is not None:
        _write_collection(f.create_group("par"), res.par)


def _read_fold(f: h5py.Group):
    from .fold import FoldResult

    return FoldResult(
        lo=np.asarray(f["lo"]),
        hi=np.asarray(f["hi"]),
        history=np.asarray(f["history"]),
        survived=np.asarray(f["survived"]),
        probe_converged=np.asarray(f["probe_converged"]),
        vary=str(f.attrs["vary"]),
        anchor=_read_equilibrium(f["anchor"]),
        spacetime=_read_spacetime(f),
        par=_read_collection(f["par"]) if "par" in f else None,
    )


def _write_basins(f: h5py.Group, res) -> None:
    f.attrs["__ebm_type__"] = "BasinResult"
    f.attrs.update(season=str(res.season), gap=float(res.gap))
    f.create_dataset("labels", data=np.asarray(res.labels))
    f.create_dataset("areas", data=np.asarray(res.areas))
    f.create_dataset("centroids", data=np.asarray(res.centroids))
    f.create_dataset("counts", data=np.asarray(res.counts))
    _write_spacetime(f, res.spacetime)
    _write_equilibrium(f.create_group("result"), res.result)
    if res.par is not None:
        _write_collection(f.create_group("par"), res.par)


def _read_basins(f: h5py.Group):
    from .basins import BasinResult

    return BasinResult(
        labels=np.asarray(f["labels"]),
        areas=np.asarray(f["areas"]),
        centroids=np.asarray(f["centroids"]),
        counts=np.asarray(f["counts"]),
        season=str(f.attrs["season"]),
        gap=float(f.attrs["gap"]),
        result=_read_equilibrium(f["result"]),
        spacetime=_read_spacetime(f),
        par=_read_collection(f["par"]) if "par" in f else None,
    )


def _write_edge(f: h5py.Group, res) -> None:
    f.attrs["__ebm_type__"] = "EdgeResult"
    f.attrs["season"] = str(res.season)
    for name in ("wa", "wb", "history", "in_a", "probe_converged",
                 "probe_finite", "area_a", "area_b"):
        f.create_dataset(name, data=np.asarray(getattr(res, name)))
    _write_spacetime(f, res.spacetime)
    _write_collection(f.create_group("a"), res.a)
    _write_collection(f.create_group("b"), res.b)
    _write_equilibrium(f.create_group("result_a"), res.result_a)
    _write_equilibrium(f.create_group("result_b"), res.result_b)
    if res.par is not None:
        _write_collection(f.create_group("par"), res.par)


def _read_edge(f: h5py.Group):
    from .basins import EdgeResult

    return EdgeResult(
        wa=np.asarray(f["wa"]),
        wb=np.asarray(f["wb"]),
        history=np.asarray(f["history"]),
        in_a=np.asarray(f["in_a"]),
        probe_converged=np.asarray(f["probe_converged"]),
        # older files lack the finite mask; converged implies finite, so
        # the conservative reconstruction marks only converged steps
        probe_finite=(np.asarray(f["probe_finite"]) if "probe_finite" in f
                      else np.asarray(f["probe_converged"])),
        area_a=np.asarray(f["area_a"]),
        area_b=np.asarray(f["area_b"]),
        a=_read_collection(f["a"]),
        b=_read_collection(f["b"]),
        result_a=_read_equilibrium(f["result_a"]),
        result_b=_read_equilibrium(f["result_b"]),
        spacetime=_read_spacetime(f),
        season=str(f.attrs["season"]),
        par=_read_collection(f["par"]) if "par" in f else None,
    )


def _write_stability(f: h5py.Group, res) -> None:
    f.attrs["__ebm_type__"] = "StabilityResult"
    f.attrs.update(rtol=float(res.rtol), n_modes=int(res.n_modes),
                   side=str(res.side))
    f.create_dataset("growth", data=np.asarray(res.growth))
    f.create_dataset("history", data=np.asarray(res.history))
    f.create_dataset("converged", data=np.asarray(res.converged))
    if res.eigenvalues is not None:  # real (n_modes=1) or complex Ritz
        f.create_dataset("eigenvalues", data=np.asarray(res.eigenvalues))
    _write_collection(f.create_group("mode"), res.mode)


def _read_stability(f: h5py.Group):
    from .equilibrium import StabilityResult

    growth = np.asarray(f["growth"])
    conv = np.asarray(f["converged"])
    eig = np.asarray(f["eigenvalues"]) if "eigenvalues" in f else None
    if eig is not None and eig.ndim == 0:
        eig = eig.item()  # float (n_modes=1) or complex scalar
    return StabilityResult(
        growth=float(growth) if growth.ndim == 0 else growth,
        history=np.asarray(f["history"]),
        converged=bool(conv) if conv.ndim == 0 else conv,
        mode=_read_collection(f["mode"]),
        rtol=float(f.attrs["rtol"]),
        n_modes=int(f.attrs["n_modes"]),
        eigenvalues=eig,
        side=str(f.attrs.get("side", "adjoint")),  # pre-side files
    )


def _write_edge_state(f: h5py.Group, res) -> None:
    f.attrs["__ebm_type__"] = "EdgeStateResult"
    f.attrs.update(season=str(res.season), area=float(res.area),
                   resid=float(res.resid), converged=bool(res.converged),
                   polish_nfev=int(res.polish_nfev))
    for name in ("drift", "tracked_years", "separation"):
        f.create_dataset(name, data=np.asarray(getattr(res, name)))
    _write_spacetime(f, res.spacetime)
    _write_collection(f.create_group("state"), res.state)
    if res.stability is not None:
        _write_stability(f.create_group("stability"), res.stability)
    if res.par is not None:
        _write_collection(f.create_group("par"), res.par)


def _read_edge_state(f: h5py.Group):
    from .basins import EdgeStateResult

    return EdgeStateResult(
        state=_read_collection(f["state"]),
        area=float(f.attrs["area"]),
        resid=float(f.attrs["resid"]),
        drift=np.asarray(f["drift"]),
        tracked_years=np.asarray(f["tracked_years"]),
        separation=np.asarray(f["separation"]),
        converged=bool(f.attrs["converged"]),
        polish_nfev=int(f.attrs["polish_nfev"]),
        stability=_read_stability(f["stability"]) if "stability" in f
        else None,
        spacetime=_read_spacetime(f),
        season=str(f.attrs["season"]),
        par=_read_collection(f["par"]) if "par" in f else None,
    )


def _write_sensitivity(f: h5py.Group, res) -> None:
    f.attrs["__ebm_type__"] = "SensitivityResult"
    f.attrs["of"] = str(res.of)
    f.create_dataset("value", data=np.asarray(res.value))
    _write_collection(f.create_group("grads"), res.grads)
    _write_collection(f.create_group("par"), res.par)


def _read_sensitivity(f: h5py.Group):
    from .sensitivity import SensitivityResult

    value = np.asarray(f["value"])
    return SensitivityResult(
        of=str(f.attrs["of"]),
        value=float(value) if value.ndim == 0 else value,
        grads=_read_collection(f["grads"]),
        par=_read_collection(f["par"]),
    )


def _write_calibration(f: h5py.Group, res) -> None:
    """A fitted parameter set is exactly the artifact a user archives (the
    reference persists any value via JLD2, EnergyBalanceModel.jl src/io.jl:37-52);
    schema mirrors the other result writers — tagged groups of Collections."""
    f.attrs["__ebm_type__"] = "CalibrationResult"
    f.create_dataset("losses", data=np.asarray(res.losses))
    _write_collection(f.create_group("params"), res.params)
    _write_collection(f.create_group("par"), res.par)
    _write_collection(f.create_group("grads"), res.grads)
    if res.best is not None:  # multi-start extras travel together
        f.attrs["best"] = int(res.best)
        _write_collection(f.create_group("start_params"), res.start_params)
        f.create_dataset("start_losses", data=np.asarray(res.start_losses))


def _read_calibration(f: h5py.Group):
    from .calibrate import CalibrationResult

    multi = "best" in f.attrs
    return CalibrationResult(
        params=_read_collection(f["params"]),
        par=_read_collection(f["par"]),
        losses=np.asarray(f["losses"]),
        grads=_read_collection(f["grads"]),
        best=int(f.attrs["best"]) if multi else None,
        start_params=_read_collection(f["start_params"]) if multi else None,
        start_losses=np.asarray(f["start_losses"]) if multi else None,
    )


def _write_lyapunov(f: h5py.Group, res) -> None:
    f.attrs["__ebm_type__"] = "LyapunovResult"
    f.attrs.update(transient=int(res.transient), n_modes=int(res.n_modes),
                   years=int(res.years))
    f.create_dataset("exponents", data=np.asarray(res.exponents))
    f.create_dataset("history", data=np.asarray(res.history))
    _write_collection(f.create_group("state"), res.state)
    _write_collection(f.create_group("modes"), res.modes)


def _read_lyapunov(f: h5py.Group):
    from .lyapunov import LyapunovResult

    return LyapunovResult(
        exponents=np.asarray(f["exponents"]),
        history=np.asarray(f["history"]),
        state=_read_collection(f["state"]),
        modes=_read_collection(f["modes"]),
        transient=int(f.attrs["transient"]),
        n_modes=int(f.attrs["n_modes"]),
        years=int(f.attrs["years"]),
    )


def _write_transition(f: h5py.Group, res) -> None:
    f.attrs["__ebm_type__"] = "TransitionResult"
    f.attrs.update(start=str(res.start), tau=float(res.tau),
                   years=int(res.years), season=str(res.season),
                   seed=int(res.seed), newton_ok=bool(res.newton_ok),
                   year0=int(res.year0), engine=str(res.engine),
                   ramped=bool(res.ramped), degenerate=bool(res.degenerate),
                   nt=int(res.nt))
    # sigma may be a per-member (K,) vector: a dataset either way
    f.create_dataset("sigma", data=np.asarray(res.sigma, dtype=np.float64))
    f.create_dataset("areas", data=np.asarray(res.areas))
    f.create_dataset("labels", data=np.asarray(res.labels))
    f.create_dataset("first_passage", data=np.asarray(res.first_passage))
    f.create_dataset("finite", data=np.asarray(res.finite))
    f.create_dataset("eta", data=np.asarray(res.eta))
    f.create_dataset("area_a", data=np.asarray(res.area_a))
    f.create_dataset("area_b", data=np.asarray(res.area_b))
    _write_collection(f.create_group("state"), res.state)
    _write_collection(f.create_group("tracked"), res.tracked)
    if res.ref_state is not None:
        _write_collection(f.create_group("ref_state_a"), res.ref_state[0])
        _write_collection(f.create_group("ref_state_b"), res.ref_state[1])
    if res.crossing_step is not None:
        f.create_dataset("crossing_step", data=np.asarray(res.crossing_step))


def _read_transition(f: h5py.Group):
    from .stochastic import TransitionResult

    return TransitionResult(
        areas=np.asarray(f["areas"]),
        labels=np.asarray(f["labels"]),
        first_passage=np.asarray(f["first_passage"]),
        finite=np.asarray(f["finite"]).astype(bool),
        state=_read_collection(f["state"]),
        eta=np.asarray(f["eta"]),
        tracked=_read_collection(f["tracked"]),
        area_a=np.asarray(f["area_a"]),
        area_b=np.asarray(f["area_b"]),
        start=str(f.attrs["start"]),
        # older files kept sigma as a scalar attr; newer files store a
        # dataset (it may be a per-member vector)
        sigma=((float(f["sigma"][()]) if f["sigma"].ndim == 0
                else np.asarray(f["sigma"])) if "sigma" in f
               else float(f.attrs["sigma"])),
        tau=float(f.attrs["tau"]),
        years=int(f.attrs["years"]),
        season=str(f.attrs["season"]),
        seed=int(f.attrs["seed"]),
        newton_ok=bool(f.attrs["newton_ok"]),
        year0=int(f.attrs.get("year0", 0)),
        engine=str(f.attrs.get("engine", "scan")),
        ramped=bool(f.attrs.get("ramped", False)),
        degenerate=bool(f.attrs.get("degenerate", False)),
        ref_state=((_read_collection(f["ref_state_a"]),
                    _read_collection(f["ref_state_b"]))
                   if "ref_state_a" in f else None),
        crossing_step=(np.asarray(f["crossing_step"])
                       if "crossing_step" in f else None),
        nt=int(f.attrs.get("nt", 0)),
    )


def _read_solutions(f: h5py.Group) -> Solutions:
    st = _read_spacetime(f)
    forcing = _read_forcing(f)
    seasonal = Seasonal(
        winter=_read_collection(f["seasonal/winter"]),
        summer=_read_collection(f["seasonal/summer"]),
        avg=_read_collection(f["seasonal/avg"]),
    )
    return Solutions(
        spacetime=st,
        ts=np.asarray(f["ts"]),
        forcing=forcing,
        parameters=_read_collection(f["parameters"]),
        initconds=_read_collection(f["initconds"]),
        lastonly=bool(f.attrs["lastonly"]),
        debug=None,
        raw=_read_collection(f["raw"]),
        seasonal=seasonal,
    )


# -- public API ----------------------------------------------------------

def unsafesave(obj, path: str, spwarn: bool = False, **kwargs) -> str:
    """Write ``obj`` to ``path``, overwriting silently (reference
    EnergyBalanceModel.jl src/io.jl:10-16). Prefer :func:`save`."""
    if not spwarn:
        warnings.warn("`unsafesave` may overwrite existing files. Use `save` instead.")
    try:  # matplotlib figure → its own writer (reference plot.jl:227-233)
        import matplotlib.figure

        if isinstance(obj, matplotlib.figure.Figure):
            obj.savefig(path, **kwargs)
            return path
    except ImportError:  # pragma: no cover
        pass
    from .basins import BasinResult, EdgeResult, EdgeStateResult
    from .calibrate import CalibrationResult
    from .equilibrium import (ContinuationResult, EquilibriumResult,
                              StabilityResult)
    from .fold import FoldResult
    from .lyapunov import LyapunovResult
    from .parallel.ensemble import EnsembleSolutions
    from .sensitivity import SensitivityResult
    from .stochastic import TransitionResult

    with h5py.File(path, "w") as f:
        if isinstance(obj, Solutions):
            _write_solutions(f, obj)
        elif isinstance(obj, EnsembleSolutions):
            _write_ensemble(f, obj)
        elif isinstance(obj, EquilibriumResult):
            _write_equilibrium(f, obj)
        elif isinstance(obj, ContinuationResult):
            _write_continuation(f, obj)
        elif isinstance(obj, FoldResult):
            _write_fold(f, obj)
        elif isinstance(obj, BasinResult):
            _write_basins(f, obj)
        elif isinstance(obj, EdgeResult):
            _write_edge(f, obj)
        elif isinstance(obj, EdgeStateResult):
            _write_edge_state(f, obj)
        elif isinstance(obj, StabilityResult):
            _write_stability(f, obj)
        elif isinstance(obj, SensitivityResult):
            _write_sensitivity(f, obj)
        elif isinstance(obj, CalibrationResult):
            _write_calibration(f, obj)
        elif isinstance(obj, LyapunovResult):
            _write_lyapunov(f, obj)
        elif isinstance(obj, TransitionResult):
            _write_transition(f, obj)
        elif isinstance(obj, dict):
            _write_collection(f, obj)
        elif isinstance(obj, str):
            f.attrs["__ebm_type__"] = "str"
            f.attrs["value"] = obj
        else:
            f.attrs["__ebm_type__"] = "array"
            f.create_dataset("value", data=np.asarray(obj))
    return path


def save(obj, path: str = None, **kwargs) -> str:
    """Save ``obj`` to ``path``; an existing file at ``path`` is renamed to
    ``name_<hexid>.ext`` first, with a warning (reference
    EnergyBalanceModel.jl src/io.jl:37-52)."""
    if path is None:
        path = os.path.join(os.getcwd(), f"{reprhex(unique_id())}.dat")
    if os.path.isfile(path):
        modified = datetime.datetime.fromtimestamp(os.path.getmtime(path)).astimezone()
        name, ext = os.path.splitext(path)
        newpath = f"{name}_{reprhex(unique_id())}{ext}"
        warnings.warn(
            f"File {path} already exists. Last modified "
            f"{modified.strftime('on %d %b %Y at %H:%M:%S')}. "
            f"The EXISTING file has been renamed to {newpath}."
        )
        os.rename(path, newpath)
    return unsafesave(obj, path, spwarn=True, **kwargs)


def unsafeload(path: str, spwarn: bool = False):
    """Read an object written by :func:`save` (reference
    EnergyBalanceModel.jl src/io.jl:54-59)."""
    if not spwarn:
        warnings.warn("`unsafeload` could overwrite existing variables. Use `load` instead.")
    with h5py.File(path, "r") as f:
        tag = f.attrs.get("__ebm_type__", "Collection")
        if tag == "Solutions":
            return _read_solutions(f)
        if tag == "EnsembleSolutions":
            return _read_ensemble(f)
        if tag == "EquilibriumResult":
            return _read_equilibrium(f)
        if tag == "ContinuationResult":
            return _read_continuation(f)
        if tag == "FoldResult":
            return _read_fold(f)
        if tag == "BasinResult":
            return _read_basins(f)
        if tag == "EdgeResult":
            return _read_edge(f)
        if tag == "EdgeStateResult":
            return _read_edge_state(f)
        if tag == "StabilityResult":
            return _read_stability(f)
        if tag == "SensitivityResult":
            return _read_sensitivity(f)
        if tag == "CalibrationResult":
            return _read_calibration(f)
        if tag == "LyapunovResult":
            return _read_lyapunov(f)
        if tag == "TransitionResult":
            return _read_transition(f)
        if tag == "str":
            return str(f.attrs["value"])
        if tag == "array":
            return np.asarray(f["value"])
        return _read_collection(f)


def load(path: str):
    """Load the object stored at ``path``."""
    return unsafeload(path, spwarn=True)


def load_into(name: str, path: str, namespace: dict):
    """Load the object at ``path`` into ``namespace[name]`` (e.g.
    ``globals()``); an existing binding is housed in the safehouse first with
    a warning — rebuild of ``load!`` (EnergyBalanceModel.jl src/io.jl:84-92)."""
    if name in namespace:
        refugee = house(name, namespace[name], safehouse(namespace))
        warnings.warn(
            f"Variable `{name}` already defined. The existing value has been "
            f"stored in the safehouse with ID {reprhex(refugee.id)}."
        )
    loaded = unsafeload(path, spwarn=True)
    namespace[name] = loaded
    return loaded
