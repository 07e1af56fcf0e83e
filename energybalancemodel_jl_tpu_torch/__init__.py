"""energybalancemodel_jl_tpu_torch — the PyTorch/CUDA port of
``energybalancemodel_jl_tpu``.

The two energy balance models of the JAX package: the MIZ
(marginal-ice-zone) model and the WE15 Classic model. Each is integrated one
model year per launch of a hand-written CUDA kernel (``csrc/miz_year.cu``,
``csrc/classic_year.cu``) on an NVIDIA GPU, or by an eager PyTorch loop over
the physics step on any device; the noise-forced ``transitions`` draws its
weather inside the same kernels (``csrc/prng.cuh``, ``csrc/noise.cuh``).
Module names and array layouts follow the JAX package, which stays the
reference the port is tested against::

    import energybalancemodel_jl_tpu_torch as ebt

    st = ebt.SpaceTime.sin(180, 2000, 30)
    par = ebt.default_parameters("MIZ")
    sols = ebt.integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                         dtype="float32", device="cuda")

    par["D"] = np.linspace(0.55, 0.65, 8192)
    ens = ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), par,
                                 ebt.zeros_init(st), device="cuda")

    cpar = ebt.default_parameters("Classic")
    E0 = np.full(st.nx, 30.0)  # warm start, with Tg = E/cw
    sols = ebt.integrate("Classic", st, ebt.Forcing(0.0), cpar,
                         {"E": E0, "Tg": E0 / cpar["cw"]}, device="cuda")

    # noise-induced transitions between two states a and b (Collections of
    # Ei, Ew, h, D, phi: the last raw step of two runs), 8192 members
    res = ebt.transitions("MIZ", ebt.SpaceTime.sin(180, 2000, 1), ebt.Forcing(0.0),
                          ebt.default_parameters("MIZ"), a, b, sigma=4.0, tau=0.05,
                          K=8192, years=3)

    # the seasonal fixed point of 8192 members with the forcing swept over
    # [-10, 10] W/m^2, each simulated year one launch of the MIZ year kernel
    par = ebt.default_parameters("MIZ")
    par["F"] = np.linspace(-10.0, 10.0, 8192)
    eq = ebt.equilibrate("MIZ", ebt.SpaceTime.sin(180, 2000, 1), ebt.Forcing(0.0), par,
                         ebt.zeros_init(st), tol=5e-2, max_years=150, device="cuda")
    eq.member_years, eq.converged, eq.state  # each member's year, flag, state

The equilibrium layer around it (``equilibrate``, ``continuation``,
``stability``, ``sensitivity``, ``calibrate``) differentiates the eager year
where it needs gradients: the MIZ Newton root carries an implicit-function
VJP (``models/miz.py::_NewtonRoot``). The search and spectra drivers
(``fold``, ``basins``, ``edge``, ``edge_state``, ``unstable_branch``,
``lyapunov``) bisect over lockstep ``equilibrate`` ensembles, polish saddles
and propagate tangents on the same two paths.

Results persist as the JAX package's HDF5 files (``save``, ``load``,
``load_into``; JLD2 in :mod:`.io_jld2`), long runs checkpoint and resume
bit-exactly (``checkpoint=``/``resume=`` of ``integrate``,
``ensemble_integrate``, ``equilibrate``, ``continuation``, ``fold`` and
``edge``; :mod:`.checkpoint`), and the reference's plots draw with
matplotlib (:mod:`.plot`)::

    sols = ebt.integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                         checkpoint="run.ckpt.h5", checkpoint_every=5)
    ebt.save(sols, "miz.h5")  # loads in either package
    fig = ebt.plot_avg(ebt.load("miz.h5"))

Every entry point runs on the CUDA device unless ``device="cpu"`` is passed
(with no CUDA device, ``device=None`` raises). The package imports ``torch``,
numpy, h5py and (for plots, when drawn) matplotlib, never ``jax``.
"""
from __future__ import annotations

import numpy as _np

from .basins import (BasinResult, EdgeResult, EdgeStateResult, basins, blend_states, edge,
                     edge_state, stack_states, unstable_branch)
from .calibrate import CalibrationResult, calibrate
from .convert import from_numpy, to_numpy
from .equilibrium import (ContinuationResult, EquilibriumResult, StabilityResult, continuation,
                          equilibrate, stability)
from .fold import FoldResult, fold
from .forcing import Forcing
from .integrate import integrate
from .lyapunov import LyapunovResult, lyapunov
from .parallel.ensemble import (EnsembleSolutions, batched_parameters,
                                ensemble_integrate, sweep)
from .params import classic_paramset, default_parameters, default_parval, miz_paramset
from .solutions import Seasonal, Solutions, annual_mean
from .sensitivity import SensitivityResult, sensitivity
from .spacetime import SpaceTime
from .stochastic import TransitionResult, transitions
from .utils import Collection, Progress, house, retrieve, safehouse, update
from .utils.numerics import crossmean, hemispheric_mean
from .io import load, load_into, save, unsafeload, unsafesave
from .plot import (Layout, backend, plot_avg, plot_basins, plot_bifurcation, plot_continuation,
                   plot_edge, plot_fold, plot_lyapunov, plot_raw, plot_seasonal,
                   plot_sensitivity, plot_transitions)

# The reference's `Vec` alias (EnergyBalanceModel.jl src/infrastructure.jl:13)
Vec = _np.ndarray


def zeros_init(st, model: str = "MIZ") -> Collection:
    """All-zero initial conditions for ``model`` on grid ``st`` — the
    canonical test configuration (EnergyBalanceModel.jl
    ``test/runtests.jl:25-31``)."""
    from .models.base import get_model

    return Collection({v: _np.zeros(st.nx) for v in get_model(model).init_vars})


__all__ = [
    "Vec",
    "Collection",
    "SpaceTime",
    "Forcing",
    "Solutions",
    "Seasonal",
    "integrate",
    "ensemble_integrate",
    "sweep",
    "batched_parameters",
    "EnsembleSolutions",
    "transitions",
    "TransitionResult",
    "equilibrate",
    "EquilibriumResult",
    "stability",
    "StabilityResult",
    "continuation",
    "ContinuationResult",
    "sensitivity",
    "SensitivityResult",
    "calibrate",
    "CalibrationResult",
    "fold",
    "FoldResult",
    "basins",
    "BasinResult",
    "edge",
    "EdgeResult",
    "edge_state",
    "EdgeStateResult",
    "unstable_branch",
    "stack_states",
    "blend_states",
    "lyapunov",
    "LyapunovResult",
    "crossmean",
    "hemispheric_mean",
    "safehouse",
    "house",
    "retrieve",
    "save",
    "load",
    "load_into",
    "unsafesave",
    "unsafeload",
    "Layout",
    "backend",
    "plot_raw",
    "plot_avg",
    "plot_seasonal",
    "plot_bifurcation",
    "plot_continuation",
    "plot_fold",
    "plot_edge",
    "plot_basins",
    "plot_sensitivity",
    "plot_lyapunov",
    "plot_transitions",
    "default_parameters",
    "default_parval",
    "miz_paramset",
    "classic_paramset",
    "annual_mean",
    "Progress",
    "update",
    "zeros_init",
    "from_numpy",
    "to_numpy",
]

__version__ = "0.1.0"
