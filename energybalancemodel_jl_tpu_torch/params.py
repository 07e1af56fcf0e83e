"""Default model parameters (rebuild of
EnergyBalanceModel.jl src/infrastructure.jl:407-474).

Parameters are plain ``Collection`` dot-dicts of float64 scalars; a batched
Collection (arrays of shape ``(K,)``) drives an ensemble, one member per
entry.
"""
from __future__ import annotations

from .utils.collection import Collection

__all__ = ["default_parval", "miz_paramset", "classic_paramset", "default_parameters"]

# Default parameter values with units (reference :407-433).
default_parval = Collection(
    D=0.6,            # diffusivity for heat transport (W m^-2 K^-1)
    A=193.0,          # OLR when T = T_m (W m^-2)
    B=2.1,            # OLR temperature dependence (W m^-2 K^-1)
    cw=9.8,           # ocean mixed layer heat capacity (W yr m^-2 K^-1)
    S0=420.0,         # insolation at equator (W m^-2)
    S1=338.0,         # insolation seasonal dependence (W m^-2)
    S2=240.0,         # insolation spatial dependence (W m^-2)
    a0=0.7,           # ice-free co-albedo at equator
    a2=0.1,           # ice-free co-albedo spatial dependence
    ai=0.4,           # co-albedo where there is sea ice
    Fb=4.0,           # heat flux from ocean below (W m^-2)
    k=2.0,            # sea ice thermal conductivity (W m^-2 K^-1)
    Lf=9.5,           # sea ice latent heat of fusion (W yr m^-3)
    F=0.0,            # radiative forcing (W m^-2)
    cg=0.01 * 9.8,    # ghost layer heat capacity (W yr m^-2 K^-1)
    tau=1e-5,         # ghost layer coupling timescale (yr)
    Tm=0.0,           # melting temperature (C)
    m1=1.6e-6 * 31536000,  # empirical constant of lateral melt
    m2=1.36,          # empirical constant of lateral melt
    alpha=0.66,       # floe geometry constant, Ai = alpha * D^2
    rl=0.5,           # lead region width (m)
    Dmin=1.0,         # new pancake size (m)
    Dmax=156.0,       # largest floe length (m)
    hmin=0.1,         # new pancake thickness (m)
    kappa=0.01 * 31536000,  # floe welding parameter
)

# Parameter subsets used by each model (reference :436-444).
miz_paramset = frozenset(
    {
        "D", "A", "B", "cw", "S0", "S1", "S2", "a0", "a2", "ai", "Fb", "k", "Lf",
        "Tm", "m1", "m2", "alpha", "rl", "Dmin", "Dmax", "hmin", "kappa",
    }
)
classic_paramset = frozenset(
    {"D", "A", "B", "cw", "S0", "S1", "S2", "a0", "a2", "ai", "Fb", "k", "Lf", "F", "cg", "tau"}
)


def default_parameters(model) -> Collection:
    """Default parameters for ``model``.

    ``'MIZ'`` selects the MIZ subset; any other value selects the classic
    subset — matching the reference's dispatch
    (EnergyBalanceModel.jl src/infrastructure.jl:473-474), which treats every
    non-``:MIZ`` symbol as classic. A frozenset/set of names selects a custom
    subset (reference :447-450).

    The keys come in the order of :data:`default_parval` in every process
    (a set's order follows the process's string hashes), so flat lists of
    parameters line up across processes.
    """
    if isinstance(model, (set, frozenset)):
        subset = model
    elif model == "MIZ":
        subset = miz_paramset
    else:
        subset = classic_paramset
    # an unknown name is last, and raises KeyError as the JAX package's does
    keys = [k for k in default_parval if k in subset] + [
        k for k in subset if k not in default_parval]
    return Collection({k: default_parval[k] for k in keys})
