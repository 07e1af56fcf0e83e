"""The benchmark's plain reference: the MIZ and Classic years of
EnergyBalanceModel.jl in plain PyTorch, member by member as a single run
would compute them, and the noise-forced years' weather (``prng.py``). It
imports nothing of the program under test and takes only inputs the
benchmark made itself (parameters, initial states, seeds)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import classic, miz, prng
from .common import Grid, columns

MODELS = {"MIZ": miz, "Classic": classic}
STORES = ("winter", "summer", "avg")


@dataclass
class Run:
    stores: dict  # store -> var -> (K, years, nx) float64
    updates: int  # the members' Newton updates in all (0 for Classic)
    state: dict  # field -> (K, nx) float64, the final state
    eta: np.ndarray  # (K,) the weather's last value (zeros without weather)


def run_state(model: str, grid: Grid, par, init, years: int, dtype, device, newton=None,
              forcing: float = 0.0, weather=None) -> Run:
    """``years`` model years of ``K`` members from ``init``.

    ``par``: name -> scalar or ``(K,)`` values; ``init``: the model's initial
    fields, each ``(K, nx)``; ``forcing``: the constant forcing (W/m^2), to
    which a parameter ``F`` adds per member. ``weather``: None, or a dict
    of the noise-forced years' keys mode: ``keys`` the members' ``(K, 2)``
    uint32 keys, ``year0`` the first year's number, ``rho`` and ``scale``
    (``(K,)``) the Ornstein-Uhlenbeck recurrence over each year's white
    draws, whose path is added to the forcing step by step."""
    mod = MODELS[model]
    K = next(iter(init.values())).shape[0]
    cols = {n: columns(par[n], K, dtype, device) for n in mod.PARAMS}
    F = columns(par.get("F", 0.0), K, dtype, device)[:, 0]
    fyear = torch.full((grid.nt,), float(forcing), dtype=torch.float64)
    base = fyear.to(dtype=dtype, device=device)[:, None] + F[None, :]
    f_rows = base[:, :, None].clone()
    carry = {k: torch.as_tensor(np.asarray(init[k]), dtype=dtype, device=device)
             for k in mod.CARRY if k in init}
    if model == "MIZ":
        carry["T0"] = torch.zeros((K, grid.nx), dtype=dtype, device=device)
    eta = torch.zeros(K, dtype=dtype, device=device)
    per_year = []
    with torch.no_grad():
        year = mod.Year(grid, cols, f_rows, carry, newton, dtype, device)
        for y in range(years):
            if weather is not None:
                keys = prng.fold_in(weather["keys"], weather["year0"] + y)
                xi = prng.normal_table(keys, grid.nt, device).to(dtype)
                path = prng.ou_path(xi, columns(weather["rho"], K, dtype, device)[:, 0],
                                    columns(weather["scale"], K, dtype, device)[:, 0], eta)
                f_rows.copy_((base + path)[:, :, None])
                eta = path[-1]
            seasonal = year.run()
            per_year.append({s: {k: v.double().cpu().numpy() for k, v in seasonal[s].items()}
                             for s in STORES})
        updates = int(year.counter) if model == "MIZ" else 0
        state = {k: v.double().cpu().numpy() for k, v in year.carry.items()}
    stores = {s: {k: np.stack([y[s][k] for y in per_year], axis=1) for k in mod.OUT_VARS}
              for s in STORES}
    return Run(stores, updates, state, eta.double().cpu().numpy())


def run_years(model: str, grid: Grid, par, init, years: int, dtype, device, newton=None,
              forcing: float = 0.0):
    """:func:`run_state`'s seasonal stores and Newton updates."""
    run = run_state(model, grid, par, init, years, dtype, device, newton, forcing)
    return run.stores, run.updates
