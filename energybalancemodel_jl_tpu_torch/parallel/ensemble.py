"""Parameter ensembles on one device.

Port of the JAX package's ``parallel/ensemble.py``. The 180-point grid is
tiny, so the device is kept busy by running whole ensembles of independent
runs at once: state is ``(K, nx)``, and a parameter Collection may mix
scalars (shared) and ``(K,)`` arrays (swept across members). Two engines:

- ``'batched'``: the eager year loop of :func:`..integrate.make_year_fn` on a
  leading member axis (swept parameters ride as ``(K, 1)`` columns).
- ``'fused'``: one call per year of the model's whole-year kernel
  (:func:`..ops.miz_year.miz_year`, :func:`..ops.classic_year.classic_year`)
  — the CUDA kernel on a GPU, its plain version on the CPU.

Every parameter, the insolation table parameters ``S0, S1, S2, a0, a2``
included, may be swept on either engine. ``'auto'`` picks ``'fused'`` for
MIZ and Classic on a CUDA device and ``'batched'`` on the CPU; on a CUDA
device it never falls back to the eager loop: a run the kernel cannot take
raises. ``solver='pallas'`` (the fixed-iteration Newton kernel) exists on
the batched engine only: with it ``'auto'`` is ``'batched'`` and
``engine='fused'`` raises, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..convert import to_numpy
from ..forcing import Forcing
from ..integrate import (FUSED_YEARS, auto_is_fused, check_fused, make_year_fn,
                         resolve_device, resolve_dtype)
from ..models.base import default_step_config, dtype_name, get_model
from ..solutions import Seasonal, Solutions
from ..spacetime import SpaceTime
from ..utils.collection import Collection
from ..utils.progress import Progress

__all__ = ["EnsembleSolutions", "ensemble_integrate", "sweep", "batched_parameters"]


@dataclasses.dataclass
class EnsembleSolutions:
    """Results of an ensemble run: ``seasonal.*.VAR`` has shape
    ``(K, dur, nx)``; ``raw.VAR`` (when collected) is ``(K, nt, nx)`` for the
    final year (``raw_mode='last'``) or ``(K, dur*nt, nx)`` for the whole run
    (``raw_mode='all'``). All arrays are numpy."""

    spacetime: SpaceTime
    forcing: Forcing
    parameters: Collection  # batched: leaves scalar or (K,)
    n_members: int
    seasonal: Seasonal
    raw: Optional[Collection] = None

    def member(self, i: int) -> Collection:
        """Parameters of member ``i``."""
        return Collection(
            {k: (np.asarray(v)[i] if np.ndim(v) > 0 else v) for k, v in self.parameters.items()}
        )

    @property
    def swept(self) -> Collection:
        """The swept parameters only: name -> (K,) values."""
        return Collection(
            {k: np.asarray(v) for k, v in self.parameters.items() if np.ndim(v) > 0}
        )

    def member_solutions(self, i: int) -> Solutions:
        """Member ``i``'s results as a single-run :class:`Solutions` view."""
        i = int(i)
        if not -self.n_members <= i < self.n_members:
            raise IndexError(f"member {i} out of range for ensemble of {self.n_members}")
        st = self.spacetime
        seasonal = Seasonal(
            *(Collection({k: np.asarray(v)[i] for k, v in coll.items()})
              for coll in self.seasonal)
        )
        lastonly = True
        if self.raw is not None:
            raw = Collection({k: np.asarray(v)[i] for k, v in self.raw.items()})
            lastonly = next(iter(raw.values())).shape[0] != st.dur * st.nt
            ts = Solutions.stored_times(st, lastonly)
        else:
            raw = Collection({k: np.zeros((0, st.nx)) for k in self.seasonal.avg.keys()})
            ts = np.zeros((0,))
        return Solutions(
            spacetime=st, ts=ts, forcing=self.forcing, parameters=self.member(i),
            initconds=Collection({}), lastonly=lastonly, debug=None, raw=raw,
            seasonal=seasonal,
        )

    def __repr__(self):
        names = ",".join(sorted(self.swept.keys())) or "none"
        if self.raw is None:
            raw = "seasonal only"
        else:
            n_steps = next(iter(self.raw.values())).shape[1]
            raw = ("full raw" if n_steps == self.spacetime.dur * self.spacetime.nt
                   else "last-year raw")
        return (
            f"EnsembleSolutions(K={self.n_members}, "
            f"{self.spacetime.nx}x{self.spacetime.nt}x{self.spacetime.dur}y, "
            f"swept: {names}, {raw})"
        )


def batched_parameters(base: Collection, sweeps: Dict[str, Sequence[float]]) -> Collection:
    """Product-grid batched parameters: each swept name gets every
    combination; shared parameters stay scalar. Returns a Collection whose
    swept leaves have shape ``(K,)`` with ``K = prod(len(v))``."""
    names = list(sweeps)
    grids = list(itertools.product(*[np.asarray(sweeps[n], dtype=np.float64) for n in names]))
    out = Collection({k: v for k, v in base.items()})
    for j, n in enumerate(names):
        out[n] = np.asarray([g[j] for g in grids], dtype=np.float64)
    out["__K__"] = len(grids)  # popped by ensemble_integrate
    return out


def _check_raw_all_budget(K, st, n_vars: int, itemsize: int, raw_memory_limit: int):
    """Up-front guard for ``raw_mode='all'``: full per-step trajectories of
    every member are only sane for small ensembles."""
    est = int(K) * st.dur * st.nt * st.nx * n_vars * itemsize
    if est > raw_memory_limit:
        raise ValueError(
            f"raw_mode='all' would materialize K*dur*nt*nx*{n_vars} vars ≈ "
            f"{est / 2**30:.2f} GiB of raw trajectories (limit "
            f"{raw_memory_limit / 2**30:.2f} GiB); use raw_mode='last'/'none', "
            "shrink the ensemble, or raise raw_memory_limit"
        )


def _ensemble_config_key(model, st, forcing, par, dtype, solver, engine, K,
                         newton_max_iter) -> str:
    """The checkpoint key of an ensemble run, character for character the
    JAX package's (``parallel/ensemble.py::_ensemble_config_key``): swept
    ``(K,)`` parameter leaves (the virtual ``"F"`` included) are digested;
    ``dtype`` may be a torch dtype or anything numpy names."""
    from .. import checkpoint as ckpt_mod

    name = dtype_name(dtype) if isinstance(dtype, torch.dtype) else np.dtype(dtype).name
    return ckpt_mod.config_key(
        "ens", model, st, forcing, par, name, solver,
        newton_max_iter, (engine, f"K={int(K)}"),
    )


def _resolve_engine(engine, spec, st, device, solver) -> str:
    if engine == "auto":
        engine = "fused" if auto_is_fused(spec.name, device, solver) else "batched"
    if engine not in ("batched", "fused"):
        raise ValueError(
            f"unknown engine {engine!r}; expected 'batched', 'fused' or 'auto'"
        )
    if engine == "fused":
        check_fused(spec.name, st.nx, device, solver, alternative="batched")
    return engine


def ensemble_integrate(
    model: str,
    st: SpaceTime,
    forcing: Forcing,
    par: Collection,
    init: Collection,
    n_members: Optional[int] = None,
    raw_mode: str = "none",
    raw_memory_limit: int = 2 * 2**30,
    dtype=None,
    device=None,
    solver: str = "pcr",
    newton_max_iter: int = 30,
    donate: bool = True,
    jit_wrapper=None,
    engine: str = "auto",
    mesh=None,
    years_per_dispatch: Optional[int] = None,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    progress: Optional[bool] = None,
) -> EnsembleSolutions:
    """Integrate an ensemble of independent runs.

    ``par`` leaves of shape ``(K,)`` are swept across members, scalars are
    shared; the virtual parameter ``"F"`` is a per-member constant added to
    the forcing. ``init`` leaves of shape ``(K, nx)`` are per member,
    ``(nx,)`` shared. ``raw_mode='last'`` also collects the final year's
    per-step states, ``'all'`` every step of every member (guarded by
    ``raw_memory_limit`` bytes). ``dtype`` defaults to float32, ``device``
    to the CUDA device (pass ``"cpu"`` for the CPU; with no CUDA device
    ``None`` raises).

    ``solver``: ``'pcr'`` (default) or ``'pcr_fused'`` (on the fused engine
    both are the kernel's PCR; on the batched engine ``'pcr_fused'``
    launches the batched PCR kernel on a GPU), ``'thomas'``, or ``'pallas'``
    (batched engine only: the fixed-iteration Newton kernel for MIZ).

    ``engine``: ``'batched'``, ``'fused'`` or ``'auto'`` (see the module
    docstring). ``years_per_dispatch`` is accepted for the JAX package's
    interface (as there, a value above 1 needs ``engine='fused'``) and does
    nothing: every year is one kernel launch, queued without a host round
    trip. ``donate`` is accepted for the JAX package's interface and does
    nothing: there it lets XLA reuse the carry's buffers, which the year
    loop here rebinds each year anyway.

    ``checkpoint`` names an HDF5 file written every ``checkpoint_every``
    simulated years and after the last (the ensemble carry and the per-year
    seasonal storage); ``resume=True`` continues a matching interrupted run
    bit-exactly from the first unfinished year, on either engine, as
    :func:`..integrate.integrate` does (:mod:`..checkpoint`; the JAX
    package's files and keys). ``raw_mode='all'`` cannot resume.

    Not ported yet: ``mesh=`` and ``jit_wrapper=`` (ROADMAP Queue 1 M14).
    """
    if mesh is not None or jit_wrapper is not None:
        raise NotImplementedError(
            "mesh= and jit_wrapper= (multi-device ensembles) are not ported "
            "yet: ROADMAP Queue 1 M14"
        )
    spec = get_model(model)
    if raw_mode not in ("none", "last", "all"):
        raise ValueError(f"ensemble raw_mode must be 'none'|'last'|'all', got {raw_mode!r}")
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    par = Collection(par)
    K = par.pop("__K__", None) or n_members
    if K is None:
        sizes = {np.shape(v)[0] for v in par.values() if np.ndim(v) > 0}
        sizes |= {np.shape(v)[0] for v in init.values() if np.ndim(v) > 1}
        if len(sizes) != 1:
            raise ValueError("Cannot infer ensemble size; pass n_members")
        K = sizes.pop()
    K = int(K)
    if raw_mode == "all":
        _check_raw_all_budget(K, st, len(spec.solution_vars), dtype.itemsize,
                              raw_memory_limit)
    par_user = Collection(par)  # what the result reports, incl. virtual "F"
    F_off = par.pop("F", None)
    if F_off is not None:
        F_off = np.asarray(F_off, dtype=np.float64)
        F_off = np.full((K,), float(F_off)) if F_off.ndim == 0 else F_off.reshape(-1)
        if F_off.shape[0] != K:
            raise ValueError(f"par['F'] must have shape ({K},), got {F_off.shape}")

    engine = _resolve_engine(engine, spec, st, device, solver)
    if years_per_dispatch is not None:
        if int(years_per_dispatch) < 1:
            raise ValueError(f"years_per_dispatch must be >= 1, got {years_per_dispatch}")
        if int(years_per_dispatch) > 1 and engine != "fused":
            raise ValueError("years_per_dispatch > 1 requires engine='fused'")

    cfg = default_step_config(dtype_name(dtype), solver=solver,
                              newton_max_iter=newton_max_iter)
    as_t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    par_t = Collection({k: as_t(v) for k, v in par.items()})
    # the batched step broadcasts (K, 1) parameter columns against (K, nx)
    par_cols = Collection({k: (v[:, None] if v.ndim == 1 else v) for k, v in par_t.items()})
    par_fused = Collection(par_t)
    if F_off is not None:
        par_fused["F"] = as_t(F_off)
    year_seasonal = make_year_fn(spec.name, st, cfg, False)
    year_full = make_year_fn(spec.name, st, cfg, True)
    fused_year = FUSED_YEARS[spec.name][0] if engine == "fused" else None

    carry = spec.init_carry(init, st, dtype, device)
    carry = Collection(
        {k: (v if v.ndim == 2 else v.expand((K,) + tuple(v.shape))) for k, v in carry.items()}
    )
    for k, v in carry.items():
        if tuple(v.shape) != (K, st.nx):
            raise ValueError(f"init[{k!r}] must be ({st.nx},) or ({K}, {st.nx}), got {tuple(v.shape)}")
    f_base = forcing.table(st)  # (dur, nt)

    def batched_forcing(year):
        if F_off is None:
            return f_base[year]
        # per-member rows, time leading: (nt, K, 1)
        return (f_base[year][:, None] + F_off[None, :])[:, :, None]

    winter_acc, summer_acc, avg_acc, raw_years = [], [], [], []
    start_year = 0
    write = None
    if checkpoint is not None:
        from .. import checkpoint as ckpt_mod

        key = _ensemble_config_key(spec.name, st, forcing, par_user, dtype, solver,
                                   engine, K, newton_max_iter)
        carry, start_year, winter_acc, summer_acc, avg_acc = ckpt_mod.resume_state(
            checkpoint, key, resume, raw_mode, st.dur,
            lambda v: torch.as_tensor(np.asarray(v), dtype=dtype,
                                      device=device).contiguous(),
            carry)
        write = ckpt_mod.year_writer(
            checkpoint, key, lambda: (carry, (winter_acc, summer_acc, avg_acc)))

    prog = Progress(
        st.dur, "Integrating ensemble",
        infofeed=lambda yy: f"year {int(yy)}/{st.dur}, {K} members",
    ) if (progress is None or progress) else None
    if prog is not None and start_year:
        prog.update(start_year, feedargs=(start_year,))

    for y in range(start_year, st.dur):
        collect = raw_mode == "all" or (raw_mode == "last" and y == st.dur - 1)
        if engine == "fused":
            carry, seasonal, _conv, ys = fused_year(carry, par_fused, f_base[y], st, cfg,
                                                    collect_raw=collect)
        else:
            fn = year_full if collect else year_seasonal
            carry, seasonal, _conv, ys = fn(carry, par_cols, batched_forcing(y))
        winter_acc.append(seasonal.winter)
        summer_acc.append(seasonal.summer)
        avg_acc.append(seasonal.avg)
        if write is not None and ((y + 1) % max(checkpoint_every, 1) == 0
                                  or y == st.dur - 1):
            write(y + 1)
        if collect:
            # the year loop stacks time first: (nt, K, nx) -> (K, nt, nx)
            raw_years.append(Collection({k: v.transpose(0, 1) for k, v in ys.items()}))
        if prog is not None:
            prog.update(y + 1, feedargs=(y + 1,))

    def stack(acc, dim):
        return Collection(
            {k: to_numpy(torch.stack([c[k] for c in acc], dim=dim)) for k in acc[0]}
        )

    raw = None
    if raw_years:
        raw = Collection(
            {k: to_numpy(torch.cat([c[k] for c in raw_years], dim=1))
             for k in raw_years[0]}
        )
    return EnsembleSolutions(
        spacetime=st,
        forcing=forcing,
        parameters=par_user,
        n_members=K,
        seasonal=Seasonal(stack(winter_acc, 1), stack(summer_acc, 1), stack(avg_acc, 1)),
        raw=raw,
    )


def sweep(
    model: str,
    st: SpaceTime,
    forcing: Forcing,
    base_par: Collection,
    sweeps: Dict[str, Sequence[float]],
    init: Collection,
    **kwargs,
) -> EnsembleSolutions:
    """Product-grid parameter sweep (bifurcation and hysteresis studies).

    Example: ``sweep('MIZ', st, ramp, par, {'D': np.linspace(0.4, 0.8, 32)},
    init)`` runs 32 diffusivities as one ensemble."""
    return ensemble_integrate(
        model, st, forcing, batched_parameters(base_par, sweeps), init, **kwargs
    )
