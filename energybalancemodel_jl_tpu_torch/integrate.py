"""``integrate`` — THE entry point.

Rebuild of ``integrate`` (EnergyBalanceModel.jl
``src/infrastructure.jl:615-636``), ported from the JAX package's
``integrate.py``. A host loop over years drives either

- ``engine='scan'``: an eager Python loop over ``models.miz.step`` (the
  parity path, any device), or
- ``engine='fused'``: one launch per year of the model's whole-year kernel
  (:func:`.ops.miz_year.miz_year`, :func:`.ops.classic_year.classic_year`;
  on a CPU tensor their plain versions), raw-collected years included.

``'auto'`` (default) picks ``'fused'`` for MIZ and Classic on a CUDA device,
in float32 and float64 alike, and ``'scan'`` on the CPU, or wherever the run
asks for what only the scan engine has (a ``debug`` hook, sub-year progress
ticks), as the JAX package does. On a CUDA device it never falls back to the
eager loop otherwise: a run the kernel cannot take raises.

``checkpoint=``/``resume=`` write and resume mid-run checkpoints
(:mod:`.checkpoint`: the JAX package's files and keys), ``profile_dir=``
writes a ``torch.profiler`` trace of the run, with the spans of
:mod:`.utils.tracing`.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch

from .convert import to_numpy
from .forcing import Forcing
from .models.base import StepConfig, default_step_config, dtype_name, get_model
from .ops import classic_year as _classic_year
from .ops import miz_year as _miz_year
from .solutions import Seasonal, Solutions
from .spacetime import SpaceTime
from .utils.collection import Collection
from .utils.progress import Progress
from .utils.tracing import profiled, span

__all__ = ["integrate", "make_year_fn", "default_dtype", "resolve_engine", "resolve_dtype",
           "resolve_device", "auto_is_fused", "check_fused", "FUSED_YEARS"]

# model -> (its whole-year kernel's wrapper, the check that the kernel runs
# a grid of nx cells on a CUDA device)
FUSED_YEARS = {
    "MIZ": (_miz_year.miz_year, _miz_year.check_nx),
    "Classic": (_classic_year.classic_year, _classic_year.check_nx),
}
# solvers the kernels stand for: both run the kernel's inline PCR, as the JAX
# package maps every solver of its fused engine to PCR (pallas_year.py:979)
FUSED_SOLVERS = ("pcr", "pcr_fused")


def default_dtype() -> torch.dtype:
    """The analysis drivers' default dtype (``equilibrate``, ``stability``,
    ``sensitivity``, ``calibrate``): float64 when PyTorch's default dtype is
    float64 (``torch.set_default_dtype``, the counterpart of JAX's
    ``jax_enable_x64``), else float32, as JAX ``integrate.default_dtype``."""
    return torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32


def resolve_dtype(dtype) -> torch.dtype:
    """``None`` -> float32 (the throughput config); accepts a torch dtype or
    anything numpy names (``'float64'``, ``np.float64``)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def resolve_device(device) -> torch.device:
    """``None`` -> the CUDA device: the port runs on the card unless the
    caller asks for the CPU (``device="cpu"``). With no CUDA device, ``None``
    raises ``RuntimeError`` instead of running on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device=\"cpu\" to run its plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def auto_is_fused(model: str, device: torch.device, solver: str) -> bool:
    """What ``engine='auto'`` means: the whole-year kernel for a model that
    has one on a CUDA device, except with ``solver='pallas'``, which exists
    on the eager engines only (JAX ``parallel/ensemble.py:362``)."""
    return device.type == "cuda" and model in FUSED_YEARS and solver != "pallas"


def check_fused(model: str, nx: int, device, solver: str = "pcr",
                alternative: str = "scan") -> None:
    """Raise ``ValueError`` when the fused engine cannot run this
    configuration on ``device``: a model with no whole-year kernel, a
    solver the kernel does not stand for (``'thomas'``, and ``'pallas'``,
    which exists on the eager engines only), or (on a CUDA device) a grid
    wider than the kernel runs. ``alternative`` names the eager engine the
    message points to."""
    if model not in FUSED_YEARS:
        raise ValueError(
            f"engine='fused' has no whole-year kernel for model {model!r}; "
            f"use engine={alternative!r}"
        )
    if solver not in FUSED_SOLVERS:
        raise ValueError(
            f"the fused engine solves by PCR inside the kernel; solver={solver!r} "
            f"runs on engine={alternative!r}"
        )
    if torch.device(device).type == "cuda":
        FUSED_YEARS[model][1](nx)


def resolve_engine(model: str, st: SpaceTime, device, engine: str = "auto",
                   solver: str = "pcr", scan_only: bool = False) -> str:
    """The single-run engine that :func:`integrate` uses: ``'auto'`` is
    ``'fused'`` for MIZ and Classic on a CUDA device and ``'scan'`` on the
    CPU. On a CUDA device ``'auto'`` never falls back to the eager loop: a
    run the kernel cannot take raises ``ValueError`` (:func:`check_fused`:
    ``solver='thomas'``, or a grid too wide), except ``solver='pallas'``,
    which only the eager engine has, and so resolves to ``'scan'``, and
    ``scan_only`` (the run asks for a feature of the scan engine: the
    ``debug`` hook or sub-year progress ticks, JAX ``integrate.py:441``).
    ``engine='scan'`` stays the caller's explicit choice."""
    spec = get_model(model)
    device = resolve_device(device)
    if engine == "auto":
        engine = ("fused" if auto_is_fused(spec.name, device, solver) and not scan_only
                  else "scan")
    if engine not in ("scan", "fused"):
        raise ValueError(
            f"unknown engine {engine!r}; expected 'auto', 'scan' or 'fused'"
        )
    if engine == "fused":
        check_fused(spec.name, st.nx, device, solver, alternative="scan")
    return engine


def _as_tensor(v, dtype, device):
    return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                           dtype=dtype, device=device)


def make_year_fn(model_name: str, st: SpaceTime, cfg: StepConfig,
                 collect_raw: bool, step_hook: Optional[Callable] = None,
                 debug: Optional[Callable] = None):
    """The one-year function ``(carry, par, fyear) -> (carry, seasonal,
    converged, raw_or_None)`` of the scan and batched engines, and the plain
    version of the whole-year kernel: an eager loop over the model's step.

    The carry's leaves share one dtype and device, and the year runs there;
    ``par`` leaves are tensors on that device (scalars, or ``(K, 1)``
    columns for a batch of members, table parameters included); ``fyear`` is
    ``(nt,)`` or, per member, ``(nt, K, 1)``. Seasonal storage accumulates as the JAX package's
    seasonal-only mode does (step 0's outputs seed the annual sums, winter/
    summer snapshots at the tick indices, ``sum / nt``); ``collect_raw``
    additionally stacks every step's outputs along a leading time axis.
    ``converged`` is the minimum of the per-step Newton flags.
    ``step_hook(t, outputs)``, when given, sees every step's outputs (the
    noisy years' in-year crossing detector, ``integrate``'s sub-year
    progress ticks). ``debug(outputs, par) -> tensor``, when given, is
    recorded every step as the output ``"debug"`` (stored and averaged like
    the model's own variables), as in the JAX package. ``stat``, when given,
    is the model's statics (a grid-sharded run passes its shard of the
    statics built on the whole grid); by default they are built from
    ``par``.
    """
    spec = get_model(model_name)
    w0 = st.winter_inx - 1  # reference tick indices are 1-based (:573-589)
    s0 = st.summer_inx - 1

    def year_fn(carry, par, fyear, stat=None):
        ref = next(iter(carry.values()))
        if stat is None:
            stat = spec.statics(st, par, ref.dtype, ref.device)
        f = _as_tensor(fyear, ref.dtype, ref.device)
        raw = [] if collect_raw else None
        acc = wint = summ = conv = None
        for t in range(st.nt):
            carry, out = spec.step(carry, spec.step_inputs(stat, f, t), stat,
                                   par, cfg)
            out = Collection(out)
            if debug is not None:
                out["debug"] = debug(out, par)
            step_conv = out.pop("newton_converged", None)
            if step_conv is not None:
                conv = step_conv if conv is None else torch.minimum(conv, step_conv)
            if step_hook is not None:
                step_hook(t, out)
            acc = out if acc is None else Collection({k: acc[k] + out[k] for k in acc})
            if t == w0:
                wint = out
            if t == s0:
                summ = out
            if raw is not None:
                raw.append(out)
        nt = torch.as_tensor(float(st.nt), dtype=ref.dtype, device=ref.device)
        seasonal = Seasonal(
            winter=wint,
            summer=summ,
            avg=Collection({k: v / nt for k, v in acc.items()}),  # true division
        )
        ys = None
        if raw is not None:
            ys = Collection({k: torch.stack([o[k] for o in raw]) for k in raw[0]})
        return carry, seasonal, conv, ys

    return year_fn


def _fused_single_year(model, carry, par, fyear, st, cfg, collect_raw):
    """A single run as a 1-member ensemble through the whole-year kernel."""
    c1 = Collection({k: v[None] for k, v in carry.items()})
    year = FUSED_YEARS[model][0]
    c1, seas, conv, raw = year(c1, par, fyear, st, cfg, collect_raw=collect_raw)
    squeeze = lambda coll: Collection({k: v[0] for k, v in coll.items()})
    if raw is not None:  # (nt, 1, nx) -> (nt, nx)
        raw = Collection({k: v[:, 0] for k, v in raw.items()})
    return (squeeze(c1),
            Seasonal(*(squeeze(coll) for coll in seas)), conv, raw)


def integrate(
    model: str,
    st: SpaceTime,
    forcing: Forcing,
    par: Collection,
    init: Collection,
    lastonly: bool = True,
    debug: Optional[Callable] = None,
    verbose: bool = False,
    dtype=None,
    device=None,
    solver: str = "pcr",
    engine: str = "auto",
    years_per_dispatch: Optional[int] = None,
    raw_mode: Optional[str] = None,
    progress: Optional[bool] = None,
    progress_steps: Optional[int] = None,
    newton_max_iter: int = 30,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    profile_dir: Optional[str] = None,
) -> Solutions:
    """Integrate ``model`` over ``st`` with climate ``forcing``, parameters
    ``par`` and initial conditions ``init``; results in a :class:`Solutions`
    of numpy arrays.

    ``model`` is ``'MIZ'`` (initial conditions ``Ei, Ew, h, D, phi``) or
    ``'Classic'`` (``E, Tg``; start from ``Tg = E/cw``: a lagged ``Tg``
    delivers a cold shock into the snowball state). ``lastonly=True`` stores
    per-step raw data only for the final year; ``raw_mode`` ('last' | 'all'
    | 'none') overrides it. ``verbose=True`` warns when the MIZ
    surface-temperature solve fails to converge in a year (the Classic step
    has no Newton solve). ``dtype`` defaults to float32; ``device`` to the
    CUDA device (:func:`resolve_device`; pass ``"cpu"`` for the CPU).
    ``solver`` selects the tridiagonal solver: ``'pcr'`` or
    ``'pcr_fused'`` (on the fused engine both run the kernel's PCR), or, on
    the scan engine, ``'thomas'`` and ``'pallas'`` (a single run's MIZ
    Newton stays adaptive: the fixed-iteration kernel takes ``(K, nx)``
    batches, as in the JAX package).

    ``engine``: see :func:`resolve_engine`. ``years_per_dispatch`` is
    accepted for compatibility with the JAX package and does nothing: each
    year is its own launch, queued without a host round trip.

    ``debug``: a callable ``(vars, par) -> tensor`` evaluated every step on
    the step's outputs and the run's parameter tensors, recorded as the
    solution variable ``"debug"`` (raw and seasonal). It needs the scan
    engine: ``'auto'`` then picks it, ``engine='fused'`` raises.

    ``progress_steps=N`` ticks the progress bar every ``N`` in-year steps on
    the scan engine (``'auto'`` then picks it); on the fused engine, or with
    ``years_per_dispatch > 1``, it warns and is ignored, as in the JAX
    package.

    ``checkpoint`` names an HDF5 file written every ``checkpoint_every``
    simulated years and after the last (the carry and the seasonal storage
    so far); with ``resume=True`` a matching checkpoint continues the run
    bit-exactly from the first unfinished year, and a file of another run
    warns and starts from ``init`` (:mod:`.checkpoint`; the files and keys
    are the JAX package's, so a checkpoint of either package resumes in the
    other). ``raw_mode='all'`` cannot resume: the raw steps of completed
    years are not checkpointed.

    ``profile_dir`` writes a ``torch.profiler`` trace of the whole call,
    result assembly included (host and, on a CUDA device, kernel activity),
    to ``profile_dir/integrate.pt.trace.json``, viewable in Perfetto or
    ``chrome://tracing``; it holds the spans of :mod:`.utils.tracing`.
    """
    # the profiler, where asked for, starts first, so that the call's root
    # span lies in its file
    with profiled(profile_dir, device, "integrate.pt.trace.json"), span("ebm.integrate"):
        with span("ebm.integrate.prepare"):
            spec = get_model(model)
            dtype = resolve_dtype(dtype)
            device = resolve_device(device)
            missing = [v for v in spec.init_vars if v not in init]
            if missing:
                raise ValueError(f"init for model {spec.name!r} is missing {missing}")
            if raw_mode is None:
                raw_mode = "last" if lastonly else "all"
            if raw_mode not in ("last", "all", "none"):
                raise ValueError(f"raw_mode must be 'last'|'all'|'none', got {raw_mode!r}")
            ticks = progress_steps is not None and int(progress_steps) > 0
            if engine == "fused" and debug is not None:
                raise ValueError(
                    "engine='fused' does not support the debug hook; use engine='scan'")
            engine = resolve_engine(spec.name, st, device, engine, solver,
                                    scan_only=debug is not None or ticks)
            if years_per_dispatch is not None and int(years_per_dispatch) < 1:
                raise ValueError(f"years_per_dispatch must be >= 1, got {years_per_dispatch}")
            # the JAX package's default chunking, which its checkpoint key names
            ypd = int(years_per_dispatch) if years_per_dispatch is not None else (
                8 if engine == "fused" else 1)
            tick_every = 0
            if ticks:
                if engine != "scan" or ypd > 1:
                    warnings.warn(
                        "progress_steps is ignored: sub-year progress ticks need "
                        "engine='scan' with years_per_dispatch=1 "
                        f"(got engine={engine!r}, years_per_dispatch={ypd})"
                    )
                else:
                    tick_every = int(progress_steps)

            cfg = default_step_config(dtype_name(dtype), solver=solver,
                                      newton_max_iter=newton_max_iter)

            prog = Progress(
                st.dur * st.nt,
                "Integrating",
                infofeed=lambda t: f"t = {round(t, 2)}",
            ) if (progress is None or progress) else None
            year_base = [0]  # the year the tick hook reports in

            def tick(t, _out):
                if (t + 1) % tick_every == 0:
                    step = year_base[0] * st.nt + t + 1
                    prog.update(step, feedargs=(float(st.T[step - 1]),))

            hook = tick if (tick_every and prog is not None) else None
            year_seasonal = make_year_fn(spec.name, st, cfg, False, hook, debug)
            year_full = make_year_fn(spec.name, st, cfg, True, hook, debug)

            # the forcing rows on the device once, in the run's dtype: a year
            # then reads its row with no copy from the host
            f_tab = _as_tensor(forcing.table(st), dtype, device)
            par_t = Collection({k: _as_tensor(v, dtype, device) for k, v in par.items()})
            carry = spec.init_carry(init, st, dtype, device)

            winter_acc, summer_acc, avg_acc = [], [], []
            start_year = 0
            write = None
            if checkpoint is not None:
                from . import checkpoint as ckpt_mod

                extras = []
                if engine != "scan":
                    extras.append(engine)
                if ypd > 1 and engine != "fused":
                    extras.append(f"ypd{ypd}")
                key = ckpt_mod.config_key("", spec.name, st, forcing, par, dtype_name(dtype),
                                          solver, newton_max_iter, extras)
                carry, start_year, winter_acc, summer_acc, avg_acc = ckpt_mod.resume_state(
                    checkpoint, key, resume, raw_mode, st.dur,
                    lambda v: torch.as_tensor(np.asarray(v), dtype=dtype,
                                              device=device).contiguous(),
                    carry)
                write = ckpt_mod.year_writer(
                    checkpoint, key, lambda: (carry, (winter_acc, summer_acc, avg_acc)))
            if prog is not None and start_year:
                prog.update(start_year * st.nt, feedargs=(float(start_year),))

        raw_chunks = []
        for y in range(start_year, st.dur):
            with span("ebm.integrate.year"):
                collect = raw_mode == "all" or (raw_mode == "last" and y == st.dur - 1)
                year_base[0] = y
                if engine == "fused":
                    carry, seasonal, converged, ys = _fused_single_year(
                        spec.name, carry, par_t, f_tab[y], st, cfg, collect)
                else:
                    fn = year_full if collect else year_seasonal
                    carry, seasonal, converged, ys = fn(carry, par_t, f_tab[y])
                winter_acc.append(seasonal.winter)
                summer_acc.append(seasonal.summer)
                avg_acc.append(seasonal.avg)
                if collect:
                    raw_chunks.append(ys)
                if verbose and converged is not None and float(converged) < 1.0:
                    warnings.warn(f"Solving for T0 failed in year {y + 1}.")
            if write is not None and ((y + 1) % max(checkpoint_every, 1) == 0
                                      or y == st.dur - 1):
                with span("ebm.integrate.checkpoint"):
                    write(y + 1)
            if prog is not None and not tick_every:
                prog.update((y + 1) * st.nt, feedargs=(float(st.T[(y + 1) * st.nt - 1]),))
        if prog is not None and tick_every:
            prog.update(st.dur * st.nt, feedargs=(float(st.T[-1]),))

        with span("ebm.integrate.assemble"):
            varnames = list(spec.solution_vars) + (["debug"] if debug is not None else [])
            if raw_chunks:
                raw = Collection(
                    {k: to_numpy(torch.cat([c[k] for c in raw_chunks], dim=0))
                     for k in varnames}
                )
            else:
                raw = Collection({k: np.zeros((0, st.nx)) for k in varnames})

            def stack(acc):
                return Collection(
                    {k: to_numpy(torch.stack([c[k] for c in acc], dim=0)) for k in varnames}
                )

            seasonal_store = Seasonal(winter=stack(winter_acc), summer=stack(summer_acc),
                                      avg=stack(avg_acc))
            ts = Solutions.stored_times(st, raw_mode != "all")
            if raw_mode == "none":
                ts = np.zeros((0,))

            return Solutions(
                spacetime=st,
                ts=ts,
                forcing=forcing,
                parameters=Collection(par),
                initconds=Collection({k: np.asarray(v) for k, v in init.items()}),
                lastonly=lastonly,
                debug=debug,
                raw=raw,
                seasonal=seasonal_store,
            )
