"""Noise-forced integration: noise-induced transitions between attractors.

Port of the JAX package's ``stochastic.py``. Weather noise perturbs the
radiative forcing as an Ornstein-Uhlenbeck process of stationary standard
deviation ``sigma`` (W/m^2) and correlation time ``tau`` (years): per step
``eta' = rho eta + sigma sqrt(1 - rho^2) xi`` with ``rho = exp(-dt / tau)``.
Each member-year's seasonal ice area is classified against two attractors'
reference areas; ``first_passage`` is each member's first year on the other
side. With a ramped :class:`~.forcing.Forcing` two sigma-zero companion
trajectories (the last two lanes of the batch) are the evolving references
(rate-induced tipping).

Member ``k``'s white draws in absolute year ``y`` are
``jax.random.normal(fold_in(fold_in(PRNGKey(seed), k), y), (nt,), dtype)``
bit for bit in float32 (:mod:`.ops.prng`), so the same seed gives the JAX
package's weather, and a run split into chunks or across calls
(``year0=``, ``init=``, ``eta0=``) equals the run in one piece.

Engines:

- ``'scan'``: the eager year loop (:func:`.integrate.make_year_fn`) on the
  ``(K, nx)`` batch, with the OU path computed in plain PyTorch over the
  year's white table (float32: the draw kernel
  :func:`.ops.normal_table.normal_table` on a CUDA device) and added to each
  step's forcing, ``(f[t] + F) + eta[t]``.
- ``'fused'``: one launch per model year of the model's whole-year kernel
  for all members (:func:`.ops.miz_year.miz_year`,
  :func:`.ops.classic_year.classic_year`): in float32 the kernel draws the
  weather itself from the ``(K, 2)`` member keys and runs the OU recurrence
  in its time loop (``ou_impl='assoc'``: a log-depth scan before it); in
  float64 it takes the white table of :func:`.ops.prng.normal_table_f64`.
  ``subyear=True`` adds the in-year first-crossing step. On the CPU the
  wrappers run their plain versions.

``'auto'`` is ``'fused'`` on a CUDA device (float32 and float64) and
``'scan'`` on the CPU; on a CUDA device it never falls back.

A ``TransitionResult`` is saved, loaded and drawn by the module-level
:func:`.io.save`, :func:`.io.load` and :func:`.plot.plot_transitions`, as
in the JAX package. Not ported: ``mesh=`` (ROADMAP Queue 1 M14); the JAX
package's ``EBM_OU_IMPL`` and
``EBM_FUSED_NOISE`` environment switches (``ou_impl=`` stays an argument);
its ``block_k=`` member tile (the kernels run one block per member).
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .convert import to_numpy
from .fold import seasonal_ice_area
from .forcing import Forcing
from .integrate import (FUSED_YEARS, check_fused, make_year_fn, resolve_device,
                        resolve_dtype)
from .models.base import default_step_config, dtype_name, get_model
from .ops import prng
from .ops._year import ou_path
from .ops.normal_table import normal_table
from .spacetime import SpaceTime
from .utils.collection import Collection
from .utils.numerics import hemispheric_mean
from .utils.progress import Progress

__all__ = ["transitions", "TransitionResult"]


@dataclasses.dataclass
class TransitionResult:
    """Result of :func:`transitions` (JAX ``stochastic.py:108-251``).

    ``areas`` is the per-year seasonal ice area of every member, shape
    ``(years, K)``; ``labels`` the per-year classification against the two
    attractor reference areas (0 = nearer ``a``, 1 = nearer ``b``, -1 =
    non-finite year; an exactly equidistant year is labeled as the START
    attractor). ``first_passage`` is each member's first year (1-based)
    whose label differs from the starting attractor's, NaN where none (or
    the member went non-finite first). ``state``/``eta`` are the final
    carries and OU values: pass them as ``init=``/``eta0=`` with
    ``year0=<years run so far>`` and the same seed to continue the run bit
    for bit. ``tracked`` holds the per-year hemispheric means asked for by
    ``track=``, each ``(years, K)``.

    Constant forcing: ``area_a``/``area_b`` are the static reference areas
    (``(1,)`` or ``(K,)``). Ramped forcing: the per-year areas of the two
    sigma-zero companions, ``(years,)``, and ``ref_state`` their final
    carries (for ``ref_init=``). ``degenerate`` flags reference areas within
    ~4x the year-to-year area fluctuation. ``crossing_step`` (``subyear=True``)
    holds each member-year's first in-year crossing step, or -1.
    """

    areas: np.ndarray
    labels: np.ndarray
    first_passage: np.ndarray
    finite: np.ndarray
    state: Collection
    eta: np.ndarray
    tracked: Collection
    area_a: np.ndarray
    area_b: np.ndarray
    start: str
    sigma: Union[float, np.ndarray]
    tau: float
    years: int
    season: str
    seed: int
    newton_ok: bool
    year0: int = 0
    engine: str = "scan"
    ramped: bool = False
    degenerate: bool = False
    ref_state: Optional[Tuple[Collection, Collection]] = None
    crossing_step: Optional[np.ndarray] = None
    nt: int = 0

    @property
    def escaped(self) -> np.ndarray:
        """Members that crossed to the other attractor within ``years``."""
        return np.isfinite(self.first_passage)

    def escape_fraction(self) -> float:
        """Fraction of finite members that escaped within ``years``."""
        fin = self.finite
        n = int(np.count_nonzero(fin))
        if n == 0:
            return float("nan")
        return float(np.count_nonzero(self.escaped & fin)) / n

    def first_passage_subyear(self) -> np.ndarray:
        """Sub-annual first-passage times in fractional years (``subyear=True``):
        for each escaped member, ``year + (step + 1) / nt`` of the in-year
        crossing on the way to its year-classified passage, walking back
        over years that were already across when they began (step 0); the
        whole year where no crossing was recorded; NaN where censored."""
        if self.crossing_step is None:
            raise ValueError(
                "no sub-annual crossing data: run transitions(..., "
                "subyear=True, engine='fused')")
        fp = np.asarray(self.first_passage, dtype=np.float64)
        out = fp.copy()
        for k in range(fp.shape[0]):
            if not np.isfinite(fp[k]):
                continue
            y = int(fp[k]) - 1
            step = self.crossing_step[y, k]
            if step < 0:
                continue  # the annual mean flipped without an in-year touch
            while step == 0 and y > 0 and self.crossing_step[y - 1, k] >= 0:
                y -= 1
                step = self.crossing_step[y, k]
            if step == 0 and y == 0:
                continue  # across from the start of the window: keep the year
            out[k] = y + (step + 1.0) / float(self.nt)
        return out

    def mean_first_passage(self) -> float:
        """Mean first-passage year over escaped members only (biased low when
        many are censored; see :meth:`escape_rate`)."""
        fp = self.first_passage[self.escaped & self.finite]
        return float(np.mean(fp)) if fp.size else float("nan")

    def escape_rate(self) -> float:
        """Escapes per member-year, the censoring-aware MLE of an
        exponential escape process."""
        fin = self.finite
        esc = self.escaped & fin
        observed = np.where(esc, self.first_passage, float(self.years))
        total = float(np.sum(observed[fin]))
        if total <= 0.0:
            return float("nan")
        return float(np.count_nonzero(esc)) / total

    def __repr__(self):
        K = self.areas.shape[1] if self.areas.ndim == 2 else 0
        n_esc = int(np.count_nonzero(self.escaped & self.finite))
        bad = int(np.count_nonzero(~self.finite))
        extra = f", {bad} non-finite" if bad else ""
        if np.ndim(self.sigma) > 0:
            s = np.asarray(self.sigma, dtype=np.float64)
            sig = f"sigma in [{s.min():g}, {s.max():g}]"
        else:
            sig = f"sigma={float(self.sigma):g}"
        kind = "ramped " if self.ramped else ""
        return (f"TransitionResult({n_esc}/{K} members escaped "
                f"'{self.start}' in {self.years} {kind}years, {sig}"
                f", tau={self.tau:g}{extra})")


def _area_of(coll, x):
    """Seasonal ice area of a ``(K, nx)`` seasonal Collection, in the run's
    dtype on its device: ``2 pi`` times the hemispheric mean of ``phi``
    (NaN as 0) or of ``E < 0`` — both engines classify with it."""
    if "phi" in coll:
        field = torch.nan_to_num(coll["phi"])
    else:
        field = (coll["E"] < 0.0).to(coll["E"].dtype)
    return 2.0 * math.pi * hemispheric_mean(field, x)


def _first_passage(labels: np.ndarray, start_label: int):
    """First-passage years from a ``(years, K)`` label history: the first
    year labeled as the OTHER attractor strictly before any non-finite (-1)
    year, 1-based, NaN where none; ``finite`` is False for members that went
    non-finite without first escaping (JAX ``stochastic.py:490-510``)."""
    years = labels.shape[0]
    other = labels == (1 - start_label)
    bad_y = labels == -1
    bad_any = bad_y.any(axis=0)
    first_bad = np.where(bad_any, bad_y.argmax(axis=0), years)
    passed = other & (np.arange(years)[:, None] < first_bad[None, :])
    esc_any = passed.any(axis=0)
    fp = np.where(esc_any, passed.argmax(axis=0) + 1.0, np.nan)
    finite = ~(bad_any & ~esc_any)
    return fp, finite


def _year_fn(model: str, engine: str, st: SpaceTime, cfg):
    """One deterministic year ``(carry, par, frow) -> seasonal`` of the
    engine: the kernel wrapper (per-member ``(K,)`` parameters) or the eager
    loop (``(K, 1)`` columns)."""
    if engine == "fused":
        year = FUSED_YEARS[model][0]
        return lambda carry, par, frow: year(carry, par, frow, st, cfg)[1]
    loop = make_year_fn(model, st, cfg, False)
    cols = lambda par: Collection({k: (v[:, None] if v.ndim == 1 else v)
                                   for k, v in par.items()})
    return lambda carry, par, frow: loop(carry, cols(par), frow)[1]


def _ref_area(obj, spec, st, par, forcing, season, dtype, device, engine):
    """Reference ice area of an attractor: from ``obj.seasonal`` when it has
    one (an equilibrate result, as numpy or tensors), else one deterministic
    year from the bare state (or ``obj.state``) under the forcing's first
    row; a bare state needs solo ``par`` (JAX ``stochastic.py:513-533``)."""
    seasonal = getattr(obj, "seasonal", None)
    if seasonal is None:
        swept = [k for k, v in Collection(par).items() if np.ndim(v) >= 1]
        if swept:
            raise ValueError(
                f"attractor references must be EquilibriumResults when par "
                f"leaves {swept} are per-member (a bare state cannot be "
                f"re-run under a swept par)")
        state = Collection(getattr(obj, "state", obj))
        return np.atleast_1d(np.float64(_det_year(
            spec, st, par, state, _forcing_rows(forcing, st, 0, 1)[0], season, dtype, device,
            engine, dtype_name(dtype))))
    return np.atleast_1d(np.asarray(
        seasonal_ice_area(to_numpy(getattr(seasonal, season)), st), dtype=np.float64))


def _det_year(spec, st, par, state, frow, season, dtype, device, engine, cfg_name,
              newton_max_iter: int = 30):
    """The ice area (float64, :func:`.fold.seasonal_ice_area`) of ONE
    deterministic year of a solo ``state`` under forcing row ``frow`` (a
    scalar ``F`` in ``par`` folds into the row), through the engine's year."""
    par = Collection(par)
    F_off = par.pop("F", None)
    frow = np.asarray(frow, dtype=np.float64)
    if F_off is not None:
        frow = frow + float(np.asarray(F_off))
    cfg = default_step_config(cfg_name, newton_max_iter=newton_max_iter)
    carry = spec.init_carry(state, st, dtype, device)
    carry = Collection({k: v[None] for k, v in carry.items()})
    par_t = Collection({k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
                        for k, v in par.items()})
    seasonal = _year_fn(spec.name, engine, st, cfg)(
        carry, par_t, torch.as_tensor(frow, dtype=dtype, device=device))
    return float(seasonal_ice_area(to_numpy(getattr(seasonal, season)), st)[0])


def _solo_state(obj, name: str) -> Collection:
    """A SOLO state Collection from a result with ``.state`` or a bare
    state (ramp companions are single trajectories)."""
    state = Collection(getattr(obj, "state", obj))
    batched = [k for k, v in state.items() if np.ndim(v) > 1]
    if batched:
        raise ValueError(
            f"ramped transitions need SOLO attractor references; reference "
            f"{name!r} has member-batched state leaves {batched} (pass a "
            f"single-member equilibrate result or one member's state)")
    return state


def _thr_sgn(a_y, b_y, sdir: float, K_run: int, dtype, device):
    """The ramped ``subyear`` crossing rows: threshold = the companions'
    mean-area midpoint in raw trapezoid units, sign = the direction toward
    the other attractor, in the run's dtype. The same function seeds the
    first year and advances every later one, so chunking cannot move it."""
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    a, b = t(a_y), t(b_y)
    thr = (a + b) / t(2.0 * 2.0 * np.pi)
    sgn = t(sdir) * torch.sign(b - a)
    return thr.expand(K_run).contiguous(), sgn.expand(K_run).contiguous()


def _forcing_rows(forcing: Forcing, st: SpaceTime, year0: int, years: int) -> np.ndarray:
    """``(years, nt)`` float64 base forcing of absolute years ``year0 ..
    year0 + years - 1``, from the ``(i + 0.5) dt`` times of
    ``Forcing.table``; past the ramp it holds the final level (JAX
    ``stochastic.py:591-604``)."""
    nt = st.nt
    if forcing.constant:
        return np.full((years, nt), float(forcing.base), dtype=np.float64)
    T = (np.arange(year0 * nt, (year0 + years) * nt, dtype=np.float64) + 0.5) * st.dt
    return np.asarray(forcing(T), dtype=np.float64).reshape(years, nt)


def _resolve_engine(engine: str, model: str, st: SpaceTime, device) -> str:
    if engine == "auto":
        engine = "fused" if device.type == "cuda" else "scan"
    if engine not in ("scan", "fused"):
        raise ValueError(f"engine must be auto|scan|fused, got {engine!r}")
    if engine == "fused":
        check_fused(model, st.nx, device, alternative="scan")
    return engine


def transitions(
    model: str,
    st: SpaceTime,
    forcing: Union[Forcing, float],
    par: Collection,
    a,
    b,
    sigma,
    tau: float = 0.02,
    years: int = 100,
    K: Optional[int] = None,
    start: str = "a",
    init: Optional[Collection] = None,
    eta0: Optional[np.ndarray] = None,
    year0: int = 0,
    track: Sequence[str] = (),
    season: str = "avg",
    seed: int = 0,
    dtype=None,
    device=None,
    newton_max_iter: int = 30,
    engine: str = "auto",
    ou_impl: Optional[str] = None,
    subyear: bool = False,
    years_per_dispatch: Optional[int] = None,
    ref_init: Optional[tuple] = None,
    ref_area0: Optional[tuple] = None,
    mesh=None,
    progress: bool = False,
) -> TransitionResult:
    """Noise-induced transition statistics between two attractors (JAX
    ``stochastic.py:607-742``).

    Runs ``K`` members from the ``start`` attractor (``"a"`` or ``"b"``;
    ``init=`` overrides the starting state) under OU weather noise of
    stationary std ``sigma`` (W/m^2, scalar or per-member ``(K,)``) and
    correlation time ``tau`` (years) added to the forcing, classifying each
    member-year's seasonal ice area against the attractors' reference areas.
    ``a``/``b`` are objects with ``.seasonal`` (and ``.state``) stores, such
    as the JAX package's equilibrate results as numpy, or bare state
    Collections, re-run for one deterministic year (solo ``par`` only).
    ``par`` leaves of shape ``(K,)`` (the virtual ``"F"`` offset included)
    sweep members; ``track`` names seasonal variables whose hemispheric means
    are kept per year.

    A ramped ``forcing`` adds two sigma-zero companions starting from ``a``'s
    and ``b``'s states (``ref_init=`` overrides them) as the per-year
    references; ramped runs need solo ``par`` and solo references.

    ``engine``: ``'scan'``, ``'fused'`` or ``'auto'`` (module docstring).
    ``ou_impl``: ``'serial'`` (default) or ``'assoc'`` (fused float32 only:
    the log-depth scan, engine parity with serial). ``subyear=True`` (fused
    float32) records each member-year's first in-year step whose ice area
    crosses the midpoint of the reference areas (``crossing_step``); under a
    ramp the threshold evolves with the companions' previous-year areas,
    seeded by ``ref_area0=`` or by one deterministic year of each companion.

    ``dtype`` defaults to float32, ``device`` to the CUDA device (pass
    ``"cpu"`` for the CPU; with no CUDA device ``None`` raises).
    ``years_per_dispatch`` bounds the years queued on the device before the
    host waits for them (default: all); results do not depend on it.
    ``year0`` offsets the absolute year (draw keys and ramp rows).
    ``mesh=`` is not ported (ROADMAP Queue 1 M14).
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (members sharded across devices) is not ported yet: ROADMAP "
            "Queue 1 M14")
    spec = get_model(model)
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    ramped = not forcing.constant
    if start not in ("a", "b"):
        raise ValueError(f"start must be 'a' or 'b', got {start!r}")
    sigma_arr = np.asarray(sigma, dtype=np.float64)
    if sigma_arr.ndim > 1:
        raise ValueError("sigma must be a scalar or a (K,) vector")
    if np.any(sigma_arr < 0.0):
        raise ValueError("sigma must be >= 0")
    tau = float(tau)
    if tau < 0.0:
        raise ValueError("tau must be >= 0")
    years = int(years)
    if years < 1:
        raise ValueError("years must be >= 1")
    year0 = int(year0)
    if year0 < 0:
        raise ValueError("year0 must be >= 0")
    if season not in ("winter", "summer", "avg"):
        raise ValueError(f"season must be winter/summer/avg, got {season!r}")
    if years_per_dispatch is not None and int(years_per_dispatch) < 1:
        raise ValueError(f"years_per_dispatch must be >= 1, got {years_per_dispatch}")
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)

    par = Collection(par)
    par.pop("__K__", None)
    sizes = {np.shape(v)[0] for v in par.values() if np.ndim(v) > 0}
    if sigma_arr.ndim == 1:
        sizes |= {sigma_arr.shape[0]}
    if init is not None:
        sizes |= {np.shape(v)[0] for v in Collection(init).values() if np.ndim(v) > 1}
    if sizes and K is not None and int(K) not in sizes:
        raise ValueError(
            f"K={K} conflicts with per-member par/init/sigma leaves of "
            f"size {sorted(sizes)}")
    if len(sizes) > 1:
        raise ValueError(f"inconsistent ensemble sizes {sorted(sizes)}")
    K = int(K) if K is not None else (sizes.pop() if sizes else 1)

    engine = _resolve_engine(engine, spec.name, st, device)
    if ou_impl is None:
        ou_impl = "serial"
    if ou_impl not in ("serial", "assoc"):
        raise ValueError(f"ou_impl must be serial|assoc, got {ou_impl!r}")
    if engine != "fused" and ou_impl == "assoc":
        raise ValueError(
            "ou_impl='assoc' is a fused-kernel mode (the scan engine "
            "IS the serial reference weather); use engine='fused'")
    if engine == "fused" and ou_impl == "assoc" and dtype != torch.float32:
        raise ValueError(
            "ou_impl='assoc' runs over the in-kernel-generated draw "
            "scratch, which is float32-only; run the ensemble in "
            "float32 (or use ou_impl='serial')")
    if subyear:
        if engine != "fused":
            raise ValueError(
                "subyear=True runs inside the fused whole-year kernel; "
                "use engine='fused' (f32)")
        if dtype != torch.float32:
            raise ValueError("subyear=True requires the float32 fused keys mode")

    if ramped:
        swept = sorted(k for k, v in par.items() if np.ndim(v) > 0)
        if swept:
            raise ValueError(
                f"ramped transitions cannot sweep par leaves {swept} "
                f"across members (the sigma-zero companion references "
                f"would need one deterministic run per member); sweep "
                f"with separate calls, or per-member sigma")
        if ref_init is not None:
            if len(ref_init) != 2:
                raise ValueError("ref_init must be (state_a, state_b)")
            state_a = _solo_state(ref_init[0], "ref_init[0]")
            state_b = _solo_state(ref_init[1], "ref_init[1]")
        else:
            state_a = _solo_state(a, "a")
            state_b = _solo_state(b, "b")
        area_a = area_b = None
    else:
        if ref_init is not None:
            raise ValueError("ref_init= is for ramped forcing only (the "
                             "sigma-zero companion trajectories)")
        area_a = _ref_area(a, spec, st, par, forcing, season, dtype, device, engine)
        area_b = _ref_area(b, spec, st, par, forcing, season, dtype, device, engine)
        for name, arr in (("a", area_a), ("b", area_b)):
            if arr.size not in (1, K):
                raise ValueError(
                    f"attractor {name}'s reference area is {arr.size}-member "
                    f"but the run has K={K}")

    if init is None:
        src = a if start == "a" else b
        init = getattr(src, "state", src)
    init = Collection(init)
    bad = [k for k, v in init.items() if np.ndim(v) > 1 and np.shape(v)[0] != K]
    if bad:
        raise ValueError(
            f"init leaves {bad} are member-batched with a size other "
            f"than K={K}")

    track = tuple(track)
    bad_track = [v for v in track if v not in spec.solution_vars]
    if bad_track:
        raise ValueError(
            f"track names {bad_track} not in the {spec.name} seasonal "
            f"store {tuple(spec.solution_vars)}")
    cfg = default_step_config(dtype_name(dtype), newton_max_iter=newton_max_iter)

    F_off = par.pop("F", None)
    ramp_shift = 0.0
    if F_off is not None and np.ndim(F_off) == 0:
        # a scalar offset folds into the base forcing (float64 host
        # arithmetic), or under a ramp into its tabulated rows
        if forcing.constant:
            forcing = Forcing(float(forcing.base) + float(np.asarray(F_off)))
        else:
            ramp_shift = float(np.asarray(F_off))
        F_off = None

    K_run = K + 2 if ramped else K
    t = lambda v: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                  dtype=dtype, device=device)
    carry = spec.init_carry(init, st, dtype, device)
    carry = Collection({k: (v if v.ndim > 1 else v.expand((K,) + tuple(v.shape)))
                        for k, v in carry.items()})
    if ramped:
        carry_a = spec.init_carry(state_a, st, dtype, device)
        carry_b = spec.init_carry(state_b, st, dtype, device)
        carry = Collection({k: torch.cat([carry[k], carry_a[k][None], carry_b[k][None]])
                            for k in carry})
    carry = Collection({k: v.contiguous() for k, v in carry.items()})

    par_run = Collection({k: t(v) for k, v in par.items()})
    f_off = t(np.asarray(F_off, dtype=np.float64)) if F_off is not None and np.ndim(F_off) == 1 \
        else torch.zeros((K,), dtype=dtype, device=device)
    if ramped:
        f_off = torch.cat([f_off, torch.zeros((2,), dtype=dtype, device=device)])

    frows_all = _forcing_rows(forcing, st, year0, years)
    if ramp_shift:
        frows_all = frows_all + ramp_shift

    member_keys = prng.fold_in(prng.prng_key(seed), np.arange(K_run))

    if eta0 is None:
        eta = torch.zeros((K_run,), dtype=dtype, device=device)
    else:
        eta0 = np.asarray(eta0, dtype=np.float64)
        if eta0.shape not in ((), (K,)):
            raise ValueError(f"eta0 must be scalar or ({K},), got {eta0.shape}")
        eta0 = np.broadcast_to(eta0, (K,))
        if ramped:
            eta0 = np.concatenate([eta0, np.zeros(2)])
        eta = t(eta0)

    dt = 1.0 / st.nt
    if tau > 0.0:
        rho = float(np.exp(-dt / tau))
        s_fac = float(np.sqrt(max(0.0, 1.0 - rho * rho)))
    else:
        rho, s_fac = 0.0, 1.0
    scale_np = np.broadcast_to(sigma_arr * s_fac, (K,)).astype(np.float64)
    if ramped:
        scale_np = np.concatenate([scale_np, np.zeros(2)])
    scale = t(scale_np)
    rho_t = t(rho)

    # the in-year crossing rows: the per-member midpoint of the two reference
    # areas in raw trapezoid units and the direction toward the other one;
    # ramped runs seed the first year here and advance it each year
    sdir = 1.0 if start == "a" else -1.0
    if ref_area0 is not None and not (subyear and ramped):
        raise ValueError(
            "ref_area0= seeds the evolving crossing threshold of a "
            "RAMPED subyear=True run (pass the prior segment's "
            "(result.area_a[-1], result.area_b[-1]))")
    cr_thr = cr_sgn = None
    if subyear and ramped:
        if ref_area0 is not None:
            if len(ref_area0) != 2:
                raise ValueError("ref_area0 must be (area_a, area_b)")
            a0, b0 = (float(np.asarray(v, np.float64)) for v in ref_area0)
        else:
            a0, b0 = (_det_year(spec, st, par, s, frows_all[0], season, dtype, device, engine,
                                dtype_name(dtype), newton_max_iter)
                      for s in (state_a, state_b))
        cr_thr, cr_sgn = _thr_sgn(a0, b0, sdir, K_run, dtype, device)
    elif subyear:
        a_arr = np.broadcast_to(np.asarray(area_a, np.float64), (K,))
        b_arr = np.broadcast_to(np.asarray(area_b, np.float64), (K,))
        other = b_arr if start == "a" else a_arr
        own = a_arr if start == "a" else b_arr
        cr_thr = t((a_arr + b_arr) / (2.0 * 2.0 * np.pi))
        cr_sgn = t(np.sign(other - own))

    x = t(st.x)
    if engine == "fused":
        kernel_year = FUSED_YEARS[spec.name][0]
        par_run["F"] = f_off
    else:
        scan_year = make_year_fn(spec.name, st, cfg, False)
        par_cols = Collection({k: (v[:, None] if v.ndim == 1 else v)
                               for k, v in par_run.items()})

    def one_year(carry, eta, yi, frow, thr, sgn):
        """One noisy model year of all K_run members: (carry, eta, seasonal,
        converged, crossing steps or None)."""
        keys = prng.fold_in(member_keys, yi)
        if engine == "fused":
            kw = dict(noise_ou=(rho_t, scale, eta))
            if dtype == torch.float32:
                kw.update(noise_keys=keys, ou_assoc=ou_impl == "assoc")
            else:
                kw.update(noise=prng.normal_table_f64(keys, st.nt, device))
            if subyear:
                kw.update(crossing=(thr, sgn))
            out = kernel_year(carry, par_run, t(frow), st, cfg, **kw)
            carry, seasonal, conv, eta = out[:4]
            return carry, eta, seasonal, conv, (out[4] if subyear else None)
        xi = (normal_table(keys, st.nt, device) if dtype == torch.float32
              else prng.normal_table_f64(keys, st.nt, device))
        etas = ou_path(xi, rho_t, scale, eta)
        fyear = (t(frow)[:, None] + f_off[None, :]) + etas
        carry, seasonal, conv, _ = scan_year(carry, par_cols, fyear[:, :, None])
        return carry, etas[-1], seasonal, conv, None

    prog = None
    if progress:
        sig_txt = (f"{float(np.min(sigma_arr)):g}..{float(np.max(sigma_arr)):g}"
                   if sigma_arr.ndim else f"{float(sigma_arr):g}")
        prog = Progress(years, title=f"Transitions (sigma={sig_txt})",
                        infofeed=lambda msg: msg)

    chunk = years if years_per_dispatch is None else int(years_per_dispatch)
    areas_h, means_h, cross_h, convs = [], [], [], []
    done = 0
    while done < years:
        k = min(chunk, years - done)
        t0 = time.perf_counter()
        for y in range(done, done + k):
            carry, eta, seasonal, conv, cross = one_year(
                carry, eta, year0 + y, frows_all[y], cr_thr, cr_sgn)
            coll = getattr(seasonal, season)
            area = _area_of(coll, x)
            areas_h.append(area)
            means_h.append([hemispheric_mean(torch.nan_to_num(coll[v]), x) for v in track])
            if conv is not None:
                convs.append(conv)
            if subyear:
                cross_h.append(cross)
                if ramped:
                    # next year's entering threshold: this year's companion
                    # areas (the last two lanes), lag 1
                    cr_thr, cr_sgn = _thr_sgn(area[-2], area[-1], sdir, K_run, dtype, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        done += k
        if prog is not None:
            prog.update(done, feedargs=(f"{done}/{years} years "
                                        f"({time.perf_counter() - t0:.1f} s)",))

    ok = float(torch.stack(convs).min()) if convs else 1.0
    areas = to_numpy(torch.stack(areas_h)).astype(np.float64)  # (years, K_run)
    tracked = Collection({
        v: to_numpy(torch.stack([m[i] for m in means_h])).astype(np.float64)
        for i, v in enumerate(track)
    })
    carry = to_numpy(carry)

    ref_state = None
    if ramped:
        area_a = areas[:, K]
        area_b = areas[:, K + 1]
        ref_state = (Collection({k: np.asarray(v[K]) for k, v in carry.items()}),
                     Collection({k: np.asarray(v[K + 1]) for k, v in carry.items()}))
        areas = areas[:, :K]
        tracked = Collection({k: v[:, :K] for k, v in tracked.items()})

    finite_y = np.isfinite(areas)
    if ramped:
        d_a = np.abs(areas - area_a[:, None])
        d_b = np.abs(areas - area_b[:, None])
    else:
        d_a = np.abs(areas - area_a[None, :]) if area_a.size == K \
            else np.abs(areas - area_a.reshape(1, 1))
        d_b = np.abs(areas - area_b[None, :]) if area_b.size == K \
            else np.abs(areas - area_b.reshape(1, 1))
    # nearest-area labels, ties toward the START attractor
    if start == "a":
        labels = np.where(finite_y, (d_b < d_a).astype(np.int8), np.int8(-1))
    else:
        labels = np.where(finite_y, np.where(d_a < d_b, 0, 1).astype(np.int8), np.int8(-1))
    labels = labels.astype(np.int8)
    fp, finite = _first_passage(labels, 0 if start == "a" else 1)

    degenerate = False
    if years >= 3:
        gap = np.abs(np.asarray(area_a, dtype=np.float64) - np.asarray(area_b, dtype=np.float64))
        with np.errstate(invalid="ignore"):
            fluct = np.abs(np.diff(areas, axis=0))
            fluct = float(np.nanmedian(fluct)) if np.isfinite(fluct).any() else 0.0
        if float(np.nanmin(gap)) <= 4.0 * fluct:
            degenerate = True
            warnings.warn(
                f"transitions: attractor reference areas come within "
                f"{float(np.nanmin(gap)):.3g} of each other while member "
                f"areas fluctuate ~{fluct:.3g} per year — nearest-area "
                f"labels are degenerate there and the escape statistics "
                f"should not be trusted (result.degenerate=True)")

    state = Collection({k: np.asarray(v) for k, v in carry.items()})
    eta_np = to_numpy(eta).astype(np.float64)
    if ramped:
        state = Collection({k: v[:K] for k, v in state.items()})
        eta_np = eta_np[:K]

    crossing_step = None
    if subyear:
        crossing_step = to_numpy(torch.stack(cross_h)).astype(np.float64)
        if ramped:
            crossing_step = crossing_step[:, :K]

    return TransitionResult(
        areas=areas, labels=labels, first_passage=fp, finite=finite,
        state=state, eta=eta_np, tracked=tracked,
        area_a=np.asarray(area_a, dtype=np.float64),
        area_b=np.asarray(area_b, dtype=np.float64),
        start=start,
        sigma=(float(sigma_arr) if sigma_arr.ndim == 0 else np.asarray(sigma_arr)),
        tau=tau, years=years, season=season, seed=int(seed),
        newton_ok=bool(ok >= 0.5), year0=year0, engine=engine,
        ramped=ramped, degenerate=degenerate, ref_state=ref_state,
        crossing_step=crossing_step, nt=int(st.nt),
    )
