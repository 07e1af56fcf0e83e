"""Visualization layer (rebuild of EnergyBalanceModel.jl src/plot.jl, host-side
matplotlib instead of Makie).

- :class:`Layout` — a grid of solution-variable names + subplot titles
  (reference :23-39) with the default MIZ 3x3 and classic 1x3 layouts
  (:41-57).
- :func:`backend` — get/set the rendering backend. The reference's weak-dep
  Makie backends (CairoMakie/GLMakie, ext/CairoExt.jl, ext/OpenGLExt.jl) map
  onto matplotlib backends through a small registry that extensions can
  override via :func:`register_backend`.
- :func:`plot_raw` / :func:`plot_avg` — Hovmöller (x–t) filled-contour tile
  grids with colorbars (:91-130, :139-150).
- :func:`plot_seasonal` — hysteresis plot: hemispheric-mean temperature vs
  ice-covered area per year, warming segment red / cooling blue, line styles
  by season (:173-225). The reference's latent indexing bug (broadcasting
  ``xfunc`` over the scalar ``dur`` instead of ``1:dur``, :196) is fixed —
  years ``1..dur`` are evaluated.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .solutions import Solutions
from .utils.numerics import np_hemispheric_mean

__all__ = [
    "Layout",
    "backend",
    "register_backend",
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
    "miz_layout",
    "classic_layout",
    "unsafesave",
]


@dataclasses.dataclass(frozen=True)
class Layout:
    """Plot layout: matrices of variable names and titles of equal shape
    (reference EnergyBalanceModel.jl src/plot.jl:23-39)."""

    vars: tuple
    titles: tuple

    def __init__(self, vars, titles):
        vars = tuple(tuple(row) for row in np.atleast_2d(np.asarray(vars, dtype=object)))
        titles = tuple(tuple(row) for row in np.atleast_2d(np.asarray(titles, dtype=object)))
        if np.shape(vars) != np.shape(titles):
            raise ValueError("Size of vars and titles must be the same.")
        object.__setattr__(self, "vars", vars)
        object.__setattr__(self, "titles", titles)

    @property
    def shape(self):
        return (len(self.vars), len(self.vars[0]))

    def __getitem__(self, idx):
        r, c = idx
        return dict(var=self.vars[r][c], title=self.titles[r][c])


miz_layout = Layout(
    [["Ew", "Ei", "E"], ["Tw", "Ti", "T"], ["h", "D", "phi"]],
    [
        [r"$E_w$ ($\mathrm{J\,m^{-2}}$)", r"$E_i$ ($\mathrm{J\,m^{-2}}$)", r"$E$ ($\mathrm{J\,m^{-2}}$)"],
        [r"$T_w$ ($^\circ$C)", r"$T_i$ ($^\circ$C)", r"$T$ ($^\circ$C)"],
        [r"$\bar{h}$ (m)", r"$\bar{\mathcal{D}}$ (m)", r"$\varphi$"],
    ],
)

classic_layout = Layout(
    [["E", "T", "h"]],
    [[r"$E$ ($\mathrm{J\,m^{-2}}$)", r"$T$ ($^\circ$C)", r"$h$ (m)"]],
)

# Backend registry — extension point mirroring the reference's
# ``init_backend(::Val)`` overridden by weak-dep packages
# (EnergyBalanceModel.jl ext/CairoExt.jl:7, ext/OpenGLExt.jl:7).
_BACKENDS = {
    "CairoMakie": "Agg",  # raster/vector offline rendering
    "GLMakie": None,  # interactive — use matplotlib's current GUI backend
    "Agg": "Agg",
}
_current = None


def register_backend(name: str, matplotlib_backend: Optional[str]) -> None:
    """Register/override a backend mapping (extension hook)."""
    _BACKENDS[name] = matplotlib_backend


def backend(name: Optional[str] = None):
    """Get the current backend, or set it by name (reference
    EnergyBalanceModel.jl src/plot.jl:59-89)."""
    global _current
    import matplotlib

    if name is None:
        return _current if _current is not None else matplotlib.get_backend()
    if name not in _BACKENDS:
        raise ValueError(f"Unsupported backend {name}.")
    target = _BACKENDS[name]
    if target is not None:
        matplotlib.use(target, force=False)
    _current = name
    return matplotlib.get_backend()


def _default_layout(sols: Solutions) -> Layout:
    return miz_layout if "phi" in sols.raw else classic_layout


def _contourf_tiles(t, x, data_layout: Layout, datamats):
    """Tile grid of filled contours + colorbars (reference
    EnergyBalanceModel.jl src/plot.jl:91-106)."""
    import matplotlib.pyplot as plt

    nrow, ncol = data_layout.shape
    fig, axes = plt.subplots(
        nrow, ncol, figsize=(4.2 * ncol, 3.0 * nrow), squeeze=False, constrained_layout=True
    )
    for r in range(nrow):
        for c in range(ncol):
            ax = axes[r][c]
            mat = datamats[r][c]
            ctr = ax.contourf(t, x, mat.T)
            ax.set_title(data_layout[r, c]["title"])
            ax.set_ylim(0, 1)
            if r == nrow - 1:
                ax.set_xlabel(r"$t$ (y)")
            if c == 0:
                ax.set_ylabel(r"$x$")
            fig.colorbar(ctr, ax=ax)
    return fig


def plot_raw(sols: Solutions, bcknd: Optional[str] = None, layout: Optional[Layout] = None):
    """Hovmöller plots of per-step raw solutions (reference
    EnergyBalanceModel.jl src/plot.jl:119-130)."""
    if bcknd is not None:
        backend(bcknd)
    layout = layout or _default_layout(sols)
    nrow, ncol = layout.shape
    mats = [[np.asarray(sols.raw[layout[r, c]["var"]]) for c in range(ncol)] for r in range(nrow)]
    # key the guard on the RAW arrays, not `ts`: a resumed already-complete
    # run returns populated stored times with (0, nx) raw storage
    if len(sols.ts) == 0 or any(m.shape[0] == 0 for row in mats for m in row):
        raise ValueError(
            "this Solutions has no per-step raw storage (raw_mode='none', "
            "or a resume of an already-completed run); use plot_avg/"
            "plot_seasonal, or rerun with raw_mode='last'/'all'"
        )
    return _contourf_tiles(np.asarray(sols.ts), sols.spacetime.x, layout, mats)


def plot_avg(sols: Solutions, bcknd: Optional[str] = None, layout: Optional[Layout] = None):
    """Annual-average Hovmöller plots (reference
    EnergyBalanceModel.jl src/plot.jl:139-150)."""
    if bcknd is not None:
        backend(bcknd)
    layout = layout or _default_layout(sols)
    nrow, ncol = layout.shape
    mats = [
        [np.asarray(sols.seasonal.avg[layout[r, c]["var"]]) for c in range(ncol)]
        for r in range(nrow)
    ]
    years = np.arange(1, sols.spacetime.dur + 1)
    return _contourf_tiles(years, sols.spacetime.x, layout, mats)


def _default_xfunc(sols: Solutions, year: int) -> float:
    """Hemispheric-mean annual-average temperature for 1-based ``year``."""
    return np_hemispheric_mean(sols.seasonal.avg["T"][year - 1], sols.spacetime.x)


def _default_yfunc(sols: Solutions, season: str, year: int) -> float:
    """Ice-covered area ``2 pi <phi>`` (or from E<0 for classic runs) —
    the shared :func:`~energybalancemodel_jl_tpu_torch.fold.seasonal_ice_area`
    diagnostic on one year's seasonal row."""
    from .fold import seasonal_ice_area

    coll = getattr(sols.seasonal, season)
    row = {k: np.asarray(coll[k])[year - 1]
           for k in ("phi", "E") if k in coll}
    return float(seasonal_ice_area(row, sols.spacetime))


def _seasonal_loops(ax, sols, xfunc, yfunc, alpha=1.0, labeled=True,
                    seasons=("avg", "winter", "summer")):
    """Draw one run's hysteresis loops on ``ax`` (warming red/cooling blue,
    seasons line-styled). Shared by the single-run and ensemble variants."""
    dur = sols.spacetime.dur
    years = np.arange(1, dur + 1)  # fixed: the reference broadcasts over scalar dur (:196)
    xdata = np.array([xfunc(sols, int(y)) for y in years])
    d = sols.forcing.domain
    segments = (
        ("Warming", range(max(d[1], 1), min(d[2], dur) + 1), "tab:red"),
        ("Cooling", range(max(d[3], 1), min(d[4], dur) + 1), "tab:blue"),
    )
    for label, yrs, color in segments:
        yrs = [y for y in yrs if 1 <= y <= dur]
        if not yrs:
            continue
        for season in seasons:
            width = 1.0
            if season == "avg":
                width += 2.0 if label == "Warming" else 1.0
            ydata = np.array([yfunc(sols, season, int(y)) for y in yrs])
            ax.plot(
                xdata[np.array(yrs) - 1],
                ydata,
                color=color,
                linewidth=width,
                alpha=alpha,
                linestyle="--" if season == "summer" else "-",
                label=f"{label} {season}" if (labeled and season == "avg") else None,
            )


def plot_seasonal(
    sols,
    bcknd: Optional[str] = None,
    xfunc: Callable = _default_xfunc,
    yfunc: Callable = _default_yfunc,
    title: str = "Ice covered area",
    xlabel: str = r"$\tilde{\mathsf{T}}$ ($^\circ$C)",
    ylabel: str = r"$A_i$",
    members=None,
):
    """Hysteresis plot over the forcing ramp (reference
    EnergyBalanceModel.jl src/plot.jl:173-225). Warming-segment years are red,
    cooling blue; seasons are line-styled (mean thick solid, winter thin
    solid, summer dashed).

    ``sols`` may also be an
    :class:`~energybalancemodel_jl_tpu_torch.parallel.EnsembleSolutions` — every
    member's annual-mean hysteresis loop is overlaid (the reference user's
    sequential plot_seasonal studies as one figure); ``members`` selects a
    subset of member indices."""
    import matplotlib.pyplot as plt

    if bcknd is not None:
        backend(bcknd)
    if sols.forcing.constant:
        raise ValueError("plot_seasonal requires a time-varying forcing (hysteresis plot)")
    fig, ax = plt.subplots(figsize=(6.0, 4.5), constrained_layout=True)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if hasattr(sols, "n_members"):  # EnsembleSolutions
        idx = range(sols.n_members) if members is None else members
        idx = list(idx)
        for j, i in enumerate(idx):
            msol = sols.member_solutions(i)
            _seasonal_loops(
                ax, msol, xfunc, yfunc,
                alpha=max(0.25, 1.5 / max(len(idx), 1)) if len(idx) > 1 else 1.0,
                labeled=(j == 0), seasons=("avg",),
            )
    else:
        _seasonal_loops(ax, sols, xfunc, yfunc)
    ax.legend()
    return fig


def plot_bifurcation(
    ens,
    param: Optional[str] = None,
    bcknd: Optional[str] = None,
    year: Optional[int] = None,
    yfunc: Callable = _default_yfunc,
    seasons=("avg", "winter", "summer"),
    title: Optional[str] = None,
    ylabel: str = r"$A_i$",
):
    """Bifurcation diagram from a :func:`~energybalancemodel_jl_tpu_torch.parallel.sweep`
    result: ice-covered area (``yfunc``) at 1-based ``year`` (default: the
    final year) against the swept parameter ``param`` (inferred when exactly
    one parameter is swept). With a ramp forcing, both the end-of-warming
    state (year ``domain[2]``, red) and the final cooled state (blue) are
    drawn — the hysteresis envelope across the parameter axis.

    Promotes the reference's plot_seasonal-based bifurcation workflow
    (EnergyBalanceModel.jl src/plot.jl:173-225) to a first-class ensemble API."""
    import matplotlib.pyplot as plt

    if bcknd is not None:
        backend(bcknd)
    swept = ens.swept
    if param is None:
        if len(swept) != 1:
            raise ValueError(
                f"pass param=: ensemble sweeps {sorted(swept.keys()) or 'nothing'}"
            )
        param = next(iter(swept.keys()))
    if param not in swept:
        raise ValueError(f"parameter {param!r} is not swept; swept: {sorted(swept.keys())}")
    pvals = np.asarray(swept[param], dtype=np.float64)
    dur = ens.spacetime.dur
    d = ens.forcing.domain
    if year is None:
        # the warmed state only exists if the warming phase completes
        # strictly before the final year — clamping d[2] to dur would draw
        # the same year twice under two labels, presenting a mid-warming
        # state as both 'warmed' and 'final'
        warmed = [] if ens.forcing.constant else [
            (int(d[2]), "tab:red", "warmed")
        ] if 1 <= d[2] < dur else []
        states = warmed + [(dur, "tab:blue", "final" if warmed else None)]
    else:
        if not 1 <= int(year) <= dur:
            raise ValueError(f"year must be in 1..{dur}, got {year}")
        states = [(int(year), "tab:blue", f"year {int(year)}")]
    order = np.argsort(pvals)
    # one Solutions view per member — not one per (state, season) pair: each
    # view copies every seasonal array of that member, and bifurcation
    # sweeps run thousands of members
    views = [ens.member_solutions(int(i)) for i in order]
    fig, ax = plt.subplots(figsize=(6.0, 4.5), constrained_layout=True)
    ax.set_title(title or f"Ice covered area vs {param}")
    ax.set_xlabel(param)
    ax.set_ylabel(ylabel)
    for yr, color, label in states:
        for season in seasons:
            ydata = np.array([yfunc(v, season, yr) for v in views])
            ax.plot(
                pvals[order], ydata, color=color,
                linewidth=2.0 if season == "avg" else 1.0,
                linestyle="--" if season == "summer" else "-",
                marker="o" if season == "avg" else None, markersize=3,
                label=f"{label} {season}" if (label and season == "avg") else None,
            )
    if ax.get_legend_handles_labels()[1]:
        ax.legend()
    return fig


def plot_continuation(
    cont,
    bcknd: Optional[str] = None,
    var: Optional[str] = None,
    seasons=("avg", "winter", "summer"),
    members=None,
    title: Optional[str] = None,
    ylabel: Optional[str] = None,
    stability=None,
):
    """Bifurcation/hysteresis diagram from an
    :func:`~energybalancemodel_jl_tpu_torch.continuation` result: the equilibrated
    ice-covered area (default) — or the hemispheric mean of ``var`` — at
    each level, against the continued parameter. The forward leg draws red
    and the ``round_trip`` return leg blue (the package's warming/cooling
    color language); where the two legs disagree at the same value the
    model is bistable — the hysteresis window. Levels whose equilibration
    did not converge are marked with a black 'x'.

    Ensemble continuations (``(K,)`` par leaves) overlay every member's
    legs; ``members`` selects a subset of member indices. ``stability``
    takes one entry per level — a
    :class:`~energybalancemodel_jl_tpu_torch.StabilityResult` from
    ``cont.stability(...)`` or a plain ``|lambda|`` float — and marks
    non-attracting levels (leading ``|lambda| > 1.02``, or a non-finite
    growth — a diverged level) with an open triangle on the lead curve:
    folds announce themselves as markers appearing along a branch. Reference analog:
    the plot_seasonal hysteresis workflow
    (EnergyBalanceModel.jl src/plot.jl:173-225) — drawn from equilibria instead
    of ramp snapshots."""
    import matplotlib.pyplot as plt

    if bcknd is not None:
        backend(bcknd)
    vals = np.asarray(cont.values, dtype=np.float64)
    direction = np.asarray(cont.direction)
    conv = np.asarray(cont.converged)
    fig, ax = plt.subplots(figsize=(6.0, 4.5), constrained_layout=True)
    ax.set_title(title or f"{var or 'Ice covered area'} vs {cont.vary}")
    ax.set_xlabel(cont.vary)
    ax.set_ylabel(var if ylabel is None and var is not None
                  else (ylabel if ylabel is not None else r"$A_i$"))

    legs = [(direction > 0, "tab:red", "forward")]
    if np.any(direction < 0):
        legs.append((direction < 0, "tab:blue", "return"))

    def field(season):
        return np.asarray(cont.ice_area(season) if var is None
                          else cont.mean(var, season))

    seasons = tuple(seasons)
    lead = seasons[0] if seasons else "avg"
    y0 = field(lead)
    cols = ([None] if y0.ndim == 1 else
            list(range(y0.shape[1])) if members is None
            else [int(i) for i in members])
    alpha = 1.0 if len(cols) == 1 else max(0.25, 1.5 / len(cols))
    for season in seasons:
        y = y0 if season == lead else field(season)
        for leg, color, label in legs:
            for j, c in enumerate(cols):
                ax.plot(
                    vals[leg], y[leg] if c is None else y[leg, c],
                    color=color, alpha=alpha,
                    linewidth=2.0 if season == lead else 1.0,
                    linestyle="--" if season == "summer" else "-",
                    marker="o" if season == lead else None, markersize=3,
                    label=(f"{label} {season}"
                           if season == lead and j == 0 else None),
                )
    bad = ~conv
    if bad.any():
        # mark on the lead season's curve so the 'x' sits on drawn data
        for j, c in enumerate(cols):
            ax.plot(vals[bad], y0[bad] if c is None else y0[bad, c],
                    linestyle="none", marker="x", color="black",
                    markersize=7,
                    label="not converged" if j == 0 else None)
    if stability is not None:
        if len(stability) != len(cont.results):
            raise ValueError(
                f"stability needs one entry per level "
                f"({len(cont.results)}), got {len(stability)}")
        lead_growth = np.asarray([
            float(np.max(np.atleast_1d(getattr(s, "growth", s))))
            for s in stability
        ])
        # non-finite growth (a diverged level) is the strongest reason to
        # flag — treat it as non-attracting, never as silently stable
        unstable = ~np.isfinite(lead_growth) | (lead_growth > 1.02)
        if unstable.any():
            for j, c in enumerate(cols):
                ax.plot(vals[unstable],
                        y0[unstable] if c is None else y0[unstable, c],
                        linestyle="none", marker="^", markersize=9,
                        markerfacecolor="none", markeredgecolor="black",
                        label=(r"non-attracting ($|\lambda| > 1$)"
                               if j == 0 else None))
    if ax.get_legend_handles_labels()[1]:
        ax.legend()
    return fig


def plot_fold(
    res,
    against: Optional[str] = None,
    bcknd: Optional[str] = None,
    title: Optional[str] = None,
    xlabel: Optional[str] = None,
):
    """Fold curve from an :func:`~energybalancemodel_jl_tpu_torch.fold` result:
    each member's fold estimate (bracket midpoint) with its final bracket
    as the error bar, against the second parameter — ``against`` names a
    key of the parameter Collection stored on the result (e.g. ``"D"``
    for the classic snowball fold F*(D)) — or the member index when
    omitted. Members with an unconverged probe (``~res.ok``) are marked
    with a black 'x': their estimates rest on unsettled solves."""
    import matplotlib.pyplot as plt

    if bcknd is not None:
        backend(bcknd)
    v = np.asarray(res.values, dtype=np.float64)
    K = len(v)
    if against is not None:
        if res.par is None or against not in res.par:
            raise ValueError(
                f"against {against!r} is not a key of the result's stored "
                f"parameters ({sorted(res.par) if res.par is not None else 'none stored'})")
        x = np.broadcast_to(
            np.asarray(res.par[against], dtype=np.float64), (K,))
        xl = against
    else:
        x = np.arange(K, dtype=np.float64)
        xl = "member"
    lo = np.minimum(res.lo, res.hi)  # brackets may run high-to-low
    hi = np.maximum(res.lo, res.hi)
    fig, ax = plt.subplots(figsize=(6.0, 4.5), constrained_layout=True)
    ax.errorbar(x, v, yerr=np.vstack([v - lo, hi - v]), fmt="o-",
                color="tab:red", capsize=3, markersize=4,
                label=f"{res.vary}* (bracket)")
    bad = ~np.asarray(res.ok)
    if bad.any():
        ax.plot(x[bad], v[bad], linestyle="none", marker="x",
                color="black", markersize=9, label="unconverged probe")
    ax.set_xlabel(xlabel or xl)
    ax.set_ylabel(f"{res.vary}*")
    ax.set_title(title or f"Fold location {res.vary}*")
    if ax.get_legend_handles_labels()[1]:
        ax.legend()
    return fig


def plot_edge(
    res,
    against: Optional[str] = None,
    bcknd: Optional[str] = None,
    title: Optional[str] = None,
    xlabel: Optional[str] = None,
):
    """Basin-boundary curve from an
    :func:`~energybalancemodel_jl_tpu_torch.basins.edge` result: each member's
    boundary-crossing weight ``w*`` along the ``a -> b`` line with its
    final bracket as the error bar, against the second parameter —
    ``against`` names a key of the parameter Collection stored on the
    result (e.g. ``"F"`` for the boundary's motion with forcing) — or
    the member index when omitted. Members with an unconverged probe
    (``~res.ok``) are marked with a black 'x'."""
    import matplotlib.pyplot as plt

    if bcknd is not None:
        backend(bcknd)
    v = np.asarray(res.values, dtype=np.float64)
    K = len(v)
    if against is not None:
        if res.par is None or against not in res.par:
            raise ValueError(
                f"against {against!r} is not a key of the result's stored "
                f"parameters ({sorted(res.par) if res.par is not None else 'none stored'})")
        x = np.broadcast_to(
            np.asarray(res.par[against], dtype=np.float64), (K,))
        xl = against
    else:
        x = np.arange(K, dtype=np.float64)
        xl = "member"
    fig, ax = plt.subplots(figsize=(6.0, 4.5), constrained_layout=True)
    ax.errorbar(x, v, yerr=np.vstack([v - res.wa, res.wb - v]), fmt="o-",
                color="tab:purple", capsize=3, markersize=4,
                label="w* (bracket)")
    bad = ~np.asarray(res.ok)
    if bad.any():
        ax.plot(x[bad], v[bad], linestyle="none", marker="x",
                color="black", markersize=9, label="unconverged probe")
    ax.set_ylim(-0.02, 1.02)
    ax.set_xlabel(xlabel or xl)
    ax.set_ylabel("boundary weight w*  (0 = a,  1 = b)")
    ax.set_title(title or "Basin boundary along the a → b line")
    if ax.get_legend_handles_labels()[1]:
        ax.legend()
    return fig


def plot_basins(
    res,
    x=None,
    bcknd: Optional[str] = None,
    title: Optional[str] = None,
    xlabel: Optional[str] = None,
):
    """Basin map from a :func:`~energybalancemodel_jl_tpu_torch.basins.basins`
    result: each member's equilibrium ice area against ``x`` (any
    per-member coordinate, e.g. the blend weights the initial family was
    built from; member index when omitted), colored by attractor label,
    with dashed lines at the attractor centroids. Unconverged members
    (label ``-1``) are marked with a black 'x' at their final area."""
    import matplotlib.pyplot as plt

    if bcknd is not None:
        backend(bcknd)
    areas = np.asarray(res.areas, dtype=np.float64)
    K = len(areas)
    if x is None:
        x = np.arange(K, dtype=np.float64)
        xl = "member"
    else:
        x = np.broadcast_to(np.asarray(x, dtype=np.float64), (K,))
        xl = "initial condition"
    fig, ax = plt.subplots(figsize=(6.0, 4.5), constrained_layout=True)
    cmap = plt.get_cmap("tab10")
    for lab in range(res.n_basins):
        sel = np.asarray(res.labels) == lab
        ax.plot(x[sel], areas[sel], linestyle="none", marker="o",
                color=cmap(lab % 10), markersize=5,
                label=f"attractor {lab} (area {res.centroids[lab]:.2f})")
        ax.axhline(res.centroids[lab], color=cmap(lab % 10),
                   linestyle="--", linewidth=0.8, alpha=0.6)
    bad = np.asarray(res.labels) < 0
    if bad.any():
        ax.plot(x[bad], areas[bad], linestyle="none", marker="x",
                color="black", markersize=9, label="unconverged")
    ax.set_xlabel(xlabel or xl)
    ax.set_ylabel(f"ice area ({res.season})")
    ax.set_title(title or "Basins of attraction")
    if ax.get_legend_handles_labels()[1]:
        ax.legend()
    return fig


def plot_sensitivity(
    res,
    n: int = 10,
    raw: bool = False,
    bcknd: Optional[str] = None,
    title: Optional[str] = None,
):
    """Tornado chart of a
    :func:`~energybalancemodel_jl_tpu_torch.sensitivity` result: the ``n``
    most influential parameters as signed horizontal bars — elasticities
    ``p * dg/dp`` by default (the :meth:`SensitivityResult.top` ranking),
    raw gradients ``dg/dp`` with ``raw=True`` (use it when offset-scaled
    parameters like the Kelvin melting point ``Tm`` dominate the
    fractional ranking for no physical reason — the documented
    elasticity caveat). Ensemble results draw the bar at the worst
    (largest-magnitude) member with one dot per member on top, so the
    member spread is visible. No reference analog (the reference has no
    sensitivity machinery)."""
    import matplotlib.pyplot as plt

    if bcknd is not None:
        backend(bcknd)
    if not res.grads:
        raise ValueError("the sensitivity result carries no gradients")
    key = ((lambda k: res.grads[k]) if raw else res.elasticity)
    rows = [(k, np.atleast_1d(np.asarray(key(k), dtype=np.float64)))
            for k in res.grads]
    rows.sort(key=lambda r: -float(np.max(np.abs(r[1]))))
    rows = rows[:max(1, int(n))]
    names = [k for k, _ in rows]
    # bar at the member top() ranked by: the largest-|.| one
    bar = np.asarray([v[int(np.argmax(np.abs(v)))] for _, v in rows])
    y = np.arange(len(rows), dtype=np.float64)[::-1]  # strongest on top
    fig, ax = plt.subplots(
        figsize=(6.0, 0.45 * len(rows) + 1.5), constrained_layout=True)
    ax.barh(y, bar, color=["tab:red" if b >= 0 else "tab:blue"
                           for b in bar], alpha=0.75)
    for yi, (_, v) in zip(y, rows):
        if v.size > 1:  # ensemble: per-member spread
            ax.plot(v, np.full(v.size, yi), linestyle="none", marker=".",
                    color="black", markersize=5)
    ax.axvline(0.0, color="black", linewidth=0.8)
    ax.set_yticks(y)
    ax.set_yticklabels(names)
    ax.set_xlabel("dg/dp" if raw else "elasticity  p · dg/dp")
    ax.set_title(title or f"Sensitivity of {res.of}")
    return fig


def plot_lyapunov(
    res,
    bcknd: Optional[str] = None,
    title: Optional[str] = None,
):
    """Convergence plot of a
    :func:`~energybalancemodel_jl_tpu_torch.lyapunov` result: the running
    (cumulative post-transient) exponent estimates against counted years
    — flat curves mean the finite-time exponents have settled, drifting
    ones need more ``years``. One line per mode; ensemble members of the
    same mode share a color with thin lines. The per-year instantaneous
    log growths of the LEADING mode are scattered behind the running
    curves (solo runs only — ensembles would overplot) so transient
    non-normal growth bursts stay visible. No reference analog."""
    import matplotlib.pyplot as plt

    if bcknd is not None:
        backend(bcknd)
    run = res.running()  # (years', m) or (years', K, m)
    if run.shape[0] < 1:
        raise ValueError("no counted years (years <= transient?)")
    yrs = np.arange(1, run.shape[0] + 1, dtype=np.float64) + res.transient
    ensemble = run.ndim == 3
    fig, ax = plt.subplots(figsize=(6.4, 4.0), constrained_layout=True)
    cycle = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    m = run.shape[-1]
    for j in range(m):
        c = cycle[j % len(cycle)]
        if ensemble:
            for i in range(run.shape[1]):
                ax.plot(yrs, run[:, i, j], color=c, linewidth=0.9,
                        alpha=0.7,
                        label=f"mode {j + 1}" if i == 0 else None)
        else:
            ax.plot(yrs, run[:, j], color=c, linewidth=1.6,
                    label=f"mode {j + 1}")
    if not ensemble:
        h = res.history[res.transient:, 0]
        ax.plot(yrs, h, linestyle="none", marker=".", color="gray",
                markersize=4, alpha=0.6, label="yearly (mode 1)")
    ax.axhline(0.0, color="black", linewidth=0.8)
    ax.set_xlabel("year")
    ax.set_ylabel("running Lyapunov exponent  (1/yr)")
    ax.set_title(title or "Finite-time Lyapunov exponents")
    ax.legend(loc="best", fontsize=8)
    return fig


def plot_transitions(
    res,
    bcknd: Optional[str] = None,
    title: Optional[str] = None,
):
    """Trajectory fan of a
    :func:`~energybalancemodel_jl_tpu_torch.stochastic.transitions` result:
    every member's per-year seasonal ice area against the two attractor
    reference lines. Members that escaped are drawn in color with a
    marker at their first-passage year; members that stayed are gray.
    A ``subyear=True`` result additionally marks each escaped member's
    SUB-ANNUAL instantaneous midpoint crossing (x) at its fractional
    year — typically years ahead of the year-mean marker.
    No reference analog (the reference is deterministic)."""
    import matplotlib.pyplot as plt

    if bcknd is not None:
        backend(bcknd)
    areas = np.asarray(res.areas)  # (years, K)
    yrs = np.arange(1, areas.shape[0] + 1)
    fig, ax = plt.subplots(figsize=(6.4, 4.0), constrained_layout=True)
    esc = res.escaped & res.finite
    fps_sub = None
    if getattr(res, "crossing_step", None) is not None:
        fps_sub = res.first_passage_subyear()
    for k in range(areas.shape[1]):
        if esc[k]:
            (line,) = ax.plot(yrs, areas[:, k], linewidth=1.1, alpha=0.9)
            y = int(res.first_passage[k])
            ax.plot([y], [areas[y - 1, k]], marker="o", markersize=5,
                    color=line.get_color())
            if fps_sub is not None and np.isfinite(fps_sub[k]) \
                    and fps_sub[k] != res.first_passage[k]:
                yi = min(max(int(fps_sub[k]), 0), areas.shape[0] - 1)
                ax.plot([fps_sub[k]], [areas[yi, k]], marker="x",
                        markersize=6, color=line.get_color())
        else:
            ax.plot(yrs, areas[:, k], color="0.65", linewidth=0.8,
                    alpha=0.6)
    for ref, name, style in ((res.area_a, "attractor a", "--"),
                             (res.area_b, "attractor b", ":")):
        ref = np.asarray(ref, dtype=np.float64)
        if getattr(res, "ramped", False):
            # evolving sigma-zero companion references: one line per year
            ax.plot(yrs, ref, color="black", linewidth=1.0,
                    linestyle=style, label=name)
        else:
            ax.axhline(float(np.mean(ref)), color="black", linewidth=1.0,
                       linestyle=style, label=name)
    n_esc = int(np.count_nonzero(esc))
    ax.set_xlabel("year")
    ax.set_ylabel(f"ice area ({res.season})")
    if np.ndim(res.sigma) > 0:
        s = np.asarray(res.sigma, dtype=np.float64)
        sig = f"sigma in [{s.min():g}, {s.max():g}]"
    else:
        sig = f"sigma={float(res.sigma):g}"
    kind = "Rate-induced tipping" if getattr(res, "ramped", False) \
        else "Noise-induced transitions"
    ax.set_title(title or (
        f"{kind}: {n_esc}/{areas.shape[1]} escaped "
        f"({sig}, tau={res.tau:g})"))
    ax.legend(loc="best", fontsize=8)
    return fig


def unsafesave(fig, path: str, spwarn: bool = False, **kwargs) -> str:
    """Figure writer (reference EnergyBalanceModel.jl src/plot.jl:227-233)."""
    import warnings

    if not spwarn:
        warnings.warn("`unsafesave` may overwrite existing files. Use `save` instead.")
    fig.savefig(path, **kwargs)
    return path
