"""Basin-of-attraction mapping, basin-boundary (edge) tracking, the edge
state and the unstable branch.

Port of the JAX package's ``basins.py``. :func:`basins` equilibrates an
ensemble of K initial states in lockstep and clusters the converged states
into attractors by their seasonal ice area (:func:`.fold.seasonal_ice_area`);
:func:`edge` bisects the basin boundary along the straight line between two
states in different basins, the initial-condition-space companion of
:func:`.fold.fold`. Members may carry different second parameters
(``par["D"]``, a per-member ``par["F"]``), so one lockstep equilibration
probes every member's own blend weight at once; on a CUDA device each is
``equilibrate(engine='auto')``, one launch of the whole-year kernel per
simulated year.

:func:`edge_state` refines one crossing into the saddle on the boundary (edge
tracking by lockstep bisection and flight, then a trust-region Gauss-Newton
polish of ``year(x) == x``), and :func:`unstable_branch` follows that saddle
along a parameter. The polish differentiates the eager year
(:func:`..integrate.make_year_fn`) in the dtype asked for: the kernels have
no VJP, as the JAX package's Pallas kernels have none.

Caveat (critical slowing down): trajectories from initial conditions near
the boundary linger on its saddle before falling to either attractor, so
tight brackets need larger ``max_years``. A probe that has not settled is
classified by its final state anyway and flagged in ``probe_converged``; a
probe whose state goes non-finite keeps its bracket that step, is flagged in
``probe_finite``, and later probes of that member step off-centre.

``edge``'s ``checkpoint=``/``resume=`` record the search after every step and
resume it bit-exactly (:mod:`.checkpoint`, the JAX package's files and keys).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .convert import to_numpy
from .equilibrium import (ContinuationResult, EquilibriumResult, StabilityResult, _level_config,
                          _needs_path, equilibrate, stability)
from .fold import seasonal_ice_area
from .forcing import Forcing
from .integrate import (_as_tensor, _fused_single_year, auto_is_fused, default_dtype,
                        make_year_fn, resolve_device, resolve_dtype)
from .models.base import default_step_config, dtype_name, get_model
from .spacetime import SpaceTime
from .utils.collection import Collection
from .utils.progress import Progress

__all__ = ["basins", "edge", "edge_state", "unstable_branch",
           "blend_states", "stack_states",
           "BasinResult", "EdgeResult", "EdgeStateResult"]


def stack_states(states: Sequence[Collection]) -> Collection:
    """Stack a sequence of (unbatched) state Collections into one
    member-batched Collection with ``(K, ...)`` leaves — the ``inits``
    format :func:`basins` consumes."""
    states = [Collection(s) for s in states]
    if not states:
        raise ValueError("stack_states needs at least one state")
    keys = set(states[0].keys())
    for s in states[1:]:
        if set(s.keys()) != keys:
            raise ValueError(
                f"states carry different variables: {sorted(keys)} vs "
                f"{sorted(s.keys())}")
    return Collection({
        k: np.stack([np.asarray(s[k], dtype=np.float64) for s in states])
        for k in states[0]
    })


def blend_states(a, b, w) -> Collection:
    """Linear interpolation ``(1-w)*a + w*b`` of two state Collections.

    Scalar ``w`` keeps the input shapes. An array ``w`` of shape ``(K,)``
    produces a member-batched Collection: 1-D leaves are treated as
    unbatched per-member fields and lifted to ``(K, nx)``; leaves of
    ``ndim >= 2`` whose leading axis is ``K`` are treated as already
    member-batched (per-member endpoints) and blended along it.
    """
    a, b = Collection(a), Collection(b)
    if set(a.keys()) != set(b.keys()):
        raise ValueError(
            f"endpoint states carry different variables: "
            f"{sorted(a.keys())} vs {sorted(b.keys())}")
    w = np.asarray(w, dtype=np.float64)
    out = Collection()
    for k in a:
        va = np.asarray(a[k], dtype=np.float64)
        vb = np.asarray(b[k], dtype=np.float64)
        va, vb = np.broadcast_arrays(va, vb)
        if w.ndim == 0:
            out[k] = (1.0 - w) * va + w * vb
        elif va.ndim >= 2 and va.shape[0] == w.shape[0]:
            ww = w.reshape((w.shape[0],) + (1,) * (va.ndim - 1))
            out[k] = (1.0 - ww) * va + ww * vb
        else:
            ww = w.reshape(w.shape + (1,) * va.ndim)
            out[k] = (1.0 - ww) * va[None] + ww * vb[None]
    return out


@dataclasses.dataclass
class BasinResult:
    """Result of :func:`basins` (JAX ``BasinResult``).

    ``labels`` assigns each member an attractor index (``-1`` where the
    equilibration did not converge or went non-finite — those members are
    excluded from the clustering); ``centroids`` are the per-attractor mean
    ice areas in ascending order, ``counts`` the member count per attractor.
    ``areas`` is every member's own diagnostic value, ``result`` the
    underlying lockstep :class:`EquilibriumResult`.
    """

    labels: np.ndarray
    areas: np.ndarray
    centroids: np.ndarray
    counts: np.ndarray
    season: str
    gap: float
    result: EquilibriumResult
    spacetime: SpaceTime
    par: Optional[Collection] = None

    @property
    def n_basins(self) -> int:
        """Number of distinct attractors among the converged members."""
        return len(self.centroids)

    @property
    def fractions(self) -> np.ndarray:
        """Converged-member fraction per attractor."""
        tot = int(self.counts.sum())
        return self.counts / max(tot, 1)

    def members(self, label: int) -> np.ndarray:
        """Indices of the members that landed in attractor ``label``."""
        return np.flatnonzero(self.labels == label)

    def __repr__(self):
        c = np.array2string(self.centroids, precision=3)
        bad = int(np.count_nonzero(self.labels < 0))
        extra = f", {bad} unconverged" if bad else ""
        return (f"BasinResult({self.n_basins} attractors, areas {c}, "
                f"counts {self.counts.tolist()}{extra})")


def _cluster_1d(values: np.ndarray, gap: float):
    """Gap-threshold clustering of a 1-D diagnostic: sorted values are
    split wherever consecutive members are more than ``gap`` apart.
    Returns (labels ascending by centroid, centroids, counts)."""
    order = np.argsort(values)
    labels = np.empty(len(values), dtype=np.int64)
    cluster = 0
    for i, idx in enumerate(order):
        if i and values[idx] - values[order[i - 1]] > gap:
            cluster += 1
        labels[idx] = cluster
    n = cluster + 1
    centroids = np.array([values[labels == c].mean() for c in range(n)])
    counts = np.array([int(np.count_nonzero(labels == c))
                       for c in range(n)])
    return labels, centroids, counts


_SEASONS = ("winter", "summer", "avg")


def _finite_members(res, K: int) -> np.ndarray:
    """Per-member all-finite flags of an equilibration's state. The ice-area
    diagnostic maps a diverged (NaN) state to area 0, so a NaN probe must
    never be classified off its area. Batchedness comes from the result
    (``member_years`` is set exactly for ensemble solves), not from a shape
    heuristic."""
    if getattr(res, "member_years", None) is None:
        ok = all(bool(np.isfinite(np.asarray(v)).all())
                 for v in res.state.values())
        return np.full(K, ok)
    ok = np.ones(K, dtype=bool)
    for v in res.state.values():
        arr = np.asarray(v)
        if arr.ndim >= 1 and arr.shape[0] == K:
            ok &= np.isfinite(arr.reshape(K, -1)).all(axis=1)
        else:  # a shared leaf poisons every member
            ok &= bool(np.isfinite(arr).all())
    return ok


def basins(
    model: str,
    st: SpaceTime,
    par: Collection,
    inits,
    forcing: Union[Forcing, float] = 0.0,
    season: str = "avg",
    gap: float = np.pi / 4,
    tol: float = 1e-2,
    max_years: int = 300,
    **equilibrate_kwargs,
) -> BasinResult:
    """Map which attractor each of K initial states falls to (JAX
    ``basins``).

    ``inits`` is a member-batched state Collection (``(K, nx)`` leaves) or a
    sequence of unbatched states (stacked via :func:`stack_states`). All K
    states equilibrate in one lockstep ensemble, then the converged, finite
    members are clustered by seasonal ice area: sorted areas split wherever
    consecutive members are more than ``gap`` apart (default pi/4; the
    Classic warm/snowball separation is O(pi)). Other keywords (``device``
    included) pass to :func:`equilibrate`.
    """
    if season not in _SEASONS:
        raise ValueError(f"season must be one of {_SEASONS}, "
                         f"got {season!r}")
    if isinstance(inits, (list, tuple)):
        inits = stack_states(inits)
    par = Collection(par)
    result = equilibrate(model, st, forcing, par, inits, tol=tol,
                         max_years=max_years, **equilibrate_kwargs)
    areas = np.atleast_1d(np.asarray(
        seasonal_ice_area(getattr(result.seasonal, season), st),
        dtype=np.float64))
    K = areas.shape[0]
    conv = (np.broadcast_to(np.atleast_1d(result.converged), (K,))
            & _finite_members(result, K))

    labels = np.full(K, -1, dtype=np.int64)
    if conv.any():
        sub, centroids, counts = _cluster_1d(areas[conv], float(gap))
        labels[conv] = sub
    else:
        centroids = np.empty(0)
        counts = np.empty(0, dtype=np.int64)
    return BasinResult(labels=labels, areas=areas, centroids=centroids,
                       counts=counts, season=season, gap=float(gap),
                       result=result, spacetime=st, par=par)


@dataclasses.dataclass
class EdgeResult:
    """Result of :func:`edge` (JAX ``EdgeResult``).

    ``wa``/``wb`` are the final per-member bracket weights (the blend falls
    to ``a``'s attractor at ``wa``, to ``b``'s at ``wb``); ``values`` their
    midpoints. ``history`` stacks ``(wa, wb)`` after each step, shape
    ``(steps, 2, K)``. ``probe_finite`` False: the probe went non-finite and
    that step held the bracket; ``probe_converged`` False with
    ``probe_finite`` True: the probe ran out of ``max_years``, was classified
    by ``in_a`` anyway, and the bracket moved. ``ok`` flags members whose
    every probe converged. ``result_a``/``result_b`` are the converged
    endpoint attractors, ``area_a``/``area_b`` their diagnostics.
    """

    wa: np.ndarray
    wb: np.ndarray
    history: np.ndarray
    in_a: np.ndarray
    probe_converged: np.ndarray
    probe_finite: np.ndarray
    area_a: np.ndarray
    area_b: np.ndarray
    a: Collection
    b: Collection
    result_a: EquilibriumResult
    result_b: EquilibriumResult
    spacetime: SpaceTime
    season: str = "avg"
    par: Optional[Collection] = None

    @property
    def values(self) -> np.ndarray:
        """Per-member boundary-crossing estimates (bracket midpoints)."""
        return 0.5 * (self.wa + self.wb)

    @property
    def width(self) -> np.ndarray:
        """Final bracket widths ``|wb - wa|``."""
        return np.abs(self.wb - self.wa)

    @property
    def ok(self) -> np.ndarray:
        """True per member when every probe along its bisection
        converged."""
        return self.probe_converged.all(axis=0)

    def states(self) -> Collection:
        """The blended states at the boundary estimates: initial conditions
        astride the basin boundary, the start of :meth:`refine`."""
        return blend_states(self.a, self.b, self.values)

    def refine(self, model: str, forcing=0.0, member: int = 0,
               **kwargs) -> "EdgeStateResult":
        """Refine member ``member``'s boundary crossing into the edge state
        via :func:`edge_state`: that member's final bracket states, scalar
        parameters (``(K,)`` sweep leaves reduce to the member's value, the
        virtual ``par["F"]`` included) and attractor reference areas are
        sliced out of this result. ``model`` and ``forcing`` must repeat the
        :func:`edge` call's; other keywords (``device`` included) pass to
        :func:`edge_state`."""
        K = len(np.atleast_1d(self.wa))
        m = int(member)
        if not 0 <= m < K:
            raise ValueError(f"member {m} out of range for K={K}")

        def slice_state(s):
            return Collection({
                k: (np.asarray(v)[m] if np.ndim(v) >= 2
                    and np.shape(v)[0] == K else np.asarray(v))
                for k, v in s.items()
            })

        par_m = None
        if self.par is not None:
            par_m = Collection({
                k: (np.asarray(v)[m] if np.ndim(v) == 1
                    and np.shape(v)[0] == K else v)
                for k, v in self.par.items()
            })
        a_m, b_m = slice_state(self.a), slice_state(self.b)
        wa = float(np.atleast_1d(self.wa)[m])
        wb = float(np.atleast_1d(self.wb)[m])
        kwargs.setdefault("season", self.season)
        return edge_state(
            model, self.spacetime, par_m if par_m is not None
            else Collection(), blend_states(a_m, b_m, wa),
            blend_states(a_m, b_m, wb), forcing=forcing,
            refs=(float(np.atleast_1d(self.area_a)[m]),
                  float(np.atleast_1d(self.area_b)[m])), **kwargs)

    def __repr__(self):
        v = np.array2string(self.values, precision=4)
        return (f"EdgeResult(w* = {v}, width {float(self.width.max()):.3g}, "
                f"{int(np.count_nonzero(self.ok))}/{len(self.wa)} members "
                f"fully converged)")


# probe weights as a bracket fraction: 0.5 normally; after a non-finite
# probe the same midpoint would diverge identically forever (deterministic
# solver), so the member's next probes step away from centre
_NUDGE = np.array([0.5, 0.45, 0.55, 0.4, 0.6, 0.35, 0.65, 0.3, 0.7])


def edge(
    model: str,
    st: SpaceTime,
    par: Collection,
    a,
    b,
    forcing: Union[Forcing, float] = 0.0,
    steps: int = 15,
    season: str = "avg",
    jump_tol: float = np.pi / 2,
    tol: float = 1e-2,
    max_years: int = 300,
    progress: bool = False,
    checkpoint: Optional[str] = None,
    resume: bool = False,
    **equilibrate_kwargs,
) -> EdgeResult:
    """Bisect the basin boundary along the line between states ``a`` and
    ``b``, per ensemble member (JAX ``edge``).

    ``a`` and ``b`` must fall to different attractors: both endpoints are
    equilibrated first, must fully converge, and their seasonal ice areas
    must separate by at least ``jump_tol`` for every member. The bisection
    then shrinks ``[wa, wb]`` (blend weights from ``[0, 1]``) by
    ``2**-steps``: each probe equilibrates ``(1-w)*a + w*b`` and is
    classified to whichever endpoint attractor its ice area is nearer (the
    references are static). ``par`` leaves of shape ``(K,)`` (or the virtual
    ``"F"``) sweep a second parameter across members; ``a``/``b`` may be
    shared (1-D leaves) or per member (``(K, nx)``). Other keywords pass to
    :func:`equilibrate`.

    ``checkpoint=`` names a file that records the search after the two
    endpoint solves and after every step (the endpoint attractors, their
    reference areas, the brackets and the histories); ``resume=True``
    replays the remaining steps bit-exactly and never repeats the endpoint
    solves. The key (the JAX package's, :func:`.checkpoint.search_key`)
    leaves out ``steps``, so a resume may extend a refinement; a file of
    another search warns and starts fresh.
    """
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError("edge needs a constant base forcing")
    if steps < 1:
        raise ValueError("steps must be >= 1")
    if season not in _SEASONS:
        raise ValueError(f"season must be one of {_SEASONS}, "
                         f"got {season!r}")
    par = Collection(par)
    a, b = Collection(a), Collection(b)
    if set(a.keys()) != set(b.keys()):
        raise ValueError(
            f"endpoint states carry different variables: "
            f"{sorted(a.keys())} vs {sorted(b.keys())}")

    K = max(
        max((v.size for v in map(np.asarray, par.values())
             if v.ndim == 1), default=1),
        max((np.asarray(v).shape[0] for c in (a, b) for v in c.values()
             if np.asarray(v).ndim >= 2), default=1),
    )

    def solve(init):
        return equilibrate(model, st, forcing, par, init, tol=tol,
                           max_years=max_years, **equilibrate_kwargs)

    def area_of(res):
        v = seasonal_ice_area(getattr(res.seasonal, season), st)
        return np.broadcast_to(np.atleast_1d(v), (K,)).astype(np.float64)

    key = None
    if _needs_path(checkpoint, resume):
        from . import checkpoint as ckpt_mod

        # steps deliberately left out: a resume may extend the refinement
        key = ckpt_mod.search_key(
            "edge", model, st, forcing, par, equilibrate_kwargs,
            extras=(f"a#{ckpt_mod.digest_collection(a)}",
                    f"b#{ckpt_mod.digest_collection(b)}",
                    f"jt={float(jump_tol)}", f"season={season}",
                    f"tol={float(tol)}", f"maxy={int(max_years)}"))
    resumed = None
    if resume:
        resumed = ckpt_mod.try_resume_search(checkpoint, key, "EdgeCheckpoint",
                                             ckpt_mod.read_edge_checkpoint)
    s_done = 0
    if resumed is not None:
        result_a, result_b = resumed["result_a"], resumed["result_b"]
        ref_a, ref_b = resumed["area_a"], resumed["area_b"]
        wa = np.asarray(resumed["wa"], dtype=np.float64)
        wb = np.asarray(resumed["wb"], dtype=np.float64)
        s_done = int(resumed["history"].shape[0])
        if s_done >= steps:  # already refined this far: report the slice
            h = resumed["history"][:steps]
            return EdgeResult(
                wa=h[-1, 0], wb=h[-1, 1], history=h, in_a=resumed["in_a"][:steps],
                probe_converged=resumed["conv"][:steps],
                probe_finite=resumed["finite"][:steps], area_a=ref_a, area_b=ref_b,
                a=a, b=b, result_a=result_a, result_b=result_b, spacetime=st,
                season=season, par=par)

    prog = None
    if progress:
        if resumed is not None:
            total, first = steps - s_done, f"resumed after step {s_done}"
        else:
            total, first = 2 + steps, "equilibrating the a endpoint"
        prog = Progress(total, title="Edge", infofeed=lambda msg: msg)
        prog.update(0, feedargs=(first,))
    done = [0]

    def tick(msg):
        if prog is not None:
            done[0] += 1
            prog.update(done[0], feedargs=(msg,))

    def endpoint(state, name):
        res = solve(state)
        conv = np.broadcast_to(np.atleast_1d(res.converged), (K,))
        if not conv.all():
            bad = np.flatnonzero(~conv)
            raise ValueError(
                f"endpoint {name} did not converge for members "
                f"{bad.tolist()} ({res!r}) — the attractor references "
                f"must be trusted; raise max_years")
        return res

    if resumed is None:
        result_a = endpoint(a, "a")
        tick("a endpoint converged")
        result_b = endpoint(b, "b")
        tick("b endpoint converged")
        ref_a, ref_b = area_of(result_a), area_of(result_b)
        close = np.flatnonzero(np.abs(ref_a - ref_b) < jump_tol)
        if close.size:
            raise ValueError(
                f"states a and b fall to attractors less than "
                f"jump_tol={jump_tol:g} apart in ice area for members "
                f"{close.tolist()} — same basin, or indistinguishable in "
                f"this diagnostic (try another season= or a smaller "
                f"jump_tol)")
        wa = np.zeros(K)
        wb = np.ones(K)

    history = np.empty((steps, 2, K))
    in_a_hist = np.empty((steps, K), dtype=bool)
    conv_hist = np.empty((steps, K), dtype=bool)
    finite_hist = np.empty((steps, K), dtype=bool)
    if s_done:
        history[:s_done] = resumed["history"]
        in_a_hist[:s_done] = resumed["in_a"]
        conv_hist[:s_done] = resumed["conv"]
        finite_hist[:s_done] = resumed["finite"]
    # trailing count of consecutive non-finite probes per member: drives the
    # off-centre nudge; recomputed from the finite history, so a resume
    # replays the remaining steps bit-exactly
    nonfin_streak = np.zeros(K, dtype=np.int64)
    for s in range(s_done):
        nonfin_streak = np.where(finite_hist[s], 0, nonfin_streak + 1)

    def write(n):
        if key is not None:
            ckpt_mod.write_edge_checkpoint(
                checkpoint, key, result_a, result_b, ref_a, ref_b, wa, wb, history[:n],
                in_a_hist[:n], conv_hist[:n], finite_hist[:n])

    if resumed is None:
        # record the endpoint stage, so an interruption in step 1 does not
        # repeat its solves on resume
        write(0)

    for s in range(s_done, steps):
        frac = _NUDGE[np.minimum(nonfin_streak, len(_NUDGE) - 1)]
        mid = wa + frac * (wb - wa)
        probe = solve(blend_states(a, b, mid))
        area = area_of(probe)
        # a diverged probe carries no basin information (its area reads 0
        # through the NaN masking): such members keep their bracket
        finite = _finite_members(probe, K)
        nonfin_streak = np.where(finite, 0, nonfin_streak + 1)
        in_a = np.abs(area - ref_a) <= np.abs(area - ref_b)
        wa = np.where(in_a & finite, mid, wa)
        wb = np.where(~in_a & finite, mid, wb)
        history[s, 0], history[s, 1] = wa, wb
        in_a_hist[s] = in_a
        finite_hist[s] = finite
        conv_hist[s] = (np.broadcast_to(np.atleast_1d(probe.converged), (K,)) & finite)
        write(s + 1)
        tick(f"step {s + 1}/{steps}: max width {float(np.abs(wb - wa).max()):.4g}")

    return EdgeResult(wa=wa, wb=wb, history=history, in_a=in_a_hist,
                      probe_converged=conv_hist, probe_finite=finite_hist,
                      area_a=ref_a, area_b=ref_b, a=a, b=b,
                      result_a=result_a, result_b=result_b, spacetime=st,
                      season=season, par=par)


@dataclasses.dataclass
class EdgeStateResult:
    """Result of :func:`edge_state` (JAX ``EdgeStateResult``): a refined
    edge state, the saddle on the basin boundary.

    ``state`` is the refined year-map fixed-point estimate (a full carry
    Collection, numpy); ``area`` its seasonal ice area; ``resid`` the
    year-map stationarity ``||year(state) - state||_inf`` over the carry;
    ``converged`` is ``resid <= tol`` and ``polish_nfev`` counts the polish's
    residual evaluations (0 when the polish was skipped). Per stage: ``drift``
    (the tracked midpoint's max-abs change from the previous stage, NaN for
    stage 0), ``tracked_years`` and ``separation`` (the flown pair's final
    ice-area separation). ``stability`` is the year-map spectrum at the state
    (``side="right"``) unless disabled.
    """

    state: Collection
    area: float
    resid: float
    drift: np.ndarray
    tracked_years: np.ndarray
    separation: np.ndarray
    converged: bool
    stability: Optional[StabilityResult]
    spacetime: SpaceTime
    season: str = "avg"
    par: Optional[Collection] = None
    polish_nfev: int = 0

    @property
    def stages_run(self) -> int:
        return len(self.drift)

    def __repr__(self):
        g = ""
        if self.stability is not None:
            lead = np.asarray(self.stability.growth).reshape(-1)[0]
            g = f", |lambda| ~ {float(lead):.4g}"
        conv = "converged" if self.converged else "NOT converged"
        return (f"EdgeStateResult(area {float(self.area):.4f}, resid "
                f"{float(self.resid):.3g}, {self.stages_run} stages, "
                f"{conv}{g})")


def _member_state(state: Collection, k: int, K: int) -> Collection:
    """Member ``k`` of an ensemble carry: ``(K, ...)`` leaves sliced, shared
    1-D leaves kept."""
    return Collection({
        key: (np.asarray(v)[k] if np.ndim(v) >= 2
              and np.shape(v)[0] == K else np.asarray(v))
        for key, v in state.items()
    })


# Practical envelope of the dense polish: nt * nx * state_dim, ~2x the
# largest measured-practical configuration of the JAX package (MIZ
# nx=48/nt=1000 = 1.38e7 units; see the guard below)
_POLISH_UNIT_CAP = 3e7


def _solo_year_inputs(model, st, forcing, par, state, dtype, device):
    """``(spec, cfg, carry, par, frow)`` of one solo year from ``state``: the
    virtual ``"F"`` folds into the forcing, leaves become tensors of
    ``dtype`` on ``device``."""
    spec = get_model(model)
    par = Collection(par)
    par.pop("__K__", None)
    F_off = par.pop("F", None)
    if F_off is not None:  # scalar virtual-F leaf folds into the forcing
        forcing = Forcing(float(forcing.base) + float(np.asarray(F_off)))
    cfg = default_step_config(dtype_name(dtype))
    carry = spec.init_carry({k: np.array(v) for k, v in state.items()}, st, dtype, device)
    par_t = Collection({k: _as_tensor(v, dtype, device) for k, v in par.items()})
    frow = _as_tensor(forcing.table(st)[0], dtype, device)
    return spec, cfg, carry, par_t, frow


def _residual_fns(model: str, st: SpaceTime, forcing: Forcing, par: Collection,
                  state: Collection, dtype, device):
    """The polish's flattened year map at ``state``: ``(x0, f, jac, from_mat,
    dim)`` with ``f(x) = year(x) - x`` and its dense Jacobian ``jac(x)``,
    both numpy float64 of the eager year (:func:`..integrate.make_year_fn`)
    in ``dtype`` on ``device``. The carry's leaves are flattened in sorted
    order.

    The residual and the Jacobian come from the same eager year. The
    Jacobian takes one forward graph and one backward: the state is repeated
    as n = dim identical members, and the identity as cotangent gives member
    i the row ``dG_i/dx``. Members never couple in the year map (the MIZ
    Newton root's implicit VJP, ``models/miz.py::_NewtonRoot``, solves each
    member's system on its own), so this is the Jacobian at ``x`` exactly,
    where JAX writes ``jax.jacrev``.
    """
    spec, cfg, carry, par_t, frow = _solo_year_inputs(model, st, forcing, par, state, dtype,
                                                      device)
    keys_order = tuple(sorted(carry.keys()))
    widths = tuple(int(carry[k].shape[-1]) for k in keys_order)
    year = make_year_fn(spec.name, st, cfg, False)

    def from_mat(x):
        out, i = {}, 0
        for k, w in zip(keys_order, widths):
            out[k] = x[..., i:i + w]
            i += w
        return Collection(out)

    def to_mat(c):
        return torch.cat([c[k] for k in keys_order], dim=-1)

    def f(x):
        with torch.no_grad():
            xt = _as_tensor(x, dtype, device)
            return to_numpy(to_mat(year(from_mat(xt), par_t, frow)[0]) - xt).astype(np.float64)

    def jac(x):
        n = x.shape[0]
        xt = _as_tensor(x, dtype, device)
        with torch.enable_grad():
            X = xt.expand(n, n).clone().requires_grad_(True)
            Y = to_mat(year(from_mat(X), par_t, frow)[0])
            eye = torch.eye(n, dtype=dtype, device=device)
            (G,) = torch.autograd.grad(Y, X, grad_outputs=eye)
        return to_numpy(G - eye).astype(np.float64)

    return to_numpy(to_mat(carry)).astype(np.float64), f, jac, from_mat, sum(widths)


def _polish_fixed_point(model: str, st: SpaceTime, forcing: Forcing,
                        par: Collection, state: Collection, dtype,
                        max_nfev: int, device=None):
    """Trust-region Gauss-Newton polish of a year-map fixed point (JAX
    ``_polish_fixed_point``).

    Flattens the carry and minimizes ``||G(x) - x||_2`` with scipy's
    ``least_squares`` (TRF) on the eager year with its exact Jacobian
    (:func:`_residual_fns`). The trust region matters: the Classic step
    albedo makes the year map piecewise smooth, and a plain Newton step
    overshoots its linearization radius.

    ``max_nfev=0`` only evaluates the residual at ``state``. Returns
    ``(state, resid_inf, nfev)`` with numpy leaves. Dense, so guarded by
    ``_POLISH_UNIT_CAP``.
    """
    dtype = default_dtype() if dtype is None else resolve_dtype(dtype)
    device = resolve_device(device)
    x0, f_np, j_np, from_mat, dim = _residual_fns(model, st, forcing, par, state, dtype, device)
    # Scale guard: one dense Jacobian costs a reverse year over nt*nx*dim
    # units (the JAX package measured MIZ nx=48/nt=1000, dim=288, at 7.2 s
    # per Jacobian on its host class). Refuse beyond ~2x that envelope
    # instead of silently hanging.
    if max_nfev >= 1:
        units = st.nt * st.nx * dim
        if units > _POLISH_UNIT_CAP:
            raise ValueError(
                f"dense Gauss-Newton polish at nx={st.nx}/nt={st.nt} "
                f"(state dim {dim}) needs ~{units / 1.9e6:.0f} s "
                f"PER Jacobian evaluation (extrapolated from measured "
                f"nt*nx*dim scaling) and O(max_nfev) of them — beyond "
                f"the practical envelope (nt*nx*dim <= {_POLISH_UNIT_CAP:.0e},"
                f" roughly nx <= 48 at nt=1000 for MIZ). Use a diagnostic "
                f"grid for the saddle hunt, or pass polish=False / "
                f"polish_max_nfev=0 to skip the polish")
    if max_nfev < 1:
        return from_mat(x0), float(np.max(np.abs(f_np(x0)))), 0
    from scipy.optimize import least_squares

    # TRF can meet xtol on a kink flat spot well above the true floor;
    # re-running from the stall point resets the trust radius, which escapes
    # those. Restart while the inf-norm keeps improving.
    x, nfev, resid = x0, 0, np.inf
    while nfev < max_nfev:
        sol = least_squares(f_np, x, jac=j_np, method="trf", xtol=1e-14,
                            ftol=1e-14, gtol=1e-14,
                            max_nfev=int(max_nfev) - nfev)
        nfev += int(sol.nfev)
        new = float(np.max(np.abs(sol.fun)))
        if not new < 0.95 * resid:
            if new < resid:
                x, resid = sol.x, new
            break
        x, resid = sol.x, new
    return from_mat(x), resid, nfev


def edge_state(
    model: str,
    st: SpaceTime,
    par: Collection,
    a,
    b,
    forcing: Union[Forcing, float] = 0.0,
    stages: int = 6,
    probes: int = 14,
    rounds: int = 2,
    flight_years: int = 40,
    flight_chunk: int = 4,
    tol: float = 1.0,
    track_tol: Optional[float] = None,
    polish: bool = True,
    polish_max_nfev: int = 200,
    commit_years: int = 300,
    commit_tol: float = 1e-2,
    season: str = "avg",
    jump_tol: float = np.pi / 2,
    refs=None,
    metric: Optional[Sequence[str]] = None,
    stability_check: bool = True,
    stability_kwargs: Optional[dict] = None,
    progress: bool = False,
    **equilibrate_kwargs,
) -> EdgeStateResult:
    """Converge the edge state — the saddle on the basin boundary between
    the attractors of states ``a`` and ``b`` — by edge tracking (JAX
    ``edge_state``).

    The tracker alternates two moves, each a lockstep ensemble
    equilibration (on a CUDA device one whole-year kernel launch per
    simulated year):

    1. **Multi-probe bisection**: ``probes`` blends between the current
       bracket pair integrate at once (``commit_years``/``commit_tol``);
       each is classified to the nearer attractor reference area, and the
       longest consistent A-prefix / B-suffix tightens the bracket.
    2. **Flight**: the bracket pair integrates forward in ``flight_chunk``
       year hops (up to ``flight_years`` per stage) while its ice-area
       separation stays below a quarter of the attractor gap; if even one
       hop separates it, the stage re-bisects first and retries.

    All ``stages`` run unless ``track_tol`` is set and the midpoint's
    stage-over-stage drift (max-abs over ``metric``'s leaves; default every
    carry leaf) falls below it first. Then every stage's midpoint, last
    first, is polished by a trust-region Gauss-Newton solve of
    ``year(x) == x`` (:func:`_polish_fixed_point`, at most
    ``polish_max_nfev`` residual evaluations each) until one meets ``tol``;
    the best is kept. ``polish=False`` reports the raw final midpoint.
    ``tol`` defaults to 1.0 because the Classic albedo hole leaves an
    O(0.1)-O(1) wobble even on attractors. The saddle's unstable
    eigenvalue and mode come from :func:`stability` with ``side="right"``
    (``stability_kwargs`` pass through; ``stability_check=False`` skips it).

    Solo only: ``par`` must not carry ``(K,)`` leaves and ``a``/``b`` must be
    unbatched (:meth:`EdgeResult.refine` slices one member out).
    ``refs=(area_a, area_b)`` supplies known attractor reference areas.
    Other keywords pass to every ``equilibrate`` call; ``dtype`` and
    ``device`` also select the polish's (float64 strongly recommended) and,
    unless ``stability_kwargs`` name their own, the stability's.
    """
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError("edge_state needs a constant forcing")
    if season not in _SEASONS:
        raise ValueError(f"season must be one of {_SEASONS}, "
                         f"got {season!r}")
    if probes < 1 or rounds < 1 or stages < 1:
        raise ValueError("stages, probes, and rounds must all be >= 1")
    if flight_chunk < 1 or flight_years < flight_chunk:
        raise ValueError("need flight_years >= flight_chunk >= 1")
    par = Collection(par)
    par.pop("__K__", None)
    if any(np.ndim(v) >= 1 for v in par.values()):
        raise ValueError(
            "edge_state refines ONE member — par must be scalar-leaved; "
            "slice a lockstep edge() run per member via EdgeResult.refine")
    a, b = Collection(a), Collection(b)
    for name, s in (("a", a), ("b", b)):
        if any(np.ndim(v) >= 2 for v in s.values()):
            raise ValueError(
                f"endpoint {name} is member-batched — edge_state refines "
                f"ONE member (EdgeResult.refine slices one out)")

    def solve(init, tol_, years_):
        return equilibrate(model, st, forcing, par, init, tol=tol_,
                           max_years=years_, **equilibrate_kwargs)

    def area_of(res, K):
        v = seasonal_ice_area(getattr(res.seasonal, season), st)
        return np.broadcast_to(np.atleast_1d(v), (K,)).astype(np.float64)

    prog = None
    if progress:
        prog = Progress(stages, title="EdgeState", infofeed=lambda msg: msg)
        prog.update(0, feedargs=("attractor references",))

    if refs is not None:
        ref_a, ref_b = (float(refs[0]), float(refs[1]))
    else:
        ends = solve(stack_states([a, b]), commit_tol, commit_years)
        conv = np.broadcast_to(np.atleast_1d(ends.converged), (2,))
        fin = _finite_members(ends, 2)
        if not (conv & fin).all():
            raise ValueError(
                f"endpoint equilibration did not converge finitely "
                f"({ends!r}) — the attractor references must be trusted; "
                f"raise commit_years or pass refs=")
        ref_a, ref_b = area_of(ends, 2)
        a = _member_state(ends.state, 0, 2)
        b = _member_state(ends.state, 1, 2)
    gap = abs(ref_a - ref_b)
    if gap < jump_tol:
        raise ValueError(
            f"attractor references {ref_a:.4g} and {ref_b:.4g} are less "
            f"than jump_tol={jump_tol:g} apart in ice area — same basin, "
            f"or indistinguishable in this diagnostic")
    sep_tol = 0.25 * gap

    def bisect_round(xa, xb):
        """One multi-probe round: returns the tightened (xa, xb)."""
        w = np.linspace(0.0, 1.0, probes + 2)[1:-1]
        res = solve(blend_states(xa, xb, w), commit_tol, commit_years)
        areas = area_of(res, probes)
        finite = _finite_members(res, probes)
        in_a = np.abs(areas - ref_a) <= np.abs(areas - ref_b)
        i = 0                      # longest finite A-prefix
        while i < probes and finite[i] and in_a[i]:
            i += 1
        j = probes - 1             # longest finite B-suffix
        while j >= 0 and finite[j] and not in_a[j]:
            j -= 1
        lo = w[i - 1] if i > 0 else 0.0
        hi = w[j + 1] if j < probes - 1 else 1.0
        if not lo < hi:            # fully inconsistent classifications
            lo, hi = 0.0, 1.0
        return blend_states(xa, xb, lo), blend_states(xa, xb, hi)

    # resolve the drift-metric leaves up front: a typo must fail before the
    # first stage's equilibrations
    if metric is None:
        drift_keys = tuple(sorted(a.keys()))
    else:
        drift_keys = tuple(metric)
        missing = [v for v in drift_keys if v not in a]
        if missing:
            raise ValueError(
                f"metric leaves {missing} not in the tracked carry "
                f"(available: {sorted(a.keys())})")

    drift_h, years_h, sep_h, mids = [], [], [], []
    mid_prev = None
    xa, xb = a, b
    for s in range(stages):
        for _ in range(rounds):
            xa, xb = bisect_round(xa, xb)

        # flight: hop the pair forward while it straddles the boundary
        # tightly; one re-bisection retry if the first hop separates it
        flown_years = 0
        sep = 0.0
        for retry in range(2):
            fa, fb = xa, xb
            while flown_years < flight_years:
                res = solve(stack_states([fa, fb]), 0.0, flight_chunk)
                if not _finite_members(res, 2).all():
                    break          # keep the last finite pair
                na = _member_state(res.state, 0, 2)
                nb = _member_state(res.state, 1, 2)
                sep = float(np.abs(np.subtract(*area_of(res, 2))))
                if sep > sep_tol:
                    break          # committed past the monitor: re-bisect
                fa, fb = na, nb
                flown_years += flight_chunk
            if flown_years or retry:
                break
            xa, xb = bisect_round(xa, xb)   # too wide to fly: tighten
        xa, xb = fa, fb

        mid = blend_states(xa, xb, 0.5)
        if mid_prev is None:
            drift = np.nan
        else:
            drift = max(
                float(np.max(np.abs(np.asarray(mid[v], dtype=np.float64)
                                    - np.asarray(mid_prev[v], dtype=np.float64))))
                for v in drift_keys)
        mid_prev = mid
        mids.append(mid)
        drift_h.append(drift)
        years_h.append(flown_years)
        sep_h.append(sep)
        if prog is not None:
            prog.update(s + 1, feedargs=(
                f"stage {s + 1}: drift {drift:.3g}, +{flown_years} yr tracked",))
        if track_tol is not None and np.isfinite(drift) and drift < track_tol:
            break

    # the refinement proper: the step-albedo kinks pin different local
    # ||year(x)-x|| floors around the saddle, so every stage midpoint is a
    # candidate start: polish last-first until one meets tol, keep the best
    if prog is not None:
        prog.update(len(drift_h), feedargs=("polishing the saddle",))
    dtype, device = equilibrate_kwargs.get("dtype"), equilibrate_kwargs.get("device")
    state, resid, nfev = None, np.inf, 0
    for cand in mids[::-1]:
        s_, r_, n_ = _polish_fixed_point(model, st, forcing, par, cand, dtype,
                                         polish_max_nfev if polish else 0, device)
        nfev += n_
        if r_ < resid:
            state, resid = s_, r_
        if resid <= tol or not polish:
            break
    converged = bool(resid <= tol)

    probe = solve(state, 0.0, 1)
    area = float(area_of(probe, 1)[0])
    if min(abs(area - ref_a), abs(area - ref_b)) < 0.1 * gap:
        warnings.warn(
            f"edge_state's polished state (ice area {area:.4g}) sits on "
            f"an ATTRACTOR (references {ref_a:.4g}/{ref_b:.4g}) — the "
            f"polish slid off the basin boundary; raise stages/probes so "
            f"tracking lands closer to the saddle first")

    stab = None
    if stability_check:
        kw = dict(side="right", device=device)
        kw.update(stability_kwargs or {})
        stab = stability(model, st, forcing, par, state, **kw)

    return EdgeStateResult(
        state=state, area=area, resid=resid,
        drift=np.asarray(drift_h), tracked_years=np.asarray(years_h),
        separation=np.asarray(sep_h), converged=converged,
        polish_nfev=nfev, stability=stab, spacetime=st, season=season,
        par=par)


def _year_seasonal(model: str, st: SpaceTime, forcing: Forcing,
                   par: Collection, state: Collection, dtype, device=None):
    """One year from ``state``: its Seasonal store (numpy), shaped like the
    solo carry. On a CUDA device one launch of the whole-year kernel, the
    path ``integrate`` takes for a year; on the CPU the eager year."""
    dtype = default_dtype() if dtype is None else resolve_dtype(dtype)
    device = resolve_device(device)
    spec, cfg, carry, par_t, frow = _solo_year_inputs(model, st, forcing, par, state, dtype,
                                                      device)
    with torch.no_grad():
        if auto_is_fused(spec.name, device, cfg.solver):
            seasonal = _fused_single_year(spec.name, carry, par_t, frow, st, cfg, False)[1]
        else:
            seasonal = make_year_fn(spec.name, st, cfg, False)(carry, par_t, frow)[1]
    return to_numpy(seasonal)


def unstable_branch(
    model: str,
    st: SpaceTime,
    values,
    par: Collection,
    saddle: Collection,
    vary: str = "F",
    forcing: Union[Forcing, float] = 0.0,
    tol: Optional[float] = None,
    polish_max_nfev: int = 200,
    jump_tol: float = np.pi / 2,
    season: str = "avg",
    dtype=None,
    progress: bool = False,
    device=None,
) -> ContinuationResult:
    """Trace the unstable (saddle) branch of a bifurcation diagram (JAX
    ``unstable_branch``).

    Starting from one converged saddle (``saddle``, e.g. an
    :func:`edge_state` result's ``.state``), each ``values`` level
    re-polishes the year-map fixed point (:func:`_polish_fixed_point`),
    warm-started from the previous level's. A level whose residual exceeds
    ``tol`` (default ``2.5x`` the first level's polished residual) or whose
    ice area jumps more than ``jump_tol`` from the last good level is marked
    not converged. Solo only. Returns a :class:`ContinuationResult` whose
    levels are the saddles; each level's ``years`` records the polish's
    residual-evaluation count. ``device`` defaults to the CUDA device.
    """
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError("unstable_branch needs a constant base forcing")
    par = Collection(par)
    if vary != "F" and vary not in par:
        raise ValueError(f"vary {vary!r} not in par (and not 'F')")
    swept = [k for k, v in par.items() if np.ndim(v) >= 1]
    if swept:
        raise ValueError(
            f"unstable_branch is solo-only (the dense Gauss-Newton "
            f"polish has no lockstep axis); par leaves {swept} are swept")
    values = np.atleast_1d(np.asarray(values, dtype=np.float64))
    if values.ndim != 1 or values.size < 1:
        raise ValueError("values must be a non-empty 1-D sequence")
    bad_state = [k for k, v in Collection(saddle).items() if np.ndim(v) > 1]
    if bad_state:
        raise ValueError(
            f"saddle leaves {bad_state} are member-batched; pass ONE "
            f"state (e.g. edge_state(...).state)")
    if polish_max_nfev < 1:
        raise ValueError("polish_max_nfev must be >= 1")

    prog = None
    if progress:
        prog = Progress(values.size, title=f"Unstable branch ({vary})",
                        infofeed=lambda msg: msg)

    state = Collection(saddle)
    results = []
    thr = tol
    last_good_area = None
    for i, v in enumerate(values):
        forcing_v, par_v = _level_config(vary, forcing, par, float(v))
        state, resid, nfev = _polish_fixed_point(model, st, forcing_v, par_v, state, dtype,
                                                 polish_max_nfev, device)
        seasonal = _year_seasonal(model, st, forcing_v, par_v, state, dtype, device)
        area = float(np.asarray(seasonal_ice_area(getattr(seasonal, season), st)))
        if thr is None:  # calibrate to the model's stationarity floor
            thr = max(2.5 * resid, 1e-8)
        ok = bool(resid <= thr)
        if last_good_area is not None and ok:
            ok = bool(abs(area - last_good_area) < jump_tol)
        if ok:
            last_good_area = area
        results.append(EquilibriumResult(
            state=Collection({k: np.asarray(x) for k, x in state.items()}),
            seasonal=seasonal, years=int(nfev), resid=float(resid),
            converged=ok, member_years=None, newton_ok=True, tol=float(thr)))
        if prog is not None:
            prog.update(i + 1, feedargs=(
                f"{vary}={float(v):g}: resid {resid:.3g}, area "
                f"{area:.3f}" + ("" if ok else " (NOT converged)"),))

    return ContinuationResult(
        values=values, direction=np.ones(values.size, dtype=np.int64),
        results=results, vary=vary, spacetime=st, model=model,
        par=Collection(par), forcing=forcing)
