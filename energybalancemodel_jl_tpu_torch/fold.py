"""Fold (saddle-node) tracking by lockstep ensemble bisection.

Port of the JAX package's ``fold.py``. A branch exists at ``hi`` (anchored by
one converged :func:`~.equilibrium.equilibrate`) and is gone at ``lo``; each
probe warm-starts from the anchor state and asks "did the solve stay on the
branch, or fall off?". ``steps`` bisection steps shrink the bracket by
``2**-steps``.

Members carry different second parameters (``par["D"] = np.linspace(...)``)
and different brackets, so one lockstep equilibration probes every member's
own midpoint at once: K fold locations cost ``steps`` ensemble solves. On a
CUDA device each solve is ``equilibrate(engine='auto')``, one launch of the
model's whole-year kernel per simulated year.

Caveat (critical slowing down): the relaxation time diverges at a fold, so
``max_years`` bounds how sharply the fold can be resolved: a probe that has
not settled is classified by its final state anyway. ``equilibrate`` keeps
every member stepping until all have converged, so the same member in a
smaller ensemble can stop at another year count and, near its fold, be
classified differently.

``checkpoint=``/``resume=`` record the search after every step and resume
it bit-exactly (:mod:`.checkpoint`, the JAX package's files and keys).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np

from .equilibrium import EquilibriumResult, _needs_path, equilibrate
from .forcing import Forcing
from .spacetime import SpaceTime
from .utils.collection import Collection
from .utils.numerics import hemispheric_mean
from .utils.progress import Progress

__all__ = ["fold", "FoldResult", "seasonal_ice_area"]


def seasonal_ice_area(coll, st: SpaceTime) -> np.ndarray:
    """Ice-covered area ``2 pi <field>`` of one seasonal store — ``phi``
    where the model has it (MIZ), else the ``E < 0`` indicator (Classic) —
    in float64 on the host, batched over leading (member) axes (JAX
    ``fold.py:40-49``)."""
    if "phi" in coll:
        field = np.nan_to_num(np.asarray(coll["phi"], dtype=np.float64))
    else:
        field = (np.asarray(coll["E"]) < 0.0).astype(np.float64)
    return 2.0 * np.pi * np.asarray(hemispheric_mean(field, st.x))


@dataclasses.dataclass
class FoldResult:
    """Result of :func:`fold` (JAX ``FoldResult``).

    ``lo``/``hi`` are the final per-member brackets (the branch survives at
    ``hi``, is lost at ``lo``; ``hi < lo`` when the surviving side is the low
    end); ``values`` their midpoints, the fold estimates. ``history`` stacks
    the brackets after each step, ``(steps, 2, K)`` in (lo, hi) order;
    ``survived`` the per-step probe classifications, ``(steps, K)``. ``ok``
    flags members whose every probe converged. ``anchor`` is the converged
    branch state every probe warm-started from; ``par`` the parameters the
    search ran under (member sweeps included).
    """

    lo: np.ndarray
    hi: np.ndarray
    history: np.ndarray
    survived: np.ndarray
    probe_converged: np.ndarray
    vary: str
    anchor: EquilibriumResult
    spacetime: SpaceTime
    par: Optional[Collection] = None

    @property
    def values(self) -> np.ndarray:
        """Per-member fold estimates (bracket midpoints), shape ``(K,)``."""
        return 0.5 * (self.lo + self.hi)

    @property
    def width(self) -> np.ndarray:
        """Final bracket widths ``|hi - lo|``."""
        return np.abs(self.hi - self.lo)

    @property
    def ok(self) -> np.ndarray:
        """True per member when every probe along its bisection converged."""
        return self.probe_converged.all(axis=0)

    def __repr__(self):
        v = np.array2string(self.values, precision=4)
        return (f"FoldResult({self.vary}* = {v}, width "
                f"{float(self.width.max()):.3g}, "
                f"{int(np.count_nonzero(self.ok))}/{len(self.lo)} members "
                f"fully converged)")


def _as_members(v, K: int, name: str) -> np.ndarray:
    out = np.broadcast_to(np.asarray(v, dtype=np.float64), (K,)).copy()
    if not np.isfinite(out).all():
        raise ValueError(f"{name} must be finite, got {out}")
    return out


def fold(
    model: str,
    st: SpaceTime,
    par: Collection,
    init: Optional[Collection],
    lo,
    hi,
    vary: str = "F",
    forcing: Union[Forcing, float] = 0.0,
    steps: int = 15,
    predicate: Optional[Callable] = None,
    jump_tol: float = np.pi / 2,
    season: str = "avg",
    check_lo: bool = True,
    anchor: Optional[EquilibriumResult] = None,
    tol: float = 1e-2,
    max_years: int = 300,
    progress: bool = False,
    checkpoint: Optional[str] = None,
    resume: bool = False,
    **equilibrate_kwargs,
) -> FoldResult:
    """Locate the fold where a solution branch ends, per ensemble member
    (JAX ``fold``).

    ``vary`` names the bisected parameter: ``"F"`` (a constant forcing offset
    per member) or any ``par`` key. The branch must exist at ``hi`` and be
    gone at ``lo``; pass ``hi < lo`` when the surviving side is the low end.

    One anchor equilibration at ``hi`` (from ``init``) must fully converge;
    its state warm-starts every probe. The default classifier is nearest
    neighbour in ice area against two evolving per-member references: "on
    the branch" starts at the anchor's area, "off the branch" at the ``lo``
    probe's, and each classified probe updates its side's reference, so the
    on-branch reference follows the branch as the bracket tightens.
    ``jump_tol`` is the least ice-area separation the two bracket ends must
    show. ``predicate(probe, anchor) -> (K,) bool`` classifies on any other
    diagnostic instead. ``check_lo`` spends one probe verifying that the
    branch is lost at ``lo``; the default classifier needs it.

    ``anchor=`` reuses a converged branch state (a prior fold's ``.anchor``,
    an :class:`EquilibriumResult` of this package or of the JAX package)
    instead of solving one from ``init``; the default classifier then
    re-probes ``hi`` once to seed its on-branch reference at the current
    bracket.

    ``checkpoint=`` names a file that records the search after the anchor
    stage and after every bisection step (the anchor, the brackets, the
    histories and the classifier's two references: atomic whole-file
    writes of a few KB); ``resume=True`` reloads it and replays the
    remaining steps bit-exactly, without the anchor and ``lo`` solves. The
    key (the JAX package's, :func:`.checkpoint.search_key`) leaves out
    ``steps``, so a resume may extend a refinement; a file of another
    search warns and starts fresh. A custom ``predicate`` cannot be
    fingerprinted: pass the same one when resuming.

    Other keywords (``engine``, ``dtype``, ``device``, ``anderson``, ...) pass
    through to :func:`equilibrate`. Returns a :class:`FoldResult`.
    """
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError("fold needs a constant base forcing")
    par = Collection(par)
    if vary != "F" and vary not in par:
        raise ValueError(f"vary {vary!r} not in par (and not 'F')")
    if vary in par and np.asarray(par[vary]).ndim >= 1:
        raise ValueError(
            f"par[{vary!r}] is member-swept, but the bisection owns the "
            f"{vary!r} axis — sweep the second parameter under a "
            f"different name")
    if steps < 1:
        raise ValueError("steps must be >= 1")

    K = max(int(np.size(lo)), int(np.size(hi)),
            max((v.size for v in map(np.asarray, par.values())
                 if v.ndim == 1), default=1))
    lo = _as_members(lo, K, "lo")
    hi = _as_members(hi, K, "hi")
    if np.any(lo == hi):
        raise ValueError("lo and hi must differ for every member")

    default_classifier = predicate is None
    if default_classifier and not check_lo:
        raise ValueError(
            "the default classifier seeds its off-branch reference from "
            "the lo probe — keep check_lo=True, or pass predicate=")
    if anchor is None and init is None:
        raise ValueError("fold needs init= (or a reused anchor=)")

    def area_of(res):
        a = seasonal_ice_area(getattr(res.seasonal, season), st)
        return np.broadcast_to(np.atleast_1d(a), (K,)).astype(np.float64)

    def solve(values, state):
        p = Collection(par)
        p[vary] = np.asarray(values)
        return equilibrate(model, st, forcing, p, state, tol=tol,
                           max_years=max_years, **equilibrate_kwargs)

    key = None
    if _needs_path(checkpoint, resume):
        from . import checkpoint as ckpt_mod

        # steps deliberately left out: a resume may extend the refinement
        key = ckpt_mod.search_key(
            "fold", model, st, forcing, par, equilibrate_kwargs,
            extras=(f"vary={vary}", f"lo#{ckpt_mod.digest_array(lo)}",
                    f"hi#{ckpt_mod.digest_array(hi)}",
                    f"jt={float(jump_tol)}", f"season={season}",
                    f"cl={'default' if default_classifier else 'custom'}",
                    f"chk={bool(check_lo)}", f"tol={float(tol)}",
                    f"maxy={int(max_years)}"))
    resumed = None
    if resume:
        resumed = ckpt_mod.try_resume_search(checkpoint, key, "FoldCheckpoint",
                                             ckpt_mod.read_fold_checkpoint)
        if resumed is not None and default_classifier and resumed["ref_on"] is None:
            resumed = None  # references missing: unusable for this classifier
    s_done = 0
    if resumed is not None:
        # the file holds everything a probe depends on: skip the anchor
        # solve, the hi re-probe and the lo check
        anchor = resumed["anchor"]
        lo = np.asarray(resumed["lo"], dtype=np.float64)
        hi = np.asarray(resumed["hi"], dtype=np.float64)
        s_done = int(resumed["history"].shape[0])
        if s_done >= steps:  # already refined this far: report the slice
            h = resumed["history"][:steps]
            return FoldResult(lo=h[-1, 0], hi=h[-1, 1], history=h,
                              survived=resumed["survived"][:steps],
                              probe_converged=resumed["conv"][:steps],
                              vary=vary, anchor=anchor, spacetime=st, par=par)

    prog = None
    if progress:
        if resumed is not None:
            total, first = steps - s_done, f"resumed after step {s_done}"
        else:
            total = (int(anchor is None) + int(anchor is not None and default_classifier)
                     + int(bool(check_lo)) + steps)
            first = "anchoring the branch at hi" if anchor is None else "anchor reused"
        prog = Progress(total, title=f"Fold ({vary})", infofeed=lambda msg: msg)
        prog.update(0, feedargs=(first,))
    done = [0]

    def tick(msg):
        if prog is not None:
            done[0] += 1
            prog.update(done[0], feedargs=(msg,))

    ref_on = ref_off = None
    if resumed is not None:
        ref_on, ref_off = resumed["ref_on"], resumed["ref_off"]
    else:
        fresh_anchor = anchor is None
        if fresh_anchor:
            anchor = solve(hi, init)
        else:
            a_shape = np.shape(next(iter(anchor.state.values())))
            if len(a_shape) > 1 and a_shape[0] != K:
                raise ValueError(
                    f"reused anchor carries {a_shape[0]} members, the "
                    f"search has {K}")
        if not np.all(anchor.converged):
            bad = np.flatnonzero(~np.atleast_1d(anchor.converged))
            raise ValueError(
                f"anchor equilibration at hi did not converge for members "
                f"{bad.tolist()} ({anchor!r}) — the branch reference state "
                f"must be trusted; raise max_years or move hi")
        if fresh_anchor:
            tick("anchor converged")

        if default_classifier:
            if fresh_anchor:
                ref_on = area_of(anchor)
            else:
                # a reused anchor may sit far up the branch: seed the on-branch
                # reference from a probe at the current hi, or a stale reference
                # near the fold misclassifies every refinement probe
                ref_on = area_of(solve(hi, anchor.state))
                tick("hi re-probed for the on-branch reference")
        if check_lo:
            probe = solve(lo, anchor.state)
            if default_classifier:
                ref_off = area_of(probe)
                still = np.flatnonzero(np.abs(ref_off - ref_on) < jump_tol)
                msg = (f"ice-area separation between the hi and lo states "
                       f"is below jump_tol={jump_tol:g} for members "
                       "{m} — either the branch still survives at lo, or "
                       "the two attractors are indistinguishable in ice "
                       "area (pass predicate= for a different diagnostic)")
            else:
                still = np.flatnonzero(np.atleast_1d(predicate(probe, anchor)))
                msg = ("the branch still survives at lo for members {m} — "
                       "the fold is not inside [lo, hi]; widen the "
                       "bracket (or the branch has no fold there)")
            if still.size:
                raise ValueError(msg.format(m=still.tolist()))
            tick("lo verified off-branch")

    def classify(probe):
        nonlocal ref_on, ref_off
        if not default_classifier:
            return np.broadcast_to(np.atleast_1d(predicate(probe, anchor)), (K,))
        # nearest neighbour against the evolving branch references: the
        # on-branch diagnostic drifts with the parameter, falling off is an
        # O(1) jump, and the winning side's reference follows the probe
        a = area_of(probe)
        survived = np.abs(a - ref_on) < np.abs(a - ref_off)
        ref_on = np.where(survived, a, ref_on)
        ref_off = np.where(~survived, a, ref_off)
        return survived

    history = np.empty((steps, 2, K))
    survived_hist = np.empty((steps, K), dtype=bool)
    conv_hist = np.empty((steps, K), dtype=bool)
    if s_done:
        history[:s_done] = resumed["history"]
        survived_hist[:s_done] = resumed["survived"]
        conv_hist[:s_done] = resumed["conv"]

    def write(n):
        if key is not None:
            ckpt_mod.write_fold_checkpoint(checkpoint, key, anchor, lo, hi, history[:n],
                                           survived_hist[:n], conv_hist[:n], ref_on, ref_off)

    if resumed is None:
        # record the anchor stage, so an interruption in step 1 does not
        # repeat its solves on resume
        write(0)

    for s in range(s_done, steps):
        mid = 0.5 * (lo + hi)
        probe = solve(mid, anchor.state)
        survived = classify(probe)
        hi = np.where(survived, mid, hi)
        lo = np.where(survived, lo, mid)
        history[s, 0], history[s, 1] = lo, hi
        survived_hist[s] = survived
        conv_hist[s] = np.broadcast_to(np.atleast_1d(probe.converged), (K,))
        write(s + 1)
        tick(f"step {s + 1}/{steps}: max width {float(np.abs(hi - lo).max()):.4g}")

    return FoldResult(lo=lo, hi=hi, history=history, survived=survived_hist,
                      probe_converged=conv_hist, vary=vary, anchor=anchor,
                      spacetime=st, par=par)
