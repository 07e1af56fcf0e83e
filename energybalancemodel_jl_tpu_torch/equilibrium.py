"""Steady states of the year map: ``equilibrate``, ``stability``,
``continuation`` and the differentiable fixed point.

Port of the JAX package's ``equilibrium.py``. The convergence loop is a host
loop over simulated years that reads one small residual per year (the JAX
package strings device ``while_loop`` chunks together; each year here is one
launch of the model's whole-year kernel on a CUDA device, so a loop on the
host costs one ``(K,)`` read per year and nothing else). The residual is the
max-norm year-over-year change of the annual-mean ``metric`` fields (NaN
presentation values count as 0): seasonal attractors are fixed points of the
YEAR map, not of the step map.

**Choosing ``tol``** (JAX ``equilibrium.py:34-47``): MIZ relaxes cleanly
(``tol=1e-3`` converges in ~80 years from zero init at the canonical
parameters); Classic carries the reference's discrete ``E == 0`` albedo
hole, whose ice-edge cells wobble at O(0.1) forever, so use ``tol~0.5`` to
detect arrival at its attractor. At equal year counts the loop is the
state ``integrate`` reaches, bitwise: it runs the same year function.

The gradient drivers (:func:`stability`, :func:`make_equilibrium_seasonal_fn`
and through it ``sensitivity`` and ``calibrate``) differentiate the eager
year (:func:`..integrate.make_year_fn`): the MIZ Newton root carries the
implicit-function VJP (``models/miz.py::_NewtonRoot``); the CUDA kernels have
no VJP and refuse inputs that require grad, as the JAX package's Pallas
kernels have none.

``equilibrate`` and ``continuation`` checkpoint and resume through
:mod:`.checkpoint` (the JAX package's files and keys). ``mesh=`` splits an
ensemble's members over a :class:`.parallel.mesh.Mesh`: ``equilibrate`` runs
the whole-year kernel on every shard, ``stability`` its year graph on member
shards; both bitwise the unsharded runs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import warnings
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .convert import to_numpy
from .forcing import Forcing
from .integrate import (FUSED_YEARS, _as_tensor, auto_is_fused, check_fused, default_dtype,
                        make_year_fn, resolve_device, resolve_dtype)
from .models.base import default_step_config, dtype_name, get_model
from .solutions import Seasonal
from .spacetime import SpaceTime
from .utils.collection import Collection
from .utils.progress import Progress

__all__ = ["equilibrate", "EquilibriumResult", "make_equilibrium_seasonal_fn",
           "stability", "StabilityResult", "continuation", "ContinuationResult"]

# Adjoint stall cutoff (JAX equilibrium.py:72-79): the implicit-gradient
# Picard loop ends once NO projected-gradient leaf has produced a finite,
# strictly smaller increment for this many consecutive iterations.
_BWD_STALL_ITERS = 30


def _mesh_and_device(mesh, device):
    """``(mesh, device)``: a given mesh checked to be a
    :class:`.parallel.mesh.Mesh`, and the device its first device when the
    caller names none."""
    if mesh is None:
        return None, device
    from .parallel.sharding import check_mesh

    mesh = check_mesh(mesh)
    return mesh, (mesh.devices.flat[0] if device is None else device)


def _year_map(spec, st, cfg, mesh, K):
    """The eager year of the gradient drivers: on the member shards of
    ``mesh`` when one is given (its lockstep Newton loop then takes the
    whole ensemble's trip count), else on one device."""
    if mesh is None:
        return make_year_fn(spec.name, st, cfg, False)
    from .parallel.sharding import check_members, shard_member_year

    check_members(mesh, K)
    cfg = dataclasses.replace(cfg, batch_axis=mesh.axis_names[0])
    return shard_member_year(make_year_fn(spec.name, st, cfg, False), mesh)


def _needs_path(checkpoint, resume):
    """Whether the driver checkpoints; ``resume=True`` needs a file."""
    if resume and checkpoint is None:
        raise ValueError("resume=True needs checkpoint=<path>")
    return checkpoint is not None


def _constant(forcing, what):
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError(what)
    return forcing


def _year_inputs(par, F_off, K, forcing, st, dtype, device):
    """The eager year's ``(par, frow)``: swept leaves as ``(K, 1)`` columns
    against ``(K, nx)`` state, and with per-member forcing offsets ``F_off``
    the forcing row ``(nt, K, 1)`` (time leading), as the batched engine of
    ``ensemble_integrate`` lays them out."""
    par_t = Collection({k: _as_tensor(v, dtype, device) for k, v in par.items()})
    if K is not None:
        par_t = Collection({k: (v[:, None] if v.ndim == 1 else v) for k, v in par_t.items()})
    frow = forcing.table(st)[0]
    if F_off is not None:
        frow = frow[:, None, None] + np.asarray(F_off)[None, :, None]
    return par_t, _as_tensor(frow, dtype, device)


def _ensemble_carry(spec, init, st, dtype, device, K):
    # numpy leaves are copied: another package's results may be read-only
    init = {k: (v if torch.is_tensor(v) else np.array(v)) for k, v in init.items()}
    carry = spec.init_carry(init, st, dtype, device)
    if K is None:
        return carry
    return Collection({k: (v if v.ndim > 1 else v.expand((int(K),) + tuple(v.shape)))
                       for k, v in carry.items()})


def _member_max(x, axis):
    """Max of ``x`` over every axis but the member ``axis`` (all axes when
    ``axis`` is None: a single run)."""
    if axis is None:
        return torch.amax(x) if x.ndim else x
    dims = [d for d in range(x.ndim) if d != axis % x.ndim]
    return torch.amax(x, dim=dims) if dims else x


def _member_where(mask, new, old, axis):
    """``where(mask, new, old)`` with the per-member ``mask`` broadcast along
    the member ``axis`` of ``new``."""
    if axis is None or mask.ndim == 0:
        return torch.where(mask, new, old)
    shape = [1] * new.ndim
    shape[axis % new.ndim] = -1
    return torch.where(mask.reshape(shape), new, old)


@dataclasses.dataclass
class EquilibriumResult:
    """Result of :func:`equilibrate` (JAX ``EquilibriumResult``).

    ``state`` is the final carry (all prognostic fields and the Newton warm
    start), numpy: pass it as ``init`` to a later ``equilibrate``/``integrate``
    call to warm-start a continuation. ``seasonal`` holds the final year's
    winter/summer/avg stores. ``years`` is the number of simulated years;
    ``member_years`` (ensembles) each member's first converged year (0 = did
    not converge). ``resid`` is the final year-over-year residual (per member
    for ensembles); ``converged`` mirrors it against ``tol``.
    """

    state: Collection
    seasonal: Seasonal
    years: int
    resid: Union[float, np.ndarray]
    converged: Union[bool, np.ndarray]
    member_years: Optional[np.ndarray]
    newton_ok: bool
    tol: float

    def __repr__(self):
        if self.member_years is None:
            conv = "converged" if self.converged else "NOT converged"
            return (f"EquilibriumResult({conv} in {self.years} years, "
                    f"resid {float(self.resid):.3e}, tol {self.tol:g})")
        k = int(np.count_nonzero(self.converged))
        return (f"EquilibriumResult({k}/{len(self.member_years)} members "
                f"converged in {self.years} years, max resid "
                f"{float(np.max(self.resid)):.3e}, tol {self.tol:g})")


def _metric_vec(seasonal: Seasonal, metric: Tuple[str, ...]):
    """The annual means of the metric fields along the grid axis; NaN
    presentation values count 0 on both years."""
    return torch.cat([torch.nan_to_num(seasonal.avg[v]) for v in metric], dim=-1)


class _Anderson:
    """Safeguarded Type-II Anderson acceleration of depth ``m`` around the
    year map (JAX ``_fixed_point_fns``, ``equilibrium.py:192-275``): the last
    ``m`` (residual, value) pairs of the flattened carry, each leaf scaled by
    its per-member magnitude at year 1, per-member regularized normal
    equations; a member whose residual norm grew steps plain Picard and
    restarts its history."""

    def __init__(self, m, carry, carry_n):
        self.m = m
        self.keys = sorted(carry.keys())
        x0 = self.flat(carry)
        g0 = self.flat(carry_n)
        self.scale = torch.cat([
            torch.clamp(torch.amax(torch.abs(carry_n[k]), dim=-1, keepdim=True),
                        min=1e-8).expand(carry_n[k].shape)
            for k in self.keys], dim=-1)
        r0 = (g0 - x0) / self.scale
        zeros = torch.zeros((m,) + tuple(r0.shape), dtype=r0.dtype, device=r0.device)
        self.R = zeros.clone()
        self.R[0] = r0
        self.G = zeros.clone()
        self.G[0] = g0 / self.scale
        self.cnt = torch.ones(r0.shape[:-1], dtype=torch.int64, device=r0.device)
        self.rnorm = torch.amax(torch.abs(r0), dim=-1)
        self.eps2 = torch.finfo(r0.dtype).eps ** 2

    def flat(self, carry):
        return torch.cat([carry[k] for k in self.keys], dim=-1)

    def unflat(self, x, tmpl):
        out, i = {}, 0
        for k in self.keys:
            w = tmpl[k].shape[-1]
            out[k] = x[..., i:i + w]
            i += w
        return Collection(out)

    def step(self, carry, year):
        """One accelerated iteration: ``(next carry, seasonal, conv, the
        unscaled year-map residual norm)``."""
        m = self.m
        x_k = self.flat(carry) / self.scale
        carry_g, seasonal, conv = year(carry)
        g_k = self.flat(carry_g) / self.scale
        r_k = g_k - x_k
        rnorm = torch.amax(torch.abs(r_k), dim=-1)
        grew = rnorm > self.rnorm
        cnt = torch.where(grew, torch.zeros_like(self.cnt), self.cnt)
        valid = torch.arange(m, device=r_k.device) < cnt[..., None]  # (..., m)
        vmask = torch.movedim(valid, -1, 0)[..., None]  # (m, ..., 1)
        dR = torch.where(vmask, r_k - self.R, 0.0)
        dG = torch.where(vmask, g_k - self.G, 0.0)
        M = torch.einsum("i...n,j...n->...ij", dR, dR)
        b = torch.einsum("i...n,...n->...i", dR, r_k)
        trace = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
        eps = torch.clamp(trace / m * 1e-6, min=self.eps2)
        eye = torch.eye(m, dtype=M.dtype, device=M.device)
        gamma = torch.linalg.solve(M + eps[..., None, None] * eye, b[..., None])[..., 0]
        x_aa = g_k - torch.einsum("i...n,...i->...n", dG, gamma)
        x_next = torch.where((cnt > 0)[..., None], x_aa, g_k)
        self.R = torch.cat([r_k[None], self.R[:-1]], dim=0)
        self.G = torch.cat([g_k[None], self.G[:-1]], dim=0)
        self.cnt = torch.clamp(cnt + 1, max=m)
        self.rnorm = rnorm
        runorm = torch.amax(torch.abs(r_k * self.scale), dim=-1)
        return self.unflat(x_next * self.scale, carry), seasonal, conv, runorm

    def evaluated(self, tmpl):
        """The last state the year map produced (``Gbuf`` slot 0), not the
        extrapolation the loop would iterate next."""
        return self.unflat(self.G[0] * self.scale, tmpl)


def _ensemble_size(par, init, n_members, K_hint, message):
    K = int(K_hint) if K_hint is not None else n_members
    if K is None:
        sizes = {np.shape(v)[0] for v in par.values() if np.ndim(v) > 0}
        sizes |= {np.shape(v)[0] for v in init.values() if np.ndim(v) > 1}
        if len(sizes) > 1:
            raise ValueError(message(sizes))
        K = sizes.pop() if sizes else None
    return K


def _virtual_F(par, forcing, K):
    """Pop the virtual ``"F"`` parameter: folded into the forcing on a single
    run, per-member ``(K,)`` offsets on an ensemble."""
    F_off = par.pop("F", None)
    if F_off is not None and K is None:
        forcing = Forcing(float(forcing.base) + float(np.asarray(F_off)))
        F_off = None
    if F_off is not None and np.ndim(F_off) == 0:
        F_off = np.full((int(K),), float(F_off))
    return F_off, forcing


def equilibrate(
    model: str,
    st: SpaceTime,
    forcing: Union[Forcing, float],
    par: Collection,
    init: Collection,
    tol: float = 1e-4,
    max_years: int = 1000,
    metric: Sequence[str] = ("E",),
    n_members: Optional[int] = None,
    dtype=None,
    newton_max_iter: int = 30,
    verbose: bool = False,
    engine: str = "auto",
    years_per_dispatch: Optional[int] = None,
    mesh=None,
    anderson: int = 0,
    check_every: int = 1,
    progress: bool = False,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    device=None,
) -> EquilibriumResult:
    """Iterate the year map to a seasonal fixed point (JAX ``equilibrate``).

    Converged when every metric field's annual mean changes by at most
    ``tol`` (max norm over the grid) from one year to the next, for every
    member. ``forcing`` must be constant (a :class:`Forcing` of one value, or
    a float); sweep forcing levels across MEMBERS with the virtual ``par``
    key ``"F"`` (per-member constant offsets, as in ``ensemble_integrate``).
    ``par`` leaves of shape ``(K,)`` make the run an ensemble; ``init`` may
    be per-member ``(K, nx)`` or shared ``(nx,)``. A previous result's
    ``.state`` (of this package or of the JAX package) is a valid ``init``:
    its extra carry fields are re-derived.

    ``engine``: ``'fused'`` runs each simulated year as ONE launch of the
    model's whole-year kernel (on the CPU its plain version), ``'batched'``
    the eager year of ``integrate``'s scan engine; ``'auto'`` picks
    ``'fused'`` on a CUDA device and ``'batched'`` on the CPU, as
    ``ensemble_integrate`` does, float64 included (the kernels have f64
    builds). The kernel runs each member's Newton loop on its own, so
    ensemble members equal their solo runs bitwise there; the eager year
    iterates Newton in lockstep over the batch, as the JAX batched engine.

    ``anderson=m > 0``: safeguarded Anderson acceleration of depth ``m``
    (:class:`_Anderson`); ``years`` then counts accelerated iterations (one
    simulated year each), and convergence also needs the unscaled year-map
    residual of the full carry at or below ``tol``. AA may land on another
    point of a neutral manifold than Picard (the MIZ frozen cells). Default
    off: Picard is the bitwise-reproducible reference. ``check_every=M``
    evaluates convergence every M simulated years only (the residual is the
    change across an M-year block, ``years`` resolves to block boundaries);
    it does not combine with ``anderson``. ``progress=True`` draws the
    package's progress bar, one tick per year.

    ``years_per_dispatch`` is accepted for the JAX package's interface and
    changes nothing: convergence is tested every year, as there.

    ``checkpoint=`` names a file the convergence loop is written to at most
    every ``checkpoint_every`` simulated years and once at the end;
    ``resume=True`` re-enters the loop from it (the JAX package's files and
    keys: model, grid, forcing, parameters, dtype, engine, metric,
    ``anderson``, ``check_every`` and the Newton cap; ``tol`` and
    ``max_years`` are left out, so a resume may continue a run to a tighter
    tolerance or a longer horizon). A file of another run warns and starts
    from ``init``. Picard resumes bit-exactly: the file holds the loop's
    carry, the last year's seasonal store and the convergence bookkeeping.
    An ``anderson > 0`` resume reseeds the acceleration history with one
    extra simulated year, so it converges to the same tolerance along
    another iterate sequence.

    ``mesh`` (a 1-D :class:`.parallel.mesh.Mesh`; an ensemble with ``K``
    divisible by its size): each shard runs the whole-year kernel on its
    members every simulated year (:func:`.parallel.sharding.shard_map_fused_year_fn`),
    bitwise the unsharded loop; ``'auto'`` is then ``'fused'`` and
    ``engine='batched'`` raises, as in the JAX package.

    ``dtype`` defaults to :func:`..integrate.default_dtype`; ``device`` to
    the CUDA device (``"cpu"`` for the CPU), or with ``mesh=`` to the mesh's
    first device. ``st.dur`` is ignored: the horizon is ``max_years``.
    """
    mesh, device = _mesh_and_device(mesh, device)
    spec = get_model(model)
    forcing = _constant(forcing, "equilibrate needs constant forcing (equilibria do not "
                                 "exist under a ramp); sweep levels across members via par['F']")
    metric = tuple(metric)
    bad = [v for v in metric if v not in spec.solution_vars]
    if bad:
        raise ValueError(f"metric vars {bad} not in {spec.name} solution vars "
                         f"{spec.solution_vars}")
    if int(anderson) < 0:
        raise ValueError("anderson must be >= 0 (0 = plain Picard)")
    anderson = int(anderson)
    if int(checkpoint_every) < 1:
        raise ValueError("checkpoint_every must be >= 1")
    check_every = int(check_every)
    if check_every < 1:
        raise ValueError("check_every must be >= 1")
    if anderson > 0 and check_every != 1:
        raise ValueError("check_every > 1 does not compose with anderson "
                         "(the acceleration algebra is per-year)")
    if years_per_dispatch is not None and int(years_per_dispatch) < 1:
        raise ValueError("years_per_dispatch must be >= 1")
    dtype = default_dtype() if dtype is None else resolve_dtype(dtype)
    device = resolve_device(device)

    par = Collection(par)
    K_hint = par.pop("__K__", None)
    par_for_key = Collection(par)  # before the virtual "F" is popped
    K = _ensemble_size(par, init, n_members, K_hint,
                       lambda sizes: "Cannot infer ensemble size; pass n_members")
    ensemble = K is not None
    F_off, forcing = _virtual_F(par, forcing, K)
    cfg = default_step_config(dtype_name(dtype), newton_max_iter=newton_max_iter)
    checkpointed = _needs_path(checkpoint, resume)

    if mesh is not None:
        # a mesh's year map is the fused kernel on every shard
        if engine == "batched":
            raise ValueError("mesh= requires engine='fused' (the sharded year map is the "
                             "fused kernel per shard)")
        if engine == "auto":
            engine = "fused"
    if engine == "auto":
        engine = "fused" if auto_is_fused(spec.name, device, "pcr") else "batched"
    if engine not in ("batched", "fused"):
        raise ValueError(f"unknown engine {engine!r}; expected 'batched', 'fused', or 'auto'")
    if engine == "fused":
        check_fused(spec.name, st.nx, device, "pcr", alternative="batched")
    if mesh is not None:
        from .parallel.sharding import check_members

        check_members(mesh, K)

    carry = _ensemble_carry(spec, init, st, dtype, device, K)
    if engine == "fused":
        # the kernel's conventions: par leaves scalar or (K,), per-member
        # offsets through the virtual "F" lane, the shared (nt,) forcing row
        par_y = Collection({k: _as_tensor(v, dtype, device) for k, v in par.items()})
        if F_off is not None:
            par_y["F"] = _as_tensor(F_off, dtype, device)
        frow = _as_tensor(forcing.table(st)[0], dtype, device)
        kernel_year = FUSED_YEARS[spec.name][0]
        if not ensemble:  # the kernels are ensemble-shaped
            carry = Collection({k: v[None] for k, v in carry.items()})
        if mesh is not None:
            from .parallel.sharding import shard_map_fused_year_fn

            sharded = shard_map_fused_year_fn(st, mesh, par_y, dtype_name(dtype), cfg,
                                              model=spec.name)

            def year(c):
                return sharded(c, par_y, frow)
        else:
            def year(c):
                c, seasonal, conv, _ = kernel_year(c, par_y, frow, st, cfg)
                return c, seasonal, conv
    else:
        par_y, frow = _year_inputs(par, F_off, K, forcing, st, dtype, device)
        eager_year = make_year_fn(spec.name, st, cfg, False)

        def year(c):
            c, seasonal, conv, _ = eager_year(c, par_y, frow)
            return c, seasonal, conv

    def newton_min(newton, conv):
        if conv is None:
            return newton
        return torch.minimum(newton, torch.amin(conv).to(newton.dtype))

    key = None
    if checkpointed:
        from . import checkpoint as ckpt_mod

        key = ckpt_mod.config_key(
            "equilibrate", spec.name, st, forcing, par_for_key, dtype_name(dtype),
            cfg.solver, newton_max_iter,
            extras=(f"engine={engine}", f"metric={','.join(metric)}",
                    f"aa={anderson}", f"ce={check_every}",
                    *((f"mesh={mesh.size}",) if mesh is not None else ())))
    loaded = None
    if resume:
        if ckpt_mod.checkpoint_matches(checkpoint, key, kind="EqCheckpoint"):
            loaded = ckpt_mod.read_eq_checkpoint(checkpoint)
        elif os.path.exists(checkpoint):
            warnings.warn(f"Checkpoint {checkpoint} does not match this equilibration's "
                          "configuration; starting from init.")

    def on_device(v, dt=dtype):
        return torch.as_tensor(np.asarray(v), dtype=dt, device=device).contiguous()

    prog = None
    with torch.no_grad():
        aa = None
        if loaded is not None and not anderson:
            # bit-exact splice: the loop state is the carry, the last
            # seasonal store and the bookkeeping; no year is re-run
            c_np, seas_np, y, resid_np, my_np, newton_f, _ = loaded
            carry = Collection({k: on_device(v) for k, v in c_np.items()})
            seasonal = Seasonal(*(Collection({k: on_device(v) for k, v in c.items()})
                                  for c in seas_np))
            prev = _metric_vec(seasonal, metric)
            resid = on_device(resid_np)
            myears = on_device(my_np, torch.int64)
            newton = on_device(newton_f)
        else:
            if loaded is not None:
                # the acceleration history is not checkpointed: reseed it
                # with one simulated year from the file's carry, counted
                carry = Collection({k: on_device(v) for k, v in loaded[0].items()})
            carry_n, seasonal, conv = year(carry)
            prev = _metric_vec(seasonal, metric)
            resid = torch.full(prev.shape[:-1], float("inf"), dtype=dtype, device=device)
            newton = newton_min(torch.ones((), dtype=dtype, device=device), conv)
            myears = torch.zeros(prev.shape[:-1], dtype=torch.int64, device=device)
            aa = _Anderson(anderson, carry, carry_n) if anderson else None
            carry, y = carry_n, 1
            if loaded is not None:
                y = int(loaded[2]) + 1
                myears = on_device(loaded[4], torch.int64)
                newton = torch.minimum(newton, on_device(loaded[5]))
        last_write = y

        def write(years_done):
            c, s, rs, my, nw = ckpt_mod.fetch_host((carry, seasonal, resid, myears, newton))
            ckpt_mod.write_eq_checkpoint(checkpoint, c, s, years_done, rs, my,
                                         float(np.min(np.atleast_1d(nw))), key)

        if progress and int(max_years) > 0:
            prog = Progress(int(max_years), title="Equilibrating",
                            infofeed=lambda r: f"max resid {r:.3e} (tol {tol:g})")
            prog.update(min(y, int(max_years)),
                        feedargs=(float(torch.nan_to_num(resid).max()),))
        while y < int(max_years) and bool(torch.any(resid > tol)):
            if aa is not None:
                carry, seasonal, conv, runorm = aa.step(carry, year)
            else:
                for _ in range(check_every):
                    carry, seasonal, conv = year(carry)
                    newton = newton_min(newton, conv)
                conv = None
            cur = _metric_vec(seasonal, metric)
            resid = torch.amax(torch.abs(cur - prev), dim=-1)
            if aa is not None:
                resid = torch.maximum(resid, runorm)
            y += check_every
            myears = torch.where((resid <= tol) & (myears == 0), y, myears)
            newton = newton_min(newton, conv)
            prev = cur
            if checkpointed and y - last_write >= int(checkpoint_every):
                write(y)
                last_write = y
            if prog is not None:
                prog.update(min(y, int(max_years)),
                            feedargs=(float(torch.nan_to_num(resid).max()),))
        if checkpointed and y > last_write:
            write(y)  # the final state: a resume of a finished run returns it
        if prog is not None:
            prog.total = max(int(y), 1)
            prog.update(prog.total, feedargs=(float(torch.nan_to_num(resid).max()),))
        if aa is not None:
            carry = aa.evaluated(carry)
    if engine == "fused" and not ensemble:
        carry = Collection({k: v[0] for k, v in carry.items()})
        seasonal = Seasonal(*(Collection({k: v[0] for k, v in c.items()}) for c in seasonal))
        resid, myears = resid[0], myears[0]
    newton_ok = bool(newton >= 1.0)
    if verbose and not newton_ok:
        warnings.warn("Solving for T0 failed during equilibration.")
    state = to_numpy(Collection(carry))
    seasonal = to_numpy(seasonal)
    resid = to_numpy(resid)
    if ensemble:
        return EquilibriumResult(
            state=state, seasonal=seasonal, years=int(y), resid=resid,
            converged=resid <= tol, member_years=to_numpy(myears), newton_ok=newton_ok,
            tol=float(tol))
    return EquilibriumResult(
        state=state, seasonal=seasonal, years=int(y), resid=float(resid),
        converged=bool(resid <= tol), member_years=None, newton_ok=newton_ok,
        tol=float(tol))


class _FixedPoint(torch.autograd.Function):
    """The year-map fixed point ``c* = Y(c*, par, frow)`` with its
    implicit-function VJP (JAX ``make_equilibrium_seasonal_fn``,
    ``equilibrium.py:474-559``). Inputs: the spec (a :class:`_FixedPointSpec`)
    and the flat tensors ``carry0 leaves, par leaves, frow``; outputs the
    leaves of ``c*``."""

    @staticmethod
    def forward(ctx, spec, *flat):
        n_c = len(spec.ckeys)
        n_p = len(spec.pkeys)
        carry0 = Collection(zip(spec.ckeys, flat[:n_c]))
        par = Collection(zip(spec.pkeys, flat[n_c:n_c + n_p]))
        frow = flat[-1]
        with torch.no_grad():
            c_star = spec.solve(carry0, par, frow)
        ctx.spec = spec
        ctx.save_for_backward(*(c_star[k] for k in spec.ckeys), *flat[n_c:])
        return tuple(c_star[k] for k in spec.ckeys)

    @staticmethod
    def backward(ctx, *cbar):
        spec = ctx.spec
        saved = ctx.saved_tensors
        n_c = len(spec.ckeys)
        c_star = saved[:n_c]
        par = saved[n_c:-1]
        frow = saved[-1]
        pbar, fbar = spec.adjoint(c_star, par, frow, cbar)
        grads = [None] * n_c + list(pbar) + [fbar]
        return (None, *(g if need else None
                        for g, need in zip(grads, ctx.needs_input_grad[1:])))


@dataclasses.dataclass(eq=False)
class _FixedPointSpec:
    """What :class:`_FixedPoint` needs besides tensors: the year, the keys,
    the member axis (None: a single run) and the loop controls."""

    step: object
    ckeys: tuple
    pkeys: tuple
    batched: bool
    tol: float
    max_years: int
    bwd_tol: float
    bwd_max_iters: int

    def delta(self, a, b):
        """Per-member max-norm distance between two carries."""
        ax = 0 if self.batched else None
        return torch.stack([_member_max(torch.abs(a[k] - b[k]), ax) for k in self.ckeys]).amax(0)

    def solve(self, carry0, par, frow):
        """Picard to ``tol`` or ``max_years``, each member on its own: a
        member stops where its solo run stops (JAX vmaps the loop)."""
        ax = 0 if self.batched else None
        c_prev, c = carry0, self.step(carry0, par, frow)
        y = torch.ones(() if not self.batched else (c[self.ckeys[0]].shape[0],),
                       dtype=torch.int64, device=frow.device)
        while True:
            active = (y < self.max_years) & (self.delta(c_prev, c) > self.tol)
            if not bool(active.any()):
                return c
            c_new = self.step(c, par, frow)
            c_prev = Collection({k: _member_where(active, c[k], c_prev[k], ax) for k in self.ckeys})
            c = Collection({k: _member_where(active, c_new[k], c[k], ax) for k in self.ckeys})
            y = y + active.to(y.dtype)

    def adjoint(self, c_star, par, frow, cbar):
        """Picard on ``lam <- cbar + J^T lam`` with one VJP of the year at
        ``c*`` per iteration, on one graph of that year built once. Each
        projected-gradient leaf keeps its value at its smallest finite
        increment; a member stops when every parameter leaf met ``bwd_tol``,
        after ``_BWD_STALL_ITERS`` iterations without a smaller increment in
        any leaf, or at ``bwd_max_iters`` (JAX ``equilibrium.py:492-557``,
        per member as its ``vmap``). A leaf that never had a finite increment
        returns 0, as in JAX, with a ``RuntimeWarning``."""
        batched = self.batched
        cax = 0 if batched else None
        pax = 0 if batched else None
        fax = 1 if batched else None
        with torch.enable_grad():
            c_in = [v.detach().clone().requires_grad_(True) for v in c_star]
            p_in = [v.detach().clone().requires_grad_(True) for v in par]
            f_in = frow.detach().clone().requires_grad_(True)
            out = self.step(Collection(zip(self.ckeys, c_in)),
                            Collection(zip(self.pkeys, p_in)), f_in)
            outs = [out[k] for k in self.ckeys]
        inputs = c_in + p_in + [f_in]
        cbar = [g if g is not None else torch.zeros_like(c) for g, c in zip(cbar, c_star)]
        axes = [pax] * len(p_in) + [fax]
        lam = list(cbar)
        prev = [torch.zeros_like(v) for v in p_in] + [torch.zeros_like(f_in)]
        best = [torch.zeros_like(v) for v in prev]
        members = () if not batched else (c_star[0].shape[0],)
        dev = frow.device
        inf = torch.full(members, float("inf"), dtype=frow.dtype, device=dev)
        min_dp = [inf.clone() for _ in prev]
        since = torch.zeros(members, dtype=torch.int64, device=dev)
        stop = torch.zeros(members, dtype=torch.bool, device=dev)
        it = torch.zeros(members, dtype=torch.int64, device=dev)
        n_p = len(p_in)
        while True:
            run = (it < self.bwd_max_iters) & ~stop
            if not bool(run.any()):
                break
            got = torch.autograd.grad(outs, inputs, grad_outputs=lam, retain_graph=True,
                                      allow_unused=True)
            got = [g if g is not None else torch.zeros_like(x) for g, x in zip(got, inputs)]
            cvec, proj = got[:len(c_in)], got[len(c_in):]
            new_lam = [a + b for a, b in zip(cbar, cvec)]
            dp = [_member_max(torch.abs(n - p), ax) for n, p, ax in zip(proj, prev, axes)]
            improved = [torch.isfinite(d) & (d < m) for d, m in zip(dp, min_dp)]
            new_best = [_member_where(im, n, b, ax)
                        for im, n, b, ax in zip(improved, proj, best, axes)]
            new_min = [torch.where(im, d, m) for im, d, m in zip(improved, dp, min_dp)]
            # the stop rule gates on the parameter leaves only: the forcing
            # row's neutral-mode increments never meet the tolerance
            p_done = torch.stack([
                d <= self.bwd_tol * (1.0 + _member_max(torch.abs(p), ax))
                for d, p, ax in zip(dp[:n_p], proj[:n_p], axes[:n_p])]).all(0) \
                if n_p else torch.ones_like(stop)
            any_improved = torch.stack(improved).any(0)
            new_since = torch.where(any_improved, torch.zeros_like(since), since + 1)
            new_stop = p_done | (new_since >= _BWD_STALL_ITERS)
            lam = [_member_where(run, n, o, cax) for n, o in zip(new_lam, lam)]
            prev = [_member_where(run, n, o, ax) for n, o, ax in zip(proj, prev, axes)]
            best = [_member_where(run, n, o, ax) for n, o, ax in zip(new_best, best, axes)]
            min_dp = [torch.where(run, n, o) for n, o in zip(new_min, min_dp)]
            since = torch.where(run, new_since, since)
            stop = torch.where(run, new_stop, stop)
            it = it + run.to(it.dtype)
        # a leaf whose increments were never finite keeps its zero start, as
        # in the JAX package, which says nothing of it; say it here
        names = self.pkeys + ("the forcing row",)
        never = [k for k, m in zip(names, min_dp) if bool((torch.isinf(m) & (it > 0)).any())]
        if never:
            warnings.warn(
                f"the fixed point's gradient of {', '.join(never)}: no backward iteration "
                "gave a finite increment, the gradient returned is 0 there", RuntimeWarning,
                stacklevel=3)
        return best[:n_p], best[n_p]


def make_equilibrium_seasonal_fn(model_name: str, st: SpaceTime, cfg, dtype_name: str = None,
                                 tol: float = 1e-9, max_years: int = 500,
                                 bwd_tol: float = 1e-9, bwd_max_iters: int = 500):
    """Differentiable map ``(par, frow, carry0) -> final-year Seasonal`` at
    the year-map fixed point (JAX ``make_equilibrium_seasonal_fn``).

    Reverse mode does not unroll the convergence loop; it applies the
    implicit function theorem at ``c* = Y(c*, par)`` by Picard iteration
    ``lam <- cbar + (dY/dc)^T lam``, one VJP of the eager year at ``c*`` per
    iteration (its graph built once per backward), with JAX's per-leaf
    convergence and stall rules (:meth:`_FixedPointSpec.adjoint`); the
    carry's cotangent is zero. One explicit differentiable year from ``c*``
    gives the seasonal diagnostics.

    A single run takes 0-dim ``par`` leaves, an ``(nt,)`` ``frow`` and an
    ``(nx,)`` carry; a batch of K members a ``(K, nx)`` carry, ``par`` leaves
    0-dim (shared) or ``(K, 1)`` and ``frow`` ``(nt,)`` or ``(nt, K, 1)``: the
    members run in lockstep, each stopping its forward and backward loops
    where its solo run stops (JAX gets this by ``vmap``). ``dtype_name`` is
    accepted for the JAX signature; the tensors fix the dtype and device.
    """
    year = make_year_fn(model_name, st, cfg, False)

    def step(carry, par, frow):
        return year(carry, par, frow)[0]

    def seasonal_at_equilibrium(par, frow, carry0):
        carry0 = Collection(carry0)
        ckeys = tuple(carry0.keys())
        batched = next(iter(carry0.values())).ndim > 1
        par = Collection(par)
        if batched:
            K = next(iter(carry0.values())).shape[0]
            # per-member leaves for the per-member stop rules; expand() sums
            # the members' cotangents back onto a shared leaf
            par = Collection({k: (v.reshape(1, 1).expand(K, 1) if v.ndim == 0 else v)
                              for k, v in par.items()})
            if frow.ndim == 1:
                frow = frow[:, None, None].expand(frow.shape[0], K, 1)
        pkeys = tuple(par.keys())
        spec = _FixedPointSpec(step, ckeys, pkeys, batched, float(tol), int(max_years),
                               float(bwd_tol), int(bwd_max_iters))
        c_star = _FixedPoint.apply(spec, *(carry0[k] for k in ckeys),
                                   *(par[k] for k in pkeys), frow)
        c_star = Collection(zip(ckeys, c_star))
        return year(c_star, par, frow)[1]

    return seasonal_at_equilibrium


@dataclasses.dataclass
class StabilityResult:
    """Result of :func:`stability` (JAX ``StabilityResult``).

    ``growth`` is the dominant ``|lambda|`` estimate of the year-map Jacobian
    at the linearization state (the last iteration's); ``history`` holds
    every iteration's, iteration-major (a trailing member axis for
    ensembles, a trailing mode axis under ``n_modes``). ``converged`` marks
    members whose last two estimates agree to ``rtol``; ``mode`` is the final
    unit mode shaped like the carry: the adjoint (left) mode by default, the
    right (physical) one under ``side="right"``. ``eigenvalues`` are the
    signed Rayleigh-Ritz values of the final subspace (real for
    ``n_modes=1``, complex and sorted by modulus for ``n_modes=m``).
    """

    growth: Union[float, np.ndarray]
    history: np.ndarray
    converged: Union[bool, np.ndarray]
    mode: Collection
    rtol: float
    n_modes: int = 1
    eigenvalues: Optional[Union[float, complex, np.ndarray]] = None
    side: str = "adjoint"

    def __repr__(self):
        if np.ndim(self.growth) == 0:
            conv = "converged" if self.converged else "NOT converged"
            kind = ("attracting" if self.growth < 1.0 - self.rtol
                    else "non-attracting" if self.growth > 1.0 + self.rtol
                    else "neutral")
            return (f"StabilityResult(|lambda| ~ {float(self.growth):.6g} "
                    f"({kind}), {len(self.history)} iterations, {conv})")
        g = np.asarray(self.growth)
        k = int(np.count_nonzero(self.converged))
        total = int(np.size(np.asarray(self.converged)))
        if self.n_modes > 1 and g.ndim == 1:
            lams = ", ".join(f"{x:.6g}" for x in g)
            return (f"StabilityResult({self.n_modes} modes, |lambda| ~ "
                    f"[{lams}], {k}/{total} converged)")
        lead = g if g.ndim == 1 else g[..., 0]
        modes = "" if self.n_modes == 1 else f" x {self.n_modes} modes"
        return (f"StabilityResult({lead.shape[0]} members{modes}, "
                f"leading |lambda| in [{float(lead.min()):.6g}, "
                f"{float(lead.max()):.6g}], {k}/{total} converged)")


class _Linearization:
    """The year map's Jacobian at a state, as products: ``adjoint(v) = J^T
    v`` by one VJP of a year graph built once, and ``right(v) = J v`` by a
    second backward through that VJP (linear in its cotangent, so exact; the
    Newton root's VJP keeps its cotangent's derivative for it). Where JAX
    transposes the pullback with ``jax.linear_transpose``
    (``equilibrium.py:1233-1244``)."""

    def __init__(self, year, carry, par, frow, keys, side):
        self.keys = keys
        with torch.enable_grad():
            self.c_in = [carry[k].detach().clone().requires_grad_(True) for k in keys]
            out = year(Collection(zip(keys, self.c_in)), par, frow)[0]
            self.outs = [out[k] for k in keys]
            if side == "right":
                self.u = [torch.zeros_like(o, requires_grad=True) for o in self.outs]
                g = torch.autograd.grad(self.outs, self.c_in, grad_outputs=self.u,
                                        create_graph=True, allow_unused=True)
                # input leaves the year does not read have no product
                self.g = [(x, i) for i, x in enumerate(g) if x is not None and x.requires_grad]
        self.apply = self.right if side == "right" else self.adjoint

    def adjoint(self, v):
        got = torch.autograd.grad(self.outs, self.c_in, grad_outputs=[v[k] for k in self.keys],
                                  retain_graph=True, allow_unused=True)
        return Collection({k: (g if g is not None else torch.zeros_like(c))
                           for k, g, c in zip(self.keys, got, self.c_in)})

    def right(self, v):
        got = torch.autograd.grad([x for x, _ in self.g], self.u,
                                  grad_outputs=[v[self.keys[i]] for _, i in self.g],
                                  retain_graph=True, allow_unused=True)
        return Collection({k: (g if g is not None else torch.zeros_like(u))
                           for k, g, u in zip(self.keys, got, self.u)})


def stability(
    model: str,
    st: SpaceTime,
    forcing: Union[Forcing, float],
    par: Collection,
    init: Collection,
    n_iter: int = 50,
    n_modes: int = 1,
    rtol: float = 1e-3,
    project: Sequence[str] = (),
    seed: int = 0,
    v0: Optional[Collection] = None,
    dtype=None,
    newton_max_iter: int = 30,
    iters_per_dispatch: Optional[int] = None,
    mesh=None,
    side: str = "adjoint",
    device=None,
) -> StabilityResult:
    """Linear stability of the YEAR map at a state (JAX ``stability``):
    the dominant ``|lambda|`` of its Jacobian by power iteration on ``J^T``
    (``side="adjoint"``) or ``J`` (``side="right"``), one VJP of the eager
    year per iteration (the kernels have no VJP).

    ``n_modes=m > 1`` iterates an m-mode block with a per-member QR
    (``torch.linalg.qr``): ``growth`` gains a trailing mode axis, ``mode`` a
    leading one. ``project`` names carry leaves zeroed, each iteration, in
    cells where the base state is fully ice-covered (``phi >= 0.99``, MIZ):
    ``project=("Ew", "phi")`` peels the neutral frozen-cell families. The
    result carries signed Rayleigh-Ritz ``eigenvalues``. ``par`` leaves of
    shape ``(K,)`` make an ensemble (the virtual ``"F"`` as in
    :func:`equilibrate`); ``v0`` warm-starts the iteration (degenerate
    columns fall back to the seeded random draw). ``iters_per_dispatch`` is
    accepted for the JAX interface and changes nothing. float64 is strongly
    recommended (many composed reverse years). ``mesh`` (a 1-D
    :class:`.parallel.mesh.Mesh`; an ensemble with ``K`` divisible by its
    size) builds the year graph on member shards
    (:func:`.parallel.sharding.shard_member_year`), bitwise the unsharded
    run; ``device`` then defaults to the mesh's first device.
    """
    mesh, device = _mesh_and_device(mesh, device)
    spec = get_model(model)
    forcing = _constant(forcing, "stability needs constant forcing (the year map must be "
                                 "autonomous); sweep levels across members via par['F']")
    if int(n_iter) < 2:
        raise ValueError("n_iter must be >= 2")
    dtype = default_dtype() if dtype is None else resolve_dtype(dtype)
    device = resolve_device(device)

    par = Collection(par)
    par.pop("__K__", None)
    K = _ensemble_size(par, init, None, None,
                       lambda sizes: f"inconsistent ensemble sizes {sorted(sizes)}")
    ensemble = K is not None
    F_off, forcing = _virtual_F(par, forcing, K)
    cfg = default_step_config(dtype_name(dtype), newton_max_iter=newton_max_iter)
    carry = _ensemble_carry(spec, init, st, dtype, device, K)
    par_t, frow = _year_inputs(par, F_off, K, forcing, st, dtype, device)
    year = _year_map(spec, st, cfg, mesh, K)

    bad = [n for n in project if n not in carry]
    if bad:
        raise ValueError(f"project names {bad} not in the {spec.name} carry "
                         f"{tuple(carry.keys())}")
    if project and "phi" not in carry:
        raise ValueError("project needs a 'phi' carry field to locate fully "
                         "ice-covered cells (MIZ only)")
    project = frozenset(project)
    frozen = (carry["phi"] >= 0.99) if project else None
    m = int(n_modes)
    if m < 1:
        raise ValueError("n_modes must be >= 1")
    if side not in ("adjoint", "right"):
        raise ValueError(f"side must be 'adjoint' or 'right', got {side!r}")
    keys_order = tuple(sorted(carry.keys()))
    widths = tuple(int(carry[k].shape[-1]) for k in keys_order)
    if m > sum(widths):
        raise ValueError(f"n_modes={m} exceeds the state dimension {sum(widths)}")
    tiny = torch.finfo(dtype).tiny

    def proj(t):
        if not project:
            return t
        return Collection({k: (torch.where(frozen, 0.0, v) if k in project else v)
                           for k, v in t.items()})

    def member_norm(t):
        return torch.sqrt(sum(torch.sum(x * x, dim=-1) for x in t.values()))

    def normalize(t):
        nrm = torch.clamp(member_norm(t), min=tiny)
        return Collection({k: x / nrm[..., None] for k, x in t.items()}), nrm

    def to_mat(t):
        return torch.cat([t[k] for k in keys_order], dim=-1)

    def from_mat(x):
        out, i = {}, 0
        for k, w in zip(keys_order, widths):
            out[k] = x[..., i:i + w]
            i += w
        return Collection(out)

    def ortho(t):
        a = torch.movedim(to_mat(t), 0, -1)  # (n, m) solo, (K, n, m)
        q, r = torch.linalg.qr(a)
        lam = torch.abs(torch.diagonal(r, dim1=-2, dim2=-1))
        return from_mat(torch.movedim(q, -1, 0)), lam

    fit = normalize if m == 1 else ortho

    def prep(v, fallback=None):
        vp = proj(v)
        if fallback is not None:
            nrm = member_norm(vp)
            bad = (~torch.isfinite(nrm)) | (nrm < float(np.sqrt(tiny)))
            fb = proj(fallback)
            vp = Collection({k: torch.where(bad[..., None], fb[k], vp[k]) for k in vp})
        return fit(vp)

    rng = np.random.default_rng(seed)
    rand = Collection({
        k: torch.as_tensor(rng.standard_normal(tuple(v.shape) if m == 1
                                               else (m,) + tuple(v.shape)),
                           dtype=dtype, device=device)
        for k, v in carry.items()})
    if v0 is not None:
        want = {k: (tuple(v.shape) if m == 1 else (m,) + tuple(v.shape))
                for k, v in carry.items()}
        bad = {k for k in want if k not in v0 or tuple(np.shape(v0[k])) != want[k]}
        if bad:
            raise ValueError(
                f"v0 leaves {sorted(bad)} missing or mis-shaped; expected "
                f"{ {k: want[k] for k in sorted(want)} }")
        # numpy leaves are copied: another package's results may be read-only
        v0 = Collection({k: _as_tensor(v0[k] if torch.is_tensor(v0[k]) else np.array(v0[k]),
                                       dtype, device) for k in want})
        v, _ = prep(v0, fallback=rand)
    else:
        v, _ = prep(rand)

    lin = _Linearization(year, carry, par_t, frow, tuple(carry.keys()), side)

    def apply(t):
        if m == 1:
            return lin.apply(t)
        cols = [lin.apply(Collection({k: x[j] for k, x in t.items()})) for j in range(m)]
        return Collection({k: torch.stack([c[k] for c in cols]) for k in t})

    hist = []
    with torch.no_grad():
        for _ in range(int(n_iter)):
            v, lam = fit(proj(apply(v)))
            hist.append(lam)
        xv = to_mat(v)
        xw = to_mat(proj(apply(v)))
        if m == 1:
            H = torch.sum(xv * xw, dim=-1)
        else:
            H = torch.einsum("i...n,j...n->...ij", xv, xw)
    history = to_numpy(torch.stack(hist)).astype(np.float64)
    H = to_numpy(H).astype(np.float64)
    if m == 1:
        eig = H
    else:
        # a non-finite linearization state leaves H non-finite: one bad
        # member gets NaN eigenvalues, not an exception
        blocks = H.reshape((-1, m, m))
        flat = np.full((blocks.shape[0], m), np.nan + 0j, np.complex128)
        ok = np.isfinite(blocks).all(axis=(-2, -1))
        if ok.any():
            good = np.linalg.eigvals(blocks[ok])
            order = np.argsort(-np.abs(good), axis=-1)
            flat[ok] = np.take_along_axis(good, order, axis=-1)
        eig = flat.reshape(H.shape[:-1])
    growth = history[-1]
    with np.errstate(invalid="ignore", divide="ignore"):
        converged = (np.isfinite(growth)
                     & (np.abs(history[-1] - history[-2])
                        <= rtol * np.maximum(np.abs(growth), np.finfo(np.float64).tiny)))
    mode = to_numpy(v)
    if ensemble or m > 1:
        return StabilityResult(growth=np.asarray(growth), history=history,
                               converged=np.asarray(converged), mode=mode, rtol=float(rtol),
                               n_modes=m, eigenvalues=np.asarray(eig), side=side)
    return StabilityResult(growth=float(growth), history=history, converged=bool(converged),
                           mode=mode, rtol=float(rtol), eigenvalues=float(eig), side=side)


def _level_config(vary: str, forcing: Forcing, par: Collection, v: float):
    """(forcing, par) for one continuation level, shared by
    :func:`continuation` and :meth:`ContinuationResult.stability`."""
    if vary == "F":
        return Forcing(float(forcing.base) + float(v)), par
    p = Collection(par)
    p[vary] = float(v)
    return forcing, p


@dataclasses.dataclass
class ContinuationResult:
    """Result of :func:`continuation`: one :class:`EquilibriumResult` per
    level, in trace order (JAX ``ContinuationResult``). ``direction`` is +1
    on the forward leg, -1 on the ``round_trip`` return leg."""

    values: np.ndarray
    direction: np.ndarray
    results: list
    vary: str
    spacetime: SpaceTime
    model: Optional[str] = None
    par: Optional[Collection] = None
    forcing: Optional[Forcing] = None

    @property
    def years(self) -> np.ndarray:
        return np.asarray([r.years for r in self.results])

    @property
    def converged(self) -> np.ndarray:
        return np.asarray([np.all(r.converged) for r in self.results])

    def mean(self, var: str = "E", season: str = "avg") -> np.ndarray:
        """Hemispheric mean of a seasonal field per level, ``(L,)`` or
        ``(L, K)``; presentation NaNs count zero."""
        from .utils.numerics import hemispheric_mean

        rows = [np.asarray(hemispheric_mean(np.nan_to_num(getattr(r.seasonal, season)[var]),
                                            self.spacetime.x))
                for r in self.results]
        return np.asarray(rows) / float(self.spacetime.x[-1] - self.spacetime.x[0])

    def ice_area(self, season: str = "avg") -> np.ndarray:
        """Ice-covered area ``2 pi <phi>`` per level (Classic: ``E < 0``)."""
        from .fold import seasonal_ice_area

        return np.asarray([np.asarray(seasonal_ice_area(getattr(r.seasonal, season),
                                                        self.spacetime))
                           for r in self.results])

    def hysteresis_gap(self, var: Optional[str] = None, season: str = "avg"):
        """``(values, gap)``: the absolute difference between the forward
        and return legs' ice area (or ``var``'s hemispheric mean) at every
        level both legs visited."""
        if not np.any(self.direction < 0):
            raise ValueError("hysteresis_gap needs a round_trip continuation (no "
                             "return leg to compare against)")
        field = self.ice_area(season) if var is None else self.mean(var, season)
        fwd = self.direction > 0
        vals, gaps = [], []
        for i in np.flatnonzero(fwd):
            j = np.flatnonzero(~fwd & (self.values == self.values[i]))
            if j.size:
                vals.append(self.values[i])
                gaps.append(np.abs(field[i] - field[j[0]]))
        return np.asarray(vals), np.asarray(gaps)

    def stability(self, warm_start: bool = True, progress: bool = False,
                  **stability_kwargs):
        """:func:`stability` at every level's equilibrium, each warm-started
        from the previous level's ``mode``; keywords pass through
        (``device=`` included)."""
        if self.model is None or self.par is None or self.forcing is None:
            raise ValueError(
                "this ContinuationResult carries no model/par/forcing — call "
                "stability per level directly")
        prog = None
        if progress:
            prog = Progress(len(self.results), title=f"Stability ({self.vary})",
                            infofeed=lambda v, r: f"{self.vary}={v:g}: {r!r}" if r is not None
                            else "")
            prog.update(0, feedargs=(self.values[0], None))
        out, v0 = [], None
        for i, (v, res) in enumerate(zip(self.values, self.results)):
            fc, p = _level_config(self.vary, self.forcing, self.par, v)
            r = stability(self.model, self.spacetime, fc, p, res.state,
                          v0=v0 if warm_start else None, **stability_kwargs)
            out.append(r)
            v0 = r.mode
            if prog is not None:
                prog.update(i + 1, feedargs=(v, r))
        return out

    def __repr__(self):
        k = int(np.count_nonzero(self.converged))
        legs = "round trip" if np.any(self.direction < 0) else "one-way"
        return (f"ContinuationResult({self.vary}: {len(self.results)} "
                f"levels in [{self.values.min():g} .. {self.values.max():g}] {legs}, "
                f"{k}/{len(self.results)} converged, {int(self.years.sum())} total years)")


def continuation(
    model: str,
    st: SpaceTime,
    values: Sequence[float],
    par: Collection,
    init: Collection,
    vary: str = "F",
    forcing: Union[Forcing, float] = 0.0,
    round_trip: bool = False,
    tol: float = 1e-3,
    max_years: int = 1000,
    progress: bool = False,
    checkpoint: Optional[str] = None,
    resume: bool = False,
    **equilibrate_kwargs,
) -> ContinuationResult:
    """Equilibrate along a parameter path, each level warm-started from the
    previous level's converged state (JAX ``continuation``).

    ``round_trip=True`` appends the reversed path (without repeating the
    turning point), tracing both hysteresis branches. ``vary="F"`` sweeps
    the constant forcing level (offsets of ``forcing``'s base); any other
    ``vary`` names a ``par`` key. Other keywords (``engine``, ``dtype``,
    ``device``, ``metric``, ...) pass through to :func:`equilibrate`.

    ``checkpoint=`` names a file that records every completed level;
    ``resume=True`` reloads them and continues from the first unfinished
    level, warm-started from the last completed state, so the remaining
    levels are the uninterrupted run's. The key (the JAX package's) covers
    the model, grid, forcing, parameters, path, ``tol``, ``max_years`` and
    the pass-through options (``device`` left out, a torch dtype by its
    numpy name: :func:`.checkpoint.key_kwargs`); a file of another run warns
    and restarts.
    """
    forcing = _constant(forcing, "continuation needs a constant base forcing")
    values = list(values)
    if not values:
        raise ValueError("values must be non-empty")
    if vary != "F" and vary not in par:
        raise ValueError(f"vary {vary!r} not in par (and not 'F')")
    path = [(float(v), 1) for v in values]
    if round_trip:
        path += [(float(v), -1) for v in values[-2::-1]]
    par = Collection(par)
    prog = None
    if progress:
        prog = Progress(len(path), title=f"Continuation ({vary})",
                        infofeed=lambda v, res: f"{vary}={v:g}: {res!r}" if res is not None
                        else "")
        prog.update(0, feedargs=(path[0][0], None))

    key = None
    if _needs_path(checkpoint, resume):
        from . import checkpoint as ckpt_mod

        pv = np.asarray([v for v, _ in path], dtype=np.float64)
        pd = np.asarray([d for _, d in path], dtype=np.int8)
        vdig = hashlib.sha1(pv.tobytes() + pd.tobytes()).hexdigest()[:16]
        kwk = ckpt_mod.key_kwargs(equilibrate_kwargs)
        kw = ",".join(f"{k}={kwk[k]!r}" for k in sorted(kwk))
        kdig = hashlib.sha1(kw.encode()).hexdigest()[:16]
        key = ckpt_mod.config_key(
            "continuation", model, st, forcing, par,
            str(kwk.get("dtype", "auto")), "",
            int(kwk.get("newton_max_iter", 30)),
            extras=(f"vary={vary}", f"path#{len(path)}:{vdig}",
                    f"tol={float(tol)}", f"maxy={int(max_years)}",
                    f"kw={kdig}"))

    state, results, start = init, [], 0
    n_in_file = None  # levels this run trusts in the file (None: recreate)
    if resume:
        try:
            matches = ckpt_mod.checkpoint_matches(checkpoint, key, kind="ContCheckpoint")
            loaded = ckpt_mod.read_cont_checkpoint(checkpoint)[0] if matches else None
        except (OSError, ValueError):  # a torn or corrupt file: start fresh
            matches, loaded = False, None
        if matches:
            results = loaded[:len(path)]
            start = n_in_file = len(results)
            if start:
                state = results[-1].state
            if prog is not None and start:
                prog.update(start, feedargs=(path[start - 1][0], results[-1]))
        elif os.path.exists(checkpoint):
            warnings.warn(f"Checkpoint {checkpoint} does not match this continuation's "
                          "configuration; starting from the first level.")

    # a resumed non-finite tail must not re-warn at (and blame) the first
    # resumed level: the divergence happened at an earlier one
    warned = start > 0 and not all(np.isfinite(np.asarray(x)).all() for x in state.values())
    for i, (v, _) in enumerate(path[start:], start=start):
        fc, p = _level_config(vary, forcing, par, v)
        res = equilibrate(model, st, fc, p, state, tol=tol, max_years=max_years,
                          **equilibrate_kwargs)
        results.append(res)
        state = res.state
        if key is not None:
            ckpt_mod.write_cont_checkpoint(checkpoint, results, key, n_prev=n_in_file)
            n_in_file = len(results)
        if not warned and not all(np.isfinite(np.asarray(x)).all() for x in state.values()):
            # once, at the first divergent level: later levels inherit it
            warned = True
            warnings.warn(
                f"continuation level {vary}={v:g} produced a non-finite state; "
                "subsequent levels warm-start from it and will stay non-finite — "
                "shrink the level spacing or restart from a fresh init past this level",
                stacklevel=2)
        if prog is not None:
            prog.update(i + 1, feedargs=(v, res))
    return ContinuationResult(
        values=np.asarray([v for v, _ in path]),
        direction=np.asarray([d for _, d in path], dtype=np.int8),
        results=results, vary=vary, spacetime=st, model=model, par=par, forcing=forcing)
