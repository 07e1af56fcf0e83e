"""Grid-sharded single runs (domain decomposition of the grid axis).

Port of the JAX package's ``parallel/spatial.py``. For very high-resolution
grids a single run is sharded over the latitude axis: each shard owns a
contiguous block of cells, the 3-point diffusion stencil exchanges one halo
cell per application (``ppermute``), and the implicit tridiagonal solves
(the Classic ghost layer, the MIZ Newton update) run through the distributed
SPIKE solver (:mod:`..ops.spike`: local solves and one small ``all_gather``
interface system). The physics is the model's own step; only the
neighbour exchange and the solver differ (``StepConfig.spatial_axis``).
Statics are built on the whole grid and split by :func:`_stat_specs`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..convert import to_numpy
from ..forcing import Forcing
from ..integrate import default_dtype, make_year_fn, resolve_dtype
from ..models.base import default_step_config, dtype_name, get_model
from ..solutions import Seasonal, Solutions
from ..spacetime import SpaceTime
from ..utils.collection import Collection
from ..utils.progress import Progress
from .halo import grid_mesh
from .mesh import Mesh, P, pmin, shard_map
from .sharding import check_mesh

__all__ = ["spatial_integrate", "grid_mesh"]


def _stat_specs(spec, st, par, stat: Collection, axis: str,
                k_axis: Optional[str] = None) -> Collection:
    """Partition specs of a statics Collection, found exactly: a leaf's last
    dimension is the grid iff it changes on a grid of ``nx + 1`` cells, and
    (with ``k_axis``) its first is the member axis iff it changes when every
    parameter is a scalar (the JAX package's ``_stat_specs_2d``; a guess from
    shapes misfires when ``K`` or ``nt`` equals ``nx``). Scalars replicate."""
    ref = next(v for v in stat.values() if torch.is_tensor(v))
    wider = spec.statics(dataclasses.replace(st, nx=st.nx + 1), par, ref.dtype, ref.device)
    solo = None
    if k_axis is not None:
        scalar = Collection({k: (v.reshape(-1)[0] if torch.is_tensor(v) and v.ndim else v)
                             for k, v in par.items()})
        solo = spec.statics(st, scalar, ref.dtype, ref.device)

    def one(k):
        shape = tuple(np.shape(stat[k]))
        if not shape:
            return P()
        grid = shape[-1] != np.shape(wider[k])[-1]
        member = solo is not None and shape != tuple(np.shape(solo[k]))
        if len(shape) == 1:
            return P(k_axis if member else (axis if grid else None))
        return P(k_axis if member else None, *([None] * (len(shape) - 2)),
                 axis if grid else None)

    return Collection({k: one(k) for k in stat})


def _make_spatial_year_fn(spec, st, cfg, collect_raw: bool, mesh: Mesh, axis: str,
                          stat_specs: Collection, k_axis: Optional[str] = None,
                          par_specs=None, f_spec=None):
    """The model year on a grid-sharded carry, ``(carry, par, fyear, stat) ->
    (carry, seasonal, converged, raw)``: each shard runs the model's eager
    year (:func:`..integrate.make_year_fn`) on its block with the halo
    exchange and SPIKE solves of ``cfg.spatial_axis``.

    With ``k_axis`` (a 2-D mesh, :mod:`.grid2d`) carry leaves are ``(K,
    nx)`` member batches split ``P(k_axis, axis)``; every data collective
    spans the grid axis only, and the Newton loop condition also reduces over
    the member axis (``cfg.batch_axis``), so every shard runs the unsharded
    batch's trip count. ``converged`` is the ``pmin`` over the mesh (None
    for a model without a Newton solve)."""
    year = make_year_fn(spec.name, st, cfg, collect_raw)
    conv_axes = axis if k_axis is None else (k_axis, axis)

    def local_year(carry, par, fyear, stat):
        carry, seasonal, conv, ys = year(carry, par, fyear, stat)
        return carry, seasonal, (None if conv is None else pmin(conv, conv_axes)), ys

    state_spec = P(axis) if k_axis is None else P(k_axis, axis)
    raw_spec = P(None, axis) if k_axis is None else P(None, k_axis, axis)
    return shard_map(
        local_year, mesh,
        in_specs=(state_spec, P() if par_specs is None else par_specs,
                  # forcing: the shared (nt,) row, or (nt, K, 1) member rows
                  P() if f_spec is None else f_spec, stat_specs),
        out_specs=(state_spec, state_spec, P(), raw_spec if collect_raw else P()),
    )


def check_grid_mesh(mesh, axis_names) -> Mesh:
    """``mesh``, checked to be a :class:`.mesh.Mesh` with the named axes."""
    mesh = check_mesh(mesh)
    missing = [a for a in axis_names if a not in mesh.shape]
    if missing:
        raise ValueError(f"the mesh has no axis {missing}; its axes are {mesh.axis_names}")
    return mesh


def spatial_integrate(
    model: str,
    st: SpaceTime,
    forcing: Forcing,
    par: Collection,
    init: Collection,
    mesh: Optional[Mesh] = None,
    axis: str = "x",
    lastonly: bool = True,
    raw_mode: Optional[str] = None,
    dtype=None,
    verbose: bool = False,
    newton_max_iter: int = 30,
    progress: Optional[bool] = None,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
) -> Solutions:
    """Integrate one run with the grid axis sharded over ``mesh`` (default:
    :func:`.halo.grid_mesh` over the CUDA devices).

    The semantics of :func:`..integrate.integrate`: ``lastonly``/``raw_mode``
    storage, seasonal snapshots, ``verbose`` Newton-non-convergence warnings
    (reference ``src/miz.jl:61-63``), the progress bar and per-year
    checkpoint/resume; parameters are scalars (sweep them with the ensemble
    engines). The run lives on the mesh's first device, each shard's block
    on its own; ``dtype`` defaults to :func:`..integrate.default_dtype`. The
    checkpoint key holds the mesh size: SPIKE's partition changes the
    rounding, so a resume must use the same decomposition.
    """
    spec = get_model(model)
    mesh = check_grid_mesh(mesh if mesh is not None else grid_mesh(axis=axis), (axis,))
    if st.nx % mesh.size != 0:
        raise ValueError(f"nx={st.nx} must divide evenly over {mesh.size} devices")
    dtype = default_dtype() if dtype is None else resolve_dtype(dtype)
    if raw_mode is None:
        raw_mode = "last" if lastonly else "all"
    if raw_mode not in ("last", "all", "none"):
        raise ValueError(f"raw_mode must be 'last'|'all'|'none', got {raw_mode!r}")
    device = mesh.devices.flat[0]
    cfg = default_step_config(dtype_name(dtype), newton_max_iter=newton_max_iter,
                              spatial_axis=axis)

    par_t = Collection({k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
                        for k, v in par.items()})
    stat = spec.statics(st, par_t, dtype, device)
    sspecs = _stat_specs(spec, st, par_t, stat, axis)
    run_seasonal = _make_spatial_year_fn(spec, st, cfg, False, mesh, axis, sspecs)
    run_full = _make_spatial_year_fn(spec, st, cfg, True, mesh, axis, sspecs)

    carry = spec.init_carry(init, st, dtype, device)
    f_tab = forcing.table(st)

    raw_chunks = []
    winter_acc, summer_acc, avg_acc = [], [], []
    start_year = 0
    write = None
    if checkpoint is not None:
        from .. import checkpoint as ckpt_mod

        # the mesh size rides in the prefix: SPIKE's partition changes the
        # rounding, so a resume must use the same decomposition
        key = ckpt_mod.config_key(f"spatial{mesh.size}", spec.name, st, forcing, par,
                                  dtype_name(dtype), "pcr", newton_max_iter)
        carry, start_year, winter_acc, summer_acc, avg_acc = ckpt_mod.resume_state(
            checkpoint, key, resume, raw_mode, st.dur,
            lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device).contiguous(),
            carry)
        write = ckpt_mod.year_writer(
            checkpoint, key, lambda: (carry, (winter_acc, summer_acc, avg_acc)))

    prog = Progress(
        st.dur * st.nt, "Integrating (spatial)", infofeed=lambda t: f"t = {round(t, 2)}",
    ) if (progress is None or progress) else None
    if prog is not None:
        prog.update(start_year * st.nt, feedargs=(float(start_year),))

    for y in range(start_year, st.dur):
        collect = raw_mode == "all" or (raw_mode == "last" and y == st.dur - 1)
        fn = run_full if collect else run_seasonal
        carry, seasonal, conv, ys = fn(carry, par_t, f_tab[y], stat)
        winter_acc.append(seasonal.winter)
        summer_acc.append(seasonal.summer)
        avg_acc.append(seasonal.avg)
        if collect:
            raw_chunks.append(ys)
        # the flag (1.0 = converged) is min-reduced over the year and the mesh
        if verbose and conv is not None and float(conv) < 1.0:
            warnings.warn(f"Solving for T0 failed in year {y + 1}.")
        if write is not None and ((y + 1) % max(checkpoint_every, 1) == 0
                                  or y == st.dur - 1):
            write(y + 1)
        if prog is not None:
            prog.update((y + 1) * st.nt, feedargs=(float(st.T[(y + 1) * st.nt - 1]),))

    varnames = list(spec.solution_vars)
    if raw_chunks:
        raw = Collection({k: to_numpy(torch.cat([c[k] for c in raw_chunks], dim=0))
                          for k in varnames})
    else:
        raw = Collection({k: np.zeros((0, st.nx)) for k in varnames})

    def stack(acc):
        return Collection({k: to_numpy(torch.stack([c[k] for c in acc], dim=0))
                           for k in varnames})

    ts = Solutions.stored_times(st, raw_mode != "all")
    if raw_mode == "none":
        ts = np.zeros((0,))
    return Solutions(
        spacetime=st, ts=ts, forcing=forcing, parameters=Collection(par),
        initconds=Collection({k: np.asarray(v) for k, v in init.items()}),
        lastonly=lastonly, debug=None, raw=raw,
        seasonal=Seasonal(stack(winter_acc), stack(summer_acc), stack(avg_acc)),
    )
