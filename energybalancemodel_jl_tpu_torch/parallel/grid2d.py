"""2-D mesh integration: ensemble members x grid decomposition.

Port of the JAX package's ``parallel/grid2d.py``. One ``(k, x)`` mesh
composes the two ways the framework scales:

- the member axis ``k`` is plain data parallelism: members are independent,
  so no data collective crosses member rows;
- the grid axis ``x`` is domain decomposition: the halo exchange of the
  diffusion stencil and the SPIKE solves inside the Newton iteration, as in
  :func:`.spatial.spatial_integrate`.

This covers ensembles of runs whose grids are each too large for one device.
The physics is the batched engine's step on a leading member axis; the shard
code is the 1-D spatial path's (``_make_spatial_year_fn(k_axis=...)``). The
one reduction across member rows is the Newton loop condition
(``StepConfig.batch_axis``), which keeps the trip count the unsharded
batch's.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..convert import to_numpy
from ..forcing import Forcing
from ..integrate import default_dtype, resolve_dtype
from ..models.base import default_step_config, dtype_name, get_model
from ..solutions import Seasonal
from ..spacetime import SpaceTime
from ..utils.collection import Collection
from ..utils.progress import Progress
from .ensemble import EnsembleSolutions, _check_raw_all_budget
from .mesh import Mesh, P, mesh_devices
from .spatial import _make_spatial_year_fn, _stat_specs, check_grid_mesh

__all__ = ["ensemble_spatial_integrate", "grid2d_mesh"]

# the insolation-table parameters (JAX parallel/ensemble.py:173): not swept
# on the 2-D mesh, as in the JAX package
TABLE_PARAMS = frozenset({"S0", "S1", "S2", "a0", "a2"})


def grid2d_mesh(nk: Optional[int] = None, ndx: Optional[int] = None, k_axis: str = "k",
                axis: str = "x", device=None) -> Mesh:
    """An ``(nk, ndx)`` mesh: member rows x grid columns, over the CUDA
    devices or ``device`` (one device or a sequence), cycled where the mesh
    has more shards than devices (:func:`.mesh.mesh_devices`). The defaults
    split the devices into two member rows where their count is even."""
    devs = mesh_devices(None, device)
    if nk is None and ndx is None:
        nk = 2 if len(devs) % 2 == 0 and len(devs) > 1 else 1
    if nk is None:
        nk = max(len(devs) // ndx, 1)
    if ndx is None:
        ndx = max(len(devs) // nk, 1)
    devs = mesh_devices(nk * ndx, devs)
    return Mesh([devs[i * ndx:(i + 1) * ndx] for i in range(nk)], (k_axis, axis))


def ensemble_spatial_integrate(
    model: str,
    st: SpaceTime,
    forcing: Forcing,
    par: Collection,
    init: Collection,
    mesh: Optional[Mesh] = None,
    k_axis: str = "k",
    axis: str = "x",
    n_members: Optional[int] = None,
    raw_mode: str = "none",
    raw_memory_limit: int = 2 * 2**30,
    dtype=None,
    verbose: bool = False,
    newton_max_iter: int = 30,
    progress: Optional[bool] = None,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
) -> EnsembleSolutions:
    """Integrate a parameter ensemble with members AND the grid sharded over
    a 2-D mesh (default :func:`grid2d_mesh`).

    ``par`` leaves of shape ``(K,)`` sweep across members, the virtual
    forcing offset ``"F"`` included (per-member forcing rows, as in
    ``ensemble_integrate``); the insolation-table parameters cannot be swept
    here, as in the JAX package. ``init`` leaves ``(nx,)`` are shared,
    ``(K, nx)`` per member. ``K`` must divide over the mesh's member rows and
    ``nx`` over its grid columns. ``raw_mode``, ``verbose`` Newton warnings,
    progress and per-year checkpoint/resume are those of
    ``ensemble_integrate``; the checkpoint key holds the mesh shape. The run
    lives on the mesh's first device; ``dtype`` defaults to
    :func:`..integrate.default_dtype`.
    """
    spec = get_model(model)
    mesh = check_grid_mesh(mesh if mesh is not None else grid2d_mesh(k_axis=k_axis, axis=axis),
                           (k_axis, axis))
    nk, ndx = mesh.shape[k_axis], mesh.shape[axis]
    if st.nx % ndx != 0:
        raise ValueError(f"nx={st.nx} must divide evenly over {ndx} grid columns")
    if raw_mode not in ("none", "last", "all"):
        raise ValueError(f"raw_mode must be 'none'|'last'|'all', got {raw_mode!r}")
    dtype = default_dtype() if dtype is None else resolve_dtype(dtype)
    device = mesh.devices.flat[0]

    par = Collection(par)
    K = par.pop("__K__", None) or n_members
    if K is None:
        sizes = {np.shape(v)[0] for v in par.values() if np.ndim(v) > 0}
        sizes |= {np.shape(v)[0] for v in init.values() if np.ndim(v) > 1}
        if len(sizes) != 1:
            raise ValueError("Cannot infer ensemble size; pass n_members")
        K = sizes.pop()
    K = int(K)
    if K % nk != 0:
        raise ValueError(f"K={K} must divide evenly over {nk} member rows")
    swept_tables = [k for k, v in par.items() if k in TABLE_PARAMS and np.ndim(v) > 0]
    if swept_tables:
        raise ValueError(
            f"cannot sweep insolation-table parameters {swept_tables} on the 2-D mesh "
            "(per-member statics tables); use ensemble_integrate")
    if raw_mode == "all":
        _check_raw_all_budget(K, st, len(spec.solution_vars), dtype.itemsize,
                              raw_memory_limit)
    par_user = Collection(par)
    # the virtual "F": no model reads par["F"], so it becomes per-member
    # forcing rows, as in ensemble_integrate
    F_off = par.pop("F", None)
    if F_off is not None and np.ndim(F_off) == 0:
        F_off = np.full((K,), float(F_off))

    cfg = default_step_config(dtype_name(dtype), newton_max_iter=newton_max_iter,
                              spatial_axis=axis, batch_axis=k_axis)
    # swept leaves as (K, 1) columns against (K, nx) state
    par_t = Collection({
        k: (t[:, None] if t.ndim == 1 else t)
        for k, t in ((k, torch.as_tensor(np.asarray(v), dtype=dtype, device=device))
                     for k, v in par.items())})
    stat = spec.statics(st, par_t, dtype, device)
    sspecs = _stat_specs(spec, st, par_t, stat, axis, k_axis)
    pspecs = Collection({k: (P(k_axis, None) if v.ndim else P()) for k, v in par_t.items()})
    f_spec = None if F_off is None else P(None, k_axis, None)
    run_seasonal = _make_spatial_year_fn(spec, st, cfg, False, mesh, axis, sspecs, k_axis,
                                         pspecs, f_spec)
    run_full = _make_spatial_year_fn(spec, st, cfg, True, mesh, axis, sspecs, k_axis,
                                     pspecs, f_spec)

    carry = spec.init_carry(init, st, dtype, device)
    carry = Collection({k: (v if v.ndim > 1 else v.expand((K,) + tuple(v.shape))).contiguous()
                        for k, v in carry.items()})
    f_tab = forcing.table(st)  # (dur, nt)
    if F_off is not None:
        # per-member rows, time leading, a trailing broadcast axis: each
        # step's forcing is a (K, 1) column against (K, nx) state
        f_tab = f_tab[:, :, None, None] + np.asarray(F_off)[None, None, :, None]

    raw_chunks = []
    start_year = 0
    winter_acc, summer_acc, avg_acc = [], [], []
    write = None
    if checkpoint is not None:
        from .. import checkpoint as ckpt_mod

        key = ckpt_mod.config_key(f"grid2d{nk}x{ndx}", spec.name, st, forcing, par_user,
                                  dtype_name(dtype), "pcr", newton_max_iter, (f"K={K}",))
        carry, start_year, winter_acc, summer_acc, avg_acc = ckpt_mod.resume_state(
            checkpoint, key, resume, raw_mode, st.dur,
            lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device).contiguous(),
            carry)
        write = ckpt_mod.year_writer(
            checkpoint, key, lambda: (carry, (winter_acc, summer_acc, avg_acc)))

    prog = Progress(
        st.dur, "Integrating ensemble (2-D mesh)",
        infofeed=lambda yy: f"year {int(yy)}/{st.dur}, {K} members x {ndx} shards",
    ) if (progress is None or progress) else None
    if prog is not None and start_year:
        prog.update(start_year, feedargs=(start_year,))

    for y in range(start_year, st.dur):
        collect = raw_mode == "all" or (raw_mode == "last" and y == st.dur - 1)
        fn = run_full if collect else run_seasonal
        fyear = torch.as_tensor(f_tab[y], dtype=dtype, device=device)
        carry, seasonal, conv, ys = fn(carry, par_t, fyear, stat)
        winter_acc.append(seasonal.winter)
        summer_acc.append(seasonal.summer)
        avg_acc.append(seasonal.avg)
        if collect:
            raw_chunks.append(ys)
        if verbose and conv is not None and float(conv) < 1.0:
            warnings.warn(f"Solving for T0 failed in year {y + 1}.")
        if write is not None and ((y + 1) % max(checkpoint_every, 1) == 0
                                  or y == st.dur - 1):
            write(y + 1)
        if prog is not None:
            prog.update(y + 1, feedargs=(y + 1,))

    varnames = list(spec.solution_vars)
    raw = None
    if raw_chunks:
        # each year's block is (nt, K, nx): concatenate time, members first
        raw = Collection({k: to_numpy(torch.cat([c[k] for c in raw_chunks], dim=0)
                                      .transpose(0, 1)) for k in varnames})

    def stack(acc):
        # per-year (K, nx) leaves, member-leading (K, dur, nx)
        return Collection({k: to_numpy(torch.stack([c[k] for c in acc], dim=1))
                           for k in varnames})

    return EnsembleSolutions(
        spacetime=st, forcing=forcing, parameters=par_user, n_members=K,
        seasonal=Seasonal(stack(winter_acc), stack(summer_acc), stack(avg_acc)), raw=raw,
    )
