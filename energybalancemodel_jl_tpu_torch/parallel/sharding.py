"""Ensemble members sharded over a device mesh (data parallelism).

Port of the JAX package's ``parallel/sharding.py``. Members are independent,
so splitting the leading member axis over a 1-D :class:`.mesh.Mesh` is pure
data parallelism: each shard advances its members, with no collective in the
hot loop. Two year maps run on the shards:

- the eager year of the batched engine (:func:`sharded_ensemble_integrate`,
  :func:`shard_map_year_fn`, the latter with a ``psum`` ensemble-mean
  diagnostic);
- the whole-year kernel, one launch per shard per year
  (:func:`shard_map_fused_year_fn`; the ``mesh=`` paths of
  ``ensemble_integrate``, ``equilibrate`` and ``transitions``).

Sharded runs equal unsharded ones bitwise: the kernels run each member's
Newton loop on its own, and the eager year's lockstep Newton loop takes the
unsharded batch's trip count (its condition reduces over the member axis,
``StepConfig.batch_axis``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..integrate import FUSED_YEARS, make_year_fn
from ..models.base import StepConfig, default_step_config
from ..utils.collection import Collection
from . import ensemble as ens
from .mesh import Mesh, P, mesh_devices, pmin, psum, shard_map

__all__ = [
    "ensemble_mesh",
    "sharded_ensemble_integrate",
    "shard_map_year_fn",
    "shard_map_fused_year_fn",
]


def _ndim(v) -> int:
    return v.ndim if torch.is_tensor(v) else np.ndim(v)


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself, or a TypeError: the drivers take a
    :class:`.mesh.Mesh` (a ``jax.sharding.Mesh`` has no counterpart here)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a parallel.mesh.Mesh, got {type(mesh).__name__}")
    return mesh


def ensemble_mesh(n_devices: Optional[int] = None, axis: str = "ensemble",
                  device=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards over the CUDA devices (or
    ``device``), cycled: ``ensemble_mesh(4)`` on one card is four shards on
    it (:func:`.mesh.mesh_devices`)."""
    return Mesh(mesh_devices(n_devices, device), (axis,))


def shard_member_year(year, mesh: Mesh, replicate: bool = False):
    """The batched engine's year map ``(carry, par, fyear) -> (carry,
    seasonal, converged, raw)`` run on the member shards of a 1-D ``mesh``:
    carry leaves ``(K, nx)`` and ``(K, 1)`` parameter columns split over the
    members, the forcing row shared (or, ``(nt, K, 1)``, split), the Newton
    flag ``pmin``-reduced. Build ``year`` with ``StepConfig.batch_axis`` set
    to the mesh axis, so its lockstep Newton loop takes the whole batch's
    trip count. ``replicate`` runs every member on every shard (a member
    count the mesh does not divide). Differentiable: the stability and
    Lyapunov drivers run their year graphs through it."""
    ax = mesh.axis_names[0]
    mem = P() if replicate else P(ax)

    def local(carry, par, fyear):
        carry, seasonal, conv, ys = year(carry, par, fyear)
        return carry, seasonal, (None if conv is None else pmin(conv, ax)), ys

    def run(carry, par, fyear):
        par_specs = Collection({k: (mem if _ndim(v) > 0 else P()) for k, v in par.items()})
        f_spec = P(None, ax) if _ndim(fyear) == 3 and not replicate else P()
        fn = shard_map(local, mesh, in_specs=(mem, par_specs, f_spec),
                       out_specs=(mem, mem, P(), P() if replicate else P(None, ax)))
        return fn(carry, par, fyear)

    return run


class _MemberShards:
    """The ``jit_wrapper`` of :func:`sharded_ensemble_integrate`
    (:func:`shard_member_year` on ``mesh``). ``batch_axis`` tells
    ``ensemble_integrate`` the mesh axis its Newton loop condition reduces
    over."""

    def __init__(self, mesh: Mesh, replicate: bool):
        self.mesh = mesh
        self.batch_axis = mesh.axis_names[0]
        self.replicate = replicate

    def __call__(self, year):
        return shard_member_year(year, self.mesh, self.replicate)


def check_members(mesh: Mesh, K) -> None:
    """The ``mesh=`` rules of the ensemble drivers: an ensemble whose size
    the mesh size divides."""
    if K is None:
        raise ValueError("mesh= needs an ensemble (per-member (K,) par leaves or a "
                         "member-batched init)")
    if int(K) % mesh.size != 0:
        raise ValueError(f"ensemble size {K} is not divisible by the mesh size {mesh.size}")


def sharded_ensemble_integrate(model: str, st, forcing, par: Collection, init: Collection,
                               mesh: Optional[Mesh] = None, **kwargs):
    """Ensemble integration with members sharded across the mesh: the
    semantics of :func:`.ensemble.ensemble_integrate` on its batched engine,
    each shard running the eager year on its members.

    A member count the mesh size does not divide cannot be split: every
    shard then carries and computes all members (correct, but unscaled),
    and a ``UserWarning`` names the leaves; pad the member count to a
    multiple of the mesh size to scale.
    """
    mesh = check_mesh(mesh if mesh is not None else ensemble_mesh(device=kwargs.get("device")))
    par = Collection(par)
    K = par.get("__K__") or kwargs.get("n_members")
    if K is None:
        sizes = {np.shape(v)[0] for v in par.values() if np.ndim(v) > 0}
        sizes |= {np.shape(v)[0] for v in init.values() if np.ndim(v) > 1}
        K = sizes.pop() if len(sizes) == 1 else None
    replicated = []
    if K is not None and int(K) % mesh.size != 0:
        replicated = [f"par[{k!r}] leading axis {np.shape(v)[0]}" for k, v in par.items()
                      if k != "__K__" and np.ndim(v) >= 1 and np.shape(v)[0] > 1]
        replicated += [f"init[{k!r}] leading axis {np.shape(v)[0]}" for k, v in init.items()
                       if np.ndim(v) > 1]
        replicated = replicated or [f"n_members {int(K)}"]
        warnings.warn(
            f"sharded_ensemble_integrate: {'; '.join(replicated)} not divisible by mesh "
            f"size {mesh.size} — these leaves are REPLICATED on every device (correct but "
            "unscaled); pad the member count to a multiple of the mesh size",
            UserWarning, stacklevel=2)
    kwargs.setdefault("device", mesh.devices.flat[0])
    return ens.ensemble_integrate(model, st, forcing, par, init,
                                  jit_wrapper=_MemberShards(mesh, bool(replicated)), **kwargs)


def shard_map_year_fn(model_name: str, st, mesh: Mesh, dtype_name: str = "float32",
                      cfg: Optional[StepConfig] = None):
    """The eager year on each shard's members plus a ``psum`` ensemble-mean
    diagnostic, the only communication between shards.

    Returns ``fn(carry, par, fyear) -> (carry, global_mean_T)``: carry leaves
    ``(K, nx)`` and ``par`` leaves ``(K,)`` with ``K`` divisible by the mesh
    size, ``fyear`` the shared ``(nt,)`` row; ``global_mean_T`` is the
    trapezoid hemispheric integral of the annual-mean ``T`` averaged over
    the whole ensemble.
    """
    mesh = check_mesh(mesh)
    axis = mesh.axis_names[0]
    if cfg is None:
        cfg = default_step_config(dtype_name)
    year = make_year_fn(model_name, st, dataclasses.replace(cfg, batch_axis=axis), False)

    def local_step(carry, par, fyear):
        cols = Collection({k: (v[:, None] if v.ndim == 1 else v) for k, v in par.items()})
        carry, seasonal, _conv, _ = year(carry, cols, fyear)
        T = seasonal.avg["T"]  # (K_local, nx)
        x = torch.as_tensor(st.x, dtype=T.dtype, device=T.device)
        hm = torch.sum((T[:, :-1] + T[:, 1:]) * (x[1:] - x[:-1]) / 2.0, dim=-1)
        count = torch.as_tensor(float(hm.shape[0]), dtype=T.dtype, device=T.device)
        return carry, psum(torch.sum(hm), axis) / psum(count, axis)

    return shard_map(local_step, mesh, in_specs=(P(axis), P(axis), P()),
                     out_specs=(P(axis), P()))


def shard_map_fused_year_fn(st, mesh: Mesh, par: Collection, dtype_name: str = "float32",
                            cfg: Optional[StepConfig] = None, block_k: int = 128,
                            model: str = "MIZ"):
    """The whole-year kernel on each shard's members: one launch per shard
    per year (:func:`..ops.miz_year.miz_year`,
    :func:`..ops.classic_year.classic_year`; their plain versions on the
    CPU), then the ``pmin`` of the Newton flag over the shards.

    ``par`` fixes which leaves are swept: ``(K,)`` leaves split over the
    mesh, scalars go to every shard. Returns ``fn(carry, par, fyear) ->
    (carry, Seasonal, converged)`` with carry leaves ``(K, nx)``, ``K``
    divisible by the mesh size. ``block_k`` is accepted for the JAX
    package's interface: the kernels run one block per member.
    """
    mesh = check_mesh(mesh)
    axis = mesh.axis_names[0]
    if cfg is None:
        cfg = default_step_config(dtype_name)
    # the plain versions' lockstep Newton loop takes the whole ensemble's
    # trip count; the kernels iterate per member and ignore it
    cfg = dataclasses.replace(cfg, batch_axis=axis)
    year = FUSED_YEARS[model][0]

    def local_step(carry, par, fyear):
        carry, seasonal, conv, _ = year(carry, par, fyear, st, cfg)
        if conv is None:
            ref = next(iter(carry.values()))
            conv = torch.ones((), dtype=ref.dtype, device=ref.device)
        return carry, seasonal, pmin(conv, axis)

    par_specs = Collection({k: (P(axis) if _ndim(v) > 0 else P()) for k, v in par.items()})
    return shard_map(local_step, mesh, in_specs=(P(axis), par_specs, P()),
                     out_specs=(P(axis), P(axis), P()))
