"""A dry run of every multi-device layout at tiny shapes (the port's
counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``).

Run it as ``python -m energybalancemodel_jl_tpu_torch.parallel.dryrun [N]``
(on the CUDA devices, cycled to N shards) or call
``dryrun_multichip(N, device="cpu")``.
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

__all__ = ["dryrun_multichip"]


def _finite(a) -> bool:
    return bool(np.isfinite(np.asarray(a)).all())


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Build an ``n_devices``-shard mesh (on the CUDA devices, cycled, or on
    ``device``) and run each layout once at tiny shapes, raising
    ``AssertionError`` on a non-finite result or a sharded run that differs
    from its unsharded one where they must agree bitwise:

    1. members split over the mesh: the eager year with a ``psum``
       diagnostic, the whole-year kernel on every shard, ``ensemble_integrate
       (mesh=)`` with a checkpoint and its resume, ``equilibrate``
       (checkpointed and resumed), ``continuation``, ``stability``,
       ``lyapunov``, ``transitions`` on both engines, and
       ``sharded_ensemble_integrate``;
    2. the grid split over the mesh: the halo-exchange stencil and a
       ``spatial_integrate`` year (halo exchange and SPIKE solves);
    3. with an even ``n_devices``, members x grid on a ``(2, n/2)`` mesh.
    """
    import energybalancemodel_jl_tpu_torch as ebt
    from ..models.base import get_model
    from .ensemble import batched_parameters
    from .grid2d import ensemble_spatial_integrate, grid2d_mesh
    from .halo import grid_mesh, sharded_diffusion
    from .sharding import (ensemble_mesh, shard_map_fused_year_fn, shard_map_year_fn,
                           sharded_ensemble_integrate)
    from .spatial import spatial_integrate

    n = int(n_devices)
    dtype = torch.float32
    mesh = ensemble_mesh(n, device=device)
    dev = mesh.devices.flat[0]
    K = 2 * n

    # -- 1. members split over the mesh ---------------------------------
    st = ebt.SpaceTime.sin(16, 8, 1)
    par_b = batched_parameters(ebt.default_parameters("MIZ"), {"D": np.linspace(0.5, 0.7, K)})
    par_b.pop("__K__")
    spec = get_model("MIZ")
    carry = spec.init_carry(ebt.zeros_init(st), st, dtype, dev)
    carry = ebt.Collection({k: v.expand((K,) + tuple(v.shape)).contiguous()
                            for k, v in carry.items()})
    fyear = torch.zeros(st.nt, dtype=dtype, device=dev)
    par_full = ebt.Collection({k: torch.as_tensor(np.asarray(v), dtype=dtype,
                                                  device=dev).expand(K) for k, v in par_b.items()})
    _, mean_T = shard_map_year_fn("MIZ", st, mesh, "float32")(carry, par_full, fyear)
    assert _finite(mean_T.cpu()), "ensemble-DP dry run produced non-finite output"
    par_fused = ebt.Collection({k: torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)
                                for k, v in par_b.items()})
    _, seas, _ = shard_map_fused_year_fn(st, mesh, par_fused, "float32")(carry, par_fused, fyear)
    assert _finite(seas.avg["E"].cpu()), "fused-year DP dry run produced non-finite output"

    st2 = ebt.SpaceTime.sin(16, 8, 2)
    init2 = ebt.zeros_init(st2)
    kw = dict(n_members=K, dtype=dtype, progress=False)
    ens = ebt.ensemble_integrate("MIZ", st2, ebt.Forcing(0.0), par_b, init2, engine="fused",
                                 mesh=mesh, years_per_dispatch=2, **kw)
    assert _finite(ens.seasonal.avg["E"]), "fused DP dry run produced non-finite output"
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "mesh.ckpt.h5")
        first = ebt.ensemble_integrate("MIZ", st2, ebt.Forcing(0.0), par_b, init2,
                                       engine="fused", mesh=mesh, checkpoint=ck, **kw)
        resumed = ebt.ensemble_integrate("MIZ", st2, ebt.Forcing(0.0), par_b, init2,
                                         engine="fused", mesh=mesh, checkpoint=ck,
                                         resume=True, **kw)
        assert np.array_equal(first.seasonal.avg["E"], resumed.seasonal.avg["E"]), (
            "mesh checkpoint resume did not reproduce the stored seasonal data")

        eq_kw = dict(tol=0.0, n_members=K, dtype=dtype, mesh=mesh)
        eq = ebt.equilibrate("MIZ", st2, 0.0, par_b, init2, max_years=2, **eq_kw)
        assert _finite(eq.seasonal.avg["E"]) and eq.years == 2, "mesh equilibrate failed"
        eck = os.path.join(td, "eq.ckpt.h5")
        ebt.equilibrate("MIZ", st2, 0.0, par_b, init2, max_years=2, checkpoint=eck, **eq_kw)
        eq_res = ebt.equilibrate("MIZ", st2, 0.0, par_b, init2, max_years=3, checkpoint=eck,
                                 resume=True, **eq_kw)
    eq3 = ebt.equilibrate("MIZ", st2, 0.0, par_b, init2, max_years=3, **eq_kw)
    assert eq_res.years == 3 and all(np.array_equal(eq_res.state[k], eq3.state[k])
                                     for k in eq3.state), (
        "mesh equilibrate resume did not reproduce the uninterrupted state")
    cont = ebt.continuation("MIZ", st2, [0.0, 1.0], par_b, init2, max_years=2, **eq_kw)
    assert _finite(cont.ice_area()) and len(cont.results) == 2, "mesh continuation failed"
    stab = ebt.stability("MIZ", st2, 0.0, par_b, init2, n_iter=3, mesh=mesh)
    assert _finite(stab.growth), "mesh stability produced a non-finite growth"
    lya = ebt.lyapunov("MIZ", st2, 0.0, par_b, init2, years=2, mesh=mesh)
    assert _finite(lya.history), "mesh lyapunov produced a non-finite history"

    tr_kw = dict(sigma=1.0, tau=0.05, years=2, K=K, dtype=dtype, years_per_dispatch=1,
                 track=("E",))
    for engine in ("scan", "fused"):
        tr = ebt.transitions("MIZ", st2, 0.0, par_b, eq, eq, mesh=mesh, engine=engine,
                             **tr_kw)
        assert _finite(tr.tracked["E"]), f"mesh {engine} transitions went non-finite"
    par_c = ebt.Collection(ebt.default_parameters("Classic"))
    E0 = np.full(st2.nx, 30.0)
    init_c = ebt.Collection(E=E0, Tg=E0 / float(par_c["cw"]))
    kw_c = dict(tr_kw, engine="fused", ou_impl="assoc", init=init_c)
    tr_cf = ebt.transitions("Classic", st2, 0.0, par_c, init_c, init_c, mesh=mesh, **kw_c)
    tr_cs = ebt.transitions("Classic", st2, 0.0, par_c, init_c, init_c, device=dev, **kw_c)
    assert np.array_equal(tr_cf.tracked["E"], tr_cs.tracked["E"]), (
        "mesh fused Classic transitions differ from the unsharded run")

    ens_b = sharded_ensemble_integrate("MIZ", st2, ebt.Forcing(0.0), par_b, init2, mesh=mesh,
                                       **kw)
    assert _finite(ens_b.seasonal.avg["E"]), "sharded batched ensemble went non-finite"

    # -- 2. the grid split over the mesh --------------------------------
    gmesh = grid_mesh(n, device=device)
    st_x = ebt.SpaceTime.sin(8 * n, 8, 1)
    T = torch.as_tensor(np.random.default_rng(0).normal(size=st_x.nx), dtype=dtype, device=dev)
    assert _finite(sharded_diffusion(st_x, gmesh)(T, 0.6).cpu()), "halo dry run went non-finite"
    st_s = ebt.SpaceTime.sin(4 * n, 8, 1)
    sols = spatial_integrate("MIZ", st_s, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                             ebt.zeros_init(st_s), mesh=gmesh, dtype=dtype, progress=False)
    assert _finite(sols.raw["E"]), "spatially sharded dry run went non-finite"

    # -- 3. members x grid ------------------------------------------------
    if n % 2 == 0:
        nk, ndx = 2, n // 2
        st_g = ebt.SpaceTime.sin(4 * ndx, 8, 1)
        par_g = ebt.Collection(ebt.default_parameters("MIZ"))
        par_g["D"] = np.linspace(0.5, 0.7, 2 * nk)
        ens2d = ensemble_spatial_integrate(
            "MIZ", st_g, ebt.Forcing(0.0), par_g, ebt.zeros_init(st_g),
            mesh=grid2d_mesh(nk, ndx, device=device), dtype=dtype, progress=False)
        assert _finite(ens2d.seasonal.avg["E"]), "2-D mesh dry run went non-finite"


if __name__ == "__main__":
    shards = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    dryrun_multichip(shards)
    print(f"dryrun_multichip({shards}) passed")
