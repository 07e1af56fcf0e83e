"""Members x grid shards on a 2-D mesh in the PyTorch port on the CPU
(``parallel/grid2d.py``: ``ensemble_spatial_integrate``, ``grid2d_mesh``).

The port's mesh is ``Mesh`` of shape (2, 4) on the CPU, the JAX package's
``grid2d_mesh(2, 4)`` on conftest's 8 virtual devices; float64, NaNs zeroed.
Bars: MIZ at ``SpaceTime.sin(16, 50, 1)`` with 6 members swept in D, every
seasonal store and the raw steps within rtol 1e-8 and atol 1e-9 of the JAX
package's run (measured 4e-14 seasonal, 2.5e-13 raw) and within rtol 1e-10
/ atol 1e-11 of the port's unsharded batched engine (the JAX package's own
bar for this comparison, ``tests/test_grid2d.py``); the same against the
batched engine for Classic, the virtual ``F`` sweep and K == nt; the
checkpoint resume bitwise. ~25 s on one worker here.
"""
import numpy as np
import pytest

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch import checkpoint as ckpt
from energybalancemodel_jl_tpu_torch.parallel.grid2d import (ensemble_spatial_integrate,
                                                             grid2d_mesh)

ST = ebt.SpaceTime.sin(16, 50, 1)
KW = dict(dtype="float64", progress=False)


def zn(a):
    return np.nan_to_num(np.asarray(a, dtype=np.float64))


def mesh24():
    return grid2d_mesh(2, 4, device="cpu")


def swept_par(K=6):
    par = ebt.Collection(ebt.default_parameters("MIZ"))
    par["D"] = np.linspace(0.55, 0.65, K)
    return par


def batched(model, st, par, init, **kw):
    return ebt.ensemble_integrate(model, st, ebt.Forcing(0.0), par, init, engine="batched",
                                  device="cpu", **KW, **kw)


def test_matches_jax_and_the_unsharded_batched_ensemble():
    import energybalancemodel_jl_tpu as ebm
    from energybalancemodel_jl_tpu.parallel.grid2d import ensemble_spatial_integrate as jesi
    from energybalancemodel_jl_tpu.parallel.grid2d import grid2d_mesh as jg

    jpar = ebm.Collection(ebm.default_parameters("MIZ"))
    jpar["D"] = np.linspace(0.55, 0.65, 6)
    jst = ebm.SpaceTime.sin(16, 50, 1)
    want = jesi("MIZ", jst, ebm.Forcing(0.0), jpar, ebm.zeros_init(jst), mesh=jg(2, 4),
                raw_mode="last", progress=False)
    par, init = swept_par(), ebt.zeros_init(ST)
    got = ensemble_spatial_integrate("MIZ", ST, ebt.Forcing(0.0), par, init, mesh=mesh24(),
                                     raw_mode="last", **KW)
    ref = batched("MIZ", ST, par, init, raw_mode="last")
    assert got.n_members == 6 and got.raw["E"].shape == (6, 50, 16)
    for k in ("E", "h", "phi", "T", "Ti", "Tw"):
        for store in ("avg", "winter", "summer"):
            g = zn(getattr(got.seasonal, store)[k])
            np.testing.assert_allclose(g, zn(getattr(want.seasonal, store)[k]), rtol=1e-8,
                                       atol=1e-9, err_msg=f"{store}.{k} vs JAX")
            np.testing.assert_allclose(g, zn(getattr(ref.seasonal, store)[k]), rtol=1e-10,
                                       atol=1e-11, err_msg=f"{store}.{k} vs batched")
    np.testing.assert_allclose(zn(got.raw["E"]), zn(want.raw["E"]), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(zn(got.raw["E"]), zn(ref.raw["E"]), rtol=1e-10, atol=1e-11)


def test_mesh_shapes():
    m = grid2d_mesh(4, 2, device="cpu")
    assert m.shape == {"k": 4, "x": 2} and m.size == 8
    assert grid2d_mesh(device=["cpu"] * 8).shape == {"k": 2, "x": 4}


def test_classic_on_2d_mesh():
    st = ebt.SpaceTime.identity(16, 1000, 1)
    par = ebt.Collection(ebt.default_parameters("Classic"))
    par["A"] = np.linspace(190.0, 196.0, 4)
    E0 = np.full(st.nx, 30.0)
    init = ebt.Collection(E=E0, Tg=E0 / float(par["cw"]))
    got = ensemble_spatial_integrate("Classic", st, ebt.Forcing(0.0), par, init,
                                     mesh=grid2d_mesh(2, 2, device="cpu"), **KW)
    np.testing.assert_allclose(got.seasonal.avg["E"], batched("Classic", st, par, init)
                               .seasonal.avg["E"], rtol=1e-10, atol=1e-11)


def test_checkpoint_resume_bit_exact(tmp_path):
    par = swept_par()
    st1, st2 = ebt.SpaceTime.sin(16, 20, 1), ebt.SpaceTime.sin(16, 20, 2)
    mesh = mesh24()
    full = ensemble_spatial_integrate("MIZ", st2, ebt.Forcing(0.0), par, ebt.zeros_init(st2),
                                      mesh=mesh, **KW)
    ck = str(tmp_path / "g2d.ckpt.h5")
    ensemble_spatial_integrate("MIZ", st1, ebt.Forcing(0.0), par, ebt.zeros_init(st1),
                               mesh=mesh, checkpoint=ck, **KW)
    # graft the 1-year state under the 2-year key and resume
    carry, years, acc, _ = ckpt.read_checkpoint(ck)
    key2 = ckpt.config_key("grid2d2x4", "MIZ", st2, ebt.Forcing(0.0), par, "float64", "pcr",
                           30, ("K=6",))
    ck2 = str(tmp_path / "g2d2.ckpt.h5")
    ckpt.write_checkpoint(ck2, carry, years, acc, key2)
    resumed = ensemble_spatial_integrate("MIZ", st2, ebt.Forcing(0.0), par, ebt.zeros_init(st2),
                                         mesh=mesh, checkpoint=ck2, resume=True, **KW)
    for k in ("E", "h", "phi"):
        np.testing.assert_array_equal(zn(resumed.seasonal.avg[k]), zn(full.seasonal.avg[k]),
                                      err_msg=k)


def test_virtual_F_sweep_matches_ensemble():
    """The virtual forcing offset ``F`` becomes per-member forcing rows (no
    model reads par['F']), as in ensemble_integrate."""
    par = ebt.Collection(ebt.default_parameters("MIZ"))
    par["F"] = np.linspace(-1.0, 3.0, 6)
    init = ebt.zeros_init(ST)
    got = ensemble_spatial_integrate("MIZ", ST, ebt.Forcing(0.0), par, init, mesh=mesh24(),
                                     **KW)
    E = zn(got.seasonal.avg["E"])
    assert np.abs(E[0] - E[-1]).max() > 1.0
    np.testing.assert_allclose(E, zn(batched("MIZ", ST, par, init).seasonal.avg["E"]),
                               rtol=1e-10, atol=1e-11)
    # a scalar F is a shared offset, applied too: the swept run's members
    par_s = ebt.Collection(ebt.default_parameters("MIZ"), F=3.0)
    one = ensemble_spatial_integrate("MIZ", ST, ebt.Forcing(0.0), par_s, init, n_members=2,
                                     mesh=grid2d_mesh(2, 2, device="cpu"), **KW)
    np.testing.assert_allclose(zn(one.seasonal.avg["E"][0]), E[-1], rtol=1e-10, atol=1e-11)


def test_K_collides_with_nt():
    """K == nt == 50: the statics are split by exact detection (their shapes
    with scalar parameters), not by guessing from shapes."""
    par = ebt.Collection(ebt.default_parameters("MIZ"))
    par["D"] = np.linspace(0.55, 0.65, 50)
    init = ebt.zeros_init(ST)
    got = ensemble_spatial_integrate("MIZ", ST, ebt.Forcing(0.0), par, init, mesh=mesh24(),
                                     **KW)
    E = zn(got.seasonal.avg["E"])
    assert E.shape == (50, 1, 16) and np.isfinite(E).all()
    np.testing.assert_allclose(E, zn(batched("MIZ", ST, par, init).seasonal.avg["E"]),
                               rtol=1e-10, atol=1e-11)


def test_raw_all_budget_guard():
    with pytest.raises(ValueError, match="raw_memory_limit"):
        ensemble_spatial_integrate("MIZ", ST, ebt.Forcing(0.0), swept_par(), ebt.zeros_init(ST),
                                   mesh=mesh24(), raw_mode="all", raw_memory_limit=64, **KW)


def test_validation():
    init = ebt.zeros_init(ST)
    run = lambda par, st=ST, init=init, **kw: ensemble_spatial_integrate(
        "MIZ", st, ebt.Forcing(0.0), par, init, mesh=kw.pop("mesh", mesh24()), **KW, **kw)
    with pytest.raises(ValueError, match="member rows"):
        run(swept_par(5))
    with pytest.raises(ValueError, match="grid columns"):
        st = ebt.SpaceTime.sin(18, 50, 1)
        run(swept_par(), st, ebt.zeros_init(st))
    with pytest.raises(ValueError, match="insolation-table"):
        run(ebt.Collection(ebt.default_parameters("MIZ"), S0=np.linspace(415.0, 425.0, 6)))
    with pytest.raises(ValueError, match="no axis"):
        run(swept_par(), mesh=grid2d_mesh(2, 4, k_axis="members", device="cpu"))
