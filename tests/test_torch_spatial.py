"""Grid-sharded single runs of the PyTorch port on the CPU
(``parallel/spatial.py``: the halo exchange and the SPIKE solves inside the
model step, ``StepConfig.spatial_axis``).

Bars (float64, zero NaNs), as the JAX package's own sharded-against-unsharded
tests (``tests/test_spatial.py:58-90``): every raw step within rtol 1e-8 and
atol 1e-9 of the JAX package's ``spatial_integrate`` on the same 8-shard
mesh (conftest's virtual devices; the port's ``Mesh([cpu] * 8)``) and of
the port's unsharded ``integrate``:
- MIZ ``SpaceTime.sin(64, 100, 2)`` from zero, both years raw: measured
  2.3e-11 against JAX, 4.7e-12 against the unsharded port (the bar holds
  through year 2; no step breaks it);
- Classic ``SpaceTime.identity(64, 1000, 1)`` from the warm init: 2.9e-13
  against JAX.
The driver surface (verbose warnings, progress, checkpoint/resume bit-exact,
uneven shards, the statics split when ``nt == nx``) runs on 4 shards at
small grids. ~45 s on one worker here (a shard's steps are small PyTorch
operations run one shard at a time, so the 8-shard runs cost ~8x an
unsharded run's operations). The ``gpu``-marked test holds the sharded run
on the card against the unsharded one and skips here.
"""
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch import checkpoint as ckpt
from energybalancemodel_jl_tpu_torch.models.base import get_model
from energybalancemodel_jl_tpu_torch.parallel import mesh as M
from energybalancemodel_jl_tpu_torch.parallel.spatial import (_stat_specs, grid_mesh,
                                                              spatial_integrate)

MIZ_VARS = ("E", "phi", "h", "Ti", "Tw", "D", "n", "T", "Ei", "Ew")


def zn(a):
    return np.nan_to_num(np.asarray(a, dtype=np.float64))


def cpu_grid(n=8):
    return grid_mesh(n, device="cpu")


def assert_close(got, want, keys):
    for k in keys:
        np.testing.assert_allclose(zn(got.raw[k]), zn(want.raw[k]), rtol=1e-8, atol=1e-9,
                                   err_msg=k)


def test_miz_matches_jax_and_the_unsharded_run():
    import energybalancemodel_jl_tpu as ebm
    from energybalancemodel_jl_tpu.parallel.spatial import grid_mesh as jgm
    from energybalancemodel_jl_tpu.parallel.spatial import spatial_integrate as jsi

    jst = ebm.SpaceTime.sin(64, 100, 2)
    want = jsi("MIZ", jst, ebm.Forcing(0.0), ebm.default_parameters("MIZ"),
               ebm.zeros_init(jst), mesh=jgm(), lastonly=False, progress=False)
    st = ebt.SpaceTime.sin(64, 100, 2)
    args = ("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"), ebt.zeros_init(st))
    got = spatial_integrate(*args, mesh=cpu_grid(), lastonly=False, progress=False,
                            dtype="float64")
    assert got.raw["E"].shape == (200, 64)
    assert_close(got, want, MIZ_VARS)
    solo = ebt.integrate(*args, lastonly=False, progress=False, dtype="float64", device="cpu")
    assert_close(got, solo, MIZ_VARS)
    for season in ("winter", "summer", "avg"):
        np.testing.assert_allclose(zn(getattr(got.seasonal, season)["E"]),
                                   zn(getattr(want.seasonal, season)["E"]),
                                   rtol=1e-8, atol=1e-9, err_msg=season)


def test_classic_matches_jax():
    import energybalancemodel_jl_tpu as ebm
    from energybalancemodel_jl_tpu.parallel.spatial import grid_mesh as jgm
    from energybalancemodel_jl_tpu.parallel.spatial import spatial_integrate as jsi

    E0 = np.full(64, 30.0)
    jpar = ebm.default_parameters("Classic")
    jst = ebm.SpaceTime.identity(64, 1000, 1)
    want = jsi("Classic", jst, ebm.Forcing(0.0), jpar, ebm.Collection(E=E0, Tg=E0 / jpar.cw),
               mesh=jgm(), lastonly=False, progress=False)
    par = ebt.default_parameters("Classic")
    st = ebt.SpaceTime.identity(64, 1000, 1)
    got = spatial_integrate("Classic", st, ebt.Forcing(0.0), par,
                            ebt.Collection(E=E0, Tg=E0 / par.cw), mesh=cpu_grid(),
                            lastonly=False, progress=False, dtype="float64")
    assert_close(got, want, ("E", "T", "h"))


def test_uneven_shards_and_foreign_meshes_are_rejected():
    st = ebt.SpaceTime.sin(30, 10, 1)
    args = ("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"), ebt.zeros_init(st))
    with pytest.raises(ValueError, match="divide evenly"):
        spatial_integrate(*args, mesh=cpu_grid())
    with pytest.raises(ValueError, match="no axis"):
        spatial_integrate(*args, mesh=cpu_grid(2), axis="y")
    with pytest.raises(TypeError, match="Mesh"):
        spatial_integrate(*args, mesh=object())


def small(dur):
    st = ebt.SpaceTime.sin(16, 30, dur)
    return ("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"), ebt.zeros_init(st))


def test_verbose_warns_on_nonconvergence():
    # zero Newton iterations cannot meet the float64 tolerance
    with pytest.warns(UserWarning, match="Solving for T0 failed"):
        spatial_integrate(*small(1), mesh=cpu_grid(4), verbose=True, newton_max_iter=0,
                          progress=False, raw_mode="none", dtype="float64")


def test_progress_renders(monkeypatch):
    import energybalancemodel_jl_tpu_torch.utils.progress as prog_mod

    rendered = []
    real = prog_mod.Progress.update

    def spy(self, current=None, feedargs=()):
        rendered.append(current)
        return real(self, current, feedargs)

    monkeypatch.setattr(prog_mod.Progress, "update", spy)
    args = small(2)
    spatial_integrate(*args, mesh=cpu_grid(4), raw_mode="none", dtype="float64")
    assert rendered and rendered[-1] == args[1].dur * args[1].nt


def test_checkpoint_resume_bit_exact(tmp_path):
    a4, a2 = small(4), small(2)
    mesh = cpu_grid(2)
    kw = dict(mesh=mesh, progress=False, dtype="float64")
    full = spatial_integrate(*a4, **kw)
    # a crash after year 2: a 2-year run's checkpoint under the 4-year key
    pre = str(tmp_path / "pre.h5")
    spatial_integrate(*a2, raw_mode="none", checkpoint=pre, **kw)
    carry, years, acc, key2 = ckpt.read_checkpoint(pre)
    assert years == 2 and key2.startswith("spatial2|")
    ck = str(tmp_path / "run.h5")
    ckpt.write_checkpoint(ck, carry, years, acc, key2.replace(repr(a2[1]), repr(a4[1])))
    resumed = spatial_integrate(*a4, checkpoint=ck, resume=True, **kw)
    for k in ("E", "h", "phi"):
        np.testing.assert_array_equal(resumed.raw[k], full.raw[k], err_msg=k)
        np.testing.assert_array_equal(resumed.seasonal.avg[k], full.seasonal.avg[k], err_msg=k)
    # another decomposition is another run: the key holds the mesh size
    with pytest.warns(UserWarning, match="does not match"):
        spatial_integrate(*a4, checkpoint=ck, resume=True, mesh=cpu_grid(4), progress=False,
                          dtype="float64", raw_mode="none")


@pytest.mark.parametrize("model", ["MIZ", "Classic"])
def test_statics_split_exactly_when_nt_equals_nx(model):
    """The per-step cosine rows are (nt,) (Classic (nt + 1,)): with nt equal
    to nx (or nx - 1) a guess from shapes would split them over the grid."""
    nx = 16
    st = ebt.SpaceTime.sin(nx, nx if model == "MIZ" else nx - 1, 1)
    par = ebt.Collection({k: torch.as_tensor(v, dtype=torch.float64)
                          for k, v in ebt.default_parameters(model).items()})
    spec = get_model(model)
    stat = spec.statics(st, par, torch.float64, torch.device("cpu"))
    specs = _stat_specs(spec, st, par, stat, "x")
    assert specs["cosv"] == M.P(None) and specs["aw"] == M.P("x")
    band = "glo" if model == "MIZ" else "klo"
    assert specs[band] == M.P("x") and specs["dt"] == M.P()


@pytest.mark.gpu
def test_spatial_run_on_the_card_matches_the_unsharded_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    st = ebt.SpaceTime.sin(1024, 64, 1)
    par = ebt.default_parameters("MIZ")
    # the explicit Tb diffusion needs D nx^2 / nt near the canonical grid's
    par["D"] = par["D"] * (180 ** 2 / 2000) * 64 / 1024 ** 2
    args = ("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st))
    got = spatial_integrate(*args, mesh=grid_mesh(4), lastonly=False, progress=False,
                            dtype="float64")
    want = ebt.integrate(*args, lastonly=False, progress=False, dtype="float64",
                         engine="scan", device="cuda")
    assert_close(got, want, MIZ_VARS)
