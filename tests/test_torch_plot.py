"""The plot layer of the PyTorch port (``plot.py``) against the JAX package,
under Agg.

Bar: every ``plot_*`` of the port, drawn from a result that the port loaded
from a file the JAX package wrote, carries the same artists as the JAX
package's function drawn from the same file: axes titles and labels equal,
every line's (x, y) data, every collection's paths, offsets and colour
arrays (the contour sets of the Hovmoller tiles included) and every bar's
bounds bitwise, NaNs at the same places. The results' fields come from one
numpy seed (``tests/torch_results.py``).
"""
import matplotlib

matplotlib.use("Agg", force=True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from matplotlib.patches import Rectangle  # noqa: E402

import energybalancemodel_jl_tpu as ebm  # noqa: E402
import energybalancemodel_jl_tpu_torch as ebt  # noqa: E402
from torch_results import ensemble_cls, factories  # noqa: E402

MIZ_VARS = ("Ew", "Ei", "E", "Tw", "Ti", "T", "h", "D", "phi")


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    import matplotlib.pyplot as plt

    plt.close("all")


def ramp_runs(mod):
    """A 6-year MIZ run and a 3-member D sweep under a warming-cooling ramp,
    from a fixed seed: shapes as ``integrate`` and ``sweep`` return them."""
    from importlib import import_module
    Seasonal = import_module(mod.__name__ + ".solutions").Seasonal
    rng = np.random.default_rng(11)
    st = mod.SpaceTime.sin(6, 8, 6)
    ramp = mod.Forcing(0.0, 4.0, -4.0, (1, 1), (4.0, -4.0))
    C = mod.Collection

    def seas(shape):
        mk = lambda: C({v: (rng.random(shape) if v == "phi" else rng.standard_normal(shape))
                        for v in MIZ_VARS})
        return Seasonal(winter=mk(), summer=mk(), avg=mk())

    sols = mod.Solutions(
        spacetime=st, ts=mod.Solutions.stored_times(st, True), forcing=ramp,
        parameters=C(mod.default_parameters("MIZ")), initconds=mod.zeros_init(st),
        lastonly=True, debug=None,
        raw=C({v: rng.standard_normal((st.nt, st.nx)) for v in MIZ_VARS}),
        seasonal=seas((st.dur, st.nx)))
    ens = ensemble_cls(mod)(
        spacetime=st, forcing=ramp, n_members=3,
        parameters=C(mod.default_parameters("MIZ"), D=np.array([0.5, 0.6, 0.7])),
        seasonal=seas((3, st.dur, st.nx)), raw=None)
    return {"Solutions": sols, "EnsembleSolutions": ens}


def results(mod):
    out = {k: f() for k, f in factories(mod).items()}
    out.update(ramp_runs(mod))
    return out


PLOTS = {
    "plot_raw": ("Solutions", {}),
    "plot_avg": ("Solutions", {}),
    "plot_seasonal": ("Solutions", {}),
    "plot_seasonal-ensemble": ("EnsembleSolutions", {}),
    "plot_bifurcation": ("EnsembleSolutions", {}),
    "plot_bifurcation-year": ("EnsembleSolutions", dict(year=2)),
    "plot_continuation": ("ContinuationResult", {}),
    "plot_continuation-var": ("ContinuationResult", dict(var="T", stability=[0.5, 1.2])),
    "plot_fold": ("FoldResult", {}),
    "plot_fold-against": ("FoldResult", dict(against="D")),
    "plot_edge": ("EdgeResult", {}),
    "plot_basins": ("BasinResult", {}),
    "plot_sensitivity": ("SensitivityResult", dict(n=2)),
    "plot_lyapunov": ("LyapunovResult", {}),
    "plot_transitions": ("TransitionResult", {}),
}


def artists(fig):
    """What a figure draws, as a flat list of strings and arrays."""
    out = []
    for ax in fig.axes:
        out.append((ax.get_title(), ax.get_xlabel(), ax.get_ylabel()))
        for line in ax.get_lines():
            out.append(np.asarray(line.get_xydata(), dtype=np.float64))
        for c in ax.collections:
            out.append(type(c).__name__)
            out.append(np.asarray(c.get_offsets(), dtype=np.float64))
            out.extend(np.asarray(p.vertices, dtype=np.float64) for p in c.get_paths())
            if c.get_array() is not None:
                out.append(np.asarray(c.get_array(), dtype=np.float64))
        for p in ax.patches:
            if isinstance(p, Rectangle):
                out.append(np.asarray(p.get_bbox().bounds, dtype=np.float64))
    return out


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """Every plotted result, written by the JAX package."""
    d = tmp_path_factory.mktemp("plots")
    paths = {}
    for name, obj in results(ebm).items():
        paths[name] = str(d / f"{name}.h5")
        ebm.save(obj, paths[name])
    return paths


@pytest.mark.parametrize("case", sorted(PLOTS))
def test_plot_draws_what_jax_draws(case, jax_files):
    fn = case.split("-")[0]
    name, kw = PLOTS[case]
    j_obj, t_obj = ebm.load(jax_files[name]), ebt.load(jax_files[name])
    assert type(t_obj).__module__.startswith("energybalancemodel_jl_tpu_torch")
    j_art = artists(getattr(ebm, fn)(j_obj, **kw))
    t_art = artists(getattr(ebt, fn)(t_obj, **kw))
    assert len(t_art) == len(j_art) and len(t_art) > 1
    drew = 0
    for a, b in zip(t_art, j_art):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=case)
            drew += a.size
        else:
            assert a == b, case
    assert drew > 0


def test_layout_backend_and_figure_save(tmp_path):
    from energybalancemodel_jl_tpu_torch.plot import classic_layout, miz_layout, register_backend

    with pytest.raises(ValueError):
        ebt.Layout([["E", "T"]], [["only one"]])
    assert miz_layout.shape == (3, 3) and classic_layout.shape == (1, 3)
    assert ebt.backend("CairoMakie") is not None and ebt.backend() == "CairoMakie"
    with pytest.raises(ValueError, match="Unsupported"):
        ebt.backend("NopeMakie")
    register_backend("MyBackend", "Agg")
    assert ebt.backend("MyBackend") is not None
    sols = results(ebt)["Solutions"]
    fig = ebt.plot_avg(sols)
    path = str(tmp_path / "avg.png")
    ebt.save(fig, path)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    empty = ebt.Solutions(**{**sols.__dict__, "ts": np.zeros((0,))})
    with pytest.raises(ValueError, match="no per-step raw storage"):
        ebt.plot_raw(empty)


def test_transitions_save_load_and_plot(tmp_path):
    """A ``TransitionResult`` goes through the module-level functions, as
    in the JAX package; the class has no methods of its own for them."""
    res = factories(ebt)["TransitionResult"]()
    for attr in ("save", "load", "plot"):
        assert not hasattr(ebt.TransitionResult, attr)
    path = str(tmp_path / "tr.h5")
    ebt.save(res, path)
    back = ebt.load(path)
    np.testing.assert_array_equal(back.areas, res.areas)
    np.testing.assert_array_equal(back.first_passage, res.first_passage)
    fig = ebt.plot_transitions(back)
    assert len(fig.axes) >= 1 and len(fig.axes[0].get_lines()) >= 2
