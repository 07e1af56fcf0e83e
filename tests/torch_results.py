"""Result objects of both packages from one numpy seed: the persistence and
plot tests of the PyTorch port build every registered type's fields here,
as JAX ``tests/test_io.py`` does, instead of running the drivers. Both
packages' factories give equal data."""
from importlib import import_module

import numpy as np


def ensemble_cls(mod):
    return import_module(mod.__name__ + ".parallel.ensemble").EnsembleSolutions


def factories(mod):
    """One object of every registered type, from a fixed seed: the two
    packages' factories give equal data."""
    Seasonal = import_module(mod.__name__ + ".solutions").Seasonal
    st = mod.SpaceTime.sin(3, 10, 2)
    par = mod.Collection({"D": 0.5, "A": 193.0})
    rng = np.random.default_rng(7)
    C = mod.Collection

    def seasonal(shape):
        mk = lambda: C({v: rng.standard_normal(shape) for v in ("E", "T", "phi")})
        return Seasonal(winter=mk(), summer=mk(), avg=mk())

    def state(K=None):
        return C({v: rng.standard_normal((3,) if K is None else (K, 3)) for v in ("E", "Tg")})

    def equilibrium(K=None):
        return mod.EquilibriumResult(
            state=state(K), seasonal=seasonal((3,) if K is None else (K, 3)), years=7,
            resid=1e-4 if K is None else rng.random(K),
            converged=True if K is None else np.ones(K, dtype=bool),
            member_years=None if K is None else np.full(K, 7.0), newton_ok=True, tol=1e-3)

    return {
        "Solutions": lambda: mod.Solutions(
            spacetime=st, ts=rng.random(10), forcing=mod.Forcing(0.0, 2.0, -2.0, (1, 1),
                                                                 (2.0, -2.0)),
            parameters=par, initconds=C(E=rng.standard_normal(3)), lastonly=True, debug=None,
            raw=C({v: rng.standard_normal((10, 3)) for v in ("E", "T", "phi")}),
            seasonal=seasonal((2, 3))),
        "EnsembleSolutions": lambda: ensemble_cls(mod)(
            spacetime=st, forcing=mod.Forcing(1.5), n_members=4,
            parameters=C({"D": rng.random(4), "A": 193.0}), seasonal=seasonal((4, 2, 3)),
            raw=C({v: rng.standard_normal((4, 10, 3)) for v in ("E", "phi")})),
        "EquilibriumResult": lambda: equilibrium(),
        "ContinuationResult": lambda: mod.ContinuationResult(
            values=np.array([0.0, 1.0]), direction=np.array([1.0, 1.0]),
            results=[equilibrium() for _ in range(2)], vary="F", spacetime=st, model="MIZ",
            par=par, forcing=mod.Forcing(0.0)),
        "StabilityResult": lambda: mod.StabilityResult(
            growth=0.97, history=rng.random(5), converged=True, mode=state(), rtol=1e-6,
            n_modes=2, eigenvalues=np.array([0.97 + 0.01j, 0.9 - 0.01j]), side="right"),
        "SensitivityResult": lambda: mod.SensitivityResult(
            of="ice_area", value=2.5, grads=C({"D": 0.1, "A": -0.2}), par=par),
        "CalibrationResult": lambda: mod.CalibrationResult(
            params=C({"D": 0.55}), par=par, losses=rng.random(4), grads=C({"D": 1e-5}),
            best=1, start_params=C({"D": rng.random(3)}), start_losses=rng.random(3)),
        "FoldResult": lambda: mod.FoldResult(
            lo=rng.random(2), hi=1.0 + rng.random(2), history=rng.random((4, 2, 2)),
            survived=np.ones((4, 2), dtype=bool), probe_converged=np.ones((4, 2), dtype=bool),
            vary="F", anchor=equilibrium(K=2), spacetime=st, par=par),
        "BasinResult": lambda: mod.BasinResult(
            labels=np.array([0, 1, 0, -1]), areas=rng.random(4),
            centroids=np.array([0.1, 2.9]), counts=np.array([2, 1]), season="avg", gap=0.5,
            result=equilibrium(K=4), spacetime=st, par=par),
        "EdgeResult": lambda: mod.EdgeResult(
            wa=rng.random(2), wb=1.0 + rng.random(2), history=rng.random((4, 2, 2)),
            in_a=np.ones((4, 2), dtype=bool), probe_converged=np.ones((4, 2), dtype=bool),
            probe_finite=np.ones((4, 2), dtype=bool), area_a=rng.random(2),
            area_b=2.0 + rng.random(2), a=state(), b=state(), result_a=equilibrium(K=2),
            result_b=equilibrium(K=2), spacetime=st, season="avg", par=par),
        "LyapunovResult": lambda: mod.LyapunovResult(
            exponents=rng.standard_normal(2), history=rng.standard_normal((6, 2)),
            state=state(), modes=state(), transient=2, n_modes=2, years=6),
        "TransitionResult": lambda: mod.TransitionResult(
            areas=rng.random((5, 3)), labels=rng.integers(-1, 2, (5, 3)).astype(np.int8),
            first_passage=np.array([2.0, np.nan, 4.0]), finite=np.array([True, True, False]),
            state=state(K=3), eta=rng.standard_normal(3),
            tracked=C({"E": rng.random((5, 3))}), area_a=np.array([0.8]),
            area_b=np.array([3.1]), start="a", sigma=rng.random(3), tau=0.05, years=5,
            season="avg", seed=3, newton_ok=True, crossing_step=rng.integers(-1, 9, (5, 3)),
            ref_state=(state(), state()), nt=10),
        "EdgeStateResult": lambda: mod.EdgeStateResult(
            state=state(), area=1.3, resid=2e-4, drift=np.array([np.nan, 0.5, 0.01]),
            tracked_years=np.array([12, 40, 40]), separation=rng.random(3), converged=True,
            polish_nfev=69, stability=mod.StabilityResult(
                growth=1.4, history=rng.random(5), converged=True, mode=state(), rtol=1e-6,
                side="right"),
            spacetime=st, season="avg", par=par),
    }
