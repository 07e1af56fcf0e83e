"""The one generator of the benchmark's traffic: it reads a configuration
file (the model, its parameters, dtype and initial state) and a traffic file
(the entry point, grid, years, members and what each call draws), and makes
each call's inputs from the seed.

Call ``i`` of a run with seed ``s`` draws from a ``SeedSequence`` of ``s``
and ``i``, so the same seed gives the same inputs, and every seed the same
sizes and the same number of members a call. The program is called through
its public entry points only."""
from __future__ import annotations

import contextlib
import json
from pathlib import Path

import numpy as np
import torch

from .check import mismatch_share, study_mismatch
from .reference import STORES, prng, run_state
from .reference.common import Grid, separate_roundings

WARM = -1  # the index of the set-up's warm call


def _rng(seed: int, i: int, tag: int = 0):
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, tag, i + 1]))


def _data(root, name: str) -> dict:
    """A data file of the traffic, ``gpubench/data/<name>`` in the checkout."""
    return json.loads((Path(root) / "gpubench" / "data" / name).read_text())


class Workload:
    """Sweeps and single runs (``ensemble_integrate``, ``integrate``): each
    call's drawn parameters, the program's call, the rows kept for the check
    and the check itself, whose number is the :func:`.check.mismatch_share`
    of the sampled rows' seasonal stores."""

    CHECK = "mismatch_share"

    def __init__(self, config: dict, traffic: dict, seed: int, device, root=None):
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.root = root
        self.keep_phase = int(_rng(self.seed, 0, tag=4).integers(2**31))
        self.model = config["model"]
        self.dtype = config["dtype"]
        self.K = int(traffic["members"])
        self.years = int(traffic["years"])
        self.grid = Grid(int(traffic["nx"]), int(traffic["nt"]))
        self.entry = traffic["entry"]
        if self.entry not in ("ensemble_integrate", "integrate", "transitions"):
            raise ValueError(f"unknown entry point {self.entry!r}")
        if self.entry == "integrate" and self.K != 1:
            raise ValueError("the entry 'integrate' runs one member a call")
        self.start = None  # a spun-up state every call starts from, or the config's init
        if "init_state" in traffic:  # a data file that holds one state
            (state,) = _data(root, traffic["init_state"])["states"].values()
            self.start = {k: np.asarray(v, dtype=np.float64) for k, v in state.items()}

    @property
    def member_years_per_call(self) -> int:
        return self.K * self.years

    @property
    def kernel_pattern(self) -> str:
        """The names of the year-kernel launches that do the cell's work."""
        return self.traffic.get("kernels", self.config["kernels"])

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)

    def draws(self, i: int) -> dict:
        """Call ``i``'s drawn parameters: name -> ``(K,)`` float64."""
        rng = _rng(self.seed, i)
        return {name: rng.uniform(lo, hi, self.K)
                for name, (lo, hi) in sorted(self.traffic["draw"].items())}

    def init(self, par: dict) -> dict:
        """The initial state, ``(nx,)`` float64 per field: the traffic's
        ``init_state`` file where it names one, else the configured one, a
        constant or ``"A/p"`` (field A divided by parameter p) per field."""
        if self.start is not None:
            return {k: v.copy() for k, v in self.start.items()}
        nx = self.grid.nx
        out = {}
        for name, rule in self.config["init"].items():
            if isinstance(rule, str):
                field, p = rule.split("/")
                out[name] = out[field] / float(par[p])
            else:
                out[name] = np.full(nx, float(rule))
        return out

    def call(self, ebt, i: int):
        """Run call ``i`` through the program's entry point; returns its
        seasonal stores, ``store -> var -> (K, years, nx)``."""
        par = dict(self.config["parameters"])
        drawn = self.draws(i)
        par.update(drawn if self.entry == "ensemble_integrate"
                   else {k: float(v[0]) for k, v in drawn.items()})
        st = ebt.SpaceTime.sin(self.grid.nx, self.grid.nt, self.years)
        common = dict(dtype=self.dtype, device=self.device, solver=self.config["solver"],
                      engine=self.config["engine"], progress=False,
                      newton_max_iter=int(self.config.get("newton", {}).get("max_iter", 30)),
                      **self.traffic.get("kwargs", {}))
        fn = getattr(ebt, self.entry)
        res = fn(self.model, st, ebt.Forcing(float(self.traffic["forcing"])), par,
                 self.init(par), **common)
        stores = {s: getattr(res.seasonal, s) for s in STORES}
        if self.entry == "integrate":
            stores = {s: {k: np.asarray(v)[None] for k, v in c.items()} for s, c in stores.items()}
        return stores

    def check_members(self, i: int):
        """The members of call ``i`` whose stores are kept for the check."""
        n = min(int(self.traffic["check_rows"]), self.K)
        return np.sort(_rng(self.seed, i, tag=1).choice(self.K, n, replace=False))

    def kept(self, i: int) -> bool:
        """Whether call ``i``'s rows are kept for the check: every
        ``keep_every``-th call of the traffic, from a phase drawn from the
        seed (copying a call's rows costs the window a few milliseconds,
        which a wide row makes a share of a short call). The run keeps its
        last call too where it kept none before."""
        every = int(self.traffic.get("keep_every", 1))
        return i % every == self.keep_phase % every

    def keep(self, stores, i: int) -> dict:
        """Call ``i``'s checked rows: their drawn parameters and stores."""
        m = self.check_members(i)
        return dict(call=i, members=m,
                    draws={k: v[m] for k, v in self.draws(i).items()},
                    stores={s: {k: np.array(np.asarray(v)[m]) for k, v in c.items()}
                            for s, c in stores.items()})

    def sample(self, kept: list) -> list:
        """``check_rows`` of the kept rows, drawn from the seed: ``(call,
        row)`` pairs."""
        pairs = [(c, r) for c, k in enumerate(kept) for r in range(len(k["members"]))]
        n = min(int(self.traffic["check_rows"]), len(pairs))
        pick = _rng(self.seed, 0, tag=2).choice(len(pairs), n, replace=False)
        return [pairs[j] for j in sorted(pick)]

    def check(self, kept: list):
        """Recompute the sampled rows with the plain reference on this
        workload's device; returns ``(the share of values that disagree,
        rows, Newton updates)``."""
        pairs = self.sample(kept)
        par, init, got = self.reference_inputs(kept, pairs)
        run = run_state(self.model, self.grid, par, init, self.years, self.torch_dtype,
                        self.device, self.config.get("newton"), float(self.traffic["forcing"]))
        return mismatch_share(got, run.stores), len(pairs), run.updates

    def control(self, dtype, fused: bool = True) -> float:
        """The share of values that disagree when the first call's checked
        members are computed by the reference in ``dtype`` (``fused`` False:
        every fused multiply-add rounded twice), against the same members
        as configured."""
        m = self.check_members(0)
        par = dict(self.config["parameters"])
        par.update({k: v[m] for k, v in self.draws(0).items()})
        rows = [self.init({**par, **{k: par[k][j] for k in self.traffic["draw"]}})
                for j in range(len(m))]
        init = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        out = []
        for dt, fuse in ((dtype, fused), (self.torch_dtype, True)):
            with contextlib.nullcontext() if fuse else separate_roundings():
                out.append(run_state(self.model, self.grid, par, init, self.years, dt,
                                     self.device, self.config.get("newton"),
                                     float(self.traffic["forcing"])).stores)
        return mismatch_share(*out)

    def reference_inputs(self, kept: list, pairs: list):
        """The parameters (scalars and per-row values) and initial states
        ``(rows, nx)`` of the sampled rows, made by the benchmark as it made
        them for the program."""
        par = dict(self.config["parameters"])
        for name in self.traffic["draw"]:
            par[name] = np.array([kept[c]["draws"][name][r] for c, r in pairs])
        rows = [self.init({**par, **{n: par[n][j] for n in self.traffic["draw"]}})
                for j in range(len(pairs))]
        init = {k: np.stack([row[k] for row in rows]) for k in rows[0]}
        program = {s: {k: np.stack([kept[c]["stores"][s][k][r] for c, r in pairs])
                       for k in kept[0]["stores"][s]} for s in STORES}
        return par, init, program


def study_seed(seed: int, i: int) -> int:
    """The 64-bit weather seed of study ``i`` of a run with seed ``seed``."""
    return int(np.random.SeedSequence([seed % 2**64, 3, i + 1]).generate_state(1, np.uint64)[0])


class Transitions(Workload):
    """Escape-rate studies (``transitions``): each call ``K`` members from
    attractor ``a`` under Ornstein-Uhlenbeck weather of stationary standard
    deviation ``sigma`` and correlation time ``tau``, for ``years`` years,
    classified each year against the areas of ``a`` and ``b``, whose states
    are read from the traffic's data file; study ``i`` draws its weather
    from :func:`study_seed`."""

    CHECK = "study_mismatch"
    FIELDS = ("Ei", "Ew", "h", "D", "phi")

    def __init__(self, config, traffic, seed, device, root):
        super().__init__(config, traffic, seed, device, root)
        data = _data(root, traffic["attractors"])
        self.states = {name: {k: np.asarray(v, dtype=np.float64) for k, v in st.items()}
                       for name, st in data["states"].items()}

    def call(self, ebt, i: int):
        st = ebt.SpaceTime.sin(self.grid.nx, self.grid.nt, 1)
        res = ebt.transitions(
            self.model, st, ebt.Forcing(float(self.traffic["forcing"])),
            dict(self.config["parameters"]), self.states["a"], self.states["b"],
            sigma=float(self.traffic["sigma"]), tau=float(self.traffic["tau"]), years=self.years,
            K=self.K, start="a", seed=study_seed(self.seed, i), dtype=self.dtype,
            device=self.device, engine=self.config["engine"], progress=False,
            newton_max_iter=int(self.config["newton"]["max_iter"]),
            **self.traffic.get("kwargs", {}))
        return res

    def keep(self, res, i: int) -> dict:
        m = self.check_members(i)
        return dict(call=i, members=m, seed=study_seed(self.seed, i),
                    areas=np.array(res.areas[:, m]), labels=np.array(res.labels[:, m]),
                    eta=np.array(res.eta[m]),
                    state={k: np.array(np.asarray(v)[m]) for k, v in res.state.items()},
                    area_a=np.asarray(res.area_a, dtype=np.float64),
                    area_b=np.asarray(res.area_b, dtype=np.float64))

    def _areas(self, phi_avg, dtype):
        """A year's ice area of each member as the program classifies it: in
        the run's dtype on the device, ``2 pi`` times the trapezoid mean of
        ``phi`` (NaN as 0) over the grid."""
        v = torch.nan_to_num(torch.as_tensor(phi_avg, dtype=dtype, device=self.device))
        x = torch.as_tensor(self.grid.x, dtype=dtype, device=self.device)
        return (2.0 * np.pi * torch.sum((v[..., :-1] + v[..., 1:]) * (x[1:] - x[:-1]) / 2.0,
                                        dim=-1)).double().cpu().numpy()

    def _study(self, keys, dtype) -> dict:
        """The plain reference's study of the members whose weather keys are
        ``keys`` (``(rows, 2)`` uint32), in ``dtype``: their yearly areas and
        labels, last weather value and final state, the attractors'
        reference areas, and the Newton updates the members made."""
        par = dict(self.config["parameters"])
        newton, forcing = self.config["newton"], float(self.traffic["forcing"])
        # the attractors' reference areas: one deterministic year of each, the
        # area of its annual mean in float64 on the host
        ab = {k: np.stack([self.states["a"][k], self.states["b"][k]]) for k in self.FIELDS}
        ref = run_state(self.model, self.grid, par, ab, 1, dtype, self.device, newton, forcing)
        phi = np.nan_to_num(ref.stores["avg"]["phi"][:, 0])
        x = self.grid.x
        area_ab = 2.0 * np.pi * np.sum((phi[:, :-1] + phi[:, 1:]) * (x[1:] - x[:-1]) / 2.0,
                                       axis=-1)
        rho = float(np.exp(-self.grid.dt / float(self.traffic["tau"])))
        scale = float(self.traffic["sigma"]) * float(np.sqrt(max(0.0, 1.0 - rho * rho)))
        init = {k: np.repeat(self.states["a"][k][None], len(keys), axis=0) for k in self.FIELDS}
        run = run_state(self.model, self.grid, par, init, self.years, dtype, self.device, newton,
                        forcing, weather=dict(keys=keys, year0=0, rho=rho, scale=scale))
        areas = self._areas(run.stores["avg"]["phi"].transpose(1, 0, 2), dtype)
        d_a, d_b = np.abs(areas - area_ab[0]), np.abs(areas - area_ab[1])
        labels = np.where(np.isfinite(areas), (d_b < d_a).astype(np.int8), np.int8(-1))
        return dict(areas=areas, labels=labels, eta=run.eta, state=run.state, area_ab=area_ab,
                    updates=run.updates)

    def check(self, kept: list):
        pairs = self.sample(kept)
        keys = np.stack([prng.fold_in(prng.prng_key(kept[c]["seed"]), kept[c]["members"][r])
                         for c, r in pairs])
        want = self._study(keys, self.torch_dtype)
        got = dict(areas=np.stack([kept[c]["areas"][:, r] for c, r in pairs], axis=1),
                   labels=np.stack([kept[c]["labels"][:, r] for c, r in pairs], axis=1),
                   eta=np.array([kept[c]["eta"][r] for c, r in pairs]),
                   state={k: np.stack([kept[c]["state"][k][r] for c, r in pairs])
                          for k in want["state"]},
                   area_ab=np.stack([np.concatenate([k["area_a"], k["area_b"]])
                                     for k in kept]))
        want["area_ab"] = np.repeat(want["area_ab"][None], len(kept), axis=0)
        return study_mismatch(got, want), len(pairs), want["updates"]

    def control(self, dtype, fused: bool = True) -> float:
        """The share of values that disagree when the study of the first
        call's checked members is computed in ``dtype`` (``fused``: as
        :meth:`Workload.control`), against the same study as configured."""
        keys = prng.fold_in(prng.prng_key(study_seed(self.seed, 0)), self.check_members(0))
        with contextlib.nullcontext() if fused else separate_roundings():
            got = self._study(keys, dtype)
        return study_mismatch(got, self._study(keys, self.torch_dtype))


def workload(config: dict, traffic: dict, seed: int, device, root) -> Workload:
    """The generator of a traffic file's entry point (``root``: the
    checkout, whose ``gpubench/data`` holds the traffic's data files)."""
    cls = Transitions if traffic["entry"] == "transitions" else Workload
    return cls(config, traffic, seed, device, root)
