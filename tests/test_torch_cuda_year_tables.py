"""The year kernels back to back on a CUDA device: the wrappers' table cache
(``ops/_year.py::year_tables``) and the entry points' device tables of
forcing rows and member keys.

Every test here needs a CUDA device and nvcc; without them each skips (the
kernels have no CPU mode). Run on the card with ``python -m pytest
--noconftest tests/test_torch_cuda_year_tables.py`` (the repo's conftest
imports jax).

- A 3-year ``integrate`` (Classic, nx=8192, float64), a 2-year MIZ
  ``ensemble_integrate`` (K=64) and a 3-year MIZ ``transitions`` (K=64, the
  float32 keys mode) give bit for bit the outputs of the same calls with the
  cache cleared before every year.
- Under ``torch.profiler``, no ``cudaStreamSynchronize`` (nor any other
  synchronisation) and no copy from pageable host memory falls between the
  end of a call's first ``ebm.year.*`` span of its year loop and the end of
  its last: the host enqueues year y+1 while year y runs.
- The MIZ wrapper's counter of the kernel's Newton updates
  (``miz_year.newton_updates``) moves only for a launch given
  ``newton_iters=``, which runs the counting build; an entry point's call
  launches the build without the count, as before, and a counted launch
  gives the same outputs as an uncounted one.
"""
import re

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.integrate import FUSED_YEARS
from energybalancemodel_jl_tpu_torch.models.base import default_step_config
from energybalancemodel_jl_tpu_torch.ops import _year
from energybalancemodel_jl_tpu_torch.ops import miz_year as miz_ops

pytestmark = pytest.mark.gpu

# the runtime calls that wait on the host for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def miz_states(cuda):
    """Two MIZ states a year from zero under forcing 0 and -10."""
    st = ebt.SpaceTime.sin(180, 2000, 1)
    par = ebt.default_parameters("MIZ")
    out = []
    for F in (0.0, -10.0):
        sol = ebt.integrate("MIZ", st, ebt.Forcing(F), par, ebt.zeros_init(st), device=cuda,
                            progress=False)
        out.append({k: np.asarray(sol.raw[k][-1]) for k in ("Ei", "Ew", "h", "D", "phi")})
    return out


def _integrate(cuda, states):
    st = ebt.SpaceTime.sin(8192, 1000, 3)
    E = np.full(st.nx, 30.0)
    par = ebt.default_parameters("Classic")
    sol = ebt.integrate("Classic", st, ebt.Forcing(0.0, 2.0, 1.0, (0, 0), (1.0, -1.0)), par,
                        {"E": E, "Tg": E / par["cw"]}, dtype=torch.float64, device=cuda,
                        progress=False)
    return {**_stores(sol.seasonal), **{f"raw.{k}": v for k, v in sol.raw.items()}}


def _ensemble(cuda, states):
    st = ebt.SpaceTime.sin(180, 2000, 2)
    par = dict(ebt.default_parameters("MIZ"), D=np.linspace(0.5, 0.7, 64))
    return _stores(ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                                          device=cuda, progress=False).seasonal)


def _transitions(cuda, states):
    st = ebt.SpaceTime.sin(180, 2000, 1)
    res = ebt.transitions("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"), *states,
                          sigma=4.0, tau=0.05, K=64, years=3, year0=2, seed=2**31 + 5,
                          device=cuda, progress=False)
    out = {"areas": res.areas, "labels": res.labels, "eta": res.eta,
           "area_a": res.area_a, "area_b": res.area_b}
    out.update({f"state.{k}": v for k, v in res.state.items()})
    out.update({f"tracked.{k}": v for k, v in res.tracked.items()})
    return out


def _stores(seasonal):
    return {f"{s}.{k}": np.asarray(v) for s in ("winter", "summer", "avg")
            for k, v in getattr(seasonal, s).items()}


CALLS = {"integrate": (_integrate, "ebm.integrate.year"),
         "ensemble_integrate": (_ensemble, "ebm.ensemble_integrate.year"),
         "transitions": (_transitions, "ebm.transitions.year")}


@pytest.mark.parametrize("call", list(CALLS))
def test_cached_tables_give_the_uncached_outputs_bit_for_bit(call, cuda, miz_states,
                                                             monkeypatch):
    run = CALLS[call][0]
    run(cuda, miz_states)  # the cache holds the grid's entry from here on
    b0, h0 = _year.year_tables.builds, _year.year_tables.hits
    cached = run(cuda, miz_states)
    assert _year.year_tables.builds == b0 and _year.year_tables.hits > h0
    for model, (year, check) in list(FUSED_YEARS.items()):
        def cleared(*args, _year_fn=year, **kwargs):
            _year.clear_year_tables()
            return _year_fn(*args, **kwargs)

        monkeypatch.setitem(FUSED_YEARS, model, (cleared, check))
    b0 = _year.year_tables.builds
    fresh = run(cuda, miz_states)
    assert _year.year_tables.builds > b0
    assert cached.keys() == fresh.keys()
    for k in cached:
        np.testing.assert_array_equal(cached[k], fresh[k], err_msg=k)


def _kind(ev) -> str:
    """A profiler event's activity kind: ``activity_type()`` where this
    PyTorch has it, else from its device and name."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    name, annotation = ev.name(), ev.is_user_annotation()
    if ev.device_type() == DeviceType.CUDA:
        return ("gpu_user_annotation" if annotation else
                "gpu_memcpy" if name.startswith("Memcpy") else "kernel")
    return ("user_annotation" if annotation else
            "cuda_runtime" if name.startswith("cuda") else "cpu_op")


def _ids(ev) -> set:
    """The correlation ids an event carries (0 is none)."""
    return {getattr(ev, f, lambda: 0)() for f in ("correlation_id", "linked_correlation_id")}


def _window(events, loop_span):
    """``(start_ns, end_ns)`` from the end of the first ``ebm.year.*`` span
    inside the call's year loop (``loop_span``) to the end of the last."""
    host = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()) for ev in events
            if _kind(ev) == "user_annotation"]
    loops = [(s, e) for s, e, n in host if n == loop_span]
    years = sorted((s, e) for s, e, n in host if n.startswith("ebm.year.")
                   and any(ls <= s and e <= le for ls, le in loops))
    assert len(years) >= 2, f"{len(years)} year spans in {loop_span!r}"
    return years[0][1], years[-1][1]


@pytest.mark.parametrize("call", list(CALLS))
def test_no_host_wait_between_year_launches(call, cuda, miz_states):
    run, loop_span = CALLS[call]
    run(cuda, miz_states)  # builds the kernels and the cache's entry
    torch.cuda.synchronize(cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(cuda, miz_states)
        torch.cuda.synchronize(cuda)
    events = list(prof.profiler.kineto_results.events())
    lo, hi = _window(events, loop_span)
    pageable = set()
    for ev in events:
        if _kind(ev) == "gpu_memcpy" and "Pageable" in ev.name():
            pageable |= _ids(ev) - {0}
    runtime = [ev for ev in events if _kind(ev) == "cuda_runtime"]
    copies = [ev for ev in runtime
              if ev.name().startswith("cudaMemcpy") and _ids(ev) & pageable]
    # the call's set-up copies the carry from pageable memory: the trace
    # links those copies to their runtime calls
    assert copies and any(ev.start_ns() < lo for ev in copies)
    inside = lambda ev: lo <= ev.start_ns() <= hi
    assert [ev.name() for ev in copies if inside(ev)] == []
    assert [ev.name() for ev in runtime if ev.name() in SYNCS and inside(ev)] == []


def _count_builds(prof) -> list:
    """Per MIZ year-kernel launch in the trace, whether it ran the counting
    build (the template's last flag, ``COUNT``)."""
    names = [ev.name() for ev in prof.profiler.kineto_results.events()
             if _kind(ev) == "kernel" and "miz_year_kernel" in ev.name()]
    flags = [re.search(r"miz_year_kernel<\w+, \d+, \d+, (?:true|false), (true|false)>", n)
             for n in names]
    assert all(flags), names
    return [f.group(1) == "true" for f in flags]


def test_newton_counter_moves_only_for_counted_launches(cuda):
    st = ebt.SpaceTime.sin(180, 2000, 2)
    ebt.integrate("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                  ebt.zeros_init(st), dtype=torch.float64, device=cuda, progress=False,
                  raw_mode="none")  # builds the kernels
    torch.cuda.synchronize(cuda)
    n0 = miz_ops.miz_year.newton_updates
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ebt.integrate("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                      ebt.zeros_init(st), dtype=torch.float64, device=cuda, progress=False,
                      raw_mode="none")
        torch.cuda.synchronize(cuda)
    assert miz_ops.miz_year.newton_updates == n0
    assert _count_builds(prof) == [False, False]
    # a caller's own newton_iters= runs the counting build and feeds the
    # counter by its sum; the year's outputs are those of an uncounted launch
    K, st1 = 3, ebt.SpaceTime.sin(180, 2000, 1)
    par = dict(ebt.default_parameters("MIZ"), D=np.array([0.55, 0.6, 0.65]))
    carry = ebt.Collection({k: torch.zeros((K, st1.nx), dtype=torch.float64, device=cuda)
                            for k in miz_ops.CARRY_KEYS})
    f = torch.zeros(st1.nt, dtype=torch.float64, device=cuda)
    cfg = default_step_config("float64")
    plain = miz_ops.miz_year(carry, par, f, st1, cfg)
    iters = torch.zeros(K, dtype=torch.int32, device=cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        counted = miz_ops.miz_year(carry, par, f, st1, cfg, newton_iters=iters)
        torch.cuda.synchronize(cuda)
    assert _count_builds(prof) == [True]
    assert int(iters.min()) >= st1.nt  # at least one update a step
    assert miz_ops.miz_year.newton_updates == n0 + int(iters.sum())
    for a, b in [(plain[0], counted[0])] + list(zip(plain[1], counted[1])):
        for k in a:
            assert torch.equal(torch.nan_to_num(a[k]), torch.nan_to_num(b[k])), k
            assert torch.equal(torch.isnan(a[k]), torch.isnan(b[k])), k
