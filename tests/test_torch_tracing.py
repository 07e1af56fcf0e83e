"""The PyTorch port's profiler spans (``utils/tracing.py``), on the CPU:
with no profiler ``span()`` is one shared no-op; under ``torch.profiler``
the entry points and the year wrappers give the span tree their docstrings
name (one root a call, one ``ebm.year.*`` per year inside its ``.year``
span, one ``.assemble``, a ``.checkpoint`` per write, the reference years of
a study); the outputs are bitwise those without a profiler; and
``integrate(profile_dir=)`` records the whole call, assembly included, and
stops recording where the call raises.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.models.base import default_step_config
from energybalancemodel_jl_tpu_torch.ops.classic_year import classic_year
from energybalancemodel_jl_tpu_torch.ops.miz_year import miz_year
from energybalancemodel_jl_tpu_torch.utils.tracing import span, traced

torch.set_num_threads(1)
ST = ebt.SpaceTime.sin(8, 50, 2)
YEAR = {"MIZ": "ebm.year.miz", "Classic": "ebm.year.classic"}


def _init(model):
    if model == "MIZ":
        return ebt.zeros_init(ST)
    E = np.full(ST.nx, 30.0)
    return {"E": E, "Tg": E / ebt.default_parameters("Classic")["cw"]}


def _spans(prof):
    """``(start_ns, end_ns, name)`` of the ``ebm.*`` spans a profile holds."""
    return sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
                  for ev in prof.profiler.kineto_results.events()
                  if ev.name().startswith("ebm."))


def _parent(spans, child):
    """The innermost span that holds ``child``, or None."""
    s, e, _ = child
    holders = [sp for sp in spans if sp is not child and sp[0] <= s and e <= sp[1]]
    return min(holders, key=lambda sp: sp[1] - sp[0]) if holders else None


def _tree(spans):
    """name -> list of parent names, one entry per span."""
    out = {}
    for sp in spans:
        parent = _parent(spans, sp)
        out.setdefault(sp[2], []).append(parent[2] if parent else None)
    return out


def _mk(path):
    path.mkdir(parents=True, exist_ok=True)
    return path


def _run(entry, model, tmp_path):
    par = ebt.default_parameters(model)
    common = dict(device="cpu", progress=False)
    if entry == "ensemble_integrate":
        return ebt.ensemble_integrate(model, ST, ebt.Forcing(0.0),
                                      dict(par, D=np.array([0.55, 0.65])), _init(model),
                                      engine="fused", checkpoint=str(tmp_path / "run.h5"),
                                      **common)
    if entry == "integrate":
        return ebt.integrate(model, ST, ebt.Forcing(0.0), par, _init(model), engine="fused",
                             raw_mode="none", checkpoint=str(tmp_path / "run.h5"), **common)
    state = _init(model)
    return ebt.transitions(model, ST, ebt.Forcing(0.0), par, state, state, sigma=1.0,
                           tau=0.05, years=2, K=2, seed=3, engine="fused", **common)


def _arrays(result):
    """Every array of a result, flattened to name -> numpy array."""
    if hasattr(result, "areas"):
        out = {f: np.asarray(getattr(result, f)) for f in ("areas", "labels", "eta",
                                                          "area_a", "area_b")}
        out.update({f"state.{k}": np.asarray(v) for k, v in result.state.items()})
        return out
    return {f"{s}.{k}": np.asarray(v) for s in ("winter", "summer", "avg")
            for k, v in getattr(result.seasonal, s).items()}


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    off = span("ebm.off")
    assert off is span("ebm.other")
    with off, off:  # re-entrant
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = span("ebm.on")
        with on:
            torch.ones(2)
    assert on is not off
    assert [name for _, _, name in _spans(prof)] == ["ebm.on"]
    assert not torch.autograd._profiler_enabled()


def test_traced_keeps_the_wrapper_and_its_counter():
    for fn, name in ((miz_year, "miz_year"), (classic_year, "classic_year")):
        assert fn.__name__ == name and fn.__wrapped__.__name__ == name
        assert isinstance(fn.launches, int)

    @traced("ebm.test")
    def f(x, y=1):
        """doc"""
        return x + y

    assert f(1, y=2) == 3 and f.__doc__ == "doc"


def test_newton_counter_counts_no_plain_year(tmp_path):
    """``miz_year.newton_updates`` is fed by kernel launches given
    ``newton_iters=`` only: an entry point's plain years on the CPU count
    nothing, and the plain version refuses ``newton_iters=``."""
    from energybalancemodel_jl_tpu_torch.ops import miz_year as ops

    assert isinstance(miz_year.newton_updates, int)
    before = miz_year.newton_updates
    for entry in ("integrate", "ensemble_integrate"):
        _run(entry, "MIZ", _mk(tmp_path / entry))
    st = ebt.SpaceTime.sin(16, 20, 1)
    carry = ebt.Collection({k: torch.zeros((2, st.nx), dtype=torch.float64)
                            for k in ops.CARRY_KEYS})
    with pytest.raises(ValueError, match="counted by the kernel only"):
        miz_year(carry, ebt.default_parameters("MIZ"), torch.zeros(st.nt, dtype=torch.float64),
                 st, default_step_config("float64"),
                 newton_iters=torch.zeros(2, dtype=torch.int32))
    assert miz_year.newton_updates == before


@pytest.mark.parametrize("model", ["MIZ", "Classic"])
@pytest.mark.parametrize("entry", ["ensemble_integrate", "integrate", "transitions"])
def test_span_tree_and_bitwise_outputs(entry, model, tmp_path):
    off = _run(entry, model, _mk(tmp_path / "off"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _run(entry, model, _mk(tmp_path / "on"))
    root = f"ebm.{entry}"
    tree = _tree(_spans(prof))
    assert tree[root] == [None]  # one root, the call's
    assert tree[f"{root}.prepare"] == [root]
    assert tree[f"{root}.year"] == [root] * ST.dur
    assert tree[f"{root}.assemble"] == [root]
    year = YEAR[model]
    if entry == "transitions":
        # the two attractors' reference years, inside the prepare phase
        assert tree["ebm.transitions.reference"] == ["ebm.transitions.prepare"]
        assert sorted(tree[year]) == (["ebm.transitions.reference"] * 2
                                      + ["ebm.transitions.year"] * ST.dur)
        assert f"{root}.checkpoint" not in tree
    else:
        assert tree[year] == [f"{root}.year"] * ST.dur
        assert tree[f"{root}.checkpoint"] == [root] * ST.dur
    a, b = _arrays(off), _arrays(on)
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


def test_profile_dir_covers_the_whole_call(tmp_path):
    par = ebt.default_parameters("Classic")
    sol = ebt.integrate("Classic", ST, ebt.Forcing(0.0), par, _init("Classic"),
                        engine="fused", device="cpu", progress=False,
                        profile_dir=str(tmp_path / "prof"))
    assert not torch.autograd._profiler_enabled()
    with open(os.path.join(tmp_path, "prof", "integrate.pt.trace.json")) as fh:
        names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
    for name in ("ebm.integrate", "ebm.integrate.prepare", "ebm.integrate.year",
                 "ebm.year.classic", "ebm.integrate.assemble"):
        assert name in names, name
    assert sol.seasonal.avg["E"].shape == (ST.dur, ST.nx)


def test_profile_dir_stops_recording_where_the_call_raises(tmp_path):
    def debug(out, par):
        raise RuntimeError("a fault in the year loop")

    with pytest.raises(RuntimeError, match="a fault in the year loop"):
        ebt.integrate("MIZ", ST, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                      _init("MIZ"), debug=debug, device="cpu", progress=False,
                      profile_dir=str(tmp_path / "prof"))
    assert not torch.autograd._profiler_enabled()
    assert not os.path.exists(os.path.join(tmp_path, "prof", "integrate.pt.trace.json"))
