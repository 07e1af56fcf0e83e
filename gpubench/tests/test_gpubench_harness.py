"""CPU tests of the benchmark harness (``gpubench/``): the plain reference
against the port's eager engine, the cells' files found by name, the import
check, the operation counts, the trace reduction, the control and the faults
that must make ``correct`` false. The test marked ``gpu`` runs a short
window of every cell on a card and skips without one."""
from __future__ import annotations

import importlib
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gpubench import run as harness  # noqa: E402
from gpubench.check import mismatch_share, study_mismatch  # noqa: E402
from gpubench.count import year_bytes, year_flops  # noqa: E402
from gpubench.reference import run_years  # noqa: E402
from gpubench.reference.common import Grid  # noqa: E402
from gpubench.trace import Trace  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NEWTON = {"abstol": 0.5, "reltol": 1e-4, "max_step": 50.0, "max_iter": 30}


def _port():
    import energybalancemodel_jl_tpu_torch as ebt

    return ebt


@pytest.mark.parametrize("model", ["MIZ", "Classic"])
def test_reference_is_the_port_eager_year(model):
    """At a tiny grid the reference's float32 stores equal the port's eager
    (scan) engine's, bitwise, over two years."""
    ebt = _port()
    nx, nt, years = 16, 100, 2
    par = dict(ebt.default_parameters(model), D=0.61)
    if model == "MIZ":
        init = {k: np.zeros(nx) for k in ("Ei", "Ew", "h", "D", "phi")}
    else:
        init = {"E": np.full(nx, 30.0), "Tg": np.full(nx, 30.0) / par["cw"]}
    sol = ebt.integrate(model, ebt.SpaceTime.sin(nx, nt, years), ebt.Forcing(0.0), par, init,
                        device="cpu", progress=False, raw_mode="none")
    ref, _ = run_years(model, Grid(nx, nt), par, {k: v[None] for k, v in init.items()}, years,
                       torch.float32, "cpu", NEWTON if model == "MIZ" else None)
    for store in ("winter", "summer", "avg"):
        for k, v in getattr(sol.seasonal, store).items():
            assert np.array_equal(np.asarray(v, dtype=np.float64), ref[store][k][0],
                                  equal_nan=True), (store, k)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import gpubench.reference, gpubench.check, "
            "gpubench.count, gpubench.traffic, gpubench.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    tops = set(eval(out))
    assert not tops & {"energybalancemodel_jl_tpu_torch", "energybalancemodel_jl_tpu", "jax"}
    for path in (ROOT / "gpubench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|energybalancemodel)", text, re.M), path


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = harness.load_cell(cell)
    assert spec["config"]["model"] in ("MIZ", "Classic")
    assert spec["traffic"]["entry"] in ("ensemble_integrate", "integrate", "transitions")
    assert min(spec["limits"].values()) >= 0.0
    moved = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in moved and len(moved) >= 2
    assert spec["per_layer"], "every cell reports a per-layer metric"
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_every_metric_has_a_reader_and_every_config_a_file():
    for m in BENCH["per_layer"]:
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").is_file()
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert json.loads((ROOT / f).read_text())["parameters"]


def test_import_check_compares_top_level_names(monkeypatch):
    _port()
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "energybalancemodel_jl_tpu.ops",
                        types.ModuleType("energybalancemodel_jl_tpu.ops"))
    assert harness.forbidden_modules() == ["energybalancemodel_jl_tpu", "jax"]


# roofline bounds (ms) that the port's kernel table gave for the canonical
# K=8192 years and the K=1 Classic year at nx=32768, counted from the CUDA
# sources (PERF.md, kernel table): cyclic reduction's n log n operations a
# solve. Here the model's equations are counted, each solve as a direct
# one, so the bounds read lower, and the lower the more of a step the
# solve is: Classic's solve is most of its step, the wide grid's most of all
KERNEL_TABLE = {("MIZ", 180, 2000, 8192): 16.1, ("Classic", 180, 2000, 8192): 6.21,
                ("Classic", 32768, 1000, 1): 0.110}


@pytest.mark.parametrize("key", list(KERNEL_TABLE))
def test_counts_at_the_canonical_shapes(key):
    model, nx, nt, K = key
    ebt = _port()
    par = tuple(sorted(ebt.default_parameters(model).items()))
    newton = tuple(sorted(NEWTON.items())) if model == "MIZ" else ()
    per_year, per_update = year_flops(model, nx, nt, par, newton)
    # 1.145 Newton updates per member-step: the canonical year from zero init
    flops = K * (per_year + 1.145 * nt * per_update)
    bound_ms = max(flops / 67e12, year_bytes(model, nx, nt, K, 4) / 3.35e12) * 1e3
    print(f"{model} nx={nx} nt={nt} K={K}: {per_year / nx / nt:.1f} operations per cell-step, "
          f"{per_update / nx:.1f} per cell and Newton update; bound {bound_ms:.4g} ms "
          f"against the kernel table's {KERNEL_TABLE[key]} ms")
    assert {"MIZ": 0.5, "Classic": 0.3 if nx <= 1024 else 0.2}[model] \
        <= bound_ms / KERNEL_TABLE[key] <= 1.0


def test_trace_reduction():
    ms = 1_000_000
    tr = Trace(window=(0, 100 * ms),
               device=[(10 * ms, 40 * ms, "void miz_year_kernel<float>", "kernel"),
                       (30 * ms, 50 * ms, "Memcpy DtoH", "gpu_memcpy"),
                       (70 * ms, 90 * ms, "void miz_year_kernel<float>", "kernel")],
               host=[(0, 100 * ms, "gpubench.window"), (52 * ms, 68 * ms, "aten::to")])
    assert tr.busy() == [[10 * ms, 50 * ms], [70 * ms, 90 * ms]]
    assert tr.busy_s() == pytest.approx(0.06)
    assert tr.kernels("miz_year_kernel") == [pytest.approx(0.03), pytest.approx(0.02)]
    assert tr.idle_gaps()[0] == ["aten::to", pytest.approx(0.02)]
    assert tr.device_ops()[0] == ["void miz_year_kernel<float>", pytest.approx(0.05)]


def test_mismatch_share():
    ref = {s: {"E": np.ones((2, 1, 3)), "Ti": np.array([[[np.nan, 1.0, 2.0]]] * 2)}
           for s in ("winter", "summer", "avg")}
    same = {s: {k: v.copy() for k, v in c.items()} for s, c in ref.items()}
    assert mismatch_share(same, ref) == 0.0
    same["avg"]["Ti"][0, 0, 2] = 2.0 * (1.0 + 0.9e-3)  # within TOL of the scale, 2
    assert mismatch_share(same, ref) == 0.0
    same["avg"]["Ti"][0, 0, 2] = 2.5
    assert mismatch_share(same, ref) == pytest.approx(1 / 36)
    same["avg"]["Ti"][0, 0, 0] = 0.0  # a number where the reference has NaN
    same["winter"]["E"][1, 0, 1] = np.inf
    assert mismatch_share(same, ref) == pytest.approx(3 / 36)


def test_study_mismatch():
    ref = dict(areas=np.ones((2, 3)), labels=np.zeros((2, 3), np.int8), eta=np.ones(3),
               area_ab=np.ones((1, 2)), state={"phi": np.ones((3, 4))})
    got = {k: (dict(v) if isinstance(v, dict) else v.copy()) for k, v in ref.items()}
    assert study_mismatch(got, ref) == 0.0
    got["labels"][1, 2] = 1
    got["state"]["phi"] = got["state"]["phi"] * 1.01
    assert study_mismatch(got, ref) == pytest.approx(13 / 29)


# -- a whole run at a small size on the CPU ------------------------------------

def _tiny_states(forcings):
    """MIZ states at the tiny grid: 3 years of the reference from zero at
    each of ``forcings`` (W/m^2)."""
    from gpubench.reference import run_state

    cfg = json.loads((ROOT / "gpubench" / "configs" / "miz-default.json").read_text())
    fields = ("Ei", "Ew", "h", "D", "phi")
    run = run_state("MIZ", Grid(16, 100), dict(cfg["parameters"], F=np.array(forcings)),
                    {k: np.zeros((len(forcings), 16)) for k in fields}, 3, torch.float32, "cpu",
                    cfg["newton"])
    return [{k: run.state[k][j].tolist() for k in fields} for j in range(len(forcings))]


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout root whose cells are BENCHMARK.json's at a tiny size: the
    grid (16, 100), three members a call, at most two years (the MIZ cells
    one member a call, the sweep through ``integrate``: on the CPU the
    program's plain years run their Newton in lockstep over the members,
    the kernels and the reference member by member)."""
    for sub in ("configs", "traffic", "cells", "data"):
        (tmp_path / "gpubench" / sub).mkdir(parents=True)
    for c in BENCH["configs"]:
        (tmp_path / c["file"]).write_text((ROOT / c["file"]).read_text())
    for w in BENCH["workloads"]:
        t = json.loads((ROOT / "gpubench" / "traffic" / f"{w['traffic']}.json").read_text())
        t.update(nx=16, nt=100, check_rows=3, years=min(t["years"], 2), keep_every=1,
                 members=3 if t["entry"] == "ensemble_integrate" else 1)
        if t["entry"] == "ensemble_integrate" and w["config"].startswith("miz"):
            t.update(entry="integrate", members=1, kwargs={"raw_mode": "none"})
        data = tmp_path / "gpubench" / "data"
        if t["entry"] == "transitions":
            a, b = _tiny_states([15.0, -25.0])
            (data / t["attractors"]).write_text(json.dumps({"states": {"a": a, "b": b}}))
        if "init_state" in t:
            (data / t["init_state"]).write_text(json.dumps({"states": {"spunup": _tiny_states([0.0])[0]}}))
        (tmp_path / "gpubench" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        (tmp_path / "gpubench" / "cells" / f"{w['name']}.json").write_text(
            (ROOT / "gpubench" / "cells" / f"{w['name']}.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    return tmp_path


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tiny_root):
    from gpubench.control import control_gap

    gap, limit, _ = control_gap(cell, 2**31 + 17, "cpu", root=tiny_root)
    assert not gap <= limit, (gap, limit)


def _faulty(year, fault):
    """A whole-year kernel wrapper with one fault planted in it."""
    from energybalancemodel_jl_tpu_torch.solutions import Seasonal

    def run(carry, par, fyear, st, cfg, collect_raw=False, **kw):
        out = year(carry, par, fyear, st, cfg, collect_raw=collect_raw, **kw)
        new, seasonal = out[0], out[1]
        if fault == "state unchanged":
            new = carry
        elif fault == "half the members left out":
            K = next(iter(carry.values())).shape[0]
            half = max(K // 2, 1)
            new = type(new)({k: torch.cat([v[:K - half], carry[k][K - half:]])
                             for k, v in new.items()})
            seasonal = Seasonal(*(type(c)({k: torch.cat([v[:K - half],
                                                         torch.zeros_like(v[K - half:])])
                                           for k, v in c.items()}) for c in seasonal))
        elif fault == "an answer altered":
            def alter(coll):  # member 0, cell 3, every field: by 1%
                out = type(coll)({k: v.clone() for k, v in coll.items()})
                for v in out.values():
                    v[0, 3] = v[0, 3] * 1.01 + 1e-2
                return out

            new = alter(new)
            seasonal = Seasonal(*(alter(c) for c in seasonal))
        return (new, seasonal) + tuple(out[2:])

    return run


@pytest.mark.parametrize("fault", [None, "state unchanged", "half the members left out",
                                   "an answer altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_make_correct_false(cell, fault, tiny_root, monkeypatch):
    """The whole run but the look for a card, at a tiny size on the CPU,
    with the program's whole-year kernel broken underneath: ``correct``
    comes out false for each fault, and true without one. (A cell on one
    chip has no exchange between chips to leave out.)"""
    ebt = _port()
    integ = importlib.import_module("energybalancemodel_jl_tpu_torch.integrate")

    if fault is not None:
        for model, (year, check) in list(integ.FUSED_YEARS.items()):
            monkeypatch.setitem(integ.FUSED_YEARS, model, (_faulty(year, fault), check))
    result = harness.run_cell(cell, 2**31 + 29, 0.0, False, device="cpu", root=tiny_root,
                              program=ebt)
    assert result["correct"] is (fault is None), result["checks"]


def test_benchmark_json_keeps_to_the_contract():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert name.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for text in ([c["source"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and name.match(w["name"]) and name.match(w["traffic"])
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell, card):
    result = harness.run_cell(cell, 2**31 + 41, 1.0, False)
    assert result["correct"], result["checks"]
