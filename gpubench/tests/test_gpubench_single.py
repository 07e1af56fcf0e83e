"""CPU tests of the float64 MIZ single-run cell ``miz-single-k1`` and its
configuration ``miz-f64``: the files found by name and holding the
upstream's headline run, the written Newton settings giving the run the port
makes, and a whole run of the cell at a tiny size."""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gpubench import run as harness  # noqa: E402
from gpubench.reference import run_state  # noqa: E402
from gpubench.reference.common import Grid  # noqa: E402

CELL = "miz-single-k1"
METRICS = {"kernel_ms.single", "miz_year_roofline.single", "mfu.single", "idle_share.single"}


def _json(rel: str) -> dict:
    return json.loads((ROOT / "gpubench" / rel).read_text())


def test_config_is_the_sweep_config_in_float64():
    """``miz-f64`` is ``miz-default`` in float64 with the port's float64
    Newton defaults: the same parameters, zero initial state, engine and
    solver."""
    f64, f32 = _json("configs/miz-f64.json"), _json("configs/miz-default.json")
    from energybalancemodel_jl_tpu_torch.models.base import default_step_config

    step = default_step_config("float64")
    assert f64["dtype"] == "float64" and f64["reduced"] == []
    for key in ("model", "engine", "solver", "parameters", "init"):
        assert f64[key] == f32[key], key
    assert set(f64["init"].values()) == {0.0}
    newton = f64["newton"]
    assert (newton["abstol"], newton["reltol"]) == (step.newton_abstol, step.newton_reltol)
    assert step.newton_max_step is None and newton["max_step"] >= 1e30  # no cap
    assert newton["max_iter"] == 30


def test_traffic_is_the_headline_run():
    t = _json("traffic/single-180-30y.json")
    assert (t["entry"], t["nx"], t["nt"], t["years"], t["members"]) == (
        "integrate", 180, 2000, 30, 1)
    assert t["draw"] == {"D": [0.55, 0.65]} and t["forcing"] == 0.0
    assert t["kwargs"] == {"raw_mode": "none"}
    assert (t["check_rows"], t["keep_every"]) == (4, 4)


def test_cell_loads_with_its_metrics():
    spec = harness.load_cell(CELL)
    assert spec["cell"]["chips"] == 1 and spec["cell"]["config"] == "miz-f64"
    assert {m["name"] for m in spec["end_to_end"]} == {"year_ms", "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == METRICS
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"])) and m["moves"] == "year_ms"
    assert set(spec["limits"]) == {"mismatch_share"}


def test_written_step_cap_is_no_cap():
    """The configuration writes "no step cap" as a finite number (plain JSON,
    within float32's range for the control): from zero, the reference in
    float64 runs bitwise as it does without a cap."""
    newton = _json("configs/miz-f64.json")["newton"]
    par = dict(_json("configs/miz-f64.json")["parameters"], D=0.61)
    init = {k: np.zeros((1, 16)) for k in ("Ei", "Ew", "h", "D", "phi")}
    runs = [run_state("MIZ", Grid(16, 100), par, init, 2, torch.float64, "cpu",
                      dict(newton, max_step=cap)) for cap in (newton["max_step"], math.inf)]
    assert runs[0].updates == runs[1].updates > 0
    for s, c in runs[1].stores.items():
        for k, v in c.items():
            assert np.array_equal(runs[0].stores[s][k], v, equal_nan=True), (s, k)


def test_cell_runs_whole_at_a_tiny_size(tmp_path):
    """The whole run but the look for a card, at ``sin(16, 100, 3)`` on the
    CPU, keeping every call: the check passes with the stores equal."""
    import energybalancemodel_jl_tpu_torch as ebt

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = next(c for c in bench["configs"] if c["name"] == "miz-f64")
    for sub in ("configs", "traffic", "cells"):
        (tmp_path / "gpubench" / sub).mkdir(parents=True)
    (tmp_path / cfg["file"]).write_text((ROOT / cfg["file"]).read_text())
    t = dict(_json("traffic/single-180-30y.json"), nx=16, nt=100, years=3, keep_every=1,
             check_rows=2)
    (tmp_path / "gpubench" / "traffic" / "single-180-30y.json").write_text(json.dumps(t))
    (tmp_path / "gpubench" / "cells" / f"{CELL}.json").write_text(
        (ROOT / "gpubench" / "cells" / f"{CELL}.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result = harness.run_cell(CELL, 2**33 + 5, 0.0, False, device="cpu", root=tmp_path,
                              program=ebt)
    assert result["correct"] and result["checks"]["mismatch_share"]["value"] == 0.0, result
    assert set(result["metrics"]) == {"year_ms", "setup_s"}
