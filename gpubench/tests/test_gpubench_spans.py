"""CPU tests of the readers of the program's spans (``gpubench/spans.py``):
their arithmetic on a synthetic trace that holds both the host-side and the
device-side copies of the ``ebm.*`` annotations, and their files found by
name. The test marked ``gpu`` makes a one-second traced run of every cell on
a card and skips without one."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gpubench import run as harness  # noqa: E402
from gpubench import spans  # noqa: E402
from gpubench.layer import Context  # noqa: E402
from gpubench.trace import Trace  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
READERS = {"wrapper_idle_ms": spans.wrapper_idle_ms, "entry_idle_ms": spans.entry_idle_ms,
           "assemble_ms": spans.assemble_ms, "reference_share": spans.reference_share}
NEW = [m for m in BENCH["per_layer"] if m["name"].split(".")[0] in READERS]
MS = 1_000_000
KERNEL = "void miz_year_kernel<float>"

# two calls in a 100 ms window (times in ms): an ensemble call of two years,
# then a study with a reference year, one year, and its assembly
HOST = [
    ("ebm.ensemble_integrate", 2, 48), ("ebm.ensemble_integrate.prepare", 2, 5),
    ("ebm.ensemble_integrate.year", 5, 20), ("ebm.year.miz", 6, 12),
    ("ebm.ensemble_integrate.year", 20, 35), ("ebm.year.miz", 21, 27),
    ("ebm.ensemble_integrate.assemble", 35, 48),
    ("ebm.transitions", 50, 98), ("ebm.transitions.prepare", 50, 60),
    ("ebm.transitions.reference", 52, 58), ("ebm.year.miz", 53, 55),
    ("ebm.transitions.year", 60, 80), ("ebm.year.miz", 61, 66),
    ("ebm.transitions.assemble", 80, 98),
    ("gpubench.call", 1, 49), ("gpubench.call", 49, 99), ("aten::copy_", 41, 46),
]
DEVICE = [
    (8, 9, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"), (10, 30, KERNEL, "kernel"),
    (30, 31, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"), (31, 40, KERNEL, "kernel"),
    (41, 46, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy"),
    (54, 56, KERNEL, "kernel"), (65, 85, KERNEL, "kernel"),
    (86, 90, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy"),
]
# the profiler's device-side copies: each annotation that launched device
# work, from its first device operation's start to its last one's end
DEVICE_SIDE = [
    ("ebm.ensemble_integrate", 8, 46), ("ebm.ensemble_integrate.year", 8, 30),
    ("ebm.year.miz", 8, 30), ("ebm.ensemble_integrate.year", 30, 40),
    ("ebm.year.miz", 30, 40), ("ebm.ensemble_integrate.assemble", 41, 46),
    ("ebm.transitions", 54, 90), ("ebm.transitions.prepare", 54, 56),
    ("ebm.transitions.reference", 54, 56), ("ebm.year.miz", 54, 56),
    ("ebm.transitions.year", 65, 85), ("ebm.year.miz", 65, 85),
    ("ebm.transitions.assemble", 86, 90),
]
# by hand: busy [8,9] [10,40] [41,46] [54,56] [65,85] [86,90], 62 of 100 ms.
# Year spans idle 3 + 0 + 1 + 4 ms; calls idle 10 and 22 ms; last year
# kernels end at 40 and 85, assemblies at 48 and 98; references 6 ms
EXPECTED = {"wrapper_idle_ms": 8 / 4, "entry_idle_ms": ((10 - 3) + (22 - 5)) / 2,
            "assemble_ms": (8 + 13) / 2, "reference_share": 6.0}


def _trace(device_side=DEVICE_SIDE, shift=0):
    host = [(s * MS, e * MS, n) for n, s, e in HOST]
    host += [(s * MS, e * MS + shift, n) for n, s, e in device_side]
    host.insert(0, (0, 100 * MS, "gpubench.window"))
    return Trace(window=(0, 100 * MS),
                 device=[(s * MS, e * MS, n, k) for s, e, n, k in DEVICE], host=host)


def _ctx(trace):
    return Context(trace=trace, kernel_pattern="miz_year_kernel", member_year_flops=1.0,
                   launch_members=1, itemsize_bytes_per_launch=1, window_s=0.1,
                   member_years=1.0, flops_peak=None, bytes_peak=None)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_arithmetic(metric):
    read = READERS[metric]
    assert read(_ctx(_trace())) == pytest.approx(EXPECTED[metric])
    # the same without the device-side copies: they are never counted
    assert read(_ctx(_trace(device_side=[]))) == pytest.approx(EXPECTED[metric])


def test_device_side_copies_would_move_the_readings():
    """Copies a nanosecond off the device's edges read as host spans, and
    then the readings move: the rule is what keeps them out."""
    moved = {m: READERS[m](_ctx(_trace(shift=1))) for m in READERS}
    for m in ("wrapper_idle_ms", "assemble_ms"):
        assert moved[m] != pytest.approx(EXPECTED[m]), m


def test_idle_parts_fit_in_the_window_idle():
    tr = _trace()
    ctx = _ctx(tr)
    calls, launches = 2, 4
    idle_ms = (tr.window_s - tr.busy_s()) * 1e3
    assert (spans.wrapper_idle_ms(ctx) * launches + spans.entry_idle_ms(ctx) * calls
            <= idle_ms + 1e-9)


def test_host_spans_keep_the_host_copies():
    got = spans.host_spans(_trace(), lambda name: name.startswith(spans.YEAR))
    assert [(s // MS, e // MS) for s, e, _ in got] == [(6, 12), (21, 27), (53, 55), (61, 66)]


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_program_without_spans_reads_nothing(metric):
    """A program without the spans, as the parent of the change that added
    them: every reader returns None and does not raise."""
    tr = Trace(window=(0, 100 * MS), device=[(s * MS, e * MS, n, k) for s, e, n, k in DEVICE],
               host=[(0, 100 * MS, "gpubench.window"), (1 * MS, 49 * MS, "gpubench.call")])
    assert READERS[metric](_ctx(tr)) is None


def test_new_metrics_found_by_name():
    assert len(NEW) == 10
    for m in NEW:
        assert callable(harness.reader(m["name"]))
        assert m["source"] == "device_trace" and m["workloads"]
        for cell in m["workloads"]:
            names = [p["name"] for p in harness.load_cell(cell)["per_layer"]]
            assert m["name"] in names, (cell, m["name"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_span_metrics(cell, card):
    result = harness.run_cell(cell, 2**31 + 43, 1.0, True)
    want = {m["name"] for m in NEW if cell in m["workloads"]}
    got = {k: v["value"] for k, v in result["metrics"].items() if k in want}
    print(cell, json.dumps(got), result["device"], flush=True)
    assert set(got) == want and all(v is not None for v in got.values()), got
    assert result["correct"], result["checks"]
