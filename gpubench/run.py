"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration file, its traffic file (``gpubench/traffic/<traffic>.json``),
its limits (``gpubench/cells/<cell>.json``) and its per-layer metrics'
readers (``gpubench/metrics/<metric>.py``) are found by name. Set-up
(imports, the CUDA context, library load, inputs, one warm call) is timed
as ``setup_s``, its parts printed on standard error; then
calls run back to back until the first one that completes after
``--seconds``. After the window the program's stores of a sample of the
checked members are compared with the plain reference (``reference/``),
recomputed on the card, and the last line of standard output is one JSON
object. With ``--trace 1`` the window runs under ``torch.profiler`` and the
line holds the per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PROGRAM = "energybalancemodel_jl_tpu_torch"
# top-level module names the measured process may not hold (the JAX package
# is the port's test reference, never part of the measured program)
FORBIDDEN = ("jax", "jaxlib", "flax", "energybalancemodel_jl_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds, compared
    whole: ``energybalancemodel_jl_tpu_torch`` is not
    ``energybalancemodel_jl_tpu``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``, with its configuration,
    traffic and limits files read, and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def reported(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if reported(m)]
    moved = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if m["moves"] in moved and reported(m)]
    return dict(
        cell=cell,
        config=load_json(root / cfg_entry["file"]),
        traffic=load_json(root / HERE.name / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(root / HERE.name / "cells" / f"{name}.json")["limits"],
        end_to_end=e2e,
        per_layer=layers,
    )


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peaks_for(kind: str, dtype: str):
    """``(flops/s, bytes/s, int32 ops/s)`` of the device named ``kind`` for
    ``dtype`` from ``peaks.json``, or Nones for a device not in it."""
    table = load_json(HERE / "peaks.json")["devices"]
    row = table.get(kind)
    if row is None:
        return None, None, None
    return row["flops"].get(dtype), row["bytes_per_s"], row.get("int32_ops_per_s")


def steady_allocator() -> None:
    """Fix glibc's allocation thresholds for this process. The entry points
    return their results as fresh numpy arrays of a few to tens of MB each
    call; by default glibc moves its mmap threshold as such blocks are
    freed, so whether a call's arrays land in pages already mapped (or in
    new ones the kernel must fault in and zero) differs from process to
    process. Fixed thresholds give every run the same policy."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    m_trim_threshold, m_mmap_threshold = -1, -3
    libc.mallopt(m_mmap_threshold, 32 * 2**20)
    libc.mallopt(m_trim_threshold, 2**30)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = ROOT, program=None, torch_s: float = 0.0) -> dict:
    """One run of cell ``name``; returns the result line's object. ``device``
    and ``program`` (the imported package) exist for the CPU tests, which
    drive the whole run at a small size without a card. ``torch_s``: the
    seconds from the start to ``import torch`` done, where the caller
    imported it."""
    import numpy as np
    import torch

    from gpubench.traffic import WARM, workload

    spec = load_cell(name, root)
    cfg, traffic = spec["config"], spec["traffic"]
    on_card = device.startswith("cuda")
    parts = {"torch": torch_s}
    if program is None:
        program = importlib.import_module(PROGRAM)
    t = time.perf_counter()
    parts["imports"] = t - T_START - torch_s  # the port and the harness's modules
    if on_card:
        torch.zeros(1, device=device)  # the CUDA context
        torch.cuda.synchronize()
        parts["context"] = time.perf_counter() - t
        t = time.perf_counter()
        try:
            build = importlib.import_module(f"{PROGRAM}.ops._build")
            build.load_library()
        except (ImportError, AttributeError):
            pass  # then the warm call builds
    t1 = time.perf_counter()
    parts["library"] = t1 - t
    wl = workload(cfg, traffic, seed, device, root)
    wl.draws(WARM)
    t2 = time.perf_counter()
    parts["inputs"] = t2 - t1
    wl.call(program, WARM)
    if on_card:
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    parts["warm_call"] = t3 - t2
    setup_s = t3 - T_START
    say("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + f", setup_s {setup_s:.3f} s")

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    from torch.profiler import record_function

    from gpubench.trace import CALL, KEEP, WINDOW

    kept, attempted, failed, durations = [], 0, 0, []
    t0 = time.perf_counter()
    with record_function(WINDOW):
        while True:
            i = attempted
            attempted += 1
            t_call = time.perf_counter()
            stores = None
            try:
                with record_function(CALL):
                    stores = wl.call(program, i)
            except Exception:  # a failed call is counted and reported; the window goes on
                failed += 1
                traceback.print_exc()
            now = time.perf_counter()
            durations.append(now - t_call)
            if now - t0 >= seconds:
                break
            if stores is not None and wl.kept(i):
                with record_function(KEEP):
                    kept.append(wl.keep(stores, i))
            del stores
    window_s = now - t0
    # the last call's rows, kept after the window closed
    if stores is not None and (wl.kept(i) or not kept):
        kept.append(wl.keep(stores, i))
    del stores
    if on_card:
        torch.cuda.synchronize()
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    trace_data = None
    if prof is not None:
        from gpubench.trace import from_profiler

        prof.__exit__(None, None, None)
        trace_data = from_profiler(prof)
        del prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    done = attempted - failed
    member_years = done * wl.member_years_per_call
    gap, updates, rows = 1.0, 0, 0
    if kept:
        t4 = time.perf_counter()
        gap, rows, updates = wl.check(kept)
        say(f"reference: {rows} rows of {len(kept)} calls, {wl.years} years, "
            f"{time.perf_counter() - t4:.3f} s")
    limit = float(spec["limits"][wl.CHECK])
    correct = bool(done > 0 and failed == 0 and gap <= limit)

    if trace:
        from gpubench.count import weather_ops, year_bytes, year_flops
        from gpubench.layer import Context

        kind = torch.cuda.get_device_name(0) if on_card else "cpu"
        flops_peak, bytes_peak, int_peak = peaks_for(kind, cfg["dtype"])
        weather = traffic["entry"] == "transitions"
        w_flops, w_ints = weather_ops(wl.grid.nt) if weather else (0, 0)
        newton = tuple(sorted(cfg.get("newton", {}).items()))
        per_year, per_update = year_flops(cfg["model"], wl.grid.nx, wl.grid.nt,
                                          tuple(sorted(cfg["parameters"].items())), newton)
        u = updates / (rows * wl.years) if rows else 0.0  # per member-year
        itemsize = np.dtype(cfg["dtype"]).itemsize
        ctx = Context(trace=trace_data, kernel_pattern=wl.kernel_pattern,
                      member_year_flops=per_year + u * per_update + w_flops,
                      member_year_int_ops=w_ints, int_peak=int_peak,
                      launch_members=wl.K,
                      itemsize_bytes_per_launch=year_bytes(cfg["model"], wl.grid.nx,
                                                           wl.grid.nt, wl.K, itemsize, weather),
                      window_s=window_s, member_years=member_years,
                      flops_peak=flops_peak, bytes_peak=bytes_peak)
        metrics = {}
        for m in spec["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        say(f"newton: {updates} updates over {rows} rows x {wl.years} years "
            f"({u / wl.grid.nt if rows else 0.0} per member-step); "
            f"operations per member-year {per_year} + {per_update} per update")
    else:
        values = {"member_years_per_s": member_years / window_s,
                  "transition_member_years_per_s": member_years / window_s,
                  "year_ms": window_s * 1e3 / (done * wl.years) if done else float("inf"),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}

    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": int(spec["cell"]["chips"]),
                   "memory_peak_bytes": memory_peak},
    }
    if trace_data is not None:
        result["device"]["busy_s"] = trace_data.busy_s()
        result["device"]["window_s"] = trace_data.window_s
        result["breakdown"] = {"device_ops": trace_data.device_ops(),
                               "idle_gaps": trace_data.idle_gaps()}
    durations.sort()
    say(f"window: {attempted} calls ({failed} failed) in {window_s:.3f} s, "
        f"{member_years} member-years, memory peak {memory_peak} bytes; seconds a call "
        f"min {durations[0]:.4f} median {durations[len(durations) // 2]:.4f} "
        f"max {durations[-1]:.4f}")
    result["checks"] = {wl.CHECK: {"value": gap, "limit": limit}}
    say(f"check {wl.CHECK} {gap!r} limit {limit!r}")
    return result


def finite_json(value):
    """``value`` with each non-finite float written as a string ("inf",
    "nan"): JSON has no such numbers."""
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    if isinstance(value, dict):
        return {k: finite_json(v) for k, v in value.items()}
    if isinstance(value, list):
        return [finite_json(v) for v in value]
    return value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_cell(args.workload)
    import torch

    torch_s = time.perf_counter() - T_START
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"this cell needs {chips} CUDA device(s); torch.cuda.is_available()="
            f"{torch.cuda.is_available()}, device_count={torch.cuda.device_count()}")
        return 2
    steady_allocator()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch_s=torch_s)
    found = forbidden_modules()
    if found:
        say(f"the measured process loaded {found}: the JAX package or JAX itself")
        return 3
    print(json.dumps(finite_json(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
