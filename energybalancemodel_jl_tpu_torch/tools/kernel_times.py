"""Time the port's kernels at the main paths' shapes, and compare two
checkouts of the package on one card in one session.

Five commands, run from the root of a checkout on a machine with a CUDA
device and nvcc::

    python energybalancemodel_jl_tpu_torch/tools/kernel_times.py measure
    python energybalancemodel_jl_tpu_torch/tools/kernel_times.py compare \\
        --parent _checkout/parent --out kernel_times.json
    python energybalancemodel_jl_tpu_torch/tools/kernel_times.py highres \\
        --out highres_times.json
    python energybalancemodel_jl_tpu_torch/tools/kernel_times.py clusters \\
        --out clusters.json
    python energybalancemodel_jl_tpu_torch/tools/kernel_times.py barriers

(as a script, not with ``-m``: the package it measures is the one under
``--root``, imported after the arguments are read)

``measure`` builds the kernels of the package under ``--root`` (default: this
checkout), prints each kernel's registers as ptxas reports them, then times
(``ms``: CUDA events around wrapper calls after a warm-up launch, which
holds what the host takes to issue them; ``device_ms``, on some rows: the
kernel alone, from ``torch.profiler``), on the canonical grid
``SpaceTime.sin(180, 2000, 1)``:

- the MIZ year: deterministic at K=8192 in float32 from zero init and from
  the ice-free state of a 40-year run at F=+15, at K=1, in float64; the noisy
  builds from that state (sigma=0, keys/serial, keys/crossing, and the
  float64 table/OU), each with the member's Newton updates counted;
- the Classic year at K=8192 (deterministic in float32 and float64,
  keys/serial, keys/crossing, keys/assoc, the float64 table/OU) and at K=1,
  and, where the checkout has both, its warp and block builds at K=1 and
  K=8192;
- K10 (``newton_t0``, 6 iterations; its scalars as Python numbers, and as
  tensors on the device) and K11 (``pcr_fused``) per call at (8192, 180),
  and their wide builds per call at (64, 16384) and (64, 32768);
- the wall time of ``transitions`` (MIZ, K=8192, 3 years, keys/serial) and of
  the 88 K=1 deterministic years its references cost (2 x 40 years of
  ``integrate`` + 8 reference-area years).

Every timed result is hashed (SHA-256 of its bytes), so two checkouts whose
kernels round alike print equal hashes. ``compare`` runs ``measure`` in a
process of its own for the parent, this checkout, this checkout, the parent,
in that order, and prints the rows side by side with the card's name and
power limit.

``barriers`` builds and runs ``tools/cluster_sync_bench.cu``: the
nanoseconds of one barrier phase of a thread-block cluster against a block's.
``clusters`` times every cluster build (both year kernels, K10 and K11) at
every cluster size and as the C side picks it, at the main paths' widths
(see its docstring).

``highres`` times the high-resolution MIZ years on the wide build: for each
grid of ``--miz`` (``nx:nt``; default the two of ``chip_smoke.py`` phase 22,
nx^2/nt = 16.0, the canonical grid's coupling) one float32 year from zero
init at F = 0 with the default Newton tolerances on the kernel's counting
build, with its seconds (CUDA events), microseconds per step and Newton
updates per step, each row beside the card's name and power limit. It
prints one JSON object and, with ``--out``, writes it there.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

CANONICAL = (180, 2000)
K_MAIN = 8192


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, n):
    """ms per call of ``fn`` by CUDA events around ``n`` calls (the caller
    makes any warm-up)."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def ptxas_rows(log):
    """kernel<dtype,template values> -> 'N registers[, S bytes spilled]' from
    an ``-Xptxas -v`` log."""
    rows, name, spill = {}, None, "0"
    for line in log.splitlines():
        m = re.search(r"(miz_year_kernel|classic_year_kernel|classic_warp_kernel|pcr_kernel|"
                      r"pcr_warp_kernel|newton_t0_kernel|normal_table_kernel|normal_bits_kernel|"
                      r"classic_cluster_kernel|miz_cluster_kernel|pcr_cluster_kernel|"
                      r"newton_t0_cluster_kernel)(?:I([fd])((?:L[ib]\d+E)*))?",
                      line)
        if m and "entry function" in line:
            args = [{"f": "f32", "d": "f64"}[m.group(2)]] if m.group(2) else []
            args += [v for _, v in re.findall(r"L([ib])(\d+)E", m.group(3) or "")]
            name, spill = f"{m.group(1)}<{','.join(args)}>", "0"
        elif name and "bytes spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            rows[name] = f"{regs} registers" + (f", {spill} bytes spilled" if spill != "0" else "")
            name = None
    return rows


def measure(root, flags, rows_wanted):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.models.base import default_step_config, get_model
    from energybalancemodel_jl_tpu_torch.ops import _build, prng
    from energybalancemodel_jl_tpu_torch.ops import classic_year as cy
    from energybalancemodel_jl_tpu_torch.ops.classic_year import classic_year
    from energybalancemodel_jl_tpu_torch.ops.diffusion import diffusion_bands
    from energybalancemodel_jl_tpu_torch.ops.miz_year import CARRY_KEYS, miz_year
    from energybalancemodel_jl_tpu_torch.ops.newton_t0 import newton_t0
    from energybalancemodel_jl_tpu_torch.ops.pcr_fused import pcr_fused

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    if flags:
        _build.NVCC_FLAGS = tuple(_build.NVCC_FLAGS) + tuple(flags)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load_library()
    result = {"root": root, "flags": flags, "gpu": nvidia_smi(),
              "build_s": time.perf_counter() - t0, "rows": {}}
    result["ptxas"] = ptxas_rows(_build.build_log())

    def digest(out):
        h = hashlib.sha256()
        for v in out:
            if torch.is_tensor(v):
                h.update(v.detach().cpu().numpy().tobytes())
            elif v is not None and hasattr(v, "items"):
                for _, w in sorted(v.items()):
                    h.update(w.detach().cpu().numpy().tobytes())
            elif isinstance(v, tuple):
                for coll in v:
                    for _, w in sorted(coll.items()):
                        h.update(w.detach().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def kernel_time(fn, n=3):
        out = fn()
        return event_ms(fn, n), out

    def device_time(fn, n, kernel):
        """ms per call that the device spent in kernels whose name holds
        ``kernel``, from torch.profiler; None if it recorded no device time."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            if kernel in e.key:
                total += getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
        return total / n / 1e3 if total else None

    def row(name, fn, n=3, count=None, kernel=None):
        if rows_wanted and not any(name.startswith(w) for w in rows_wanted):
            return
        ms, out = kernel_time(fn, n)
        entry = {"ms": ms, "sha": digest(out if isinstance(out, tuple) else (out,))}
        if kernel is not None:
            entry["device_ms"] = device_time(fn, n, kernel)
        if count is not None:
            entry["newton_updates_per_member_step"] = count()
        result["rows"][name] = entry
        print(f"  {name}: {json.dumps(entry)}", flush=True)

    nx, nt = CANONICAL
    st1 = ebt.SpaceTime.sin(nx, nt, 1)
    mpar = ebt.default_parameters("MIZ")
    cpar = ebt.default_parameters("Classic")

    def miz_setup(K, dtype):
        par = dict(mpar)
        par["D"] = np.linspace(0.55, 0.65, K)
        carry = ebt.Collection(
            {k: torch.zeros((K, nx), dtype=dtype, device=dev) for k in CARRY_KEYS})
        return carry, par, torch.zeros(nt, dtype=dtype, device=dev), st1

    def counted(args, cfg, **kw):
        K = args[0]["Ei"].shape[0]

        def count():
            n = torch.zeros(K, dtype=torch.int32, device=dev)
            miz_year(*args, cfg, newton_iters=n, **kw)
            return int(n.sum()) / K / nt
        return count

    cfg32, cfg64 = default_step_config("float32"), default_step_config("float64")
    for label, K, dtype, cfg in (("miz det f32 K=8192 zero init", K_MAIN, torch.float32, cfg32),
                                 ("miz det f32 K=1 zero init", 1, torch.float32, cfg32),
                                 ("miz det f64 K=8192 zero init", K_MAIN, torch.float64, cfg64)):
        args = miz_setup(K, dtype)
        row(label, lambda: miz_year(*args, cfg), count=counted(args, cfg),
            kernel="miz_year_kernel")

    # the ice-free state of 40 years at F=+15, and the ice-covered one at -25
    st40 = ebt.SpaceTime.sin(nx, nt, 40)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refs = {}
    for name, F in (("a", 15.0), ("b", -25.0)):
        sol = ebt.integrate("MIZ", st40, ebt.Forcing(F), mpar, ebt.zeros_init(st40),
                            dtype="float32", device=dev, progress=False)
        refs[name] = ebt.Collection({k: sol.raw[k][-1] for k in ("Ei", "Ew", "h", "D", "phi")})
    result["rows"]["miz 80 K=1 reference years (2 x integrate 40 y), wall"] = {
        "ms": (time.perf_counter() - t0) * 1e3}
    print(f"  reference runs: {time.perf_counter() - t0:.3f} s", flush=True)

    rho = float(np.exp(-1.0 / nt / 0.05))
    keys = prng.member_year_keys(0, K_MAIN, 0)
    thr_sgn = (torch.linspace(0.0, 1.0, K_MAIN, device=dev),
               torch.tensor([1.0, -1.0], device=dev).repeat(K_MAIN // 2))

    def attractor_inputs(model, state, par, F, sigma, dtype):
        carry = get_model(model).init_carry(state, st1, dtype, dev)
        carry = ebt.Collection({k: v.expand((K_MAIN,) + tuple(v.shape)).contiguous()
                                for k, v in carry.items()})
        ou = (rho, sigma * float(np.sqrt(1.0 - rho * rho)),
              torch.zeros(K_MAIN, dtype=dtype, device=dev))
        return (carry, par, torch.full((nt,), F, dtype=dtype, device=dev), st1), ou

    a32, ou32 = attractor_inputs("MIZ", refs["a"], mpar, 0.0, 4.0, torch.float32)
    a64, ou64 = attractor_inputs("MIZ", refs["a"], mpar, 0.0, 4.0, torch.float64)
    miz_modes = {
        "miz det f32 K=8192 ice-free state": (a32, cfg32, {}),
        "miz noisy sigma=0 f32": (a32, cfg32, dict(noise_keys=keys,
                                                   noise_ou=(rho, 0.0, ou32[2]))),
        "miz keys/serial f32": (a32, cfg32, dict(noise_keys=keys, noise_ou=ou32)),
        "miz keys/crossing f32": (a32, cfg32, dict(noise_keys=keys, noise_ou=ou32,
                                                   crossing=thr_sgn)),
        "miz table/OU f64": (a64, cfg64, dict(
            noise=torch.as_tensor(np.random.default_rng(3).normal(size=(nt, K_MAIN)),
                                  device=dev), noise_ou=ou64)),
    }
    for label, (args, cfg, kw) in miz_modes.items():
        row(label, lambda: miz_year(*args, cfg, **kw), n=2, count=counted(args, cfg, **kw))

    # Classic from the warm init
    par = dict(cpar)
    par["D"] = np.linspace(0.55, 0.65, K_MAIN)
    E = torch.full((K_MAIN, nx), 30.0, dtype=torch.float32, device=dev)
    cargs = (ebt.Collection(E=E, Tg=E / par["cw"]), par,
             torch.zeros(nt, dtype=torch.float32, device=dev), st1)
    cou = (rho, 8.0 * float(np.sqrt(1.0 - rho * rho)),
           torch.zeros(K_MAIN, dtype=torch.float32, device=dev))
    row("classic det f32 K=8192", lambda: classic_year(*cargs, cfg32), kernel="classic_")
    E64 = E.double()
    cargs64 = (ebt.Collection(E=E64, Tg=E64 / par["cw"]), par,
               torch.zeros(nt, dtype=torch.float64, device=dev), st1)
    row("classic det f64 K=8192", lambda: classic_year(*cargs64, cfg64))
    row("classic keys/serial f32", lambda: classic_year(*cargs, cfg32, noise_keys=keys,
                                                        noise_ou=cou))
    row("classic keys/crossing f32", lambda: classic_year(*cargs, cfg32, noise_keys=keys,
                                                          noise_ou=cou, crossing=thr_sgn))
    row("classic keys/assoc f32", lambda: classic_year(*cargs, cfg32, noise_keys=keys,
                                                       noise_ou=cou, ou_assoc=True))
    # a seeded table, as the MIZ row's: the same input for both checkouts
    cou64 = (cou[0], cou[1], cou[2].double())
    table64 = torch.as_tensor(np.random.default_rng(3).normal(size=(nt, K_MAIN)), device=dev)
    row("classic table/OU f64", lambda: classic_year(*cargs64, cfg64, noise=table64,
                                                     noise_ou=cou64))
    # the single run (K = 1, as integrate runs it), on the build the kernel
    # picks, and on each build where the checkout has both
    cargs1 = (ebt.Collection(E=E[:1], Tg=E[:1] / par["cw"]), cpar, cargs[2], st1)
    row("classic det f32 K=1", lambda: classic_year(*cargs1, cfg32))
    if hasattr(cy, "WARP_MIN_K"):
        saved = cy.WARP_MIN_K
        for label, min_k in (("warp", 1), ("block", 2 ** 30)):
            cy.WARP_MIN_K = min_k
            row(f"classic det f32 K=1 {label} build", lambda: classic_year(*cargs1, cfg32))
            row(f"classic det f32 K=8192 {label} build", lambda: classic_year(*cargs, cfg32))
        cy.WARP_MIN_K = saved

    # K11 and K10 at (8192, 180)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
    g = np.random.default_rng(13)
    lo, up = g.normal(size=(K_MAIN, nx)), g.normal(size=(K_MAIN, nx))
    bands = (t(lo), t(np.abs(lo) + np.abs(up) + 1.0), t(up))
    b = t(g.normal(size=(K_MAIN, nx)))
    row("K11 pcr_fused f32 (8192, 180)", lambda: pcr_fused(*bands, b), n=20, kernel="pcr_")
    geom = diffusion_bands(st1)
    insol = (mpar["S0"] - mpar["S1"] * st1.x * np.cos(2 * np.pi * 0.3)) - mpar["S2"] * st1.x ** 2
    g = np.random.default_rng(12)
    nargs = [t(g.normal(-5.0, 5.0, (K_MAIN, nx))),
             t(np.abs(g.normal(1.0, 0.5, (K_MAIN, nx))) + mpar["hmin"]),
             t(g.normal(0.0, 3.0, (K_MAIN, nx))), t(g.uniform(0.0, 1.0, (K_MAIN, nx))),
             t(np.tile(insol, (K_MAIN, 1))), t(geom.lo), t(geom.di), t(geom.up),
             t(np.linspace(0.55, 0.65, K_MAIN)), mpar["k"], mpar["Tm"], mpar["A"], mpar["B"],
             mpar["ai"], 0.0]
    row("K10 newton_t0 f32 (8192, 180) 6 iterations",
        lambda: newton_t0(*nargs, max_step=50.0, iters=6), n=20, kernel="newton_t0_kernel")
    # the scalars as the batched engine passes them: tensors on the device
    dargs = nargs[:9] + [t(v) for v in nargs[9:]]
    step = t(50.0)
    row("K10 newton_t0 f32, scalars on the device",
        lambda: newton_t0(*dargs, max_step=step, iters=6), n=20, kernel="newton_t0_kernel")
    # their wide builds at chip_smoke.py phase 22's shapes: K11 (64, 32768),
    # K10 (64, 16384) with 6 iterations, float32
    for label, fn in wide_solver_calls(torch, dev, torch.float32, mpar, 64):
        row(label, fn, n=5)

    # the wide year kernels at their main paths' shapes (chip_smoke.py phase
    # 22), K=1 float32: the Classic year at nx=32768, nt=1000 from the warm
    # init, and the MIZ high-resolution year SpaceTime.sin(1536, 147456)
    # from zero init with the default Newton tolerances (a short year at the
    # same width warms the build; one year is timed and hashed, ~40-60 s)
    hst = ebt.SpaceTime.sin(32768, 1000, 1)
    hE = torch.full((1, hst.nx), 30.0, dtype=torch.float32, device=dev)
    hargs = (ebt.Collection(E=hE, Tg=hE / cpar["cw"]), cpar,
             torch.zeros(hst.nt, dtype=torch.float32, device=dev), hst)
    row("classic wide f32 K=1 nx=32768 nt=1000", lambda: classic_year(*hargs, cfg32))
    mname = "miz wide f32 K=1 SpaceTime.sin(1536, 147456)"
    if not rows_wanted or any(mname.startswith(w) for w in rows_wanted):
        mst = ebt.SpaceTime.sin(1536, 147456, 1)
        mcarry = ebt.Collection(
            {k: torch.zeros((1, mst.nx), dtype=torch.float32, device=dev) for k in CARRY_KEYS})
        mf = torch.zeros(mst.nt, dtype=torch.float32, device=dev)
        warm = ebt.SpaceTime.sin(1536, 16, 1)
        miz_year(ebt.Collection({k: v for k, v in mcarry.items()}), mpar,
                 torch.zeros(warm.nt, dtype=torch.float32, device=dev), warm, cfg32)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = miz_year(mcarry, mpar, mf, mst, cfg32)
        stop.record()
        torch.cuda.synchronize()
        result["rows"][mname] = entry = {"ms": start.elapsed_time(stop), "sha": digest(out)}
        print(f"  {mname}: {json.dumps(entry)}", flush=True)

    # the transitions main path: wall time, kernels and host
    if not rows_wanted or "transitions" in rows_wanted:
        for _ in range(2):  # the first call warms the allocator
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ebt.transitions("MIZ", st1, ebt.Forcing(0.0), mpar, refs["a"], refs["b"],
                                  sigma=4.0, tau=0.05, K=K_MAIN, years=3, seed=0,
                                  dtype="float32", device=dev)
            wall = time.perf_counter() - t0
        result["rows"]["transitions MIZ K=8192 3 years keys/serial, wall"] = {
            "ms": wall * 1e3, "sha": hashlib.sha256(
                np.ascontiguousarray(res.areas).tobytes()).hexdigest()[:16]}
        print(f"  transitions: {wall:.3f} s", flush=True)
    return result


def wide_solver_calls(torch, dev, dtype, mpar, K):
    """``(label, call)`` of K11 at (K, 32768) and K10 at (K, 16384), 6
    iterations, on seeded inputs (chip_smoke.py phase 22's)."""
    from energybalancemodel_jl_tpu_torch.ops.diffusion import diffusion_bands
    from energybalancemodel_jl_tpu_torch.ops.newton_t0 import newton_t0
    from energybalancemodel_jl_tpu_torch.ops.pcr_fused import pcr_fused
    from energybalancemodel_jl_tpu_torch.spacetime import SpaceTime

    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    g = np.random.default_rng(22)
    n11 = 32768
    lo, up = g.normal(size=(K, n11)), g.normal(size=(K, n11))
    di = (np.abs(lo) + np.abs(up) + g.uniform(0.5, 2.0, lo.shape)) * g.choice([-1.0, 1.0],
                                                                           lo.shape)
    bands, b = (t(lo), t(di), t(up)), t(g.normal(size=(K, n11)))
    n10 = 16384
    st = SpaceTime.sin(n10, 1000, 1)
    geom = diffusion_bands(st)
    insol = (mpar["S0"] - mpar["S1"] * st.x * np.cos(2 * np.pi * 0.3)) - mpar["S2"] * st.x ** 2
    g = np.random.default_rng(12)
    args = [t(g.normal(-5.0, 5.0, (K, n10))),
            t(np.abs(g.normal(1.0, 0.5, (K, n10))) + mpar["hmin"]),
            t(g.normal(0.0, 3.0, (K, n10))), t(g.uniform(0.0, 1.0, (K, n10))),
            t(np.tile(insol, (K, 1))), t(geom.lo), t(geom.di), t(geom.up),
            t(np.linspace(0.55, 0.65, K) * (180 ** 2 / 2000) * 2000 / n10 ** 2), mpar["k"],
            mpar["Tm"], mpar["A"], mpar["B"], mpar["ai"], 0.0]
    name = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    return [(f"K11 wide pcr_fused {name} ({K}, {n11})", lambda: pcr_fused(*bands, b)),
            (f"K10 wide newton_t0 {name} ({K}, {n10}) 6 iterations",
             lambda: newton_t0(*args, max_step=50.0, iters=6))]


def compare(parent, out, rows_wanted):
    runs = []
    for root in (parent, ".", ".", parent):
        cmd = [sys.executable, os.path.abspath(__file__), "measure", "--root", root, "--json"]
        if rows_wanted:
            cmd += ["--rows", *rows_wanted]
        print(f"== measure {root}", flush=True)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sys.stdout.write(proc.stdout[-6000:])
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-6000:])
            raise SystemExit(f"measure {root} failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    gpu = runs[0]["gpu"]
    print(f"card: {gpu}")
    print(f"{'row':58s} {'parent':>9s} {'change':>9s} {'change':>9s} {'parent':>9s}  ratio  same bits")
    for name in runs[1]["rows"]:
        ms = [r["rows"].get(name, {}).get("ms", float("nan")) for r in runs]
        shas = {r["rows"].get(name, {}).get("sha") for r in runs}
        ratio = (ms[0] + ms[3]) / (ms[1] + ms[2])
        print(f"{name:58s} {ms[0]:9.3f} {ms[1]:9.3f} {ms[2]:9.3f} {ms[3]:9.3f}  {ratio:5.2f}  "
              f"{len(shas) == 1}")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as fh:
            json.dump({"gpu": gpu, "order": ["parent", "change", "change", "parent"],
                       "runs": runs}, fh, indent=1)


def highres(grids, out):
    sys.path.insert(0, os.path.abspath("."))
    import torch

    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.models.base import default_step_config
    from energybalancemodel_jl_tpu_torch.ops import _build
    from energybalancemodel_jl_tpu_torch.ops.miz_year import CARRY_KEYS, miz_year

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    dev = torch.device("cuda", 0)
    _build.load_library()  # outside the timed years
    result = {"gpu": nvidia_smi(), "miz": []}
    cfg = default_step_config("float32")
    for nx, nt in grids:
        st = ebt.SpaceTime.sin(nx, nt, 1)
        carry = ebt.Collection(
            {k: torch.zeros((1, nx), dtype=torch.float32, device=dev) for k in CARRY_KEYS})
        f = torch.zeros(nt, dtype=torch.float32, device=dev)
        updates = torch.zeros(1, dtype=torch.int32, device=dev)
        # the timed year includes the wrapper's sum and read-back of the count
        # (miz_year.newton_updates): microseconds against a year of seconds
        s = event_ms(lambda: miz_year(carry, ebt.default_parameters("MIZ"), f, st, cfg,
                                      newton_iters=updates), 1) / 1e3
        row = dict(nx=nx, nt=nt, coupling=nx ** 2 / nt, s_per_year=s, us_per_step=s / nt * 1e6,
                   newton_updates_per_step=int(updates.sum()) / nt,
                   newton_max_iter=cfg.newton_max_iter, gpu=result["gpu"])
        result["miz"].append(row)
        print(json.dumps(row), flush=True)
    if out:
        with open(out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))


def barriers(out):
    """Build ``tools/cluster_sync_bench.cu`` with nvcc and run it: the
    nanoseconds of one barrier phase of a thread-block cluster (and of a
    block), for cluster sizes 1-16 and 96 or 384 threads per block."""
    import tempfile

    sys.path.insert(0, os.path.abspath("."))
    from energybalancemodel_jl_tpu_torch.ops import _build

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cluster_sync_bench.cu")
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "cluster_sync_bench")
        subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-std=c++17", "-o", exe, src], check=True)
        proc = subprocess.run([exe], capture_output=True, text=True, check=True)
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    result = {"gpu": nvidia_smi(), "phases": rows}
    for r in rows:
        print(json.dumps(r), flush=True)
    if out:
        with open(out, "w") as fh:
            json.dump(result, fh, indent=1)


def clusters(out):
    """The cluster builds at C = 2, 4, 8 and 16 (as ``ops._year.FORCE_CLUSTER``
    forces it) and as the C side picks, at the main paths' widths: the
    Classic year at nx=32768, nt=1000, K=1 (float32, float64; CUDA events
    per year); the MIZ year at nx=1536 (float32, float64) and nx=16384
    (float32) over nt=256 steps with D scaled to the canonical coupling,
    K=1, once with 0 and once with 8 fixed Newton updates a step: the step's
    cost without updates and the cost of one update (the high-resolution
    year is nt x (base + u x update), u the updates a step that ``highres``
    counts); and K11 at (64, 32768), K10 at (64, 16384) with 6 iterations
    (float32, float64; CUDA events per call)."""
    sys.path.insert(0, os.path.abspath("."))
    import torch

    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.models.base import StepConfig, default_step_config
    from energybalancemodel_jl_tpu_torch.ops import _build, _year
    from energybalancemodel_jl_tpu_torch.ops.classic_year import classic_year
    from energybalancemodel_jl_tpu_torch.ops.miz_year import CARRY_KEYS, miz_year

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    dev = torch.device("cuda", 0)
    _build.load_library()
    result = {"gpu": nvidia_smi(), "classic": [], "miz": []}
    cfg = default_step_config("float32")
    fixed = lambda n: StepConfig(solver="pcr", newton_abstol=0.0, newton_reltol=0.0,
                                 newton_max_step=50.0, newton_max_iter=n)

    def planned(kernel, nx, nt, dtype, C):
        _year.FORCE_CLUSTER[kernel] = C
        try:
            return _year.cluster_plan(kernel, nx, nt, 1, dtype, dev)._asdict()
        except RuntimeError as e:
            return {"error": str(e)}

    for dtype in (torch.float32, torch.float64):
        st = ebt.SpaceTime.sin(32768, 1000, 1)
        par = ebt.default_parameters("Classic")
        E = torch.full((1, st.nx), 30.0, dtype=dtype, device=dev)
        args = (ebt.Collection(E=E, Tg=E / par["cw"]), par,
                torch.zeros(st.nt, dtype=dtype, device=dev), st)
        for C in (2, 4, 8, 16, 0):
            row = dict(nx=st.nx, nt=st.nt, dtype=str(dtype), C=C or "chosen",
                       plan=planned("classic_year", st.nx, st.nt, dtype, C))
            if "error" not in row["plan"]:
                classic_year(*args, cfg)
                row["ms_per_year"] = event_ms(lambda: classic_year(*args, cfg), 3)
            result["classic"].append(row)
            print(json.dumps(row), flush=True)
    _year.FORCE_CLUSTER["classic_year"] = 0
    nt = 256
    for nx, dtype in ((1536, torch.float32), (1536, torch.float64), (16384, torch.float32)):
        st = ebt.SpaceTime.sin(nx, nt, 1)
        par = ebt.default_parameters("MIZ")
        par["D"] = par["D"] * (180 ** 2 / 2000) * nt / nx ** 2
        carry = ebt.Collection(
            {k: torch.zeros((1, nx), dtype=dtype, device=dev) for k in CARRY_KEYS})
        f = torch.zeros(nt, dtype=dtype, device=dev)
        for C in (2, 4, 8, 16, 0):
            row = dict(nx=nx, nt=nt, dtype=str(dtype), C=C or "chosen",
                       plan=planned("miz_year", nx, nt, dtype, C))
            if "error" not in row["plan"]:
                t = {}
                for n in (0, 8):
                    miz_year(carry, par, f, st, fixed(n))
                    t[n] = event_ms(lambda: miz_year(carry, par, f, st, fixed(n)), 2)
                row["us_per_step_no_update"] = t[0] * 1e3 / nt
                row["us_per_update"] = (t[8] - t[0]) * 1e3 / nt / 8
            result["miz"].append(row)
            print(json.dumps(row), flush=True)
    _year.FORCE_CLUSTER["miz_year"] = 0
    result["solvers"] = []
    mpar = ebt.default_parameters("MIZ")
    for dtype in (torch.float32, torch.float64):
        for (label, fn), (kernel, n) in zip(wide_solver_calls(torch, dev, dtype, mpar, 64),
                                           (("pcr_fused", 32768), ("newton_t0", 16384))):
            for C in (2, 4, 8, 16, 0):
                _year.FORCE_CLUSTER[kernel] = C
                try:
                    plan = _year.cluster_plan(kernel, n, 1, 64, dtype, dev)._asdict()
                except RuntimeError as e:
                    plan = {"error": str(e)}
                row = dict(call=label, C=C or "chosen", plan=plan)
                if "error" not in plan:
                    fn()
                    row["ms_per_call"] = event_ms(fn, 5)
                result["solvers"].append(row)
                print(json.dumps(row), flush=True)
            _year.FORCE_CLUSTER[kernel] = 0
    if out:
        with open(out, "w") as fh:
            json.dump(result, fh, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("measure")
    m.add_argument("--root", default=".")
    m.add_argument("--nvcc-flag", action="append", default=[])
    m.add_argument("--rows", nargs="*", default=[])
    m.add_argument("--json", action="store_true", help="print the result as one JSON line")
    c = sub.add_parser("compare")
    c.add_argument("--parent", required=True)
    c.add_argument("--out", default="")
    c.add_argument("--rows", nargs="*", default=[])
    h = sub.add_parser("highres")
    h.add_argument("--miz", nargs="*", type=lambda v: tuple(map(int, v.split(":"))),
                   default=[(2048, 262144), (1536, 147456)])
    h.add_argument("--out", default="")
    b = sub.add_parser("barriers")
    b.add_argument("--out", default="")
    cl = sub.add_parser("clusters")
    cl.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.cmd == "measure":
        res = measure(args.root, args.nvcc_flag, args.rows)
        print(f"card: {res['gpu']}; built in {res['build_s']:.1f} s")
        for k, v in res["ptxas"].items():
            print(f"  {k}: {v}")
        if args.json:
            print(json.dumps(res))
    elif args.cmd == "highres":
        highres(args.miz, args.out)
    elif args.cmd == "barriers":
        barriers(args.out)
    elif args.cmd == "clusters":
        clusters(args.out)
    else:
        compare(args.parent, args.out, args.rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
