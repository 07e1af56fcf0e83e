#!/usr/bin/env python3
"""Prove on one NVIDIA GPU that the PyTorch/CUDA port's main paths run, and
run through its hand-written kernels.

Run from the root of a checkout, on a machine with a CUDA device and nvcc::

    python3 chip_smoke.py           # about seven minutes on an H100

Phases (any failure exits non-zero, and no phase carries on past its own
failure):

1. the card (``nvidia-smi`` name and power limit) and the toolchain;
2. build the kernels from ``energybalancemodel_jl_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and print each kernel's registers;
3. the MIZ kernel against its plain PyTorch version on the card: a small
   grid point by point in float64 and float32 (raw-collected year included),
   the canonical grid at the main path's width point by point with fixed
   Newton iterations and by year-level hemispheric means with the adaptive
   Newton, members against solo runs bitwise, and ``years_per_dispatch``
   chunking;
4. the MIZ main path: a K=8192 canonical MIZ ensemble, float32, fused engine;
5. a single canonical MIZ run through ``integrate`` with ``engine='auto'``,
   every year (the raw-collected last one too) through the kernel;
6. the MIZ kernel and its plain version timed per model year on the
   canonical grid at K=1 and K=8192, f32 and f64, and the kernel's
   raw-collected year at K=1;
7. the Classic kernel against its plain version, bitwise: nx=40/nt=1000
   K=8 with D, S1 and F swept (f64 and f32, warm init and zeros, 2 years,
   the second raw-collected), the canonical grid at K=8192, the nx=4096
   single run, and members against solo runs;
8. the Classic main path: a K=8192 canonical ensemble (``engine='auto'``)
   and a 3-year single run through ``integrate`` (3 launches);
9. the batched PCR (K11) and the fixed-iteration Newton for T0 (K10)
   against their plain versions bitwise at the canonical (8192, 180), then
   one canonical MIZ year on ``ensemble_integrate(engine='batched')`` with
   ``solver='pcr_fused'`` and with ``solver='pallas'``;
10. the Classic kernel timed per model year (K=1, K=8192, f32, f64), and the
    K11 and K10 kernels per call, each beside its plain version.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

CANONICAL = (180, 2000)  # SpaceTime.sin(nx, nt, dur), bench.py's grid
K_MAIN = 8192
# kernel vs plain on the small grid: float64 point by point, both tolerances
BAR_F64 = 1e-8
# float32 with a fixed Newton iteration count (on the small grid and at the
# main path's shape): bitwise equal. Built without FMA contraction, the
# kernel rounds every operation where the plain version does (measured on an
# H100: 0). The JAX package's own fused-vs-XLA bars, atol 0.5 on the carry
# and 0.05 on the seasonal stores (tests/test_pallas_year.py:108,121), are
# only the documented upper bound
BAR_F32_FIXED = 0.0
# canonical grid, float32, one year from zero init, adaptive Newton: the
# kernel iterates per member, the plain version in lockstep, and the
# trajectory amplifies that sub-tolerance difference by nature (pointwise
# spread O(10) on an O(100) field), so only year-level hemispheric means of
# the annual-mean E and T are held, per member. Measured on an H100, max over
# 8192 members: 0.74 (E) and 0.24 (T); 1.8 and 0.56 in a build with FMA
# contraction. The bars leave ~3x headroom over the larger pair
BAR_HEMI_E = 5.0
BAR_HEMI_T = 2.0
# the Classic year (no Newton loop), K11 and K10 against their plain
# versions: bitwise, in every configuration held here
BAR_BITWISE = 0.0


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """'kernel<dtype,template ints> N regs[, S B spilled]' per compiled
    kernel, from the ``-Xptxas -v`` log."""
    out, name, spill = [], None, "0"
    for line in log.splitlines():
        m = re.search(r"(miz_year_kernel|classic_year_kernel|pcr_kernel|newton_t0_kernel)"
                      r"I([fd])((?:Li\d+E)*)", line)
        if m and "entry function" in line:
            ints = "".join("," + v for v in re.findall(r"Li(\d+)E", m.group(3)))
            name, spill = f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'f64'}{ints}>", "0"
        elif name and "bytes spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name} {regs} regs" + (f", {spill} B spilled" if spill != "0" else ""))
            name = None
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    import energybalancemodel_jl_tpu_torch as ebt
    from energybalancemodel_jl_tpu_torch.integrate import resolve_engine
    from energybalancemodel_jl_tpu_torch.models.base import (StepConfig, default_step_config,
                                                              dtype_name)
    from energybalancemodel_jl_tpu_torch.ops import _build
    from energybalancemodel_jl_tpu_torch.ops.classic_year import (classic_year,
                                                                   classic_year_reference)
    from energybalancemodel_jl_tpu_torch.ops.diffusion import diffusion_bands
    from energybalancemodel_jl_tpu_torch.ops.miz_year import (CARRY_KEYS, miz_year,
                                                               miz_year_reference)
    from energybalancemodel_jl_tpu_torch.ops.newton_t0 import newton_t0, newton_t0_reference
    from energybalancemodel_jl_tpu_torch.ops.pcr_fused import pcr_fused
    from energybalancemodel_jl_tpu_torch.ops.tridiag import pcr_solve

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card and toolchain ------------------------------------------------
    smi = nvidia_smi()
    print(smi, flush=True)
    nvcc_version = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    say(1, f"gpu={torch.cuda.get_device_name(0)!r} count={torch.cuda.device_count()} "
           f"torch={torch.__version__} cuda={torch.version.cuda} nvcc={nvcc_version!r}")

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    say(2, f"built csrc/*.cu in {time.perf_counter() - t0:.1f} s")
    say(2, "ptxas: " + " | ".join(ptxas_summary(_build.build_log())))

    def setup(nx, nt, K, dtype, D=(0.55, 0.65)):
        st = ebt.SpaceTime.sin(nx, nt, 1)
        par = ebt.default_parameters("MIZ")
        par["D"] = np.linspace(D[0], D[1], K)
        carry = ebt.Collection(
            {k: torch.zeros((K, nx), dtype=dtype, device=dev) for k in CARRY_KEYS})
        f = torch.zeros(nt, dtype=dtype, device=dev)
        return st, par, carry, f

    def years(fn, carry, par, f, st, cfg, n, raw_last=False):
        """n years; with ``raw_last`` the last one is raw-collected."""
        for y in range(n):
            carry, seas, conv, raw = fn(carry, par, f, st, cfg,
                                        collect_raw=raw_last and y == n - 1)
        torch.cuda.synchronize()
        return carry, seas, conv, raw

    def diff(a, b, what):
        a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            fail(f"{what}: NaN positions differ")
        return float(np.max(np.abs(np.nan_to_num(a) - np.nan_to_num(b)), initial=0.0)), \
            bool(np.allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=BAR_F64, atol=BAR_F64))

    def bitwise(a, b):
        return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
            torch.nan_to_num(a), torch.nan_to_num(b))

    def compare(out_k, out_p, label, bar=None):
        """Max |kernel - plain| over the carry, the seasonal stores and (when
        collected) the raw steps; fails past the absolute ``bar`` or, when
        None, past rtol = atol = BAR_F64."""
        (ck, sk, _, rk), (cp, sp, _, rp) = out_k, out_p
        pairs = {"carry": [(f"carry.{k}", ck[k], cp[k]) for k in ck],
                 "seasonal": [(f"{name}.{k}", a[k], b[k])
                              for name, a, b in zip(("winter", "summer", "avg"), sk, sp)
                              for k in a],
                 "raw": [(f"raw.{k}", rk[k], rp[k]) for k in (rk or {})]}
        worst = {}
        for part, items in pairs.items():
            worst[part] = 0.0
            for what, a, b in items:
                d, close = diff(a, b, f"{label} {what}")
                worst[part] = max(worst[part], d)
                if (not close) if bar is None else d > bar:
                    fail(f"{label}: {what} differs by {d:.3e}")
        return worst

    # -- 3. kernel against its plain version ---------------------------------
    st, par, carry, f = setup(40, 200, 8, torch.float64)
    cfg64 = default_step_config("float64")
    out_k = years(miz_year, carry, par, f, st, cfg64, 2, raw_last=True)
    out_p = years(miz_year_reference, carry, par, f, st, cfg64, 2, raw_last=True)
    w64 = compare(out_k, out_p, "f64 nx=40")
    say(3, f"f64 nx=40 nt=200 K=8 2y (year 2 raw-collected): max|kernel-plain| "
           f"carry={w64['carry']:.3e} seasonal={w64['seasonal']:.3e} raw={w64['raw']:.3e} "
           f"(bar rtol=atol={BAR_F64:g}) "
           f"conv kernel={float(out_k[2]):g} plain={float(out_p[2]):g}")

    fixed32 = StepConfig(solver="pcr", newton_abstol=0.0, newton_reltol=0.0,
                         newton_max_step=50.0, newton_max_iter=8)
    st, par, carry, f = setup(40, 200, 8, torch.float32)
    out_k = years(miz_year, carry, par, f, st, fixed32, 2, raw_last=True)
    out_p = years(miz_year_reference, carry, par, f, st, fixed32, 2, raw_last=True)
    w32 = compare(out_k, out_p, "f32 nx=40", BAR_F32_FIXED)
    say(3, f"f32 nx=40 nt=200 K=8 2y (year 2 raw-collected), 8 fixed Newton iterations: "
           f"max|kernel-plain| carry={w32['carry']:.3e} seasonal={w32['seasonal']:.3e} "
           f"raw={w32['raw']:.3e} (bar {BAR_F32_FIXED}: bitwise)")

    # canonical grid at the main path's width, float32, one year: point by
    # point with fixed Newton iterations, then with the adaptive default
    st, par, carry, f = setup(*CANONICAL, K_MAIN, torch.float32)
    out_k = years(miz_year, carry, par, f, st, fixed32, 1)
    out_p = years(miz_year_reference, carry, par, f, st, fixed32, 1)
    wmain = compare(out_k, out_p, "f32 canonical", BAR_F32_FIXED)
    say(3, f"f32 canonical K={K_MAIN} 1y, 8 fixed Newton iterations: max|kernel-plain| "
           f"carry={wmain['carry']:.3e} seasonal={wmain['seasonal']:.3e} "
           f"(bar {BAR_F32_FIXED}: bitwise)")
    del out_k, out_p

    cfg32 = default_step_config("float32")
    x = st.x
    hemi = lambda v: np.sum((v[:, :-1] + v[:, 1:]) * (x[1:] - x[:-1]) / 2.0, axis=-1)
    ck, sk, conv_k, _ = years(miz_year, carry, par, f, st, cfg32, 1)
    cp, sp, conv_p, _ = years(miz_year_reference, carry, par, f, st, cfg32, 1)
    for coll in (ck, sk.avg, sk.winter, sk.summer):
        for k in ("E", "T", "h", "phi", "Ei", "Ew", "D", "n", "T0"):
            if k in coll and not bool(torch.isfinite(coll[k]).all()):
                fail(f"canonical kernel output {k} is not finite")
    hemi_err = {}
    for k, bar in (("E", BAR_HEMI_E), ("T", BAR_HEMI_T)):
        hk = hemi(sk.avg[k].double().cpu().numpy())
        hp = hemi(sp.avg[k].double().cpu().numpy())
        hemi_err[k] = float(np.max(np.abs(hk - hp)))
        if not hemi_err[k] <= bar:
            fail(f"canonical hemispheric mean of avg.{k} differs by {hemi_err[k]:.3e} > {bar}")
    point_E = float((sk.avg["E"] - sp.avg["E"]).abs().max())
    say(3, f"f32 canonical K={K_MAIN} 1y, adaptive Newton: finite; max over members "
           f"|hemi_mean kernel-plain| "
           f"avg.E={hemi_err['E']:.3e} (bar {BAR_HEMI_E}) avg.T={hemi_err['T']:.3e} "
           f"(bar {BAR_HEMI_T}); pointwise max|dE|={point_E:.3e} (no bar: chaotic); "
           f"conv kernel={float(conv_k):g} plain={float(conv_p):g}")

    # members against solo runs, bitwise: the kernel groups Newton per member
    for m in (0, K_MAIN // 2 + 1, K_MAIN - 1):
        solo_par = dict(par, D=par["D"][m])
        solo = ebt.Collection({k: v[m:m + 1] for k, v in carry.items()})
        cs, ss, _, _ = years(miz_year, solo, solo_par, f, st, cfg32, 1)
        same = all(bitwise(cs[k][0], ck[k][m]) for k in ck) and all(
            bitwise(a[k][0], b[k][m]) for a, b in zip(ss, sk) for k in a)
        if not same:
            fail(f"member {m} of the K={K_MAIN} ensemble differs from its solo run")
    say(3, f"members 0, {K_MAIN // 2 + 1}, {K_MAIN - 1} of the canonical ensemble equal their solo runs bitwise")

    # years_per_dispatch is accepted for the JAX package's interface and does
    # nothing yet (every year is one launch): this holds its contract for
    # when chunking exists, and cannot fail before then
    st3 = ebt.SpaceTime.sin(40, 200, 4)
    par3 = ebt.default_parameters("MIZ")
    par3["D"] = np.linspace(0.55, 0.65, 8)
    par3["F"] = np.linspace(-1.0, 1.0, 8)
    runs = [ebt.ensemble_integrate("MIZ", st3, ebt.Forcing(0.0), par3, ebt.zeros_init(st3),
                                   engine="fused", dtype="float32", device=dev,
                                   years_per_dispatch=ypd, progress=False)
            for ypd in (1, 3)]
    for name, a, b in zip(("winter", "summer", "avg"), runs[0].seasonal, runs[1].seasonal):
        for k in a:
            if not np.array_equal(a[k], b[k], equal_nan=True):
                fail(f"years_per_dispatch chunking changed {name}.{k}")
    say(3, "years_per_dispatch 1 vs 3 (4 years, D and F swept): bitwise equal")

    # -- 4. the main path -------------------------------------------------------
    st = ebt.SpaceTime.sin(*CANONICAL, 2)
    par = ebt.default_parameters("MIZ")
    par["D"] = np.linspace(0.55, 0.65, K_MAIN)
    miz_year.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens = ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                                 engine="fused", dtype="float32", device=dev, progress=False)
    elapsed = time.perf_counter() - t0
    main_launches = miz_year.launches
    E = ens.seasonal.avg["E"]
    finite = bool(np.isfinite(E).all())
    if E.shape != (K_MAIN, st.dur, st.nx) or not finite:
        fail(f"main path: avg.E has shape {E.shape}, finite={finite}")
    if main_launches <= 0:
        fail("main path never launched the miz_year kernel")
    myd = K_MAIN * st.dur / elapsed * 86400.0
    say(4, f"ensemble_integrate K={K_MAIN} SpaceTime.sin(180, 2000, 2) f32 fused: "
           f"{elapsed:.3f} s, {myd:.4e} model-years/day, finite={finite}, "
           f"checksum(avg.E)={float(np.sum(E, dtype=np.float64)):.6e}, "
           f"miz_year launches +{main_launches}")

    # -- 5. a single run, engine='auto' ------------------------------------------
    st = ebt.SpaceTime.sin(*CANONICAL, 3)
    engine = resolve_engine("MIZ", st, dev)
    if engine != "fused":
        fail(f"engine='auto' resolved to {engine!r} on {dev}")
    before = miz_year.launches
    t0 = time.perf_counter()
    sol = ebt.integrate("MIZ", st, ebt.Forcing(0.0), ebt.default_parameters("MIZ"),
                        ebt.zeros_init(st), dtype="float32", device=dev, progress=False)
    elapsed = time.perf_counter() - t0
    rose = miz_year.launches - before
    if rose != st.dur:
        fail(f"integrate(engine='auto') launched the miz_year kernel {rose} times "
             f"for {st.dur} years")
    ok = (sol.seasonal.avg["E"].shape == (3, st.nx) and sol.raw["E"].shape == (st.nt, st.nx)
          and np.isfinite(sol.seasonal.avg["E"]).all() and np.isfinite(sol.raw["E"]).all())
    if not ok:
        fail("single run: wrong shapes or non-finite output")
    say(5, f"integrate SpaceTime.sin(180, 2000, 3) f32 engine='auto' -> {engine!r}: "
           f"{elapsed:.3f} s (years 1-2 seasonal, year 3 raw-collected, all by the "
           f"kernel), miz_year launches +{rose}, finite")

    # -- 6. kernel and plain version per model year, canonical grid -----------
    # kernel: CUDA events over 3 launches after a warm-up; plain: host clock
    timing = {}
    for dtype in (torch.float32, torch.float64):
        cfg = default_step_config(dtype_name(dtype))
        for K in (1, K_MAIN):
            st, par, carry, f = setup(*CANONICAL, K, dtype)
            miz_year(carry, par, f, st, cfg)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                miz_year(carry, par, f, st, cfg)
            stop.record()
            torch.cuda.synchronize()
            kernel_ms = start.elapsed_time(stop) / 3
            t0 = time.perf_counter()
            years(miz_year_reference, carry, par, f, st, cfg, 1)
            plain_ms = (time.perf_counter() - t0) * 1e3
            timing[dtype, K] = kernel_ms, plain_ms
            row = dict(dtype=str(dtype), K=K, kernel_ms_per_year=kernel_ms,
                       plain_ms_per_year=plain_ms, gpu=smi,
                       kernel_model_years_per_day=K / kernel_ms * 864e5)
            if K == 1:  # a single run's raw-collected year
                start.record()
                for _ in range(3):
                    miz_year(carry, par, f, st, cfg, collect_raw=True)
                stop.record()
                torch.cuda.synchronize()
                row["kernel_raw_year_ms"] = start.elapsed_time(stop) / 3
            say(6, json.dumps(row))
    kernel_ms, plain_ms = timing[torch.float32, K_MAIN]

    # -- 7. the Classic kernel against its plain version, bitwise ------------
    def classic_setup(nx, nt, K, dtype, warm=True, swept=("D",)):
        """Classic inputs: the warm init E = 30, Tg = E/cw (bench.py's; from
        zeros the model lands in the snowball state) or zeros, seeded forcing
        noise, and the named parameters swept over the K members."""
        st = ebt.SpaceTime.sin(nx, nt, 1)
        par = ebt.default_parameters("Classic")
        sweeps = {"D": (0.55, 0.65), "S1": (320.0, 350.0), "F": (-1.0, 1.0)}
        for name in swept:
            par[name] = np.linspace(*sweeps[name], K)
        E = torch.full((K, nx), 30.0 if warm else 0.0, dtype=dtype, device=dev)
        carry = ebt.Collection(E=E, Tg=E / par["cw"])
        f = torch.as_tensor(np.random.default_rng(7).normal(0.0, 0.5, nt), dtype=dtype,
                            device=dev)
        return st, par, carry, f

    cfg_of = lambda dtype: default_step_config(dtype_name(dtype))
    wsmall = {}
    for dtype in (torch.float64, torch.float32):
        for warm in (True, False):
            st, par, carry, f = classic_setup(40, 1000, 8, dtype, warm, ("D", "S1", "F"))
            out_k = years(classic_year, carry, par, f, st, cfg_of(dtype), 2, raw_last=True)
            out_p = years(classic_year_reference, carry, par, f, st, cfg_of(dtype), 2,
                          raw_last=True)
            label = f"classic {dtype_name(dtype)} nx=40 {'warm' if warm else 'zeros'}"
            w = compare(out_k, out_p, label, BAR_BITWISE)
            wsmall[label] = max(w.values())
            say(7, f"{label} nt=1000 K=8 D,S1,F swept 2y (year 2 raw-collected): "
                   f"max|kernel-plain| carry={w['carry']:.3e} seasonal={w['seasonal']:.3e} "
                   f"raw={w['raw']:.3e} (bar {BAR_BITWISE}: bitwise)")

    st, par, carry_c, f = classic_setup(*CANONICAL, K_MAIN, torch.float32)
    ck_out = years(classic_year, carry_c, par, f, st, cfg_of(torch.float32), 1)
    wcl = compare(ck_out, years(classic_year_reference, carry_c, par, f, st,
                                cfg_of(torch.float32), 1), "classic f32 canonical", BAR_BITWISE)
    say(7, f"classic f32 canonical K={K_MAIN} D swept 1y: max|kernel-plain| "
           f"carry={wcl['carry']:.3e} seasonal={wcl['seasonal']:.3e} (bar {BAR_BITWISE}: bitwise)")
    for m in (0, K_MAIN // 2 + 1, K_MAIN - 1):
        solo = years(classic_year, ebt.Collection({k: v[m:m + 1] for k, v in carry_c.items()}),
                     dict(par, D=par["D"][m]), f, st, cfg_of(torch.float32), 1)
        same = all(bitwise(solo[0][k][0], ck_out[0][k][m]) for k in solo[0]) and all(
            bitwise(a[k][0], b[k][m]) for a, b in zip(solo[1], ck_out[1]) for k in a)
        if not same:
            fail(f"classic member {m} of the K={K_MAIN} ensemble differs from its solo run")
    say(7, f"classic members 0, {K_MAIN // 2 + 1}, {K_MAIN - 1} of the canonical ensemble "
           "equal their solo runs bitwise")
    del ck_out, carry_c

    st, par, carry, f = classic_setup(4096, 1000, 1, torch.float32, swept=())
    whi = compare(years(classic_year, carry, par, f, st, cfg_of(torch.float32), 1, True),
                  years(classic_year_reference, carry, par, f, st, cfg_of(torch.float32), 1,
                        True), "classic f32 nx=4096", BAR_BITWISE)
    say(7, f"classic f32 K=1 SpaceTime.sin(4096, 1000, 1) 1y raw-collected (4 cells per "
           f"thread): max|kernel-plain| carry={whi['carry']:.3e} seasonal={whi['seasonal']:.3e} "
           f"raw={whi['raw']:.3e} (bar {BAR_BITWISE}: bitwise)")

    # -- 8. the Classic main path -----------------------------------------------
    st = ebt.SpaceTime.sin(*CANONICAL, 2)
    par = ebt.default_parameters("Classic")
    par["D"] = np.linspace(0.55, 0.65, K_MAIN)
    E0 = np.full(st.nx, 30.0)
    warm_init = {"E": E0, "Tg": E0 / par["cw"]}
    classic_year.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens = ebt.ensemble_integrate("Classic", st, ebt.Forcing(0.0), par, warm_init,
                                 dtype="float32", device=dev, progress=False)
    elapsed = time.perf_counter() - t0
    classic_launches = classic_year.launches
    E = ens.seasonal.avg["E"]
    finite = bool(np.isfinite(E).all())
    if E.shape != (K_MAIN, st.dur, st.nx) or not finite:
        fail(f"classic main path: avg.E has shape {E.shape}, finite={finite}")
    if classic_launches <= 0:
        fail("the classic main path never launched the classic_year kernel")
    say(8, f"ensemble_integrate('Classic') K={K_MAIN} SpaceTime.sin(180, 2000, 2) f32 "
           f"engine='auto', warm init: {elapsed:.3f} s, "
           f"{K_MAIN * st.dur / elapsed * 86400.0:.4e} model-years/day, finite={finite}, "
           f"checksum(avg.E)={float(np.sum(E, dtype=np.float64)):.6e}, "
           f"classic_year launches +{classic_launches}")

    st = ebt.SpaceTime.sin(*CANONICAL, 3)
    engine = resolve_engine("Classic", st, dev)
    if engine != "fused":
        fail(f"engine='auto' resolved to {engine!r} for Classic on {dev}")
    before = classic_year.launches
    t0 = time.perf_counter()
    sol = ebt.integrate("Classic", st, ebt.Forcing(0.0), ebt.default_parameters("Classic"),
                        warm_init, dtype="float32", device=dev, progress=False)
    elapsed = time.perf_counter() - t0
    rose = classic_year.launches - before
    if rose != st.dur:
        fail(f"integrate('Classic') launched the classic_year kernel {rose} times for "
             f"{st.dur} years")
    ok = (sol.seasonal.avg["E"].shape == (3, st.nx) and sol.raw["E"].shape == (st.nt, st.nx)
          and np.isfinite(sol.seasonal.avg["E"]).all() and np.isfinite(sol.raw["E"]).all())
    if not ok:
        fail("classic single run: wrong shapes or non-finite output")
    say(8, f"integrate('Classic') SpaceTime.sin(180, 2000, 3) f32 engine='auto' -> "
           f"{engine!r}: {elapsed:.3f} s, classic_year launches +{rose} (year 3 "
           "raw-collected), finite")

    # -- 9. K11 and K10 against their plain versions, then on the batched engine
    nx = CANONICAL[0]
    rng = np.random.default_rng(11)
    werr = {}
    for dtype in (torch.float32, torch.float64):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        lo, up = rng.normal(size=(K_MAIN, nx)), rng.normal(size=(K_MAIN, nx))
        di = (np.abs(lo) + np.abs(up) + rng.uniform(0.5, 2.0, (K_MAIN, nx))) * rng.choice(
            [-1.0, 1.0], (K_MAIN, nx))
        b = t(rng.normal(size=(K_MAIN, nx)))
        for bands, kind in (((t(lo), t(di), t(up)), "per-system"),
                            ((t(lo[0]), t(di[0]), t(up[0])), "shared")):
            x_k, x_p = pcr_fused(*bands, b), pcr_solve(*bands, b)
            torch.cuda.synchronize()
            d, _ = diff(x_k, x_p, f"pcr_fused {kind}")
            werr[dtype_name(dtype), kind] = d
            if d > BAR_BITWISE:
                fail(f"pcr_fused {dtype_name(dtype)} {kind} bands differs by {d:.3e}")
    say(9, f"pcr_fused (K11) vs pcr_solve at ({K_MAIN}, {nx}): max|kernel-plain| " + ", ".join(
        f"{dt} {kind} {d:.3e}" for (dt, kind), d in werr.items()) + f" (bar {BAR_BITWISE})")
    pcr_err = max(werr.values())

    def newton_inputs(dtype):
        """A canonical-width T0 solve on a seeded MIZ batch (the K10 kernel's
        arguments, JAX pallas_solve_T0's order)."""
        st1 = ebt.SpaceTime.sin(nx, CANONICAL[1], 1)
        mpar = ebt.default_parameters("MIZ")
        geom = diffusion_bands(st1)
        insol = ((mpar["S0"] - mpar["S1"] * st1.x * np.cos(2 * np.pi * 0.3))
                 - mpar["S2"] * st1.x ** 2)
        g = np.random.default_rng(12)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        return ([t(g.normal(-5.0, 5.0, (K_MAIN, nx))),
                 t(np.abs(g.normal(1.0, 0.5, (K_MAIN, nx))) + mpar["hmin"]),
                 t(g.normal(0.0, 3.0, (K_MAIN, nx))), t(g.uniform(0.0, 1.0, (K_MAIN, nx))),
                 t(np.tile(insol, (K_MAIN, 1))), t(geom.lo), t(geom.di), t(geom.up),
                 t(np.linspace(0.55, 0.65, K_MAIN)), mpar["k"], mpar["Tm"], mpar["A"],
                 mpar["B"], mpar["ai"], 0.0],
                dict(max_step=50.0, iters=6))

    nargs, nkw = newton_inputs(torch.float32)
    x_k = newton_t0(*nargs, **nkw)
    x_p = newton_t0_reference(*nargs, **nkw)
    torch.cuda.synchronize()
    newton_err, _ = diff(x_k, x_p, "newton_t0")
    if newton_err > BAR_BITWISE:
        fail(f"newton_t0 differs from its plain version by {newton_err:.3e}")
    say(9, f"newton_t0 (K10) vs plain at ({K_MAIN}, {nx}) f32, 6 iterations: "
           f"max|kernel-plain| {newton_err:.3e} (bar {BAR_BITWISE}: bitwise), "
           f"finite={bool(torch.isfinite(x_k).all())}")

    st = ebt.SpaceTime.sin(*CANONICAL, 1)
    par = ebt.default_parameters("MIZ")
    par["D"] = np.linspace(0.55, 0.65, K_MAIN)
    solver_launches = {}
    for solver, counter in (("pcr_fused", pcr_fused), ("pallas", newton_t0)):
        counter.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ebt.ensemble_integrate("MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
                                     engine="batched", solver=solver, dtype="float32",
                                     device=dev, progress=False)
        elapsed = time.perf_counter() - t0
        solver_launches[solver] = counter.launches
        finite = bool(np.isfinite(out.seasonal.avg["E"]).all())
        if counter.launches <= 0 or not finite:
            fail(f"batched engine, solver={solver!r}: {counter.launches} kernel launches, "
                 f"finite={finite}")
        say(9, f"ensemble_integrate('MIZ', engine='batched', solver={solver!r}) K={K_MAIN} "
               f"SpaceTime.sin(180, 2000, 1) f32: {elapsed:.3f} s for the full year, "
               f"{counter.__name__} launches +{counter.launches}, finite={finite}, "
               f"checksum(avg.E)={float(np.sum(out.seasonal.avg['E'], dtype=np.float64)):.6e}")

    # -- 10. timing: Classic per model year, K11 and K10 per call -------------
    def kernel_time(fn, n):
        """ms per call by CUDA events over n launches after a warm-up."""
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    def host_time(fn, n):
        """ms per call by host clock over n calls, synchronised."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    ctiming = {}
    for dtype in (torch.float32, torch.float64):
        for K in (1, K_MAIN):
            st, par, carry, f = classic_setup(*CANONICAL, K, dtype)
            cfg = cfg_of(dtype)
            k_ms = kernel_time(lambda: classic_year(carry, par, f, st, cfg), 3)
            p_ms = host_time(lambda: classic_year_reference(carry, par, f, st, cfg), 1)
            ctiming[dtype, K] = k_ms, p_ms
            say(10, json.dumps(dict(kernel="classic_year", dtype=str(dtype), K=K,
                                    kernel_ms_per_year=k_ms, plain_ms_per_year=p_ms, gpu=smi,
                                    kernel_model_years_per_day=K / k_ms * 864e5)))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    g = np.random.default_rng(13)
    lo, up = g.normal(size=(K_MAIN, nx)), g.normal(size=(K_MAIN, nx))
    bands = (t(lo), t(np.abs(lo) + np.abs(up) + 1.0), t(up))
    b = t(g.normal(size=(K_MAIN, nx)))
    pcr_ms = kernel_time(lambda: pcr_fused(*bands, b), 20)
    pcr_plain_ms = host_time(lambda: pcr_solve(*bands, b), 20)
    say(10, json.dumps(dict(kernel="pcr_fused", shape=f"({K_MAIN}, {nx}) f32 per-system bands",
                            kernel_ms_per_call=pcr_ms, plain_ms_per_call=pcr_plain_ms, gpu=smi)))
    newton_ms = kernel_time(lambda: newton_t0(*nargs, **nkw), 20)
    newton_plain_ms = host_time(lambda: newton_t0_reference(*nargs, **nkw), 5)
    say(10, json.dumps(dict(kernel="newton_t0", shape=f"({K_MAIN}, {nx}) f32, 6 iterations",
                            kernel_ms_per_call=newton_ms, plain_ms_per_call=newton_plain_ms,
                            gpu=smi)))

    kernels = {"kernels": [{
        "name": "miz_year",
        "route": "cuda",
        "source": "energybalancemodel_jl_tpu_torch/csrc/miz_year.cu",
        "replaces": "energybalancemodel_jl_tpu/ops/pallas_year.py:458",
        "also_replaces": "energybalancemodel_jl_tpu/ops/pallas_year.py:352",
        "launches": main_launches,
        # at the main path's shape, fixed Newton iterations (bars above)
        "max_abs_err": max(wmain.values()),
        "max_abs_err_f64_nx40": max(w64.values()),
        "max_abs_err_f32_nx40": max(w32.values()),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "shape": f"K={K_MAIN} nx={CANONICAL[0]} nt={CANONICAL[1]} float32, one model year",
    }, {
        "name": "classic_year",
        "route": "cuda",
        "source": "energybalancemodel_jl_tpu_torch/csrc/classic_year.cu",
        "replaces": "energybalancemodel_jl_tpu/ops/pallas_year.py:1628",
        "also_replaces": "energybalancemodel_jl_tpu/ops/pallas_year.py:1378",
        "launches": classic_launches,
        "max_abs_err": max(wcl.values()),
        "max_abs_err_nx40": max(wsmall.values()),
        "max_abs_err_nx4096_K1": max(whi.values()),
        "ms": ctiming[torch.float32, K_MAIN][0],
        "plain_ms": ctiming[torch.float32, K_MAIN][1],
        "shape": f"K={K_MAIN} nx={CANONICAL[0]} nt={CANONICAL[1]} float32, one model year",
    }, {
        "name": "pcr_fused",
        "route": "cuda",
        "source": "energybalancemodel_jl_tpu_torch/csrc/pcr.cu",
        "replaces": "energybalancemodel_jl_tpu/ops/pallas_tridiag.py:29",
        "launches": solver_launches["pcr_fused"],
        "max_abs_err": pcr_err,
        "ms": pcr_ms,
        "plain_ms": pcr_plain_ms,
        "shape": f"({K_MAIN}, {nx}) float32, one solve",
    }, {
        "name": "newton_t0",
        "route": "cuda",
        "source": "energybalancemodel_jl_tpu_torch/csrc/newton_t0.cu",
        "replaces": "energybalancemodel_jl_tpu/ops/pallas_newton.py:90",
        "launches": solver_launches["pallas"],
        "max_abs_err": newton_err,
        "ms": newton_ms,
        "plain_ms": newton_plain_ms,
        "shape": f"({K_MAIN}, {nx}) float32, 6 Newton iterations",
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
